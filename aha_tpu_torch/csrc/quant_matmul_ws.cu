// y[M, N] = x[M, K] @ W[K, N] with bf16 x, weight-only, at many rows: a
// warp-specialised Hopper kernel shared by the two quantised weights,
//   * int8 W [K, N] with a per-column f32 scale: the exact bf16 products summed
//     in f32 over K, the scale times the finished sum, one cast; replaces, from
//     the plan's WS_MIN_M rows on, the TPU kernel
//     aha_tpu/ops/pallas/fused_matmul.py::int8_matmul (a8=False) and, through the
//     same plan, aha_tpu/ops/pallas/quant_matmul.py::quant_matmul;
//   * packed int4 W (q4value [K/2, N], row 2 j in the low nibble of byte j, 2 j + 1
//     in the high one, values offset by 8) with bf16 scales scale4 [K/G, N]: each
//     group's f32 sum times its scale, added into the f32 total in group order
//     (acc += part * s, as _kernel_int4 does; the scale is never folded into a bf16
//     weight), one cast; replaces, from WS_MIN_M rows on, the forward of
//     aha_tpu/ops/pallas/fused_matmul.py::int4_matmul (and int4_qlinear's).
// Below WS_MIN_M rows the one-warpgroup wgmma kernels of int8_matmul.cu and
// int4_matmul.cu stay.
//
// What bounds it on an H100 at these rows: the 2 M K N operations at 989 TFLOP/s,
// and the shared memory's 128 bytes a clock that the products' operands and the
// copies share. The one-warpgroup kernels ran the copies, the conversion of the
// weight and the products as one chain on one warpgroup, and their token tile (at
// most 128 rows, int4 80) made each weight tile be copied and converted once for
// every 128 (80) rows of x. Builds with parts switched off (an H100, int8 gate_up
// at 2,048 rows) put the copies first among what is left, then the conversion;
// moving the fence before the products to the producer, or leaving it out, changed
// little.
//
// The design: a tile is 128 weight columns (two slabs of 64), T token rows and a K
// range; a block of three warpgroups walks its K range in stages of 64 through a
// ring of kStages shared-memory slots guarded by mbarriers. One block an SM takes
// tiles t, t + 132, ... (token tiles fastest: the blocks in flight share a few
// column blocks of W in L2), and its ring runs on from one tile into the next: the
// producer fills the next tile's first stages while the consumers store the last
// tile's sums (a tile of the int8 tower, K 1,024, is 16 stages).
//   * Warpgroup 0, the producer (setmaxnreg: 72 registers a thread), only copies:
//     a slot's x tile (T rows, the B operand as it lies, 128-byte swizzle), the raw
//     weight bytes (int8: 64 rows of 128 columns, 144 bytes apart; int4: 32 packed
//     rows, 160 bytes apart, and the group's 128 bf16 scales), by cp.async, whose
//     landing arrives on the slot's `full` barrier (cp.async.mbarrier.arrive
//     .noinc), after waiting on its `empty` barrier for the consumers to release it.
//     No tensor map: nothing of the host's work grows with calls.
//   * Warpgroups 1 and 2, the consumers (216 registers a thread), take slab c =
//     0 and 1. Both share the slot's x tile and raw bytes; each converts its own
//     slab's 64 columns once, in registers, as the A operand (int8 -> bf16 as
//     pair_bf16, int4 nibbles - 8 as int4_matmul.cu's unpack; exact), and runs
//     wgmma m64nTk16 with the x tile as B, N = T up to 256: the weight is copied
//     and converted once a block for T token rows. A stage is two halves of two
//     16-deep pieces whose operands alternate between two register sets: while the
//     tensor cores run one half, the consumer converts the next, and the other
//     consumer's products fill the pipe. A consumer releases a slot once the
//     products that read it are done.
// Shared memory a clock at the full tensor rate (int8, T 256): the x tile's 32 KB
// copied in and read by both consumers' products (64 KB), the raw bytes copied in
// and read by both, about 110 bytes of the 128 (the one-shared-operand route, a
// converted bf16 tile read by consumers that split the rows, needed some 160 and
// ran slower than the one-warpgroup kernel on an H100).
//
// Registers: int8 keeps one f32 sum over the block's K, T / 2 registers (128 at T
// 256). int4 keeps the running group's sum and the total, T registers: T <= 160.
// Beside them two operand sets of 8, the stage's weight words, the descriptors.
//
// The accumulator rows are relabelled, not moved: consumer c's row gid (gid + 8)
// of warp w is weight column 4 (8 w + gid) + 2 c (+ 1) (int8_matmul.py::
// fwd_row_to_column of row 64 c + 16 w + gid (+ 8)), so a 32-bit word of a raw row
// holds both consumers' columns of a thread, its bytes 2 c and 2 c + 1 its own, and
// y leaves as 4-byte stores of two neighbouring columns.
//
// K is split when the plan wants more tiles (whole stages for int8, whole groups
// for int4): each split writes its f32 sums and splitk_reduce adds them in split
// order, then scales (int8) and rounds: no atomics, the same bits every time.
#include <type_traits>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kBN = 128;                  // weight columns a block: two slabs of 64
constexpr int kKS = 64;                   // contraction depth of a stage
constexpr int kThreads = 3 * kWgThreads;  // the producer and two consumers
constexpr int kSmemLimit = 232448;        // a block's shared memory on an H100 (227 KB)
constexpr int kMaxStages = 6;
constexpr int kProducerRegs = 72, kConsumerRegs = 216;   // 128 x 72 + 256 x 216 = 384 x 168
static_assert(kWgThreads * kProducerRegs + 2 * kWgThreads * kConsumerRegs == kThreads * 168,
              "the registers the block is launched with, 168 a thread, moved between roles");

// A stage's raw bytes after its x tile: int8 64 rows of the block's 128 columns, 144
// bytes apart (the words a warp reads at once, rows 2 tig + d at columns 8 w + gid,
// meet 32 banks); int4 32 packed rows 160 bytes apart (rows tig + 4 q), then the
// group's 128 bf16 scales; each padded to a multiple of 1 KB.
template <bool W4> struct Raw {
  static constexpr int kRow = W4 ? 160 : 144;
  static constexpr int kScales = 32 * 160;
  static constexpr int kBytes = W4 ? 6144 : 9216;
};
template <bool W4> __host__ __device__ constexpr int stage_bytes(int T) {
  return T * 128 + Raw<W4>::kBytes;
}
// as many slots as fit beside the alignment slack and the barriers, at most six
template <bool W4> __host__ __device__ constexpr int stages(int T) {
  return (kSmemLimit - kAlignSlack - 256) / stage_bytes<W4>(T) < kMaxStages
             ? (kSmemLimit - kAlignSlack - 256) / stage_bytes<W4>(T)
             : kMaxStages;
}
template <bool W4> __host__ __device__ constexpr int smem_bytes(int T) {
  return stages<W4>(T) * stage_bytes<W4>(T) + kAlignSlack;
}

// The int8 values of byte C of a (low half) and of b (high half) as a bf16 pair,
// exactly: 0x4300 | (v & 0x7f) is the bf16 128 + (v & 127) (its ulp is 1 there),
// 0xC300 ^ (v & 0x80) is -128, or -256 where v is negative, and their sum is v. The
// byte selector (C, C, 4 + C, 4 + C) and the masks and biases k.m7f = 0x007F007F,
// k.m43 = 0x43004300, k.m80 = 0x00800080, k.mc3 = 0xC300C300 are held in registers.
struct Consts {
  uint32_t m7f, m43, m80, mc3;   // int8; int4: m7f = 0x0F0F0F0F, m43 = 0x43 in every byte
  uint32_t sel0, sel1;           // int8: the pair selectors of the slab's two columns;
                                 // int4: the byte selector of its two columns beside 0x43
};
__device__ __forceinline__ uint32_t pair_bf16(uint32_t a, uint32_t b, uint32_t sel,
                                              const Consts& k) {
  const uint32_t p = __byte_perm(a, b, sel);
  uint32_t low, high;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(low) : "r"(p), "r"(k.m7f), "r"(k.m43));
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(high) : "r"(p), "r"(k.m80), "r"(k.mc3));
  return as_u32(__hadd2(as_bf162(low), as_bf162(high)));
}

// The operands of half H of a stage (its pieces 2 H and 2 H + 1) for the consumer's
// slab. int8: wq[4 p + d] is weight row 16 p + 2 tig + (0, 1, 8, 9)[d] of this thread's
// four columns; register 0 of piece p is its first column at rows 2 tig, 2 tig + 1
// (row gid), register 1 its second (row gid + 8), registers 2, 3 the same at rows
// + 8. int4: wq[q] is packed row tig + 4 q (K rows 2 tig + 8 q, + 1); as
// int4_matmul.cu's unpack: 0x4300 | n is the bf16 128 + n, less 136 is n - 8.
template <bool W4, int H>
__device__ __forceinline__ void operands(uint32_t (&a)[2][4], const uint32_t (&wq)[16],
                                         const Consts& k) {
  if constexpr (W4) {
    const __nv_bfloat162 offset = as_bf162(0x43084308u);   // the bf16 pair (136, 136)
#pragma unroll
    for (int q = 4 * H; q < 4 * H + 4; ++q) {
      const uint32_t lo = wq[q] & k.m7f, hi = (wq[q] >> 4) & k.m7f;
      const uint32_t even = as_u32(__hsub2(as_bf162(__byte_perm(lo, k.m43, k.sel0)), offset));
      const uint32_t odd = as_u32(__hsub2(as_bf162(__byte_perm(hi, k.m43, k.sel0)), offset));
      a[(q >> 1) - 2 * H][2 * (q & 1)] = __byte_perm(even, odd, 0x5410u);       // column 0
      a[(q >> 1) - 2 * H][2 * (q & 1) + 1] = __byte_perm(even, odd, 0x7632u);   // column 1
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = 2 * H + i;
      a[i][0] = pair_bf16(wq[4 * p], wq[4 * p + 1], k.sel0, k);
      a[i][1] = pair_bf16(wq[4 * p], wq[4 * p + 1], k.sel1, k);
      a[i][2] = pair_bf16(wq[4 * p + 2], wq[4 * p + 3], k.sel0, k);
      a[i][3] = pair_bf16(wq[4 * p + 2], wq[4 * p + 3], k.sel1, k);
    }
  }
}

// tot += grp * (the row's scale): rows gid (elements 4 j, 4 j + 1) and gid + 8; a
// group's f32 sum by one fused multiply-add, as int4_matmul.cu's
template <int NA>
__device__ __forceinline__ void add_scaled(float (&tot)[NA], const float (&grp)[NA], float s_a,
                                           float s_b) {
#pragma unroll
  for (int e = 0; e < NA; ++e) tot[e] = fmaf(grp[e], (e & 2) ? s_b : s_a, tot[e]);
}

// The block's tiles, one after another: tile t of the grid's (token tiles fastest,
// then column blocks, then K splits) is the block's when t % gridDim.x == blockIdx.x.
struct Tile {
  int m0, n0, kbeg, split, nst;   // first row, first column, first K row, split, its stages
};
__device__ __forceinline__ Tile tile_of(int t, int T, int M, int K, int N, int k_per_split) {
  const int mt = (M + T - 1) / T, nt = (N + kBN - 1) / kBN;
  Tile r;
  r.m0 = (t % mt) * T;
  r.n0 = ((t / mt) % nt) * kBN;
  r.split = t / (mt * nt);
  r.kbeg = r.split * k_per_split;
  r.nst = max(0, min(K, r.kbeg + k_per_split) - r.kbeg) / kKS;
  return r;
}

// W4: int4 weights (w packed, scale bf16 [K/G, N]); else int8 (scale f32 [N])
template <bool W4, int T>
__device__ __forceinline__ void ws_body(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                                        const void* __restrict__ scale, bf16* __restrict__ y,
                                        float* __restrict__ ws, int M, int K, int N, int G,
                                        int k_per_split, int splits, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty) {
  constexpr int kStages = stages<W4>(T), kStage = stage_bytes<W4>(T);
  constexpr int kRawOff = T * 128, kRow = Raw<W4>::kRow, NA = T / 2;
  static_assert(kStages >= 3, "a slot read by the products, one landing, one in flight");
  unsigned char* ring = align_tiles(smem);
  const uint32_t ring_a = smem_addr(ring);
  const int n_tiles = ((M + T - 1) / T) * ((N + kBN - 1) / kBN) * splits;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kWgThreads);        // every producer thread's copies landed
      mbar_init(&empty[s], 2 * kWgThreads);   // every consumer thread, its products done
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ---- the producer: fills each free slot, its copies arrive when they land; the
    // ring runs on from one tile into the next (g counts the block's stages)
    regs_down<kProducerRegs>();
    const int tid = threadIdx.x;
    // its 16-byte chunks of the x tile: chunk tid % 8 of rows tid / 8 + 16 r (the
    // swizzle, r & 7 of the row, is the same in every pass), pointers stepped pass by
    // pass so that no pass keeps an address of its own; of the raw rows: row idx / 8,
    // columns 16 (idx % 8) ..
    constexpr int kPasses = T / 16, kChunks = W4 ? 2 : 4;
    const int xr = tid >> 3, xc = tid & 7;
    const uint32_t xdst = xr * 128 + ((xc ^ (xr & 7)) << 4);
    const size_t wstep = static_cast<size_t>(W4 ? kKS / 2 : kKS) * N;   // bytes of W a stage
    int g = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, T, M, K, N, k_per_split);
      const bf16* xsrc = x + static_cast<size_t>(tl.m0 + xr) * K + tl.kbeg + xc * 8;
      const int x_rows = M - tl.m0 - xr;   // passes r with 16 r < x_rows have a row
      const uint8_t* wsrc[kChunks];
      uint32_t wdst[kChunks];
      bool wok[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int idx = tid + c * kWgThreads, row = idx >> 3, col = tl.n0 + (idx & 7) * 16;
        wok[c] = col < N;
        wsrc[c] = w + static_cast<size_t>((W4 ? tl.kbeg / 2 : tl.kbeg) + row) * N +
                  (wok[c] ? col : 0);
        wdst[c] = kRawOff + row * kRow + (idx & 7) * 16;
      }
      const bool sok = W4 && tid < 16 && tl.n0 + tid * 8 < N;
      const bf16* ssrc = static_cast<const bf16*>(scale) + (sok ? tl.n0 + tid * 8 : 0);
      for (int i = 0; i < tl.nst; ++i, ++g) {
        const int slot = g % kStages;
        if (g >= kStages) mbar_wait(&empty[slot], ((g / kStages) - 1) & 1);   // g - kStages done
        const uint32_t st = ring_a + slot * kStage;
        const bf16* xp = xsrc + i * kKS;
#pragma unroll
        for (int r = 0; r < kPasses; ++r) {
          const bool ok = 16 * r < x_rows;
          cp_async16(st + xdst + r * 16 * 128, ok ? xp : x, ok);
          xp += 16 * static_cast<size_t>(K);
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) cp_async16(st + wdst[c], wsrc[c] + i * wstep, wok[c]);
        if (W4 && tid < 16)
          cp_async16(st + kRawOff + Raw<W4>::kScales + tid * 16,
                     ssrc + static_cast<size_t>((tl.kbeg + i * kKS) / G) * N, sok);
        cp_async_arrive(&full[slot]);
      }
    }
    return;
  }

  // ---- the consumers: consumer c converts slab c (columns 4 (8 w + gid) + 2 c, + 1)
  regs_up<kConsumerRegs>();
  const int c = threadIdx.x / kWgThreads - 1;
  const int tid = threadIdx.x - (c + 1) * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int col2 = 4 * (8 * warp + gid) + 2 * c;   // this thread's two columns in a block's 128
  // int8: weight row 2 tig of a stage at this thread's four columns (its words: rows
  // 16 p + 2 tig + (0, 1, 8, 9)); int4: packed row tig (its words: rows tig + 4 q)
  const int w_off = kRawOff + (W4 ? 1 : 2) * tig * kRow + (8 * warp + gid) * 4;
  Consts k;
  if constexpr (W4) {
    k = Consts{pinned(0x0F0F0F0Fu), bias_bytes(), 0u, 0u, pinned(c ? 0x4342u : 0x4140u), 0u};
  } else {
    const uint32_t c0 = 2 * c, c1 = 2 * c + 1;
    k = Consts{pinned(0x007F007Fu), pinned(0x43004300u), pinned(0x00800080u), pinned(0xC300C300u),
               pinned(c0 | (c0 << 4) | ((4 + c0) << 8) | ((4 + c0) << 12)),
               pinned(c1 | (c1 << 4) | ((4 + c1) << 8) | ((4 + c1) << 12))};
  }

  float acc[NA];   // int8: the sum over the tile's K; int4: the running group's
  float tot[W4 ? NA : 1];   // int4: the total over the groups
  uint32_t a0[2][4], a1[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) a0[p][e] = a1[p][e] = 0u;

  // One stage, g-th of the block (first: it opens a tile or an int4 group, whose
  // sums start anew, and the stage before it was released already; known when
  // compiled). The assembler follows which products are in flight only so far:
  // operand registers and descriptors are pinned before the first product of a
  // batch, the scale-d flags are constants, no wait is conditional and no
  // accumulator is read while a product may be in flight. Otherwise it makes every
  // product wait for the one before it.
  auto stage = [&](int g, auto first) {
    constexpr int kAcc = decltype(first)::value ? 0 : 1;
    const int slot = g % kStages;
    mbar_wait(&full[slot], (g / kStages) & 1);
    fence_async_shared();   // the landed x tile, for the products
    const unsigned char* st = ring + slot * kStage + w_off;
    uint32_t wq[16];
#pragma unroll
    for (int q = 0; q < (W4 ? 8 : 16); ++q)
      wq[q] = lds32(st + (W4 ? 4 * q : 16 * (q >> 2) + (q & 1) + 8 * ((q >> 1) & 1)) * kRow);
    uint64_t xd[4];
    wg_desc_pieces(xd, ring_a + slot * kStage);
    keep(a0);
    operands<W4, 0>(a0, wq, k);
    keep(a0);
    wg_fence();
    wgmma_rs<T>(acc, a0[0], xd[0], kAcc);
    wgmma_rs<T>(acc, a0[1], xd[1], 1);
    wg_commit();
    wg_wait<1>();   // the stage before: its second half is done, a1 is free
    if constexpr (!decltype(first)::value) mbar_arrive(&empty[(g - 1) % kStages]);
    keep(a1);
    operands<W4, 1>(a1, wq, k);
    keep(a1);
    wg_fence();
    wgmma_rs<T>(acc, a1[0], xd[2], 1);
    wgmma_rs<T>(acc, a1[1], xd[3], 1);
    wg_commit();
    wg_wait<1>();   // this stage's first half is done: a0 is free
  };
  int g = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, T, M, K, N, k_per_split);
    // no product is in flight here: the sums start anew
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < (W4 ? NA : 1); ++e) tot[e] = 0.f;
    if constexpr (!W4) {
      if (tl.nst > 0) {
        stage(g, std::true_type{});
        for (int j = 1; j < tl.nst; ++j) stage(g + j, std::false_type{});
        g += tl.nst;
        wg_wait<0>();
        keep(acc);
        mbar_arrive(&empty[(g - 1) % kStages]);
      }
    } else {
      const int gs = G / kKS;   // stages a group
      const int s_off = Raw<W4>::kScales + col2 * 2;
      for (int i = 0; i < tl.nst; i += gs) {
        stage(g, std::true_type{});
        for (int j = 1; j < gs; ++j) stage(g + j, std::false_type{});
        g += gs;
        const int last = (g - 1) % kStages;
        wg_wait<0>();
        keep(acc);
        keep(a0);
        keep(a1);
        // the group's scales of this thread's two columns, bf16 -> f32, and its sums
        // into the totals; the other consumer has the tensor cores meanwhile
        const uint32_t sc = lds32(ring + last * kStage + kRawOff + s_off);
        add_scaled(tot, acc, __uint_as_float(sc << 16), __uint_as_float(sc & 0xffff0000u));
        mbar_arrive(&empty[last]);
      }
    }

    // token 8 j + 2 tig + b: this thread's two columns side by side, while the producer
    // fills the next tile's stages
    const int n2 = tl.n0 + col2;
    if (n2 >= N) continue;
    float2 sc = make_float2(1.f, 1.f);
    if (!W4 && splits == 1)
      sc = *reinterpret_cast<const float2*>(static_cast<const float*>(scale) + n2);
    auto store = [&](const float (&s)[NA]) {
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int m = tl.m0 + 8 * j + 2 * tig + b;
          if (m >= M) continue;
          const float v0 = s[4 * j + b], v1 = s[4 * j + 2 + b];
          if (splits == 1)
            *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(m) * N + n2) =
                __floats2bfloat162_rn(v0 * sc.x, v1 * sc.y);
          else
            *reinterpret_cast<float2*>(ws + (static_cast<size_t>(tl.split) * M + m) * N + n2) =
                make_float2(v0, v1);
        }
    };
    if constexpr (W4)
      store(tot);
    else
      store(acc);
  }
}

// the two kernels by name (the profiler's tables, phase 1's ptxas report)
template <int T>
__global__ void __launch_bounds__(kThreads, 1)
int8_mm_ws_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ scale, bf16* __restrict__ y, float* __restrict__ ws,
                  int M, int K, int N, int k_per_split, int splits) {
  extern __shared__ __align__(128) unsigned char smem_w8ws[];
  __shared__ uint64_t bars[2 * kMaxStages];
  ws_body<false, T>(x, w, scale, y, ws, M, K, N, kKS, k_per_split, splits, smem_w8ws, bars,
                    bars + kMaxStages);
}
template <int T>
__global__ void __launch_bounds__(kThreads, 1)
int4_mm_ws_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                  const bf16* __restrict__ scale4, bf16* __restrict__ y, float* __restrict__ ws,
                  int M, int K, int N, int G, int k_per_split, int splits) {
  extern __shared__ __align__(128) unsigned char smem_w4ws[];
  __shared__ uint64_t bars[2 * kMaxStages];
  ws_body<true, T>(x, w, scale4, y, ws, M, K, N, G, k_per_split, splits, smem_w4ws, bars,
                   bars + kMaxStages);
}

template <bool W4, int T>
cudaError_t launch_tile(const bf16* x, const uint8_t* w, const void* scale, bf16* y, float* ws,
                        int M, int K, int N, int G, int splits, int sms, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<W4>(T);
  // whole stages (int8) or whole groups (int4) a split; a split past K writes zeros
  const int unit = W4 ? G : kKS;
  const int kps = ((K / unit + splits - 1) / splits) * unit;
  // one block an SM, each walking its tiles
  const int tiles = ((M + T - 1) / T) * ((N + kBN - 1) / kBN) * splits;
  const dim3 grid(tiles < sms ? tiles : sms);
  cudaError_t err;
  if constexpr (W4) {
    err = allow_smem(int4_mm_ws_kernel<T>, kSmem);
    if (err != cudaSuccess) return err;
    int4_mm_ws_kernel<T><<<grid, kThreads, kSmem, st>>>(
        x, w, static_cast<const bf16*>(scale), y, ws, M, K, N, G, kps, splits);
  } else {
    err = allow_smem(int8_mm_ws_kernel<T>, kSmem);
    if (err != cudaSuccess) return err;
    int8_mm_ws_kernel<T><<<grid, kThreads, kSmem, st>>>(
        x, w, static_cast<const float*>(scale), y, ws, M, K, N, kps, splits);
  }
  return cudaGetLastError();
}

// token tiles: int8 multiples of 16 from 96 to 256 (T / 2 accumulator registers),
// int4 from 64 to 160 (T: the group's sums and the totals)
#define AHA_WS8_TILES(X) \
  X(96) X(112) X(128) X(144) X(160) X(176) X(192) X(208) X(224) X(240) X(256)
#define AHA_WS4_TILES(X) X(64) X(80) X(96) X(112) X(128) X(144) X(160)

}  // namespace

// x [M, K] bf16 @ W -> y [M, N] bf16: bits 8 (w int8 [K, N], scale f32 [N]) or 4 (w
// packed int4 [K/2, N], scale bf16 [K/G, N], G % 64 == 0); K % 64 == 0, N % 16 == 0,
// x, w and scale 16-byte aligned; tile: the block's token rows; splits: K splits of
// whole stages (groups), summed by splitk_reduce from a workspace [splits, M, N] f32.
// The wrapper's plan checks.
extern "C" int aha_quant_matmul_ws(const void* x, const void* w, const void* scale, void* y,
                                   void* workspace, int M, int K, int N, int G, int bits,
                                   int splits, int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w4 = bits == 4;
  if (M <= 0 || N <= 0 || K <= 0 || K % kKS != 0 || N % 16 != 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && workspace == nullptr) || (bits != 4 && bits != 8) ||
      (w4 && (G <= 0 || G % kKS != 0 || K % G != 0)) || (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the SMs of the current device, asked once a device
  static int sms_of[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0 &&
      cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int sms = sms_of[dev];
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  bf16* yp = static_cast<bf16*>(y);
  float* wsf = static_cast<float*>(workspace);
  cudaError_t err = cudaErrorInvalidValue;
#define AHA_TILE4(T) \
  case T: err = launch_tile<true, T>(xp, wp, scale, yp, wsf, M, K, N, G, splits, sms, st); break;
#define AHA_TILE8(T) \
  case T: err = launch_tile<false, T>(xp, wp, scale, yp, wsf, M, K, N, G, splits, sms, st); break;
  if (w4) {
    switch (tile) { AHA_WS4_TILES(AHA_TILE4) default: break; }
  } else {
    switch (tile) { AHA_WS8_TILES(AHA_TILE8) default: break; }
  }
#undef AHA_TILE4
#undef AHA_TILE8
  if (err == cudaSuccess && splits > 1)
    err = launch_splitk_reduce<bf16>(wsf, w4 ? nullptr : static_cast<const float*>(scale),
                                     nullptr, yp, M, N, splits, st);
  return static_cast<int>(err);
}

// bytes of dynamic shared memory the kernel asks for at token tile `tile` with bits 8
// or 4 (-1: no such tile); the wrapper's plan computes the same number
extern "C" int aha_quant_matmul_ws_smem(int bits, int tile) {
#define AHA_TILE(T) \
  case T: return bits == 4 ? smem_bytes<true>(T) : smem_bytes<false>(T);
  if (bits == 4) {
    switch (tile) { AHA_WS4_TILES(AHA_TILE) default: return -1; }
  }
  if (bits != 8) return -1;
  switch (tile) { AHA_WS8_TILES(AHA_TILE) default: return -1; }
#undef AHA_TILE
}
