// y[M, N] = sum over groups g of (x[M, g] @ W4[g, N]) * scale4[g, N]
//
// W4 is packed int4: byte (j, n) of q4value [K/2, N] holds row 2j of column n
// in its low nibble and row 2j + 1 in its high nibble, each value offset by 8
// (stored 0..15 for -8..7). scale4 [K/G, N] is bf16, one scale per group of G
// consecutive rows and output column; it multiplies the f32 partial sum of its
// group, the groups are added in f32, and the result is cast once. With int8
// activations (a8: xq [M, K] and per-row scales sx [M] from
// csrc/quantize_rows.cu) a group's sum is exact int32, converted to f32 before
// its scale, and the finished sum is multiplied by sx.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/fused_matmul.py::int4_matmul
// (_kernel_int4, both a8 values): every decoder projection, the projector and
// the lm_head of the --int4 config. That kernel is handed x split into even
// and odd columns, prepared outside, because interleaving rows is costly
// there; here a thread reads x[2j], x[2j + 1] next to byte j and the split is
// never materialised.
//
// What bounds it on an H100: bytes for a generated token (M = 1) and a verify
// pass (4 .. 13 rows): the K*N/2 weight bytes (+ 2*(K/G)*N of scales) are the
// traffic, each packed byte is read from device memory once and its two
// nibbles are unpacked in registers. From a frame chunk's 49 rows on, and
// clearly at a fused pass's 196 and a training sequence's 926, operations: 2*M*K*N
// against the tensor cores' 989 TFLOP/s, so the products belong on wgmma and
// what is left beside them (unpacking a [128 x 64] piece of W per 64 rows of K,
// the copies, the group scales) decides the time. Four paths, chosen by the
// wrapper's plan() from the operands:
//   * decode (bf16 x, weight-only, 1 <= M <= 16, G % 64 == 0, N % 16 == 0,
//     16-byte aligned operands): section "decode rows" below. One kernel and
//     one launch plan for every M up to 16, mma.sync per warp with x as the
//     16-row A operand, the packed bytes through a cp.async ring of seven
//     slots, 16 warps an SM. A 7B layer's four products at M = 1 .. 16 take
//     0.07-0.08 ms where the CUDA-core kernel below took 0.17 (M = 1) and the
//     mma.sync kernel 0.35 (M = 4 .. 13), the lm_head 0.11 ms where they took
//     0.24 and 0.59 (NVIDIA H100 80GB HBM3, 700 W; bounds 0.036 and 0.084 ms,
//     bytes).
//   * wgmma (as decode, M >= 17): section "tensor-core path, wgmma" below. The
//     product is turned round (y^T = W^T x^T), the unpacked weight is the
//     register operand of the warpgroup products and never touches shared
//     memory, raw bytes, x tiles and scales arrive by cp.async through a
//     six-slot ring, two accumulator sets (a group's sum, the total) of f32. At
//     M = 926 a decoder layer's four products take 1.23 ms where the mma.sync
//     kernel below took 4.34 (NVIDIA H100 80GB HBM3, 700 W; bound 0.44 ms).
//   * mma.sync (M > 1, G % 32 == 0, N % 8 == 0; int8 x whatever the output
//     type, and bf16 x where neither path above applies): the 64 x 128 tile
//     scheme of common.cuh, one buffer a tile, no copy overlaps a product. A
//     packed byte is exactly the (k, k + 1) pair of one column, i.e. one
//     32-bit bf16x2 word of the transposed weight tile (int8 activations:
//     two bytes make one word of four int8). Values -8..7 are exact in
//     bf16. A warp keeps two accumulator sets: the running group's (f32 or
//     int32) and the total (f32); at a group's last K step the first is
//     scaled into the second.
//   * CUDA cores (M = 1 off the decode path, f32 x, ragged shapes): a block covers 128 columns;
//     each of its 256 threads owns 16 contiguous columns (one 16-byte load
//     = 16 columns x 2 rows) and one of 32 lanes along K. The lanes are 4
//     group slots x 8 row lanes: a thread walks whole groups, so that it
//     applies each group's scale once to its own partial sum.
// When the grid would leave SMs idle, K is split over the grid (whole groups on
// the CUDA-core, decode and wgmma paths, 32-row steps on the mma.sync path; a group cut
// by a split boundary is scaled on both sides, which is the same sum): each
// split writes an f32 partial and splitk_reduce adds them in a fixed order.
#include <type_traits>

#include "wgmma.cuh"

namespace {

// ---- CUDA-core path ---------------------------------------------------------

constexpr int kCols = 16;                  // columns per thread (one 16B load)
constexpr int kColGroups = 8;              // threads along N
constexpr int kBN = kCols * kColGroups;    // 128 columns per block
constexpr int kKLanes = 32;                // threads along K
constexpr int kRowLanes = 8;               // lanes sharing one group
constexpr int kSlots = kKLanes / kRowLanes;   // groups in flight per block

template <typename X> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

// A stored nibble n (0..15) as its value n - 8 in the accumulator's type. The
// f32 form avoids the quarter-rate int -> float conversion: 0x4B000000 | n is
// the float 2^23 + n, and subtracting 2^23 + 8 is exact.
template <typename Acc> __device__ __forceinline__ Acc nibble_value(uint32_t n);
template <> __device__ __forceinline__ float nibble_value<float>(uint32_t n) {
  return __uint_as_float(0x4B000000u | n) - 8388616.0f;
}
template <> __device__ __forceinline__ int nibble_value<int>(uint32_t n) {
  return static_cast<int>(n) - 8;
}

// A packed byte b as the bf16 pair (low nibble - 8, high nibble - 8): 0x4300 | n
// is the bf16 128 + n (its ulp is 1 there), and subtracting 136 is exact.
__device__ __forceinline__ __nv_bfloat162 nibbles_bf162(uint32_t b) {
  const uint32_t biased = 0x43004300u | (b & 0xFu) | ((b >> 4) << 16);
  const uint32_t offset = 0x43084308u;
  return __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                 *reinterpret_cast<const __nv_bfloat162*>(&offset));
}

template <typename X, typename Y, int BM>
__global__ void __launch_bounds__(kColGroups * kKLanes)
int4_mm_kernel(const X* __restrict__ x, const float* __restrict__ sx,
               const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ scale4,
               Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N, int G,
               int groups_per_split, int splits, int vec) {
  using Acc = typename AccOf<X>::type;
  const int cg = threadIdx.x;               // column group
  const int kl = threadIdx.y;               // K lane
  const int slot = kl / kRowLanes, rl = kl % kRowLanes;
  const int n0 = blockIdx.x * kBN + cg * kCols;
  const int m0 = blockIdx.y * BM;
  const int Gh = G / 2;                     // packed rows per group
  const int gbeg = blockIdx.z * groups_per_split;
  const int gend = min(K / G, gbeg + groups_per_split);

  float tot[BM][kCols];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) tot[r][c] = 0.f;

  const bool full = vec && (n0 + kCols <= N);
  for (int g = gbeg + slot; g < gend; g += kSlots) {
    Acc grp[BM][kCols];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) grp[r][c] = 0;

#pragma unroll 2
    for (int j = g * Gh + rl; j < (g + 1) * Gh; j += kRowLanes) {
      Acc lo[kCols], hi[kCols];
      const uint8_t* wrow = w + static_cast<size_t>(j) * N + n0;
      if (full) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(wrow));
        const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t b = (word[c >> 2] >> (8 * (c & 3))) & 0xffu;
          lo[c] = nibble_value<Acc>(b & 0xFu);
          hi[c] = nibble_value<Acc>(b >> 4);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t b = (n0 + c < N) ? wrow[c] : 0x88u;   // 0x88: both nibbles zero
          lo[c] = nibble_value<Acc>(b & 0xFu);
          hi[c] = nibble_value<Acc>(b >> 4);
        }
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        Acc x0 = 0, x1 = 0;
        if (m0 + r < M) load2(x + static_cast<size_t>(m0 + r) * K + 2 * j, x0, x1);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          grp[r][c] = mad(x1, hi[c], mad(x0, lo[c], grp[r][c]));
      }
    }
    // the group's scale, once, on this thread's share of the group's sum
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float s =
          (n0 + c < N) ? __bfloat162float(scale4[static_cast<size_t>(g) * N + n0 + c]) : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) tot[r][c] += static_cast<float>(grp[r][c]) * s;
    }
  }

  // sum the 32 K lanes through shared memory, one row at a time
  __shared__ float red[kKLanes][kBN + 4];
  const int t = kl * kColGroups + cg;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[kl][cg * kCols + c] = tot[r][c];
    __syncthreads();
    if (t < kBN) {
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < kKLanes; ++l) s += red[l][t];
      const int row = m0 + r, col = blockIdx.x * kBN + t;
      if (row < M && col < N) {
        if (splits == 1) {
          if (sx != nullptr) s *= sx[row];
          y[static_cast<size_t>(row) * N + col] = from_f32<Y>(s);
        } else {
          ws[(static_cast<size_t>(blockIdx.z) * M + row) * N + col] = s;
        }
      }
    }
    __syncthreads();
  }
}

// ---- tensor-core path, mma.sync ------------------------------------------------------

// A8 = false: x bf16, group sums in f32. A8 = true: x int8 (+ sx), group sums
// in int32.
template <bool A8, typename Y>
__global__ void __launch_bounds__(128)
int4_mm_tc_kernel(const void* __restrict__ x, const float* __restrict__ sx,
                  const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ scale4,
                  Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N, int G,
                  int k_per_split, int splits) {
  using Acc = typename std::conditional<A8, int, float>::type;
  constexpr int RB = TileRow<A8>::kBytes;
  __shared__ __align__(16) unsigned char xs[kTM * RB];
  __shared__ __align__(16) unsigned char wt[kTN * RB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;   // the warp's 32 x 64 sub-tile

  float tot[2][8][4];
  Acc grp[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[mi][ni][e] = 0.f;
        grp[mi][ni][e] = 0;
      }

  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    stage_x_tile<A8>(xs, x, m0, M, K, k0, tid);
    const uint8_t* wp = w + static_cast<size_t>(k0 / 2) * N;   // 16 packed rows of this step
    if constexpr (A8) {
      // 8 pairs of packed rows (four K values) x 16 groups of 8 columns, one
      // item per thread; a column's four values become one word of wt[n][k]
      const int kq = tid & 7, ng = (tid >> 3) * 8, n = n0 + ng;
      uint2 p0 = make_uint2(0u, 0u), p1 = make_uint2(0u, 0u);
      if (n < N) {   // N % 8 == 0: a group of columns is all in or all out
        p0 = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(2 * kq) * N + n));
        p1 = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(2 * kq + 1) * N + n));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t a = byte_of(p0, j), b = byte_of(p1, j);
        // (nibble - 8) as int8: 0..15 -> 0xF8..0x07
        const uint32_t word = (((a & 0xFu) - 8u) & 0xffu) | ((((a >> 4) - 8u) & 0xffu) << 8) |
                              ((((b & 0xFu) - 8u) & 0xffu) << 16) |
                              ((((b >> 4) - 8u) & 0xffu) << 24);
        *reinterpret_cast<uint32_t*>(wt + (ng + j) * RB + kq * 4) = word;
      }
    } else {
      // 16 packed rows x 16 groups of 8 columns, two items per thread; a
      // packed byte is the (k, k + 1) bf16 pair of its column
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int c = tid + it * 128;
        const int kp = c & 15, ng = (c >> 4) * 8, n = n0 + ng;
        uint2 p = make_uint2(0u, 0u);
        if (n < N) p = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(kp) * N + n));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(wt + (ng + j) * RB + kp * 4) =
              nibbles_bf162(byte_of(p, j));
        }
      }
    }
    __syncthreads();
    mma_tile<A8>(grp, xs, wt, wm, wn, gid, tig);
    __syncthreads();

    const int knext = k0 + kTK;
    if (knext % G == 0 || knext >= kend) {
      // last step of a group (or of this split's share of it): scale the
      // group's sum into the total
      const __nv_bfloat16* srow = scale4 + static_cast<size_t>(k0 / G) * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn + ni * 8 + tig * 2;
        float s0 = 0.f, s1 = 0.f;
        if (col < N) {   // col even, N % 8 == 0: col + 1 < N too
          s0 = __bfloat162float(srow[col]);
          s1 = __bfloat162float(srow[col + 1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          tot[mi][ni][0] += static_cast<float>(grp[mi][ni][0]) * s0;
          tot[mi][ni][1] += static_cast<float>(grp[mi][ni][1]) * s1;
          tot[mi][ni][2] += static_cast<float>(grp[mi][ni][2]) * s0;
          tot[mi][ni][3] += static_cast<float>(grp[mi][ni][3]) * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) grp[mi][ni][e] = 0;
        }
      }
    }
  }
  store_tile<Y>(tot, y, ws, nullptr, sx, M, N, m0, n0, wm, wn, gid, tig, splits, blockIdx.z);
}

// ---- tensor-core path, wgmma (bf16 x, weight-only, G % 64 == 0, N % 16 == 0) ------------------
//
// The product turned round: y^T = W^T x^T. The 64-row side of a warpgroup
// product runs over weight columns, its register operand is a [64 columns x
// 16 rows] piece of W^T, and its width is the token tile. A packed byte is the
// (2 j, 2 j + 1) bf16 pair of its column, i.e. one register of that operand, so
// the dequantised weight never exists in memory of any kind: the raw bytes
// travel device memory -> ring -> registers. The group scale belongs to an
// accumulator ROW here, two scales a thread and slab.
//
// A block is one warpgroup that owns 128 weight columns (two slabs of 64) and a
// token tile of TM <= 80 rows, and walks K in stages of 64 through a ring of
// kStages slots filled by cp.async, four stages ahead. A stage holds the x
// tile (TM rows of 128 bytes, swizzled, the B operand as it lies), the packed
// bytes (32 packed rows of 128 columns, 160 bytes apart so that the four rows a
// warp reads at once fall in distinct banks) and the group's 128 scales, all in
// 16-byte copies (4-byte copies of a thread's own words cost a quarter of the
// kernel's time). The thread whose accumulator rows are gid and gid + 8 of warp
// w owns the four neighbouring columns 4 (8 w + gid) .. + 3 (rows gid and gid + 8
// of slab 0, then of slab 1: the accumulator rows are relabelled, no data is
// shuffled): a 32-bit word of a packed row is its share of that row, the packed
// rows tig + 4 q are what its operand registers need, and y leaves as 8-byte
// stores of those four columns.
//
// The two slabs alternate: while the tensor cores run one slab's four products
// of a stage, the threads unpack the other's operand. After a group's last
// stage the block waits for its products and adds both slabs' group sums (f32)
// times their scales into the totals (f32); a group's first product starts its
// sum anew (scale-d). Two blocks share an SM and fill each other's gaps. A K
// split covers whole groups and writes its f32 totals as a partial.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, M = 926, 300-375 TFLOP/s): not
// the tensor cores (about a third of their rate). Builds with parts switched
// off: no unpacking 3%, no wait at a group's end 5%, half the x tile's bytes 5%,
// no weight and scale copies 24% while those were 4-byte copies (16-byte ones
// took 10% off). What is left is the chain of a stage on one warpgroup, some
// 300 instructions, many on the half-rate integer pipe. Tried and dropped: a
// scale pass per slab beside the other slab's products (the assembler then makes
// every product wait for the one before it, see stage()); three blocks an SM at
// 56 rows (slower by a third).
namespace w4 {

using namespace wg;

constexpr int kSlabs = 2;             // 64-column slabs of the weight per block
constexpr int kBN = 64 * kSlabs;      // weight columns per block
constexpr int kKS = 64;               // contraction depth of a stage
constexpr int kStages = 6;            // ring slots; kStages - 2 stages are in flight
constexpr int kWRow = 160;            // bytes from one packed row of a stage to the next
constexpr int kWBytes = (kKS / 2) * kWRow;
constexpr int kSBytes = kBN * 2;      // the group's scales of the block's columns

// tiles start on 1024 bytes
__host__ __device__ constexpr int stage_bytes(int TM) {
  return TM * 128 + (kWBytes + kSBytes + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int smem_bytes(int TM) { return kStages * stage_bytes(TM) + kAlignSlack; }

// the [64 x 16] operands of a stage's four products for slab SLAB, from this
// thread's eight words (word q: packed row tig + 4 q of its four columns, the
// slab's two in bytes 2 SLAB and 2 SLAB + 1). 0x4300 | n is the bf16 128 + n
// (its ulp is 1 there), and subtracting 136 is exact: byte permutes put the low
// and the high nibbles of the two columns beside 0x43, one subtraction makes
// each a pair of values, two more permutes sort them by column.
template <int SLAB>
__device__ __forceinline__ void unpack(uint32_t (&a)[4][4], const uint32_t (&wq)[8],
                                       uint32_t bias) {
  const __nv_bfloat162 offset = as_bf162(0x43084308u);   // the bf16 pair (136, 136)
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t lo = wq[q] & 0x0F0F0F0Fu, hi = (wq[q] >> 4) & 0x0F0F0F0Fu;
    constexpr uint32_t two_columns = SLAB == 0 ? 0x4140u : 0x4342u;
    // rows 2 j (low nibbles) and 2 j + 1 (high nibbles) of the slab's two columns
    const uint32_t even = as_u32(__hsub2(as_bf162(__byte_perm(lo, bias, two_columns)), offset));
    const uint32_t odd = as_u32(__hsub2(as_bf162(__byte_perm(hi, bias, two_columns)), offset));
    a[q >> 1][2 * (q & 1)] = __byte_perm(even, odd, 0x5410u);       // column 0: rows 2 j, 2 j + 1
    a[q >> 1][2 * (q & 1) + 1] = __byte_perm(even, odd, 0x7632u);   // column 1
  }
}
// tot += grp * (the row's scale): rows gid (elements 4 j, 4 j + 1) and gid + 8
template <int NA>
__device__ __forceinline__ void add_scaled(float (&tot)[NA], const float (&grp)[NA], float s_a,
                                           float s_b) {
#pragma unroll
  for (int e = 0; e < NA; ++e) tot[e] = fmaf(grp[e], (e & 2) ? s_b : s_a, tot[e]);
}

template <int TM>
__global__ void __launch_bounds__(kWgThreads, 2)
int4_mm_wgmma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                     const bf16* __restrict__ scale4, bf16* __restrict__ y,
                     float* __restrict__ ws, int M, int K, int N, int G, int k_per_split,
                     int splits) {
  constexpr int kStage = stage_bytes(TM), NA = TM / 2;
  extern __shared__ __align__(128) unsigned char smem_w4[];
  unsigned char* ring = align_tiles(smem_w4);
  const uint32_t ring_a = smem_addr(ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int nst = max(0, min(K, kbeg + k_per_split) - kbeg) / kKS;   // whole groups a split
  const int gs = G / kKS;                                            // stages per group

  // this thread's four weight columns (N % 16 == 0: all four exist, or none)
  const int n4 = n0 + 4 * (8 * warp + gid);
  const bool n_ok = n4 < N;
  // its share of a stage's copies: rows of the x tile, two 16-byte chunks of the
  // packed bytes (row idx / 8, columns 16 (idx % 8) ..), and for 16 threads 8 scales
  const RowsCopy<TM> copy_x(static_cast<size_t>(K));
  const bf16* xsrc = x + static_cast<size_t>(m0) * K + kbeg;
  constexpr int kWOff = TM * 128, kSOff = kWOff + kWBytes;
  const uint8_t* wsrc[2];
  uint32_t wdst[2];
  bool wok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * kWgThreads, row = idx >> 3, col = n0 + (idx & 7) * 16;
    wok[c] = col < N;
    wsrc[c] = w + static_cast<size_t>(kbeg / 2 + row) * N + (wok[c] ? col : 0);
    wdst[c] = kWOff + row * kWRow + (idx & 7) * 16;
  }
  const bool sok = tid < 16 && n0 + tid * 8 < N;
  const bf16* ssrc = scale4 + (sok ? n0 + tid * 8 : 0);
  auto load = [&](int i) {   // stage i of this split into its slot
    const uint32_t st = ring_a + (i % kStages) * kStage;
    copy_x(st, xsrc + i * kKS, M - m0);
    const size_t rows = static_cast<size_t>(i) * (kKS / 2) * N;
#pragma unroll
    for (int c = 0; c < 2; ++c) cp_async16(st + wdst[c], wsrc[c] + rows, wok[c]);
    if (tid < 16)
      cp_async16(st + kSOff + tid * 16, ssrc + static_cast<size_t>((kbeg + i * kKS) / G) * N, sok);
  };
  // the packed rows tig + 4 q of its four columns, and their scales
  const int w_off = kWOff + tig * kWRow + (8 * warp + gid) * 4;
  const int s_off = kSOff + (8 * warp + gid) * 8;

  float tot[kSlabs][NA], grp[kSlabs][NA];
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
#pragma unroll
    for (int e = 0; e < NA; ++e) tot[s][e] = grp[s][e] = 0.f;
  uint32_t a0[4][4], a1[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) a0[p][e] = a1[p][e] = 0u;
  const uint32_t bias = bias_bytes();

#pragma unroll
  for (int i = 0; i < kStages - 2; ++i) {
    if (i < nst) load(i);
    cp_async_commit();
  }
  // One stage; first: it opens a group, whose sums start anew (known when
  // compiled). The assembler follows which products are in flight only so far:
  // whatever defines an input of a product (operand registers, descriptors) is
  // pinned before the first product of its four, and no accumulator is read
  // while a product of an earlier stage may be in flight. Otherwise it makes
  // every product wait for the one before it.
  auto stage = [&](int i, auto first) {
    constexpr int kAccumulate = decltype(first)::value ? 0 : 1;
    cp_async_wait<kStages - 3>();   // stage i has landed
    wg_wait<1>();                   // slab 0 of stage i - 1 is done: a0 is free
    __syncthreads();                // ... and every warp is past stage i - 2
    if (i + kStages - 2 < nst) load(i + kStages - 2);
    cp_async_commit();

    const int slot = i % kStages;
    const unsigned char* st = ring + slot * kStage;
    uint32_t wq[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      wq[q] = *reinterpret_cast<const uint32_t*>(st + w_off + q * 4 * kWRow);
    uint64_t xd[4];
    wg_desc_pieces(xd, ring_a + slot * kStage);
    keep(a0);
    unpack<0>(a0, wq, bias);
    keep(a0);
    wg_fence();
    wgmma_rs<TM>(grp[0], a0[0], xd[0], kAccumulate);
#pragma unroll
    for (int p = 1; p < 4; ++p) wgmma_rs<TM>(grp[0], a0[p], xd[p], 1);
    wg_commit();

    wg_wait<1>();                   // slab 1 of stage i - 1 is done: a1 is free
    keep(a1);
    unpack<1>(a1, wq, bias);
    keep(a1);
    wg_fence();
    wgmma_rs<TM>(grp[1], a1[0], xd[0], kAccumulate);
#pragma unroll
    for (int p = 1; p < 4; ++p) wgmma_rs<TM>(grp[1], a1[p], xd[p], 1);
    wg_commit();
  };
  for (int i = 0; i < nst; i += gs) {
    stage(i, std::true_type{});
    for (int j = 1; j < gs; ++j) stage(i + j, std::false_type{});
    // the group's four scales of this thread's columns (every stage of the group
    // brought them), bf16 -> f32, and its sums into the totals; the block that
    // shares the SM has the tensor cores meanwhile
    const uint2 sc =
        *reinterpret_cast<const uint2*>(ring + ((i + gs - 1) % kStages) * kStage + s_off);
    wg_wait<0>();
    keep(a0);
    keep(a1);
    keep(grp[0]);
    keep(grp[1]);
    add_scaled(tot[0], grp[0], __uint_as_float(sc.x << 16), __uint_as_float(sc.x & 0xffff0000u));
    add_scaled(tot[1], grp[1], __uint_as_float(sc.y << 16), __uint_as_float(sc.y & 0xffff0000u));
  }

  // token 8 j + 2 tig + b: this thread's four columns side by side
  if (!n_ok) return;
#pragma unroll
  for (int j = 0; j < TM / 8; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int m = m0 + 8 * j + 2 * tig + b;
      if (m >= M) continue;
      const float v0 = tot[0][4 * j + b], v1 = tot[0][4 * j + 2 + b];
      const float v2 = tot[1][4 * j + b], v3 = tot[1][4 * j + 2 + b];
      if (splits == 1) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
        *reinterpret_cast<uint2*>(y + static_cast<size_t>(m) * N + n4) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      } else {
        *reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.z) * M + m) * N + n4) =
            make_float4(v0, v1, v2, v3);
      }
    }
}

template <int TM>
cudaError_t launch_tile(const void* x, const uint8_t* w, const bf16* scale4, void* y, float* ws,
                        int M, int K, int N, int G, int splits, cudaStream_t st) {
  cudaError_t err = allow_smem(int4_mm_wgmma_kernel<TM>, smem_bytes(TM));
  if (err != cudaSuccess) return err;
  // whole groups a split; a split past K writes zeros
  const int kps = ((K / G + splits - 1) / splits) * G;
  // token tiles run fastest: the blocks in flight share a few column blocks of W
  const dim3 grid((M + TM - 1) / TM, (N + kBN - 1) / kBN, splits);
  int4_mm_wgmma_kernel<TM><<<grid, kWgThreads, smem_bytes(TM), st>>>(
      static_cast<const bf16*>(x), w, scale4, static_cast<bf16*>(y), ws, M, K, N, G, kps, splits);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const uint8_t* w, const bf16* scale4, void* y, float* ws, int M,
                   int K, int N, int G, int splits, int tile, cudaStream_t st) {
  if (G % kKS != 0 || N % 16 != 0 || (N + kBN - 1) / kBN > 65535) return cudaErrorInvalidValue;
  switch (tile) {   // 14 rows and more: 16 .. 80
#define AHA_TILE(TM) \
  case TM: return launch_tile<TM>(x, w, scale4, y, ws, M, K, N, G, splits, st);
    AHA_TILE(16) AHA_TILE(24) AHA_TILE(32) AHA_TILE(40) AHA_TILE(48) AHA_TILE(56) AHA_TILE(64)
    AHA_TILE(72) AHA_TILE(80)
#undef AHA_TILE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace w4

// ---- decode rows (1 .. 16), bf16 x, weight-only, G % 64 == 0, N % 16 == 0: mma.sync ------------
//
// A token (1 row) and a verify pass (2 .. 16 rows) move K N / 2 weight bytes for
// at most 32 M K N operations: bytes bound them by two orders of magnitude, so
// the design is about weight bytes in flight, with the unpacking cheap and off
// the copies' path. One kernel, one plan and one order of sums for every M from
// 1 to 16: x is the A operand of mma.sync m16n8k16 (16 token rows, those past M
// zero), so a row's output is the same bits whether it goes alone or with 15
// others.
//
// Route: mma.sync per warp rather than wgmma. Four warps a block, each on its
// own 32 weight columns, and four blocks an SM: 16 warps an SM, none of which
// waits on a warpgroup's products, and no accumulator is ever in flight (the
// assembler's serialisation of wgmma, section above, cannot arise).
//
// A block owns 128 weight columns and a K split of whole groups, and walks it in
// stages of 64 rows through a ring of kStages slots filled by cp.async, all but
// one in flight (6 x 4 KB of weight a block, 96 KB an SM). A stage holds the x
// tile (16 rows of 128 bytes, swizzled: ldmatrix reads it without conflicts), the
// packed bytes (32 packed rows of the block's 128 columns, 160 bytes apart, so
// that the four rows a warp reads at once fall in distinct banks) and the group's
// 128 scales, all in 16-byte copies. The thread (gid, tig) of warp w reads the
// 32-bit word of packed rows tig + 4 q at columns 32 w + 4 gid .. + 3: byte t of
// it is the (2 j, 2 j + 1) pair of column 32 w + 4 gid + t, which is its B
// register for column gid of n-tile t (the columns are relabelled, no data is
// shuffled). One byte permute, one logic operation and one bf16x2 subtraction
// make a register (nibble_pair). Its accumulator element (n-tile t, column
// 2 tig + e) is weight column 32 w + 8 tig + 4 e + t: the eight columns
// 32 w + 8 tig .. + 7 of tokens gid and gid + 8 leave as 16-byte stores.
//
// The group sums alternate between two register sets: group g sums into set
// g % 2, and the set of group g - 1 is scaled into the totals (f32) after the
// first stage of group g has issued its products, so no warp waits for a
// group's last product. A K split writes its f32 totals as a partial and
// splitk_reduce adds the splits in a fixed order.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): not the memory but each SM's
// issue of the instructions a warp spends on a stage (one third of them the
// unpacking). With parts switched off, the copies alone came near the memory
// rate, the unpacking and the products alone took longer than the copies, and
// weights that stay in L2 were no faster. Three things helped: the wait for a
// stage carries no proxy fence (mma.sync and ldmatrix read shared memory as
// ordinary loads; the fence compiled to a MEMBAR a stage), the unpacking's mask
// and 0x43 bytes sit in registers (as two immediates the assembler made two
// logic operations of one), and splits that leave every SM about the same work
// (plan). Tried and dropped: 8 warps (256 columns) a block, 2 warps a block,
// fewer ring slots, and the weight unpacked without the subtraction (128 + n,
// with 136 sum x taken off each group by one more product a piece): none faster.
namespace w4d {

using namespace wg;

constexpr int kThreads = 128;                 // four warps, 32 weight columns each
constexpr int kBN = 128;                      // weight columns per block
constexpr int kTM = 16;                       // token rows, the A operand's 16
constexpr int kKS = 64;                       // contraction depth of a stage
constexpr int kStages = 7;                    // ring slots; kStages - 1 stages in flight
constexpr int kBlocksPerSm = 4;               // 16 warps an SM
constexpr int kWRow = kBN + 32;               // bytes from one packed row of a stage to the next
constexpr int kXBytes = kTM * 128;
constexpr int kWBytes = (kKS / 2) * kWRow;
constexpr int kSBytes = kBN * 2;
constexpr int kStage = kXBytes + kWBytes + kSBytes;   // 7424: a multiple of 128
constexpr int kSmem = kStages * kStage;

// the bf16 pair (low nibble - 8, high nibble - 8) of byte T of v (v4 = v >> 4):
// the permute puts byte T of v in byte 0 and byte T of v4 in byte 2, one logic
// operation ((p & mask) | magic, with mask = 0x000F000F and magic = 0x43004300
// held in registers: as two immediates it takes two) keeps their low nibbles
// beside 0x43 (the bf16 128 + n, whose ulp is 1), and subtracting 136 is exact
template <int T>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v, uint32_t v4, uint32_t mask,
                                                uint32_t magic) {
  constexpr uint32_t sel = T | (T << 4) | ((4 + T) << 8) | ((4 + T) << 12);
  uint32_t biased;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(biased)
      : "r"(__byte_perm(v, v4, sel)), "r"(mask), "r"(magic));
  return as_u32(__hsub2(as_bf162(biased), as_bf162(0x43084308u)));
}
// bf16 h (0: the low half, 1: the high half) of a word, as f32
__device__ __forceinline__ float half_f32(uint32_t word, int h) {
  return __uint_as_float(h ? (word & 0xffff0000u) : (word << 16));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
int4_mm_decode_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                      const bf16* __restrict__ scale4, bf16* __restrict__ y,
                      float* __restrict__ ws, int M, int K, int N, int G, int groups_per_split,
                      int splits) {
  extern __shared__ __align__(128) unsigned char smem_w4d[];
  const uint32_t ring_a = smem_addr(smem_w4d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int gs = G / kKS;                                          // stages a group
  const int gbeg = blockIdx.y * groups_per_split;
  const int ng = max(0, min(K / G, gbeg + groups_per_split) - gbeg);   // groups of this split
  const int nst = ng * gs;
  const int kbeg = gbeg * G;

  // this thread's share of a stage's copies, as running sources: one chunk of
  // the x tile (rows past M are zeros), two 16-byte chunks of the packed bytes
  // (row idx / 8, columns 16 (idx % 8) ..), and for 16 threads 8 scales
  const RowsCopy<kTM> copy_x(static_cast<size_t>(K));
  const bf16* xsrc = x + kbeg;
  const uint8_t* wsrc[2];
  uint32_t wdst[2];
  bool wok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * kThreads, row = idx >> 3, col = n0 + (idx & 7) * 16;
    wok[c] = col < N;
    wsrc[c] = w + static_cast<size_t>(kbeg / 2 + row) * N + (wok[c] ? col : 0);
    wdst[c] = kXBytes + row * kWRow + (idx & 7) * 16;
  }
  const size_t wstep = static_cast<size_t>(kKS / 2) * N;
  const bool sok = tid < 16 && n0 + tid * 8 < N;
  const bf16* ssrc = scale4 + static_cast<size_t>(gbeg) * N + (sok ? n0 + tid * 8 : 0);
  int lslot = 0, lstage = 0, lj = 0;   // the next load: its slot, stage and stage of its group
  auto load = [&]() {
    if (lstage < nst) {
      const uint32_t st = ring_a + lslot * kStage;
      copy_x(st, xsrc, M);
#pragma unroll
      for (int c = 0; c < 2; ++c) cp_async16(st + wdst[c], wsrc[c], wok[c]);
      if (tid < 16) cp_async16(st + kXBytes + kWBytes + tid * 16, ssrc, sok);
      xsrc += kKS;
#pragma unroll
      for (int c = 0; c < 2; ++c) wsrc[c] += wstep;
      if (++lj == gs) {
        lj = 0;
        ssrc += N;
      }
    }
    cp_async_commit();
    ++lstage;
    lslot = lslot == kStages - 1 ? 0 : lslot + 1;
  };
  // the packed rows tig + 4 q of its four columns; the scales of its eight output
  // columns; the row of the x tile that this lane names to ldmatrix (matrix
  // lane / 8: token rows 8 (lane / 8 % 2) .., k 8 (lane / 16) .. of a piece)
  const int w_off = kXBytes + tig * kWRow + (32 * warp + 4 * gid);
  const int s_off = kXBytes + kWBytes + (32 * warp + 8 * tig) * 2;
  const int xr = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t x_off[4];   // the piece's 16-byte chunk of that row, swizzled
#pragma unroll
  for (int p = 0; p < 4; ++p) x_off[p] = xr * 128 + (((2 * p + (lane >> 4)) ^ (xr & 7)) << 4);

  float tot[4][4], acc[2][4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[t][e] = acc[0][t][e] = acc[1][t][e] = 0.f;
  uint4 sc = make_uint4(0u, 0u, 0u, 0u);   // the scales of the group whose sums wait in a set
  const uint32_t mask = pinned(0x000F000Fu), magic = pinned(0x43004300u);

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load();
  int slot = 0;   // of the stage being multiplied
  // one stage: its four 16-deep pieces, each one ldmatrix of x and four products
  // (n-tiles 0 .. 3) into set SET; returns the stage's slot
  auto stage = [&](auto set) {
    constexpr int SET = decltype(set)::value;
    copies_landed<kStages - 2>();   // this stage has landed
    __syncthreads();                // ... for every thread, and every warp is past the last one
    load();                         // into the slot the last stage freed
    const unsigned char* st = smem_w4d + slot * kStage;
    const uint32_t sa = ring_a + slot * kStage;
    slot = slot == kStages - 1 ? 0 : slot + 1;
    uint32_t wq[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) wq[q] = lds32(st + w_off + q * 4 * kWRow);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t a[4];
      ldmatrix_x4(a, sa + x_off[p]);
      const uint32_t v0 = wq[2 * p], v1 = wq[2 * p + 1], v04 = v0 >> 4, v14 = v1 >> 4;
      mma_bf16(acc[SET][0], a, nibble_pair<0>(v0, v04, mask, magic),
               nibble_pair<0>(v1, v14, mask, magic));
      mma_bf16(acc[SET][1], a, nibble_pair<1>(v0, v04, mask, magic),
               nibble_pair<1>(v1, v14, mask, magic));
      mma_bf16(acc[SET][2], a, nibble_pair<2>(v0, v04, mask, magic),
               nibble_pair<2>(v1, v14, mask, magic));
      mma_bf16(acc[SET][3], a, nibble_pair<3>(v0, v04, mask, magic),
               nibble_pair<3>(v1, v14, mask, magic));
    }
    return st;
  };
  // the group sums of set SET times their scales into the totals; the set starts anew
  auto flush = [&](auto set) {
    constexpr int SET = decltype(set)::value;
    const uint32_t s[4] = {sc.x, sc.y, sc.z, sc.w};   // columns 8 tig + (0, 1), (2, 3), ..
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float s0 = half_f32(s[t >> 1], t & 1), s1 = half_f32(s[2 + (t >> 1)], t & 1);
      tot[t][0] = fmaf(acc[SET][t][0], s0, tot[t][0]);
      tot[t][1] = fmaf(acc[SET][t][1], s1, tot[t][1]);
      tot[t][2] = fmaf(acc[SET][t][2], s0, tot[t][2]);
      tot[t][3] = fmaf(acc[SET][t][3], s1, tot[t][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[SET][t][e] = 0.f;
    }
  };
  // a group into set SET: after its first stage, the set of the group before is
  // scaled and this group's scales are taken from the slot
  auto group = [&](bool first, auto set) {
    constexpr int SET = decltype(set)::value;
    const unsigned char* st = stage(set);
    if (!first) flush(std::integral_constant<int, 1 - SET>{});
    sc = *reinterpret_cast<const uint4*>(st + s_off);
    for (int j = 1; j < gs; ++j) stage(set);
  };
  for (int g = 0; g < ng; g += 2) {
    group(g == 0, std::integral_constant<int, 0>{});
    if (g + 1 < ng) group(false, std::integral_constant<int, 1>{});
  }
  if (ng & 1) flush(std::integral_constant<int, 0>{});
  else if (ng > 0) flush(std::integral_constant<int, 1>{});

  // tokens gid and gid + 8: this thread's eight columns side by side
  const int nc = n0 + 32 * warp + 8 * tig;
  if (nc >= N) return;   // N % 16 == 0: all eight exist, or none
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = gid + 8 * h;
    if (m >= M) continue;
    float v[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[t] = tot[t][2 * h];
      v[4 + t] = tot[t][2 * h + 1];
    }
    if (splits == 1) {
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = as_u32(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * N + nc) =
          make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      float4* o =
          reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.y) * M + m) * N + nc);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

cudaError_t launch(const void* x, const uint8_t* w, const bf16* scale4, void* y, float* ws, int M,
                   int K, int N, int G, int splits, cudaStream_t st) {
  if (M > kTM || G % kKS != 0 || N % 16 != 0 || splits > 65535) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(int4_mm_decode_kernel, kSmem);
  if (err != cudaSuccess) return err;
  // whole groups a split; a split past K writes zeros
  const int gps = (K / G + splits - 1) / splits;
  const dim3 grid((N + kBN - 1) / kBN, splits);
  int4_mm_decode_kernel<<<grid, kThreads, kSmem, st>>>(static_cast<const bf16*>(x), w, scale4,
                                                       static_cast<bf16*>(y), ws, M, K, N, G, gps,
                                                       splits);
  return cudaGetLastError();
}

}  // namespace w4d

enum Path { kScalar = 0, kVec16 = 1, kTensorCore = 2, kWgmma = 3, kDecode = 4 };

template <typename X, typename Y>
cudaError_t launch(const void* x, const float* sx, const void* w, const void* scale4, void* y,
                   void* ws, int M, int K, int N, int G, int splits, int path,
                   cudaStream_t st) {
  const uint8_t* wq = static_cast<const uint8_t*>(w);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale4);
  Y* yp = static_cast<Y*>(y);
  float* wsf = static_cast<float*>(ws);
  if (path == kTensorCore) {
    // split boundaries on the 32-row K step; a split past K writes zeros
    const int kps = ((K + splits - 1) / splits + kTK - 1) / kTK * kTK;
    const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, splits);
    if constexpr (std::is_same<X, int8_t>::value) {
      int4_mm_tc_kernel<true, Y><<<grid, 128, 0, st>>>(x, sx, wq, sc, yp, wsf, M, K, N, G, kps,
                                                       splits);
    } else if constexpr (std::is_same<X, __nv_bfloat16>::value &&
                         std::is_same<Y, __nv_bfloat16>::value) {
      int4_mm_tc_kernel<false, Y><<<grid, 128, 0, st>>>(x, nullptr, wq, sc, yp, wsf, M, K, N, G,
                                                        kps, splits);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const int groups = K / G;
    const int gps = (groups + splits - 1) / splits;
    const dim3 block(kColGroups, kKLanes);
    const int nb = (N + kBN - 1) / kBN;
    const int vec = path == kVec16;
    const X* xp = static_cast<const X*>(x);
    if (M == 1) {
      int4_mm_kernel<X, Y, 1><<<dim3(nb, 1, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, G, gps, splits, vec);
    } else {
      constexpr int BM = 2;
      int4_mm_kernel<X, Y, BM><<<dim3(nb, (M + BM - 1) / BM, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, G, gps, splits, vec);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_reduce<Y>(wsf, nullptr, sx, yp, M, N, splits, st);
}

}  // namespace

// x: [M, K] of x_dtype (AHA_F32, AHA_BF16, or AHA_I8 with the per-row scales
// sx [M]); y: [M, N] of y_dtype (x's own type unless x is int8). K % G == 0,
// G even. path: 0 scalar CUDA-core loads, 1 16-byte CUDA-core loads
// (N % 16 == 0, 16-byte aligned weight), 2 tensor cores through mma.sync (M > 1,
// G % 32 == 0, N % 8 == 0, x 16-byte and weight 8-byte aligned; bf16 x -> bf16 y,
// or int8 x), 3 tensor cores through wgmma (bf16 x -> bf16 y, G % 64 == 0,
// N % 16 == 0, x, weight and scales 16-byte aligned, tile: the token tile, a
// multiple of 8 from 16 to 80; whole groups a split), 4 the decode rows on
// mma.sync (as 3, M <= 16, tile unused; whole groups a split); the wrapper checks.
extern "C" int aha_int4_matmul(const void* x, const void* sx, const void* w, const void* scale4,
                               void* y, void* workspace, int M, int K, int N, int G,
                               int x_dtype, int y_dtype, int splits, int path, int tile,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 2 != 0 || K % G != 0 || splits < 1 ||
      (splits > 1 && workspace == nullptr) || (x_dtype == AHA_I8) != (sx != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sxf = static_cast<const float*>(sx);
  cudaError_t err = cudaErrorInvalidValue;
  if (path == kWgmma || path == kDecode) {
    if (x_dtype != AHA_BF16 || y_dtype != AHA_BF16) return static_cast<int>(err);
    float* wsf = static_cast<float*>(workspace);
    const uint8_t* wq = static_cast<const uint8_t*>(w);
    const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale4);
    err = path == kWgmma ? w4::launch(x, wq, sc, y, wsf, M, K, N, G, splits, tile, st)
                         : w4d::launch(x, wq, sc, y, wsf, M, K, N, G, splits, st);
    if (err == cudaSuccess && splits > 1)
      err = launch_splitk_reduce<__nv_bfloat16>(wsf, nullptr, nullptr,
                                                static_cast<__nv_bfloat16*>(y), M, N, splits, st);
    return static_cast<int>(err);
  }
  if (x_dtype == AHA_F32 && y_dtype == AHA_F32 && path != kTensorCore)
    err = launch<float, float>(x, sxf, w, scale4, y, workspace, M, K, N, G, splits, path, st);
  else if (x_dtype == AHA_BF16 && y_dtype == AHA_BF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, sxf, w, scale4, y, workspace, M, K, N, G,
                                               splits, path, st);
  else if (x_dtype == AHA_I8 && y_dtype == AHA_F32)
    err = launch<int8_t, float>(x, sxf, w, scale4, y, workspace, M, K, N, G, splits, path, st);
  else if (x_dtype == AHA_I8 && y_dtype == AHA_BF16)
    err = launch<int8_t, __nv_bfloat16>(x, sxf, w, scale4, y, workspace, M, K, N, G, splits,
                                        path, st);
  return static_cast<int>(err);
}
