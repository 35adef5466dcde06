// dx[M, K] = g[M, N] @ W^T, W = dequantised packed int4:
//   dx[m, k] = sum over n of g[m, n] * scale4[k / G, n] * w[k, n]
//
// The weight layouts are those of int4_matmul.cu: byte (j, n) of q4value
// [K/2, N] holds row 2j of column n in its low nibble and row 2j + 1 in its
// high nibble, values offset by 8; scale4 [K/G, N] is bf16, one scale per
// group of G rows and output column.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/fused_matmul.py::int4_matmul_t
// (_kernel_int4_t): the gradient with respect to the activations of every
// frozen int4 projection in QLoRA training (the backward of int4_qlinear).
// That kernel rescales the cotangent tile by each group's scales before the
// contraction over N and writes the even and the odd K rows as two planes,
// which its caller interleaves afterwards. Here a thread that unpacks byte j
// holds dx's columns 2j and 2j + 1 side by side, so dx is written interleaved
// at once and no plane exists.
//
// The contraction runs along N, the weight's fast axis, and the scale changes
// with both the K group and n, so it cannot be taken out of the sum as in the
// forward. The kernel scales the unpacked weight instead: s * (nibble - 8) is
// rounded once to the type of g (exact in f32: 4 + 8 significant bits; one
// bf16 rounding for bf16, as a dequantised bf16 weight would carry), products
// and sums are f32, the result is cast once.
//
// What bounds it on an H100: operations. At a training sequence's M (926 rows
// at 16 frames) the product is far above the 295 operations per byte where the
// tensor cores, not the memory, are the limit: 2 * M * N * K operations over
// K * N / 2 weight bytes. Beside the products, what costs is dequantising a
// [128 x 64] piece of W per stage and the tiles that blocks read again from
// L2. Three paths, chosen by the wrapper's plan():
//   * wgmma (bf16 g, G % 64 == 0, N % 64 == 0, 16-byte aligned operands):
//     section "tensor-core path, wgmma" below. The product is turned round
//     (dx^T = W g^T), the dequantised weight is the register operand of the
//     warpgroup products, raw bytes, g tiles and scales arrive by cp.async
//     through a six-slot ring shared by a block's two warpgroups, one accumulator
//     set. At M = 926 a decoder
//     layer's four products take 1.00 ms where the mma.sync kernel below took
//     2.98 (NVIDIA H100 80GB HBM3, 700 W; bound 0.44 ms).
//   * mma.sync (bf16 g, N % 32 == 0, K % 8 == 0, where the wgmma path does not
//     apply): the 64 x 128 tile scheme of common.cuh with the roles turned: a
//     block owns 64 rows of g and 128 columns of dx (64 packed rows of W) and
//     walks N in steps of 32. The g tile is staged as it lies (n contiguous). A
//     thread loads 16 packed bytes of one packed row and their 16 scales,
//     unpacks two neighbouring bytes into the bf16 pairs (lo_n, lo_n+1) and
//     (hi_n, hi_n+1), scales them and stores them into the rows 2j and 2j + 1
//     of the transposed weight tile [k][n]: exactly the operand layout
//     mma.sync wants. One buffer a tile: no copy overlaps a product.
//   * CUDA cores (f32 g, ragged shapes): a warp owns one packed row (two
//     columns of dx) and four rows of g, its lanes stride along n (coalesced
//     bytes, scales and g), and a shuffle tree adds the 32 partial sums.
#include "wgmma.cuh"

namespace {

// ---- tensor-core path, mma.sync --------------------------------------------------

__global__ void __launch_bounds__(128)
int4_mm_t_tc_kernel(const __nv_bfloat16* __restrict__ g, const uint8_t* __restrict__ w,
                    const __nv_bfloat16* __restrict__ scale4, __nv_bfloat16* __restrict__ dx,
                    int M, int K, int N, int G) {
  constexpr int RB = TileRow<false>::kBytes;
  __shared__ __align__(16) unsigned char gs[kTM * RB];
  __shared__ __align__(16) unsigned char wt[kTN * RB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTM, c0 = blockIdx.y * kTN;   // c0: first column of dx
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // this thread's share of the weight tile: packed row j, 16 of the step's 32 columns
  const int jj = tid >> 1, half = tid & 1;
  const int j = c0 / 2 + jj;
  const bool in = j < K / 2;
  const uint8_t* wrow = w + static_cast<size_t>(in ? j : 0) * N + half * 16;
  const __nv_bfloat16* srow = scale4 + static_cast<size_t>(in ? (2 * j) / G : 0) * N + half * 16;
  const uint32_t offset = 0x43084308u;   // the bf16 pair (136, 136)

  for (int n0 = 0; n0 < N; n0 += kTK) {
    stage_x_tile<false>(gs, g, m0, M, N, n0, tid);
    uint4 u = make_uint4(0u, 0u, 0u, 0u), s0 = u, s1 = u;   // zero scales: a row past K adds 0
    if (in) {
      u = __ldg(reinterpret_cast<const uint4*>(wrow + n0));
      s0 = __ldg(reinterpret_cast<const uint4*>(srow + n0));
      s1 = __ldg(reinterpret_cast<const uint4*>(srow + n0 + 8));
    }
    const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
    const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      // bytes 2p, 2p + 1: columns n, n + 1 of packed row j. 0x4300 | v is the
      // bf16 128 + v (ulp 1 there), so subtracting 136 gives v - 8 exactly.
      const uint32_t two = uw[p >> 1] >> (16 * (p & 1));
      const uint32_t b0 = two & 0xffu, b1 = (two >> 8) & 0xffu;
      const uint32_t lob = 0x43004300u | (b0 & 0xFu) | ((b1 & 0xFu) << 16);
      const uint32_t hib = 0x43004300u | (b0 >> 4) | ((b1 >> 4) << 16);
      const __nv_bfloat162 s2 = as_bf162(sw[p]);
      lo[p] = as_u32(__hmul2(__hsub2(as_bf162(lob), as_bf162(offset)), s2));
      hi[p] = as_u32(__hmul2(__hsub2(as_bf162(hib), as_bf162(offset)), s2));
    }
    unsigned char* r0 = wt + (2 * jj) * RB + half * 32;
    *reinterpret_cast<uint4*>(r0) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(r0 + 16) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    *reinterpret_cast<uint4*>(r0 + RB) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(r0 + RB + 16) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    __syncthreads();
    mma_tile<false>(acc, gs, wt, wm, wn, gid, tig);
    __syncthreads();
  }
  store_tile<__nv_bfloat16>(acc, dx, nullptr, nullptr, nullptr, M, K, m0, c0, wm, wn, gid, tig, 1,
                            0);
}

// ---- tensor-core path, wgmma (bf16 g, G % 64 == 0, N % 64 == 0) -------------------------------
//
// The product turned round: dx^T = W g^T. The 64-row side of a warpgroup
// product runs over rows k of W (columns of dx), its register operand is a
// [64 k x 16 n] piece of the dequantised W, its width is the token tile and the
// g tile is the B operand as it lies (n, the contraction, contiguous). Two
// neighbouring packed bytes (j, n), (j, n + 1) give the bf16 pair of row 2 j in
// their low nibbles and of row 2 j + 1 in their high nibbles; a thread's operand
// registers hold accumulator rows gid and gid + 8 of its warp, so row 16 w + gid
// of a slab IS dx column 16 w + 2 gid and row 16 w + gid + 8 column 16 w + 2 gid +
// 1 (row_to_column in the wrapper's module): the rows are relabelled at the
// store, where a thread then holds two neighbouring columns of dx, and no data
// is shuffled. s * (nibble - 8) is rounded once to bf16 on its way into the
// register, as the plain version rounds.
//
// A block is two warpgroups that share the g tile; each owns 128 columns of dx
// (two slabs of 64, 64 packed rows), the block 256, and a token tile of TM <=
// 128 rows. It walks N in stages of 64 through a ring of kStages slots filled by
// cp.async four stages ahead. A stage holds the g tile (TM rows of 128 bytes,
// swizzled), the packed bytes (128 rows of 64, padded to 80 so that a warp's
// eight rows fall in distinct banks) and each slab's 64 scales. A warpgroup's
// slabs alternate: the tensor cores run one slab's four products while its
// threads dequantise the other's operand; one accumulator set.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, M = 926, 380-435 TFLOP/s): the
// dequantising (about 120 of a stage's 300 instructions a thread, mostly on
// the half-rate integer pipe) takes about as long as the products beside it,
// and the tiles every block reads again from L2 (half the g tile's bytes
// bought 22% with one warpgroup a block; the second warpgroup, which halves
// them for good, bought 4%).
namespace w4t {

using namespace wg;

constexpr int kSlabs = 2;             // 64-row slabs of W per warpgroup
constexpr int kWgs = 2;               // warpgroups per block: they share the g tile
constexpr int kThreads = kWgs * kWgThreads;
constexpr int kBK = 64 * kSlabs * kWgs;   // columns of dx per block
constexpr int kNS = 64;               // contraction depth of a stage
constexpr int kStages = 6;            // ring slots; kStages - 2 stages are in flight
constexpr int kWRow = 80;             // bytes from one packed row of a stage to the next
constexpr int kWBytes = (kBK / 2) * kWRow;
constexpr int kSBytes = kWgs * kSlabs * kNS * 2;

// tiles start on 1024 bytes
__host__ __device__ constexpr int stage_bytes(int TM) { return TM * 128 + (kWBytes + kSBytes + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int smem_bytes(int TM) { return kStages * stage_bytes(TM) + kAlignSlack; }

// the [64 x 16] operands of a stage's four products for one slab: wrow: this
// thread's packed row at byte 2 tig; srow: the slab's scales at byte 4 tig
__device__ __forceinline__ void dequant(uint32_t (&a)[4][4], const unsigned char* wrow,
                                        const unsigned char* srow, uint32_t bias) {
  const __nv_bfloat162 offset = as_bf162(0x43084308u);   // the bf16 pair (136, 136)
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    // bytes (j, n), (j, n + 1), (j, n + 8), (j, n + 9) for n = 16 p + 2 tig, and
    // their scales. 0x4300 | v is the bf16 128 + v (ulp 1 there), so subtracting
    // 136 gives v - 8 exactly: a byte permute puts two nibbles beside 0x43.
    const uint32_t four =
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(wrow + 16 * p)) |
        (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(wrow + 16 * p + 8)) << 16);
    const uint32_t lo = four & 0x0F0F0F0Fu, hi = (four >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 s2 = as_bf162(*reinterpret_cast<const uint32_t*>(srow + 32 * p + 16 * h));
      const uint32_t two_columns = h == 0 ? 0x4140u : 0x4342u;
      a[p][2 * h] = as_u32(__hmul2(
          __hsub2(as_bf162(__byte_perm(lo, bias, two_columns)), offset), s2));   // row 2 j
      a[p][2 * h + 1] = as_u32(__hmul2(
          __hsub2(as_bf162(__byte_perm(hi, bias, two_columns)), offset), s2));   // 2 j + 1
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 1)
int4_mm_t_wgmma_kernel(const bf16* __restrict__ g, const uint8_t* __restrict__ w,
                       const bf16* __restrict__ scale4, bf16* __restrict__ dx, int M, int K,
                       int N, int G) {
  constexpr int kStage = stage_bytes(TM), NA = TM / 2;
  constexpr int kWOff = TM * 128, kSOff = kWOff + kWBytes;
  extern __shared__ __align__(128) unsigned char smem_w4t[];
  unsigned char* ring = align_tiles(smem_w4t);
  const uint32_t ring_a = smem_addr(ring);
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;   // warp of its warpgroup
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * TM, k0 = blockIdx.y * kBK;
  const int nst = N / kNS;

  // this thread's share of a stage's copies: rows of the g tile, two 16-byte
  // chunks of the packed bytes (rows past K / 2 as zeros), and for 32 threads a
  // chunk of the scales
  const RowsCopy<TM, kThreads> copy_g(static_cast<size_t>(N));
  const bf16* gsrc = g + static_cast<size_t>(m0) * N;
  const uint8_t* wsrc[2];
  uint32_t wdst[2];
  bool wok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * kThreads, row = idx >> 2, ch = idx & 3;
    wok[c] = k0 / 2 + row < K / 2;
    wsrc[c] = w + static_cast<size_t>(wok[c] ? k0 / 2 + row : 0) * N + ch * 16;
    wdst[c] = kWOff + row * kWRow + ch * 16;
  }
  const int sslab = (tid >> 3) & 3, sch = tid & 7;
  const bool sok = tid < 32 && k0 + 64 * sslab < K;
  const bf16* ssrc = scale4 + static_cast<size_t>(sok ? (k0 + 64 * sslab) / G : 0) * N + sch * 8;
  const uint32_t sdst = kSOff + sslab * (kNS * 2) + sch * 16;
  auto load = [&](int i) {   // stage i into its slot
    const uint32_t st = ring_a + (i % kStages) * kStage;
    copy_g(st, gsrc + i * kNS, M - m0);
#pragma unroll
    for (int c = 0; c < 2; ++c) cp_async16(st + wdst[c], wsrc[c] + i * kNS, wok[c]);
    if (tid < 32) cp_async16(st + sdst, ssrc + i * kNS, sok);
  };

  float acc[kSlabs][NA];
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[s][e] = 0.f;
  uint32_t a0[4][4], a1[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) a0[p][e] = a1[p][e] = 0u;
  const uint32_t bias = bias_bytes();
  // this warpgroup's slab 0; slab 1: 32 packed rows and 128 bytes of scales on
  const int wrow0 = kWOff + (64 * wgi + 8 * warp + gid) * kWRow + 2 * tig;
  const int srow0 = kSOff + 2 * wgi * (kNS * 2) + 4 * tig;

#pragma unroll
  for (int i = 0; i < kStages - 2; ++i) {
    if (i < nst) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<kStages - 3>();   // stage i has landed
    wg_wait<1>();                   // slab 0 of stage i - 1 is done: a0 is free
    __syncthreads();                // ... and every warp is past stage i - 2
    if (i + kStages - 2 < nst) load(i + kStages - 2);
    cp_async_commit();

    const int slot = i % kStages;
    const unsigned char* st = ring + slot * kStage;
    const uint32_t st_a = ring_a + slot * kStage;
    uint64_t gd[4];
    wg_desc_pieces(gd, st_a);
    keep(a0);
    dequant(a0, st + wrow0, st + srow0, bias);
    keep(a0);                       // defined before the first product of the four
    wg_fence();
#pragma unroll
    for (int p = 0; p < 4; ++p) wgmma_rs<TM>(acc[0], a0[p], gd[p], 1);
    wg_commit();

    wg_wait<1>();                   // slab 1 of stage i - 1 is done: a1 is free
    keep(a1);
    dequant(a1, st + wrow0 + 32 * kWRow, st + srow0 + kNS * 2, bias);
    keep(a1);
    wg_fence();
#pragma unroll
    for (int p = 0; p < 4; ++p) wgmma_rs<TM>(acc[1], a1[p], gd[p], 1);
    wg_commit();
  }
  wg_wait<0>();
  keep(a0);
  keep(a1);
  keep(acc[0]);
  keep(acc[1]);

  // accumulator rows gid and gid + 8 are the neighbouring columns 2 gid and
  // 2 gid + 1 of this warp's 16: one 4-byte store per token and slab
#pragma unroll
  for (int s = 0; s < kSlabs; ++s) {
    const int k = k0 + 128 * wgi + 64 * s + 16 * warp + 2 * gid;
    if (k >= K) continue;   // K % 64 == 0: a slab is all in or all out
#pragma unroll
    for (int j = 0; j < TM / 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int m = m0 + 8 * j + 2 * tig + b;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(dx + static_cast<size_t>(m) * K + k) =
              __floats2bfloat162_rn(acc[s][4 * j + b], acc[s][4 * j + 2 + b]);
      }
  }
}

template <int TM>
cudaError_t launch_tile(const bf16* g, const uint8_t* w, const bf16* scale4, bf16* dx, int M,
                        int K, int N, int G, cudaStream_t st) {
  cudaError_t err = allow_smem(int4_mm_t_wgmma_kernel<TM>, smem_bytes(TM));
  if (err != cudaSuccess) return err;
  // token tiles run fastest: the blocks in flight walk N together
  const dim3 grid((M + TM - 1) / TM, (K + kBK - 1) / kBK);
  int4_mm_t_wgmma_kernel<TM><<<grid, kThreads, smem_bytes(TM), st>>>(g, w, scale4, dx, M, K, N,
                                                                        G);
  return cudaGetLastError();
}

cudaError_t launch(const bf16* g, const uint8_t* w, const bf16* scale4, bf16* dx, int M, int K,
                   int N, int G, int tile, cudaStream_t st) {
  if (G % 64 != 0 || N % kNS != 0 || (K + kBK - 1) / kBK > 65535) return cudaErrorInvalidValue;
  switch (tile) {
#define AHA_TILE(TM) \
  case TM: return launch_tile<TM>(g, w, scale4, dx, M, K, N, G, st);
    AHA_TILE(8) AHA_TILE(16) AHA_TILE(24) AHA_TILE(32) AHA_TILE(40) AHA_TILE(48) AHA_TILE(56)
    AHA_TILE(64) AHA_TILE(72) AHA_TILE(80) AHA_TILE(88) AHA_TILE(96) AHA_TILE(104) AHA_TILE(112)
    AHA_TILE(120) AHA_TILE(128)
#undef AHA_TILE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace w4t

// ---- CUDA-core path ----------------------------------------------------------------

constexpr int kRowsT = 4;    // rows of g per warp
constexpr int kWarpsT = 8;   // packed rows of W per block

template <typename T>
__global__ void __launch_bounds__(kWarpsT * 32)
int4_mm_t_kernel(const T* __restrict__ g, const uint8_t* __restrict__ w,
                 const __nv_bfloat16* __restrict__ scale4, T* __restrict__ dx, int M, int K,
                 int N, int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarpsT + warp;
  const int m0 = blockIdx.y * kRowsT;
  if (j >= K / 2) return;
  const uint8_t* wrow = w + static_cast<size_t>(j) * N;
  const __nv_bfloat16* srow = scale4 + static_cast<size_t>((2 * j) / G) * N;
  float lo[kRowsT], hi[kRowsT];
#pragma unroll
  for (int r = 0; r < kRowsT; ++r) lo[r] = hi[r] = 0.f;

  for (int n = lane; n < N; n += 32) {
    const uint32_t b = wrow[n];
    const float s = __bfloat162float(srow[n]);
    // the dequantised weight in g's type, as the plain version holds it
    const float wl = to_f32(from_f32<T>(s * (static_cast<float>(b & 0xFu) - 8.f)));
    const float wh = to_f32(from_f32<T>(s * (static_cast<float>(b >> 4) - 8.f)));
#pragma unroll
    for (int r = 0; r < kRowsT; ++r) {
      if (m0 + r < M) {
        const float gv = to_f32(g[static_cast<size_t>(m0 + r) * N + n]);
        lo[r] = fmaf(gv, wl, lo[r]);
        hi[r] = fmaf(gv, wh, hi[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsT; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[r] += __shfl_xor_sync(0xffffffffu, lo[r], o);
      hi[r] += __shfl_xor_sync(0xffffffffu, hi[r], o);
    }
    if (lane == 0 && m0 + r < M) {
      T* o = dx + static_cast<size_t>(m0 + r) * K + 2 * j;
      o[0] = from_f32<T>(lo[r]);
      o[1] = from_f32<T>(hi[r]);
    }
  }
}

template <typename T>
cudaError_t launch_cuda_cores(const void* g, const void* w, const void* scale4, void* dx, int M,
                              int K, int N, int G, cudaStream_t st) {
  const dim3 grid((K / 2 + kWarpsT - 1) / kWarpsT, (M + kRowsT - 1) / kRowsT);
  int4_mm_t_kernel<T><<<grid, kWarpsT * 32, 0, st>>>(
      static_cast<const T*>(g), static_cast<const uint8_t*>(w),
      static_cast<const __nv_bfloat16*>(scale4), static_cast<T*>(dx), M, K, N, G);
  return cudaGetLastError();
}

}  // namespace

// g: [M, N] of dtype (AHA_F32 or AHA_BF16); dx: [M, K] of the same type. K % G == 0,
// G even. path: 0 CUDA cores; 2 tensor cores through mma.sync (bf16 only,
// N % 32 == 0, K % 8 == 0); 3 tensor cores through wgmma (bf16 only, G % 64 == 0,
// N % 64 == 0, tile: the token tile, a multiple of 8 up to 128); g, w and scale4
// 16-byte aligned on both tensor-core paths; the wrapper checks.
extern "C" int aha_int4_matmul_t(const void* g, const void* w, const void* scale4, void* dx,
                                 int M, int K, int N, int G, int dtype, int path, int tile,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 2 != 0 || K % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 3) {
    if (dtype != AHA_BF16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(w4t::launch(
        static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(w),
        static_cast<const __nv_bfloat16*>(scale4), static_cast<__nv_bfloat16*>(dx), M, K, N, G,
        tile, st));
  }
  if (path == 2) {
    if (dtype != AHA_BF16 || N % 32 != 0 || K % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((M + kTM - 1) / kTM, (K + kTN - 1) / kTN);
    int4_mm_t_tc_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(w),
        static_cast<const __nv_bfloat16*>(scale4), static_cast<__nv_bfloat16*>(dx), M, K, N, G);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 0 || (M + kRowsT - 1) / kRowsT > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == AHA_F32)
    return static_cast<int>(launch_cuda_cores<float>(g, w, scale4, dx, M, K, N, G, st));
  if (dtype == AHA_BF16)
    return static_cast<int>(launch_cuda_cores<__nv_bfloat16>(g, w, scale4, dx, M, K, N, G, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
