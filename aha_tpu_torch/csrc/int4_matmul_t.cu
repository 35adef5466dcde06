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
// What bounds it on an H100: at a training sequence's M (926 rows at 16
// frames) the product is far above the 295 operations per byte where the
// tensor cores, not the memory, are the limit: 2 * M * N * K operations over
// K * N / 2 weight bytes. Two paths, chosen by the wrapper:
//   * tensor cores (bf16 g, N % 32 == 0, K % 8 == 0): the 64 x 128 tile scheme
//     of common.cuh with the roles turned: a block owns 64 rows of g and 128
//     columns of dx (64 packed rows of W) and walks N in steps of 32. The g
//     tile is staged as it lies (n contiguous). A thread loads 16 packed bytes
//     of one packed row and their 16 scales, unpacks two neighbouring bytes
//     into the bf16 pairs (lo_n, lo_n+1) and (hi_n, hi_n+1), scales them and
//     stores them into the rows 2j and 2j + 1 of the transposed weight tile
//     [k][n]: exactly the operand layout mma.sync wants. No cp.async pipeline
//     and no wgmma yet.
//   * CUDA cores (f32 g, ragged shapes): a warp owns one packed row (two
//     columns of dx) and four rows of g, its lanes stride along n (coalesced
//     bytes, scales and g), and a shuffle tree adds the 32 partial sums.
#include "common.cuh"

namespace {

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- tensor-core path -----------------------------------------------------------

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
// G even. tensor_cores: bf16 only, N % 32 == 0, K % 8 == 0, g, w and scale4
// 16-byte aligned; the wrapper checks.
extern "C" int aha_int4_matmul_t(const void* g, const void* w, const void* scale4, void* dx,
                                 int M, int K, int N, int G, int dtype, int tensor_cores,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 2 != 0 || K % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_cores) {
    if (dtype != AHA_BF16 || N % 32 != 0 || K % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((M + kTM - 1) / kTM, (K + kTN - 1) / kTN);
    int4_mm_t_tc_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(w),
        static_cast<const __nv_bfloat16*>(scale4), static_cast<__nv_bfloat16*>(dx), M, K, N, G);
    return static_cast<int>(cudaGetLastError());
  }
  if ((M + kRowsT - 1) / kRowsT > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == AHA_F32)
    return static_cast<int>(launch_cuda_cores<float>(g, w, scale4, dx, M, K, N, G, st));
  if (dtype == AHA_BF16)
    return static_cast<int>(launch_cuda_cores<__nv_bfloat16>(g, w, scale4, dx, M, K, N, G, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
