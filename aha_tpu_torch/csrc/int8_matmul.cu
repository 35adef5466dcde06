// y[M, N] = (x[M, K] @ W[K, N]) * scale[N]  with W int8, f32 accumulation; or,
// with int8 activations (a8), y = (xq[M, K] @ W[K, N]) * scale[N] * sx[M] with
// exact int32 accumulation, xq / sx from csrc/quantize_rows.cu.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/fused_matmul.py::int8_matmul
// (_kernel_int8, both a8 values): the int8 product behind every decoder
// projection, the projector and the lm_head of the --int8 config. The same
// entry serves aha_tpu/ops/pallas/quant_matmul.py::quant_matmul (the same
// function, a8=False, unstacked).
//
// What bounds it on an H100: at the streaming path's M (1 for generation,
// 13..220 for text / frame chunks, 1568 for the projector over 32 frames)
// the K*N weight bytes dominate the traffic, so both paths below read each
// weight byte from device memory once and convert int8 in registers; the
// per-channel scale multiplies the finished f32 sum once (it factors out of
// the contraction), as in the TPU kernel's epilogue. Two paths, chosen by
// the wrapper from the operands:
//   * tensor cores (bf16 x, M > 1, K % 32 == 0, N % 8 == 0): a block owns a
//     64 x 128 output tile and walks K in steps of 32. It stages the x tile
//     (bf16) and the weight tile (int8 -> bf16, transposed so a thread's
//     fragment pair is one 32-bit shared load) in shared memory and runs
//     mma.sync m16n8k16 bf16 with f32 accumulators (4 warps, 32 x 64 each).
//     int8 values and bf16 activations are exact in bf16, so only the
//     summation order differs from the plain version. Blocks of the same
//     weight tile for different row tiles are adjacent in the grid, so a
//     repeat of a weight tile comes from L2. No cp.async / TMA pipeline
//     and no wgmma yet: that is work for a later change.
//   * CUDA cores (everything else, M = 1 included, where the product is
//     bound by weight bytes): a block covers 128 output columns; each of its
//     256 threads owns 16 contiguous columns (one 16-byte int8 load per
//     weight row) and one of 32 lanes along K, so a warp reads 4 rows x 128
//     contiguous bytes; rows of x are taken BM at a time.
// With a8 the same two paths run on int8 activations: the CUDA-core path
// multiplies and adds in int32, the tensor-core path stages both tiles as
// int8 and runs mma.sync m16n8k32 s8 with int32 accumulators (any M > 1,
// whatever the output type). The int32 sum is exact; it becomes f32 once,
// before the two scales (the TPU kernel adds its K-block partials in f32,
// which is the same number while the sum stays below 2^24).
// When the grid would leave SMs idle, K is split over grid z: each split
// writes an f32 partial and a second kernel sums the splits in a fixed
// order (deterministic, no atomics), scales and casts.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

// ---- CUDA-core path ---------------------------------------------------------

constexpr int kCols = 16;                  // columns per thread (one 16B load)
constexpr int kColGroups = 8;              // threads along N
constexpr int kBN = kCols * kColGroups;    // 128 columns per block
constexpr int kKLanes = 32;                // threads along K

template <typename X> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int8_t x) { return x; }

// X: activation type (float, bf16, or int8 with the per-row scales sx);
// Y: output type.
template <typename X, typename Y, int BM>
__global__ void __launch_bounds__(kColGroups * kKLanes)
int8_mm_kernel(const X* __restrict__ x, const float* __restrict__ sx,
               const int8_t* __restrict__ w, const float* __restrict__ scale,
               Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
               int k_per_split, int splits, int vec) {
  using Acc = typename AccOf<X>::type;
  const int cg = threadIdx.x;   // column group
  const int kl = threadIdx.y;   // K lane
  const int n0 = blockIdx.x * kBN + cg * kCols;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  Acc acc[BM][kCols];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0;

  const bool full = vec && (n0 + kCols <= N);
#pragma unroll 4
  for (int k = kbeg + kl; k < kend; k += kKLanes) {
    Acc wf[kCols];
    const int8_t* wrow = w + static_cast<size_t>(k) * N + n0;
    if (full) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(wrow));
      const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wf[4 * i + 0] = c[i].x;
        wf[4 * i + 1] = c[i].y;
        wf[4 * i + 2] = c[i].z;
        wf[4 * i + 3] = c[i].w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) wf[j] = (n0 + j < N) ? static_cast<Acc>(wrow[j]) : 0;
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const Acc xv = (m0 + r < M) ? to_acc(x[static_cast<size_t>(m0 + r) * K + k]) : 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = mad(xv, wf[j], acc[r][j]);
    }
  }

  // sum the 32 K lanes through shared memory, one row at a time
  __shared__ Acc red[kKLanes][kBN + 4];
  const int t = kl * kColGroups + cg;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[kl][cg * kCols + j] = acc[r][j];
    __syncthreads();
    if (t < kBN) {
      Acc si = 0;
#pragma unroll 8
      for (int l = 0; l < kKLanes; ++l) si += red[l][t];
      const float s = static_cast<float>(si);
      const int row = m0 + r, col = blockIdx.x * kBN + t;
      if (row < M && col < N) {
        if (splits == 1) {
          float v = s * scale[col];
          if (sx != nullptr) v *= sx[row];
          y[static_cast<size_t>(row) * N + col] = from_f32<Y>(v);
        } else {
          ws[(static_cast<size_t>(blockIdx.z) * M + row) * N + col] = s;
        }
      }
    }
    __syncthreads();
  }
}

// ---- tensor-core path (bf16 x) --------------------------------------------------

constexpr int kTPad = 8;   // bf16 pad per shared row (20-word stride)

__global__ void __launch_bounds__(128)
int8_mm_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ ws, int M, int K, int N, int k_per_split, int splits) {
  __shared__ __align__(16) __nv_bfloat16 xs[kTM][kTK + kTPad];  // x tile, row-major
  __shared__ __align__(16) __nv_bfloat16 wt[kTN][kTK + kTPad];  // weight tile, [n][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;   // the warp's 32 x 64 sub-tile

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    // x tile: 64 rows x 32 bf16 = 256 chunks of 16 bytes, 2 per thread
#pragma unroll
    for (int it = 0; it < kTM * kTK / 8 / 128; ++it) {
      const int c = tid + it * 128;
      const int r = c / (kTK / 8), kc = (c % (kTK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * K + k0 + kc));
      *reinterpret_cast<uint4*>(&xs[r][kc]) = v;
    }
    // weight tile: 16 row pairs x 16 groups of 8 columns, 2 items per thread;
    // consecutive threads take consecutive row pairs, so the transposed
    // 32-bit stores (a bf16 pair along k) fall in distinct banks
#pragma unroll
    for (int it = 0; it < (kTK / 2) * (kTN / 8) / 128; ++it) {
      const int c = tid + it * 128;
      const int kp = c % (kTK / 2), ng = (c / (kTK / 2)) * 8;
      const int k = k0 + 2 * kp, n = n0 + ng;
      uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
      if (n < N) {   // N % 8 == 0: a group is all in or all out
        lo = __ldg(reinterpret_cast<const uint2*>(w + static_cast<size_t>(k) * N + n));
        hi = __ldg(reinterpret_cast<const uint2*>(w + static_cast<size_t>(k + 1) * N + n));
      }
      const int8_t* a = reinterpret_cast<const int8_t*>(&lo);
      const int8_t* b = reinterpret_cast<const int8_t*>(&hi);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(&wt[ng + j][2 * kp]) =
            __floats2bfloat162_rn(static_cast<float>(a[j]), static_cast<float>(b[j]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + gid;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + tig * 2]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + tig * 2]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + tig * 2 + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = wn + ni * 8 + gid;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&wt[n][kk + tig * 2]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&wt[n][kk + tig * 2 + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + gid + 8 * h;
        const int col = n0 + wn + ni * 8 + tig * 2;
        if (row >= M || col >= N) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(&y[static_cast<size_t>(row) * N + col]) =
              __floats2bfloat162_rn(v0 * scale[col], v1 * scale[col + 1]);
        } else {
          float* o = ws + (static_cast<size_t>(blockIdx.z) * M + row) * N + col;
          o[0] = v0;
          o[1] = v1;
        }
      }
}

// ---- tensor-core path, int8 activations --------------------------------------------

template <typename Y>
__global__ void __launch_bounds__(128)
int8_mm_tc_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                     const int8_t* __restrict__ w, const float* __restrict__ scale,
                     Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
                     int k_per_split, int splits) {
  constexpr int RB = TileRow<true>::kBytes;
  __shared__ __align__(16) unsigned char xs[kTM * RB];
  __shared__ __align__(16) unsigned char wt[kTN * RB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    stage_x_tile<true>(xs, xq, m0, M, K, k0, tid);
    // weight tile: 8 quads of K rows x 16 groups of 8 columns, one item per
    // thread; the four K values of a column become one 32-bit word of wt[n][k]
    {
      const int kq = tid & 7, ng = (tid >> 3) * 8;
      const int k = k0 + 4 * kq, n = n0 + ng;
      uint2 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[i] = make_uint2(0u, 0u);
        if (n < N)   // N % 8 == 0: a group is all in or all out
          r[i] = __ldg(reinterpret_cast<const uint2*>(w + static_cast<size_t>(k + i) * N + n));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word |= byte_of(r[i], j) << (8 * i);
        *reinterpret_cast<uint32_t*>(wt + (ng + j) * RB + kq * 4) = word;
      }
    }
    __syncthreads();
    mma_tile<true>(acc, xs, wt, wm, wn, gid, tig);
    __syncthreads();
  }
  store_tile<Y>(acc, y, ws, scale, sx, M, N, m0, n0, wm, wn, gid, tig, splits, blockIdx.z);
}

enum Path { kScalar = 0, kVec16 = 1, kTensorCore = 2 };

// X = activation type as stored (int8 with sx for a8), Y = output type
template <typename X, typename Y>
cudaError_t launch(const void* x, const float* sx, const void* w, const void* scale, void* y,
                   void* ws, int M, int K, int N, int splits, int path, cudaStream_t st) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const X* xp = static_cast<const X*>(x);
  Y* yp = static_cast<Y*>(y);
  float* wsf = static_cast<float*>(ws);
  if (path == kTensorCore) {
    // split boundaries on the 32-row K step; a split past K writes zeros
    const int kps = ((K + splits - 1) / splits + kTK - 1) / kTK * kTK;
    const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, splits);
    if constexpr (std::is_same<X, int8_t>::value) {
      int8_mm_tc_a8_kernel<Y><<<grid, 128, 0, st>>>(xp, sx, wq, sc, yp, wsf, M, K, N, kps,
                                                    splits);
    } else if constexpr (std::is_same<X, __nv_bfloat16>::value &&
                         std::is_same<Y, __nv_bfloat16>::value) {
      int8_mm_tc_kernel<<<grid, 128, 0, st>>>(xp, wq, sc, yp, wsf, M, K, N, kps, splits);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const int k_per_split = (K + splits - 1) / splits;
    const dim3 block(kColGroups, kKLanes);
    const int nb = (N + kBN - 1) / kBN;
    const int vec = path == kVec16;
    if (M == 1) {
      int8_mm_kernel<X, Y, 1><<<dim3(nb, M, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, k_per_split, splits, vec);
    } else {
      constexpr int BM = 4;
      int8_mm_kernel<X, Y, BM><<<dim3(nb, (M + BM - 1) / BM, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, k_per_split, splits, vec);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_reduce<Y>(wsf, sc, sx, yp, M, N, splits, st);
}

}  // namespace

// path: 0 scalar CUDA-core loads, 1 16-byte CUDA-core loads (N % 16 == 0,
// 16-byte aligned weight), 2 tensor cores (bf16 x, M > 1, K % 32 == 0,
// N % 8 == 0, x 16-byte and weight 8-byte aligned); the wrapper checks.
extern "C" int aha_int8_matmul(const void* x, const void* w, const void* scale, void* y,
                               void* workspace, int M, int K, int N, int x_dtype, int splits,
                               int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == AHA_F32 && path != kTensorCore)
    return static_cast<int>(launch<float, float>(x, nullptr, w, scale, y, workspace, M, K, N,
                                                 splits, path, st));
  if (x_dtype == AHA_BF16)
    return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(
        x, nullptr, w, scale, y, workspace, M, K, N, splits, path, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 activations xq [M, K] with per-row scales sx [M] (csrc/quantize_rows.cu);
// y_dtype is the output's type. path 2 here needs M > 1, K % 32 == 0,
// N % 8 == 0, xq 16-byte and weight 8-byte aligned, whatever y_dtype.
extern "C" int aha_int8_matmul_a8(const void* xq, const void* sx, const void* w,
                                  const void* scale, void* y, void* workspace, int M, int K,
                                  int N, int y_dtype, int splits, int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || sx == nullptr ||
      (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sxf = static_cast<const float*>(sx);
  if (y_dtype == AHA_F32)
    return static_cast<int>(launch<int8_t, float>(xq, sxf, w, scale, y, workspace, M, K, N,
                                                  splits, path, st));
  if (y_dtype == AHA_BF16)
    return static_cast<int>(launch<int8_t, __nv_bfloat16>(xq, sxf, w, scale, y, workspace, M,
                                                          K, N, splits, path, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* aha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
