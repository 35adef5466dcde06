// y[M, N] = (x[M, K] @ W[K, N]) * scale[N]  with W int8, f32 accumulation.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/fused_matmul.py::int8_matmul
// (_kernel_int8, a8=False): the weight-only int8 product behind every
// decoder projection, the projector and the lm_head of the --int8 config.
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

template <typename T, int BM>
__global__ void __launch_bounds__(kColGroups * kKLanes)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, T* __restrict__ y,
               float* __restrict__ ws, int M, int K, int N, int k_per_split,
               int splits, int vec) {
  const int cg = threadIdx.x;   // column group
  const int kl = threadIdx.y;   // K lane
  const int n0 = blockIdx.x * kBN + cg * kCols;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  float acc[BM][kCols];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  const bool full = vec && (n0 + kCols <= N);
#pragma unroll 4
  for (int k = kbeg + kl; k < kend; k += kKLanes) {
    float wf[kCols];
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
      for (int j = 0; j < kCols; ++j) wf[j] = (n0 + j < N) ? static_cast<float>(wrow[j]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float xv = (m0 + r < M) ? to_f32(x[static_cast<size_t>(m0 + r) * K + k]) : 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
    }
  }

  // sum the 32 K lanes through shared memory, one row at a time
  __shared__ float red[kKLanes][kBN + 4];
  const int t = kl * kColGroups + cg;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[kl][cg * kCols + j] = acc[r][j];
    __syncthreads();
    if (t < kBN) {
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < kKLanes; ++l) s += red[l][t];
      const int row = m0 + r, col = blockIdx.x * kBN + t;
      if (row < M && col < N) {
        if (splits == 1)
          y[static_cast<size_t>(row) * N + col] = from_f32<T>(s * scale[col]);
        else
          ws[(static_cast<size_t>(blockIdx.z) * M + row) * N + col] = s;
      }
    }
    __syncthreads();
  }
}

// ---- tensor-core path (bf16 x) --------------------------------------------------

constexpr int kTM = 64, kTN = 128, kTK = 32;  // block tile
constexpr int kTPad = 8;                       // bf16 pad per shared row (20-word stride)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// ---- split-K reduction ----------------------------------------------------------

template <typename T>
__global__ void int8_mm_reduce(const float* __restrict__ ws, const float* __restrict__ scale,
                               T* __restrict__ y, int M, int N, int splits) {
  const size_t MN = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < MN;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * MN + i];
    y[i] = from_f32<T>(s * scale[i % N]);
  }
}

enum Path { kScalar = 0, kVec16 = 1, kTensorCore = 2 };

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y, void* ws,
                   int M, int K, int N, int splits, int path, cudaStream_t st) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* wsf = static_cast<float*>(ws);
  if (path == kTensorCore) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // split boundaries on the 32-row K step; a split past K writes zeros
      const int kps = ((K + splits - 1) / splits + kTK - 1) / kTK * kTK;
      const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, splits);
      int8_mm_tc_kernel<<<grid, 128, 0, st>>>(static_cast<const T*>(x), wq, sc,
                                              static_cast<T*>(y), wsf, M, K, N, kps, splits);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const int k_per_split = (K + splits - 1) / splits;
    const dim3 block(kColGroups, kKLanes);
    const int nb = (N + kBN - 1) / kBN;
    const int vec = path == kVec16;
    if (M == 1) {
      int8_mm_kernel<T, 1><<<dim3(nb, M, splits), block, 0, st>>>(
          static_cast<const T*>(x), wq, sc, static_cast<T*>(y), wsf, M, K, N, k_per_split,
          splits, vec);
    } else {
      constexpr int BM = 4;
      int8_mm_kernel<T, BM><<<dim3(nb, (M + BM - 1) / BM, splits), block, 0, st>>>(
          static_cast<const T*>(x), wq, sc, static_cast<T*>(y), wsf, M, K, N, k_per_split,
          splits, vec);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t MN = static_cast<size_t>(M) * N;
  const int threads = 256;
  const int blocks = static_cast<int>(std::min<size_t>((MN + threads - 1) / threads, 65535));
  int8_mm_reduce<T><<<blocks, threads, 0, st>>>(wsf, sc, static_cast<T*>(y), M, N, splits);
  return cudaGetLastError();
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
    return static_cast<int>(launch<float>(x, w, scale, y, workspace, M, K, N, splits, path, st));
  if (x_dtype == AHA_BF16)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, w, scale, y, workspace, M, K, N, splits, path, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* aha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
