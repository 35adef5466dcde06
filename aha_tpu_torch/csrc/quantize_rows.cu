// xq[M, K] int8, sx[M] f32 from x[M, K]: per-row symmetric int8,
//   sx = max(absmax(x) / 127, 1e-12),  xq = clip(round_half_even(x / sx), -127, 127).
//
// Replaces aha_tpu/ops/pallas/fused_matmul.py::_quantize_rows, the per-token
// activation quantiser in front of the a8 variants of int8_matmul and
// int4_matmul (the TPU package leaves it to XLA outside its kernels; here it
// is a kernel of its own so that the a8 path holds no chain of elementwise
// library calls).
//
// What bounds it on an H100: bytes, x read once and one byte per element
// written (a layer's two widths at 196 rows: 13.2 MB, 4 us at 3.35 TB/s), and at
// the decode rows the launch and the latency of one row. Rows whose K is a
// multiple of the 16-byte chunk (8 bf16, 4 f32) on a 16-byte aligned x take the
// vector kernel: a block a row, each thread loads its chunks of the row with
// 16-byte loads, all in flight at once, and holds them in registers between the
// maximum and the quantisation, so x is read from device memory once and a
// thread divides at most 32 values (256 threads a row up to 512 chunks, a layer's
// K = 3584; 1024 up to 4096, down's K = 18944). A warp a row left a token's row
// of 3584 values to 32 threads, and the quantiser took 7 us of device time a
// launch in a graph (NVIDIA H100 80GB HBM3, 700 W). Other rows take the scalar
// kernel: a block a row, x read twice (the second pass from L1 / L2).
// The int8-activation products behind it are launched to start while it runs
// (programmatic dependent launch): each block of it lets them start at once, and
// they wait for its xq and sx only after their weight copies are in flight.
// The division and the rounding are IEEE (no fast-math), so the result is
// bit-equal to the plain version.
//
// planes[3, M, K] bf16 from x[M, K] f32: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid), each rounded to nearest even (split_bf16x3).
//
// The prologue of the f32-activation paths of int8_matmul.cu's and
// int4_matmul.cu's wgmma kernels, which multiply each plane on the bf16 tensor
// cores and add the three products into one f32 accumulator. It replaces no
// TPU kernel of its own: the TPU kernel computes an f32 dot on its matrix unit
// (aha_tpu/ops/pallas/fused_matmul.py::_kernel_int8 / _kernel_int4), which the
// H100 offers only on the CUDA cores (67 TFLOP/s against 989 for bf16). Each
// residual is exact in f32 (x - hi and its remainder are differences of nearby
// floats), and three planes of 8 significant bits and a sign hold the 24 of x,
// so hi + mid + lo == x but for values whose residual falls below bf16's
// smallest normal (|x| < 2^-100 or so). What bounds it: bytes, 4 read and 6
// written an element (a layer's four widths at 49 rows: 5.3 MB, 1.6 us at
// 3.35 TB/s). A thread takes four values (one 16-byte load, three 8-byte
// stores); the products behind it start while it runs (programmatic dependent
// launch), their weight copies in flight before they wait for the planes.
// Subtractions and round-to-nearest conversions only, so the planes are
// bit-equal to the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float quantized(float v, float s) {
  return fminf(fmaxf(rintf(v / s), -127.f), 127.f);   // round half to even
}

// the maximum of `amax` over the THREADS threads of a block (a multiple of 32)
template <int THREADS>
__device__ __forceinline__ float row_max(float amax) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) amax = fmaxf(amax, warp_max[i]);
  return amax;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int K) {
  allow_dependents();
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = xq + row * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
  const float s = fmaxf(row_max<kThreads>(amax) / 127.0f, 1e-12f);
  for (int k = threadIdx.x; k < K; k += kThreads)
    qr[k] = static_cast<int8_t>(quantized(to_f32(xr[k]), s));
  if (threadIdx.x == 0) sx[row] = s;
}

// the E values of a 16-byte chunk as f32
__device__ __forceinline__ void chunk_values(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = as_bf162(w[i]);
    v[2 * i] = __low2float(p);
    v[2 * i + 1] = __high2float(p);
  }
}
__device__ __forceinline__ void chunk_values(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}

// a block of TPR threads a row, CH chunks of 16 bytes a thread at most (chunk
// lane + TPR j of its row)
template <typename T, int TPR, int CH>
__global__ void __launch_bounds__(TPR)
quantize_rows_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int K) {
  allow_dependents();
  constexpr int E = 16 / sizeof(T);   // values a chunk
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const int chunks = K / E;
  const uint4* src = reinterpret_cast<const uint4*>(x) + static_cast<size_t>(row) * chunks;
  uint4 u[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + j * TPR;
    u[j] = c < chunks ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    float v[E];
    chunk_values(u[j], v);
#pragma unroll
    for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  const float s = fmaxf(row_max<TPR>(amax) / 127.0f, 1e-12f);
  int8_t* qr = xq + static_cast<size_t>(row) * K;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + j * TPR;
    if (c >= chunks) continue;
    float v[E];
    chunk_values(u[j], v);
    uint32_t q[E / 4];
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      q[i] = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        q[i] |= (static_cast<uint32_t>(static_cast<int>(quantized(v[4 * i + b], s))) & 0xffu)
                << (8 * b);
    }
    if constexpr (E == 8)
      *reinterpret_cast<uint2*>(qr + c * E) = make_uint2(q[0], q[1]);
    else
      *reinterpret_cast<uint32_t*>(qr + c * E) = q[0];
  }
  if (lane == 0) sx[row] = s;
}

template <typename T>
cudaError_t launch(const void* x, int8_t* xq, float* sx, int M, int K, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const int chunks = K / E;
  const bool vec = K % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec && chunks <= 256 * 2) {
    quantize_rows_vec_kernel<T, 256, 2><<<M, 256, 0, st>>>(xp, xq, sx, K);
  } else if (vec && chunks <= 1024 * 4) {
    quantize_rows_vec_kernel<T, 1024, 4><<<M, 1024, 0, st>>>(xp, xq, sx, K);
  } else {
    quantize_rows_kernel<T><<<M, kThreads, 0, st>>>(xp, xq, sx, K);
  }
  return cudaGetLastError();
}

// n values; VEC: four a thread (n % 4 == 0, x 16-byte aligned), else one
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
split_bf16x3_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes, size_t n) {
  allow_dependents();
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (VEC) {
    for (size_t i = first; i < n / 4; i += stride) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
      const float vs[4] = {v.x, v.y, v.z, v.w};
      __nv_bfloat16 p[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(vs[e], p[0][e], p[1][e], p[2][e]);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        reinterpret_cast<uint2*>(planes + q * n)[i] =
            make_uint2(as_u32(__halves2bfloat162(p[q][0], p[q][1])),
                       as_u32(__halves2bfloat162(p[q][2], p[q][3])));
    }
  } else {
    for (size_t i = first; i < n; i += stride) split3(x[i], planes[i], planes[n + i], planes[2 * n + i]);
  }
}

}  // namespace

// planes [3, M, K] bf16 (contiguous) of x [M, K] f32 (contiguous)
extern "C" int aha_split_bf16x3(const void* x, void* planes, int M, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(M) * K;
  const float* xp = static_cast<const float*>(x);
  __nv_bfloat16* pp = static_cast<__nv_bfloat16*>(planes);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t items = vec ? n / 4 : n;
  const size_t want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (vec)
    split_bf16x3_kernel<true><<<blocks, kThreads, 0, st>>>(xp, pp, n);
  else
    split_bf16x3_kernel<false><<<blocks, kThreads, 0, st>>>(xp, pp, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aha_quantize_rows(const void* x, void* xq, void* sx, int M, int K, int x_dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (x_dtype == AHA_F32) return static_cast<int>(launch<float>(x, q, s, M, K, st));
  if (x_dtype == AHA_BF16) return static_cast<int>(launch<__nv_bfloat16>(x, q, s, M, K, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
