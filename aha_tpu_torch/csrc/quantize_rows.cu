// xq[M, K] int8, sx[M] f32 from x[M, K]: per-row symmetric int8,
//   sx = max(absmax(x) / 127, 1e-12),  xq = clip(round_half_even(x / sx), -127, 127).
//
// Replaces aha_tpu/ops/pallas/fused_matmul.py::_quantize_rows, the per-token
// activation quantiser in front of the a8 variants of int8_matmul and
// int4_matmul (the TPU package leaves it to XLA outside its kernels; here it
// is a kernel of its own so that the a8 path holds no chain of elementwise
// library calls).
//
// What bounds it on an H100: bytes. x is read twice (the maximum, then the
// values; the second read of a row of at most 18944 elements comes from L1 /
// L2) and one byte per element is written. One block of 256 threads per row;
// at M = 1 that is a single block, and the launch dominates.
// The division and the rounding are IEEE (no fast-math), so the result is
// bit-equal to the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int K) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = xq + row * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) amax = fmaxf(amax, warp_max[i]);
  const float s = fmaxf(amax / 127.0f, 1e-12f);
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = rintf(to_f32(xr[k]) / s);   // round half to even
    qr[k] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
  if (threadIdx.x == 0) sx[row] = s;
}

}  // namespace

extern "C" int aha_quantize_rows(const void* x, void* xq, void* sx, int M, int K, int x_dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (x_dtype == AHA_F32)
    quantize_rows_kernel<float><<<M, kThreads, 0, st>>>(static_cast<const float*>(x), q, s, K);
  else if (x_dtype == AHA_BF16)
    quantize_rows_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, s, K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
