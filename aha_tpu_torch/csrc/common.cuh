// Shared helpers of the aha_tpu_torch kernels (plain C interface, built with
// nvcc into one shared library and called through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
enum AhaDtype { AHA_F32 = 0, AHA_BF16 = 1, AHA_I8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// four consecutive elements as f32 (pointers 4-element aligned)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  o[0] = __low2float(a); o[1] = __high2float(a); o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&o)[4]) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  o[0] = c.x; o[1] = c.y; o[2] = c.z; o[3] = c.w;
}
