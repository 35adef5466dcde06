// Shared helpers of the aha_tpu_torch kernels (plain C interface, built with
// nvcc into one shared library and called through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
// AHA_BF16X3: an f32 x as its three bf16 planes [3, M, K] (split_bf16x3)
enum AhaDtype { AHA_F32 = 0, AHA_BF16 = 1, AHA_I8 = 2, AHA_BF16X3 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// a bf16 pair as the 32-bit word that holds it, and back
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the three bf16 planes of one f32 value, hi + mid + lo == v (split_bf16x3 in
// quantize_rows.cu; the f32 queries of decode_attention.cu's tensor-core path)
__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = __fsub_rn(v, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
}

// Programmatic dependent launch (sm_90). A kernel launched with programmatic
// stream serialisation (launch_after_prior_grid) may start while the kernel ahead
// of it on the stream still runs: until wait_prior_grid() it may touch only what
// that kernel does not write. wait_prior_grid() returns once the grid ahead has
// completed and its writes are visible (at once for a kernel launched the usual
// way); allow_dependents() lets such a kernel behind this one start now.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
template <typename... Params, typename... Args>
inline cudaError_t launch_after_prior_grid(void (*kernel)(Params...), dim3 grid, dim3 block,
                                           int smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
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

// two consecutive elements (pointer 2-element aligned) in the accumulator's type
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x; b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(p));
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  a = __low2float(v); b = __high2float(v);
}
__device__ __forceinline__ void load2(const int8_t* p, int& a, int& b) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  a = v.x; b = v.y;
}

// multiply-add in the accumulator's type: f32 for float activations, exact
// int32 for int8 activations
__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mad(int a, int b, int c) { return a * b + c; }

// ---- split-K: sum the f32 partials in a fixed order (no atomics), then the
// per-column scale and the per-row scale where given, one cast at the end ------
template <typename Y>
__global__ void splitk_reduce(const float* __restrict__ ws, const float* __restrict__ col_scale,
                              const float* __restrict__ row_scale, Y* __restrict__ y, int M,
                              int N, int splits) {
  const size_t MN = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < MN;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * MN + i];
    if (col_scale != nullptr) s *= col_scale[i % N];
    if (row_scale != nullptr) s *= row_scale[i / N];
    y[i] = from_f32<Y>(s);
  }
}

template <typename Y>
inline cudaError_t launch_splitk_reduce(const float* ws, const float* col_scale,
                                        const float* row_scale, Y* y, int M, int N, int splits,
                                        cudaStream_t st) {
  const size_t MN = static_cast<size_t>(M) * N;
  const int threads = 256;
  const size_t want = (MN + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  splitk_reduce<Y><<<blocks, threads, 0, st>>>(ws, col_scale, row_scale, y, M, N, splits);
  return cudaGetLastError();
}

// ---- tensor-core tiles (mma.sync) shared by the quantized matmuls -----------------
//
// The first tensor-core scheme of the port, kept for int8 activations (on int8
// and int4 weights) and for the bf16 shapes that the wgmma kernels of
// int8_matmul.cu / int4_matmul.cu / int4_matmul_t.cu (primitives: wgmma.cuh) do
// not take. Nothing here overlaps: a K step loads, stores to shared memory,
// synchronises, multiplies, synchronises.
//
// A block of 4 warps owns a 64 x 128 output tile and walks K in steps of 32.
// Both operands are staged in shared memory with K contiguous: x rows as they
// are, the weight tile transposed to [n][k], so that a thread's mma fragment
// register is one 32-bit shared load. Elements are bf16 (mma m16n8k16, f32
// accumulators) or, for int8 activations, int8 (mma m16n8k32, int32
// accumulators). A shared row holds the 32 K values plus padding chosen so
// that the 8 rows x 4 words a warp reads per fragment fall in 32 distinct
// banks (row stride 20 words for bf16, 12 words for int8).
constexpr int kTM = 64, kTN = 128, kTK = 32;

template <bool A8> struct TileRow { static constexpr int kBytes = A8 ? 48 : 80; };

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows m0..m0+63, columns k0..k0+31 of x [M, K] (bf16, or int8 when A8;
// 16-byte aligned rows) into xs; rows past M are zero. 128 threads.
template <bool A8>
__device__ __forceinline__ void stage_x_tile(unsigned char* xs, const void* x, int m0, int M,
                                             int K, int k0, int tid) {
  constexpr int RB = TileRow<A8>::kBytes;
  if constexpr (A8) {
    // 64 rows x 32 bytes = 128 chunks of 16 bytes, one per thread
    const int r = tid >> 1, kc = (tid & 1) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M)
      v = __ldg(reinterpret_cast<const uint4*>(static_cast<const int8_t*>(x) +
                                               static_cast<size_t>(m0 + r) * K + k0 + kc));
    *reinterpret_cast<uint4*>(xs + r * RB + kc) = v;
  } else {
    // 64 rows x 32 bf16 = 256 chunks of 16 bytes, two per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int c = tid + it * 128;
      const int r = c >> 2, kc = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) +
                                                 static_cast<size_t>(m0 + r) * K + k0 + kc));
      *reinterpret_cast<uint4*>(xs + r * RB + kc * 2) = v;
    }
  }
}

// byte j (0..7, a compile-time constant after unrolling) of eight packed bytes
__device__ __forceinline__ uint32_t byte_of(const uint2& v, int j) {
  return ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xffu;
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One 32-deep K step of a warp's 32 x 64 sub-tile at (wm, wn) of the block
// tile: acc += xs[wm.., :] @ wt[wn.., :]^T.
template <bool A8, typename Acc>
__device__ __forceinline__ void mma_tile(Acc (&acc)[2][8][4], const unsigned char* xs,
                                         const unsigned char* wt, int wm, int wn, int gid,
                                         int tig) {
  constexpr int RB = TileRow<A8>::kBytes;
  if constexpr (A8) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const unsigned char* r0 = xs + (wm + mi * 16 + gid) * RB + tig * 4;
      af[mi][0] = lds32(r0);
      af[mi][1] = lds32(r0 + 8 * RB);
      af[mi][2] = lds32(r0 + 16);
      af[mi][3] = lds32(r0 + 8 * RB + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const unsigned char* bp = wt + (wn + ni * 8 + gid) * RB + tig * 4;
      const uint32_t b0 = lds32(bp), b1 = lds32(bp + 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const unsigned char* r0 = xs + (wm + mi * 16 + gid) * RB + (kk + tig * 2) * 2;
        af[mi][0] = lds32(r0);
        af[mi][1] = lds32(r0 + 8 * RB);
        af[mi][2] = lds32(r0 + 16);
        af[mi][3] = lds32(r0 + 8 * RB + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const unsigned char* bp = wt + (wn + ni * 8 + gid) * RB + (kk + tig * 2) * 2;
        const uint32_t b0 = lds32(bp), b1 = lds32(bp + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }
}

// Write a warp's accumulators (column pairs col, col + 1 with col even and
// N % 8 == 0): the finished value times col_scale[col] and row_scale[row]
// where given, cast to Y; or, with split K, the raw f32 partial of this split.
template <typename Y, typename Acc>
__device__ __forceinline__ void store_tile(const Acc (&acc)[2][8][4], Y* y, float* ws,
                                           const float* col_scale, const float* row_scale,
                                           int M, int N, int m0, int n0, int wm, int wn,
                                           int gid, int tig, int splits, int split) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + gid + 8 * h;
        const int col = n0 + wn + ni * 8 + tig * 2;
        if (row >= M || col >= N) continue;
        float v0 = static_cast<float>(acc[mi][ni][2 * h]);
        float v1 = static_cast<float>(acc[mi][ni][2 * h + 1]);
        if (splits == 1) {
          if (col_scale != nullptr) { v0 *= col_scale[col]; v1 *= col_scale[col + 1]; }
          if (row_scale != nullptr) { v0 *= row_scale[row]; v1 *= row_scale[row]; }
          Y* o = y + static_cast<size_t>(row) * N + col;
          o[0] = from_f32<Y>(v0);
          o[1] = from_f32<Y>(v1);
        } else {
          float* o = ws + (static_cast<size_t>(split) * M + row) * N + col;
          o[0] = v0;
          o[1] = v1;
        }
      }
}
