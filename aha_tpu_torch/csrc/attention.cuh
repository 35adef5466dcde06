// What the tensor-core attention kernels share (flash_attention.cu, the forward
// and backward over a whole sequence; decode_attention.cu, the rows of a chunk
// against the ring cache): the two products of a 64-row tile as warpgroup
// products, the softmax's reductions within a quad of threads, exponentials, and
// the way out of a finished tile. wgmma.cuh has the primitives and the layouts
// of an accumulator, of a register operand and of a swizzled tile. sm_90a only.
#pragma once

#include "wgmma.cuh"

namespace attn {

using namespace wg;

constexpr int kDh = 128;   // head size of the tensor-core paths: a tile is two halves of 64 columns
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 2^x as one ex2.approx (2 ulp; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s [64 x 64] = A B^T over the 128 columns of two tiles (rows of A: the output's
// rows; rows of B: its columns), or s += A B^T where `acc` (a constant);
// started, not waited for
__device__ __forceinline__ void wg_products_nt(float (&s)[32], const unsigned char* a,
                                               const unsigned char* b, int acc = 0) {
  const uint32_t at = smem_addr(a), bt = smem_addr(b);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
    wgmma_ss(s, wg_desc(at + off), wg_desc(bt + off), kk != 0 || acc);
  }
}
// acc [64 x 128] (lo: columns 0 .. 63, hi: 64 .. 127) += P B with P [64 x 64] in
// A fragments and B a tile whose 64 rows are the contraction; started, not waited for
__device__ __forceinline__ void wg_products_pn(float (&lo)[32], float (&hi)[32],
                                               const uint32_t (&pa)[4][4], const unsigned char* b) {
  const uint32_t bt = smem_addr(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_t(lo, pa[kk], wg_desc(bt + kk * 16 * 128));
    wgmma_rs_t(hi, pa[kk], wg_desc(bt + kHalfBytes + kk * 16 * 128));
  }
}
// an accumulator [64 x 64] rounded to bf16 as the A fragments of the next product
__device__ __forceinline__ void wg_round(uint32_t (&pa)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// A warp's 16 finished rows (lo: columns 0 .. 63, hi: 64 .. 127; rows gid and
// gid + 8 times f0 and f1): through its own rows of the consumed tile `qs` and
// out in 16-byte stores. row_ptr(r) gives the address of the block's row r
// (0 .. 63) in device memory, or nullptr for a row that is not written.
template <typename F>
__device__ __forceinline__ void store_rows(unsigned char* qs, const float (&lo)[32],
                                           const float (&hi)[32], float f0, float f1, F row_ptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, row0 = warp * 16;
  __syncthreads();   // every warp's products have read the tile
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unsigned char* a = qs + swz(row0 + gid, j) + tig * 4;
    unsigned char* c = qs + swz(row0 + gid + 8, j) + tig * 4;
    *reinterpret_cast<uint32_t*>(a) = pack_bf16(lo[4 * j] * f0, lo[4 * j + 1] * f0);
    *reinterpret_cast<uint32_t*>(c) = pack_bf16(lo[4 * j + 2] * f1, lo[4 * j + 3] * f1);
    *reinterpret_cast<uint32_t*>(a + kHalfBytes) = pack_bf16(hi[4 * j] * f0, hi[4 * j + 1] * f0);
    *reinterpret_cast<uint32_t*>(c + kHalfBytes) = pack_bf16(hi[4 * j + 2] * f1, hi[4 * j + 3] * f1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = lane + 32 * i, r = row0 + (idx >> 4), c = idx & 15;
    bf16* dst = row_ptr(r);
    if (dst != nullptr)
      *reinterpret_cast<uint4*>(dst + c * 8) = *reinterpret_cast<const uint4*>(qs + swz(r, c));
  }
}

}  // namespace attn
