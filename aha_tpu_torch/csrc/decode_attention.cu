// Cached GQA attention of S query rows against the ring-buffer KV cache.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/decode_attention.py::
// cached_decode_attention (_kernel): for each (batch row, kv head) the
// n_rep query heads that share the kv head are grouped onto rows, ordered
// (rep, s); cached keys get a per-slot residual RoPE rotation (rotate-half,
// cos/sin tables per slot); a slot is visible to a row iff
// order[slot] >= 0 && order[slot] <= g[row]; softmax is online; the output
// is P.V normalised by the row sum. In int8 KV mode the per-(slot, head)
// K scales multiply the score columns and the V scales the probability
// columns, so the cache is read as int8.
//
// Design (simple and exact first): one block of 4 warps per (tile of 16
// query rows, kv head, batch row). The block walks all Wp slots in tiles of
// 32: it stages the tile's K (rotated, in f32) and V in shared memory with
// 4-element vector loads, then each warp scores its 4 rows side by side
// against the 32 slots (one slot per lane), updates the running max / sum
// with warp shuffles and accumulates P.V with each lane owning Dh/32 output
// dims. The ragged tail of the 2049-slot cache is masked here; the cache
// needs no padding to a tile multiple.
//
// What bounds it on an H100: the K/V bytes of one layer (2049 x 4 x 128 x 2
// x 2 bytes = 4 MB in bf16 for the 7B) are read once per row tile; at S = 1
// only B x KVH blocks run, so a single-token step uses 4 SMs of 132. The
// split-W (flash-decoding) form that spreads the slots over more blocks and
// a tensor-core (wgmma) inner product are left for later changes.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBW = 32;                        // cache slots per tile
constexpr int kThreads = kWarps * 32;

template <typename QT, typename KT, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                        const KT* __restrict__ vc, const float* __restrict__ cosb,
                        const float* __restrict__ sinb, const int* __restrict__ order,
                        const int* __restrict__ g, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, QT* __restrict__ out, int S, int NH,
                        int KVH, int Wp, float scale) {
  constexpr int DPL = (DH + 31) / 32;  // output dims per lane
  constexpr int HALF = DH / 2;
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rep = NH / KVH;
  const int M = n_rep * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  __shared__ __align__(16) float q_s[kRows][DH];
  // K rows padded to DH + 4 floats: 16-byte rows, and a lane-per-slot
  // float4 read touches distinct banks in each quarter warp
  __shared__ __align__(16) float k_s[kBW][DH + 4];
  __shared__ __align__(16) float v_s[kBW][DH];
  __shared__ int g_s[kRows];
  __shared__ int ord_s[kBW];
  __shared__ float ks_s[kBW], vs_s[kBW];

  for (int i = threadIdx.x; i < kRows * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH, R = tile * kRows + r;
    float val = 0.f;
    if (R < M) {
      const int rep = R / S, s = R % S;
      val = to_f32(q[((static_cast<size_t>(b) * S + s) * NH + kvh * n_rep + rep) * DH + d]);
    }
    q_s[r][d] = val;
  }
  if (threadIdx.x < kRows) {
    const int R = tile * kRows + threadIdx.x;
    // rows past M see no slot (order <= -2 never holds for order >= 0)
    g_s[threadIdx.x] = R < M ? g[b * S + R % S] : -2;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_i[rr] = -INFINITY;
    l_i[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] = 0.f;
  }

  const bool scaled = ksc != nullptr;
  const int row0 = warp * kRowsPerWarp;
  for (int w0 = 0; w0 < Wp; w0 += kBW) {
    __syncthreads();  // the previous tile is consumed
    // stage the tile: each thread takes 4 consecutive dims of a slot (vector
    // loads of K, its rotate-half partner, cos, sin and V), DH / 16 items
#pragma unroll
    for (int it = 0; it < DH / 16; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int j = i / (DH / 4), d = (i % (DH / 4)) * 4, slot = w0 + j;
      float kr[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (slot < Wp) {
        const size_t base = ((static_cast<size_t>(b) * Wp + slot) * KVH + kvh) * DH;
        const size_t tb = (static_cast<size_t>(b) * Wp + slot) * DH;
        float x[4], xp[4], cs[4], sn[4];
        load4(kc + base + d, x);
        load4(kc + base + (d < HALF ? d + HALF : d - HALF), xp);
        load4(cosb + tb + d, cs);
        load4(sinb + tb + d, sn);
        load4(vc + base + d, vv);
        // rotate-half: the first half takes -x2 * sin, the second +x1 * sin
        const float sg = d < HALF ? -1.f : 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) kr[e] = x[e] * cs[e] + sg * xp[e] * sn[e];
      }
      *reinterpret_cast<float4*>(&k_s[j][d]) = make_float4(kr[0], kr[1], kr[2], kr[3]);
      *reinterpret_cast<float4*>(&v_s[j][d]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
    }
    if (threadIdx.x < kBW) {
      const int slot = w0 + threadIdx.x;
      const bool in = slot < Wp;
      ord_s[threadIdx.x] = in ? order[static_cast<size_t>(b) * Wp + slot] : -1;
      const size_t si = (static_cast<size_t>(b) * Wp + slot) * KVH + kvh;
      ks_s[threadIdx.x] = (in && scaled) ? ksc[si] : 1.f;
      vs_s[threadIdx.x] = (in && scaled) ? vsc[si] : 1.f;
    }
    __syncthreads();

    // scores of the warp's 4 rows against slot `lane`, side by side
    float dot[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) dot[rr] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(&k_s[lane][d]);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[row0 + rr][d]);
        dot[rr] = fmaf(qv.x, kv.x, dot[rr]);
        dot[rr] = fmaf(qv.y, kv.y, dot[rr]);
        dot[rr] = fmaf(qv.z, kv.z, dot[rr]);
        dot[rr] = fmaf(qv.w, kv.w, dot[rr]);
      }
    }
    const int ord = ord_s[lane];
    float pv[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool vis = ord >= 0 && ord <= g_s[row0 + rr];
      const float sc = vis ? dot[rr] * scale * ks_s[lane] : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[rr], mx);
      // nothing visible to this row so far: keep the empty state
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_i[rr] - m_new);
      const float p = vis ? expf(sc - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_i[rr] = l_i[rr] * alpha + psum;
      m_i[rr] = m_new;
      pv[rr] = p * vs_s[lane];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] *= alpha;
    }
#pragma unroll 4
    for (int jj = 0; jj < kBW; ++jj) {
      float vj[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        const int d = lane + 32 * dd;
        vj[dd] = d < DH ? v_s[jj][d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pj = __shfl_sync(0xffffffffu, pv[rr], jj);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] = fmaf(pj, vj[dd], acc[rr][dd]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int R = tile * kRows + row0 + rr;
    if (R >= M) continue;
    const int rep = R / S, s = R % S;
    const float inv = 1.f / fmaxf(l_i[rr], 1e-30f);
    QT* o = out + ((static_cast<size_t>(b) * S + s) * NH + kvh * n_rep + rep) * DH;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (d < DH) o[d] = from_f32<QT>(acc[rr][dd] * inv);
    }
  }
}

template <typename QT, typename KT, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cs,
                   const void* sn, const void* order, const void* g, const void* ks,
                   const void* vs, void* out, int B, int S, int NH, int KVH, int Wp,
                   float scale, cudaStream_t st) {
  const int M = (NH / KVH) * S;
  const dim3 grid((M + kRows - 1) / kRows, KVH, B);
  decode_attention_kernel<QT, KT, DH><<<grid, kThreads, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(cs), static_cast<const float*>(sn),
      static_cast<const int*>(order), static_cast<const int*>(g),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<QT*>(out), S,
      NH, KVH, Wp, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_dim(int Dh, const void* q, const void* k, const void* v, const void* cs,
                   const void* sn, const void* order, const void* g, const void* ks,
                   const void* vs, void* out, int B, int S, int NH, int KVH, int Wp,
                   float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<QT, KT, 16>(q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
    case 32: return launch<QT, KT, 32>(q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
    case 64: return launch<QT, KT, 64>(q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
    case 128: return launch<QT, KT, 128>(q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int aha_decode_attention(const void* q, const void* k, const void* v,
                                    const void* cs, const void* sn, const void* order,
                                    const void* g, const void* ks, const void* vs, void* out,
                                    int B, int S, int NH, int KVH, int Dh, int Wp, int q_dtype,
                                    int kv_dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KVH <= 0 || NH % KVH != 0 || Wp <= 0 || (kv_dtype == AHA_I8) != (ks != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == AHA_F32 && kv_dtype == AHA_F32)
    err = by_dim<float, float>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
  else if (q_dtype == AHA_F32 && kv_dtype == AHA_I8)
    err = by_dim<float, int8_t>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
  else if (q_dtype == AHA_BF16 && kv_dtype == AHA_BF16)
    err = by_dim<__nv_bfloat16, __nv_bfloat16>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
  else if (q_dtype == AHA_BF16 && kv_dtype == AHA_I8)
    err = by_dim<__nv_bfloat16, int8_t>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, B, S, NH, KVH, Wp, scale, st);
  return static_cast<int>(err);
}
