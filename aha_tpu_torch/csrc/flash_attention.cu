// Causal attention over a whole sequence, forward and backward, without the
// [T, T] score matrix in device memory.
//
//   o[b, t, h]   = sum over visible keys u of softmax_u(scale * q[b,t,h] . k[b,u,h/rep]) v[b,u,h/rep]
//   lse[b, h, t] = log sum over visible keys of exp(scale * q . k)       (f32)
//   key u is visible to query t when u <= t and key_valid[b, u] (where given);
//   a query with no visible key gives o = 0 and lse = -inf.
//
// q, o [B, T, NH, Dh]; k, v [B, T, KVH, Dh] (q and k already rotated); NH =
// rep * KVH. The backward takes q, k, v, o, do and lse and recomputes the
// probabilities: delta = rowsum(do * o), p = exp(scale * q.k - lse),
// ds = p * (do.v - delta), dq = scale * ds k, dk = scale * ds^T q, dv = p^T do.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/flash_attention.py::
// flash_causal_attention (_kernel), which is forward only, pads T to its block
// and carries the running maximum, sum and accumulator in scratch memory from
// one step of a sequential key grid to the next. Blocks of a GPU grid run in
// no order and share nothing, so here a block owns 64 (position, head) rows of
// one (batch, kv head), the rep query heads of a position side by side so that
// they share each staged K / V tile, and loops over the 32-key tiles up to its
// last position itself; the ragged last tile and the padding mask are masked
// in the kernel, nothing is padded.
//
// Inside a block a warp owns 8 rows. Scores: a lane owns one key of the tile
// and walks Dh in float4 steps, the 8 query rows broadcast from shared memory
// (row stride Dh + 4 floats keeps the 16-byte loads of 8 lanes on 32 distinct
// banks). Weighted sum: a lane owns the columns lane, lane + 32, .. of the
// output and reads the probabilities back from shared memory, four keys per
// 16-byte broadcast. All arithmetic is f32 on the CUDA cores, whatever the
// storage type: the running maximum and sum per row live in registers, the
// output is cast once.
//
// The backward is two kernels after the small delta pass, so that no sum
// crosses blocks and no atomic is needed (the result is the same from run to
// run): one shaped like the forward that owns query rows and produces dq, and
// one that owns a tile of 32 keys, loops over the row tiles from its first
// visible position on, and produces dk and dv (a warp owns 4 keys of the
// tile, a lane the columns lane, lane + 32, ..). The price is that the scores
// and do.v are computed twice: 7 tile products instead of the 5 a fused
// backward with atomics on dq would need.
//
// What bounds it on an H100: operations. At T = 926, 28 heads, Dh 128 the
// forward is 4 * NH * T^2 * Dh / 2 = 6.1 GFLOP over 15 MB, far right of the
// roofline's ridge; on the CUDA cores it cannot pass 67 TFLOP/s, and the tensor
// cores (mma.sync, then wgmma) are the next step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // (position, head) rows per block
constexpr int kKeys = 32;      // keys per tile: one per lane
constexpr int kRW = 8;         // rows per warp
constexpr int kThreads = 256;  // 8 warps
constexpr int kPS = 36;        // row stride of the probability tile (16-byte rows)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Rows R0 .. R0 + 63 of group g (row R: position R / rep, head g * rep + R % rep)
// of src [B, T, NH, DH] as f32 into dst [64][DH + 4]; rows past the end are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage_query_rows(float* dst, const T* __restrict__ src, int b,
                                                 int g, int R0, int nrows, int rep, int Tn,
                                                 int NH) {
  constexpr int DS = DH + 4, C4 = DH / 4;
  for (int idx = threadIdx.x; idx < kRows * C4; idx += kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int R = R0 + r;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (R < nrows) {
      const int pos = R / rep, head = g * rep + R % rep;
      load4(src + (static_cast<size_t>(b * Tn + pos) * NH + head) * DH + c, f);
    }
    *reinterpret_cast<float4*>(dst + r * DS + c) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// Keys k0 .. k0 + 31 of kv head g of src [B, T, KVH, DH] into dst [32][DH + 4].
template <typename T, int DH>
__device__ __forceinline__ void stage_key_rows(float* dst, const T* __restrict__ src, int b,
                                               int g, int k0, int Tn, int KVH) {
  constexpr int DS = DH + 4, C4 = DH / 4;
  for (int idx = threadIdx.x; idx < kKeys * C4; idx += kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (k0 + r < Tn) load4(src + (static_cast<size_t>(b * Tn + k0 + r) * KVH + g) * DH + c, f);
    *reinterpret_cast<float4*>(dst + r * DS + c) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// 1 where key k0 + lane exists and is no padding
__device__ __forceinline__ void stage_key_flags(int* kvis, const uint8_t* __restrict__ key_valid,
                                                int b, int k0, int Tn) {
  if (threadIdx.x < kKeys) {
    const int kp = k0 + threadIdx.x;
    kvis[threadIdx.x] = kp < Tn && (key_valid == nullptr || key_valid[b * Tn + kp] != 0);
  }
}

// acc[i][j] += sum over the tile's keys of ps[row i][key] * tile[key][lane + 32 j]
template <int DH>
__device__ __forceinline__ void weighted_sum(float (&acc)[kRW][(DH + 31) / 32], const float* ps,
                                             const float* tile, int row0, int lane) {
  constexpr int DS = DH + 4, JD = (DH + 31) / 32;
#pragma unroll 2
  for (int k4 = 0; k4 < kKeys; k4 += 4) {
    float t[4][JD];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int d = lane + 32 * j;
        t[kk][j] = d < DH ? tile[(k4 + kk) * DS + d] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(ps + (row0 + i) * kPS + k4);
#pragma unroll
      for (int j = 0; j < JD; ++j)
        acc[i][j] += p.x * t[0][j] + p.y * t[1][j] + p.z * t[2][j] + p.w * t[3][j];
    }
  }
}

// ---- forward ---------------------------------------------------------------------

template <int DH> constexpr int fwd_smem_floats() {
  return kRows * (DH + 4) + 2 * kKeys * (DH + 4) + kRows * kPS + kKeys;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ key_valid, T* __restrict__ o,
                 float* __restrict__ lse, int Tn, int NH, int KVH, float scale) {
  constexpr int DS = DH + 4, JD = (DH + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kRows * DS;
  float* vs = ks + kKeys * DS;
  float* ps = vs + kKeys * DS;
  int* kvis = reinterpret_cast<int*>(ps + kRows * kPS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = NH / KVH, g = blockIdx.y, b = blockIdx.z;
  const int nrows = Tn * rep, R0 = blockIdx.x * kRows, row0 = warp * kRW;

  stage_query_rows<T, DH>(qs, q, b, g, R0, nrows, rep, Tn, NH);
  int qpos[kRW], warp_last = -1;
  float m[kRW], l[kRW], acc[kRW][JD];
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int R = R0 + row0 + i;
    qpos[i] = R < nrows ? R / rep : -1;
    warp_last = max(warp_last, qpos[i]);
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  }
  const int last_pos = min(Tn - 1, (R0 + kRows - 1) / rep);

  for (int k0 = 0; k0 <= last_pos; k0 += kKeys) {
    __syncthreads();   // the previous tile is consumed (first pass: nothing to wait for)
    stage_key_rows<T, DH>(ks, k, b, g, k0, Tn, KVH);
    stage_key_rows<T, DH>(vs, v, b, g, k0, Tn, KVH);
    stage_key_flags(kvis, key_valid, b, k0, Tn);
    __syncthreads();
    if (k0 > warp_last) continue;   // every key of the tile lies after this warp's rows

    float s[kRW];
#pragma unroll
    for (int i = 0; i < kRW; ++i) s[i] = 0.f;
    const float* kr = ks + lane * DS;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kRW; ++i)
        s[i] += dot4(*reinterpret_cast<const float4*>(qs + (row0 + i) * DS + d), kv);
    }
    const int kpos = k0 + lane;
    const bool kok = kvis[lane] != 0;
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const bool vis = kok && kpos <= qpos[i];
      const float sv = vis ? s[i] * scale : kNeg;
      const float m_new = fmaxf(m[i], warp_max(sv));
      // while no key has been visible m stays at kNeg: alpha = 1 on a zero sum
      const float alpha = expf(m[i] - m_new);
      const float p = vis ? expf(sv - m_new) : 0.f;
      l[i] = l[i] * alpha + p;   // this lane's share; the lanes are added at the end
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
      ps[(row0 + i) * kPS + lane] = p;
    }
    __syncwarp();
    weighted_sum<DH>(acc, ps, vs, row0, lane);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const float lsum = warp_sum(l[i]);
    const int R = R0 + row0 + i;
    if (R >= nrows) continue;
    const int pos = R / rep, head = g * rep + R % rep;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    T* orow = o + (static_cast<size_t>(b * Tn + pos) * NH + head) * DH;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = lane + 32 * j;
      if (d < DH) orow[d] = from_f32<T>(acc[i][j] * inv);
    }
    if (lane == 0)
      lse[(static_cast<size_t>(b) * NH + head) * Tn + pos] =
          lsum > 0.f ? m[i] + logf(lsum) : -INFINITY;
  }
}

// ---- backward ----------------------------------------------------------------------

// delta[b, h, t] = sum over d of do[b, t, h, d] * o[b, t, h, d]; one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int B, int Tn, int NH, int DH) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp;
  if (row >= static_cast<long long>(B) * Tn * NH) return;
  const T* a = o + row * DH;
  const T* c = dout + row * DH;
  float s = 0.f;
  for (int d = lane; d < DH; d += 32) s += to_f32(a[d]) * to_f32(c[d]);
  s = warp_sum(s);
  if (lane == 0) {
    const int head = static_cast<int>(row % NH);
    const long long bt = row / NH;
    const int pos = static_cast<int>(bt % Tn), b = static_cast<int>(bt / Tn);
    delta[(static_cast<size_t>(b) * NH + head) * Tn + pos] = s;
  }
}

// this warp's 8 rows against the tile's 32 keys: s[i] = q_i . k_lane, dp[i] = do_i . v_lane
template <int DH>
__device__ __forceinline__ void scores_and_dp(float (&s)[kRW], float (&dp)[kRW], const float* qs,
                                              const float* dos, const float* ks, const float* vs,
                                              int row0, int lane) {
  constexpr int DS = DH + 4;
#pragma unroll
  for (int i = 0; i < kRW; ++i) s[i] = dp[i] = 0.f;
  const float* kr = ks + lane * DS;
  const float* vr = vs + lane * DS;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      s[i] += dot4(*reinterpret_cast<const float4*>(qs + (row0 + i) * DS + d), kv);
      dp[i] += dot4(*reinterpret_cast<const float4*>(dos + (row0 + i) * DS + d), vv);
    }
  }
}

template <int DH> constexpr int dq_smem_floats() {
  return 2 * kRows * (DH + 4) + 2 * kKeys * (DH + 4) + kRows * kPS + kKeys;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Tn, int NH, int KVH, float scale) {
  constexpr int DS = DH + 4, JD = (DH + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * DS;
  float* ks = dos + kRows * DS;
  float* vs = ks + kKeys * DS;
  float* ps = vs + kKeys * DS;
  int* kvis = reinterpret_cast<int*>(ps + kRows * kPS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = NH / KVH, g = blockIdx.y, b = blockIdx.z;
  const int nrows = Tn * rep, R0 = blockIdx.x * kRows, row0 = warp * kRW;

  stage_query_rows<T, DH>(qs, q, b, g, R0, nrows, rep, Tn, NH);
  stage_query_rows<T, DH>(dos, dout, b, g, R0, nrows, rep, Tn, NH);
  int qpos[kRW], warp_last = -1;
  float row_lse[kRW], row_delta[kRW], acc[kRW][JD];
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int R = R0 + row0 + i;
    qpos[i] = -1;
    row_lse[i] = row_delta[i] = 0.f;
    if (R < nrows) {
      qpos[i] = R / rep;
      const size_t at = (static_cast<size_t>(b) * NH + g * rep + R % rep) * Tn + qpos[i];
      row_lse[i] = lse[at];
      row_delta[i] = delta[at];
    }
    warp_last = max(warp_last, qpos[i]);
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  }
  const int last_pos = min(Tn - 1, (R0 + kRows - 1) / rep);

  for (int k0 = 0; k0 <= last_pos; k0 += kKeys) {
    __syncthreads();
    stage_key_rows<T, DH>(ks, k, b, g, k0, Tn, KVH);
    stage_key_rows<T, DH>(vs, v, b, g, k0, Tn, KVH);
    stage_key_flags(kvis, key_valid, b, k0, Tn);
    __syncthreads();
    if (k0 > warp_last) continue;

    float s[kRW], dp[kRW];
    scores_and_dp<DH>(s, dp, qs, dos, ks, vs, row0, lane);
    const int kpos = k0 + lane;
    const bool kok = kvis[lane] != 0;
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const bool vis = kok && kpos <= qpos[i];
      const float p = vis ? expf(s[i] * scale - row_lse[i]) : 0.f;
      ps[(row0 + i) * kPS + lane] = p * (dp[i] - row_delta[i]);
    }
    __syncwarp();
    weighted_sum<DH>(acc, ps, ks, row0, lane);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int R = R0 + row0 + i;
    if (R >= nrows) continue;
    T* row = dq + (static_cast<size_t>(b * Tn + qpos[i]) * NH + g * rep + R % rep) * DH;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = lane + 32 * j;
      if (d < DH) row[d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <int DH> constexpr int dkv_smem_floats() {
  return 2 * kRows * (DH + 4) + 2 * kKeys * (DH + 4) + 2 * kRows * kPS + 3 * kRows + kKeys;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Tn, int NH, int KVH,
                     float scale) {
  constexpr int DS = DH + 4, JD = (DH + 31) / 32;
  constexpr int KW = kKeys / (kThreads / 32);   // keys per warp when the sums are taken: 4
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * DS;
  float* ks = dos + kRows * DS;
  float* vs = ks + kKeys * DS;
  float* ps = vs + kKeys * DS;
  float* dss = ps + kRows * kPS;
  float* lse_s = dss + kRows * kPS;
  float* delta_s = lse_s + kRows;
  int* qpos_s = reinterpret_cast<int*>(delta_s + kRows);
  int* kvis = qpos_s + kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = NH / KVH, g = blockIdx.y, b = blockIdx.z;
  const int nrows = Tn * rep, k0 = blockIdx.x * kKeys, row0 = warp * kRW;

  stage_key_rows<T, DH>(ks, k, b, g, k0, Tn, KVH);
  stage_key_rows<T, DH>(vs, v, b, g, k0, Tn, KVH);
  stage_key_flags(kvis, key_valid, b, k0, Tn);
  float acc_dk[KW][JD], acc_dv[KW][JD];
#pragma unroll
  for (int kk = 0; kk < KW; ++kk)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc_dk[kk][j] = acc_dv[kk][j] = 0.f;

  // the row tiles from the one that holds position k0 on: earlier rows see none of these keys
  for (int R0 = (k0 * rep) / kRows * kRows; R0 < nrows; R0 += kRows) {
    __syncthreads();   // the previous tile's sums are taken (first pass: K, V staged below)
    stage_query_rows<T, DH>(qs, q, b, g, R0, nrows, rep, Tn, NH);
    stage_query_rows<T, DH>(dos, dout, b, g, R0, nrows, rep, Tn, NH);
    if (threadIdx.x < kRows) {
      const int R = R0 + threadIdx.x;
      int pos = -1;
      float a = 0.f, c = 0.f;
      if (R < nrows) {
        pos = R / rep;
        const size_t at = (static_cast<size_t>(b) * NH + g * rep + R % rep) * Tn + pos;
        a = lse[at];
        c = delta[at];
      }
      qpos_s[threadIdx.x] = pos;
      lse_s[threadIdx.x] = a;
      delta_s[threadIdx.x] = c;
    }
    __syncthreads();

    float s[kRW], dp[kRW];
    scores_and_dp<DH>(s, dp, qs, dos, ks, vs, row0, lane);
    const int kpos = k0 + lane;
    const bool kok = kvis[lane] != 0;
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const int r = row0 + i;
      const bool vis = kok && kpos <= qpos_s[r];
      const float p = vis ? expf(s[i] * scale - lse_s[r]) : 0.f;
      ps[r * kPS + lane] = p;
      dss[r * kPS + lane] = p * (dp[i] - delta_s[r]);
    }
    __syncthreads();

    // dv[key] += p[row][key] * do[row], dk[key] += ds[row][key] * q[row] over the 64 rows
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kPS + warp * KW);
      const float4 d4 = *reinterpret_cast<const float4*>(dss + r * kPS + warp * KW);
      const float pk[KW] = {p4.x, p4.y, p4.z, p4.w};
      const float dk4[KW] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int d = lane + 32 * j;
        const float dov = d < DH ? dos[r * DS + d] : 0.f;
        const float qv = d < DH ? qs[r * DS + d] : 0.f;
#pragma unroll
        for (int kk = 0; kk < KW; ++kk) {
          acc_dv[kk][j] = fmaf(pk[kk], dov, acc_dv[kk][j]);
          acc_dk[kk][j] = fmaf(dk4[kk], qv, acc_dk[kk][j]);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KW; ++kk) {
    const int kp = k0 + warp * KW + kk;
    if (kp >= Tn) continue;
    const size_t at = (static_cast<size_t>(b * Tn + kp) * KVH + g) * DH;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = lane + 32 * j;
      if (d < DH) {
        dk[at + d] = from_f32<T>(acc_dk[kk][j] * scale);
        dv[at + d] = from_f32<T>(acc_dv[kk][j]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* key_valid, void* o,
                       void* lse, int B, int Tn, int NH, int KVH, float scale, cudaStream_t st) {
  constexpr int bytes = fwd_smem_floats<DH>() * 4;
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DH>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn * (NH / KVH) + kRows - 1) / kRows, KVH, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(o), static_cast<float*>(lse), Tn,
      NH, KVH, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* key_valid,
                       const void* o, const void* dout, const void* lse, void* delta, void* dq,
                       void* dk, void* dv, int B, int Tn, int NH, int KVH, float scale,
                       cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
  const float* lsep = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);

  const long long rows = static_cast<long long>(B) * Tn * NH;
  const int warps = kThreads / 32;
  flash_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0, st>>>(
      static_cast<const T*>(o), dop, deltap, B, Tn, NH, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dq_bytes = dq_smem_floats<DH>() * 4;
  err = allow_smem(flash_bwd_dq_kernel<T, DH>, dq_bytes);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((Tn * (NH / KVH) + kRows - 1) / kRows, KVH, B);
  flash_bwd_dq_kernel<T, DH><<<qgrid, kThreads, dq_bytes, st>>>(
      qp, kp, vp, valid, dop, lsep, deltap, static_cast<T*>(dq), Tn, NH, KVH, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkv_bytes = dkv_smem_floats<DH>() * 4;
  err = allow_smem(flash_bwd_dkv_kernel<T, DH>, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kgrid((Tn + kKeys - 1) / kKeys, KVH, B);
  flash_bwd_dkv_kernel<T, DH><<<kgrid, kThreads, dkv_bytes, st>>>(
      qp, kp, vp, valid, dop, lsep, deltap, static_cast<T*>(dk), static_cast<T*>(dv), Tn, NH, KVH,
      scale);
  return cudaGetLastError();
}

bool shape_ok(int B, int Tn, int NH, int KVH) {
  return B > 0 && Tn > 0 && NH > 0 && KVH > 0 && NH % KVH == 0 && B <= 65535 && KVH <= 65535;
}

}  // namespace

// q, o: [B, T, NH, DH]; k, v: [B, T, KVH, DH], contiguous, of dtype (AHA_F32 or
// AHA_BF16), 16-byte aligned; key_valid: [B, T] bytes (nonzero = a real key) or
// null; lse: [B, NH, T] f32. DH 16 or 128.
extern "C" int aha_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* key_valid, void* o, void* lse, int B, int T,
                                       int NH, int KVH, int DH, int dtype, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, T, NH, KVH)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == AHA_F32 && DH == 16)
    err = launch_fwd<float, 16>(q, k, v, key_valid, o, lse, B, T, NH, KVH, scale, st);
  else if (dtype == AHA_F32 && DH == 128)
    err = launch_fwd<float, 128>(q, k, v, key_valid, o, lse, B, T, NH, KVH, scale, st);
  else if (dtype == AHA_BF16 && DH == 16)
    err = launch_fwd<__nv_bfloat16, 16>(q, k, v, key_valid, o, lse, B, T, NH, KVH, scale, st);
  else if (dtype == AHA_BF16 && DH == 128)
    err = launch_fwd<__nv_bfloat16, 128>(q, k, v, key_valid, o, lse, B, T, NH, KVH, scale, st);
  return static_cast<int>(err);
}

// As above, plus o and dout [B, T, NH, DH], delta [B, NH, T] f32 scratch, and
// the outputs dq [B, T, NH, DH], dk, dv [B, T, KVH, DH] of dtype. Three
// launches: delta, dq, then dk and dv.
extern "C" int aha_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* key_valid, const void* o, const void* dout,
                                       const void* lse, void* delta, void* dq, void* dk, void* dv,
                                       int B, int T, int NH, int KVH, int DH, int dtype,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, T, NH, KVH)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == AHA_F32 && DH == 16)
    err = launch_bwd<float, 16>(q, k, v, key_valid, o, dout, lse, delta, dq, dk, dv, B, T, NH,
                                KVH, scale, st);
  else if (dtype == AHA_F32 && DH == 128)
    err = launch_bwd<float, 128>(q, k, v, key_valid, o, dout, lse, delta, dq, dk, dv, B, T, NH,
                                 KVH, scale, st);
  else if (dtype == AHA_BF16 && DH == 16)
    err = launch_bwd<__nv_bfloat16, 16>(q, k, v, key_valid, o, dout, lse, delta, dq, dk, dv, B, T,
                                        NH, KVH, scale, st);
  else if (dtype == AHA_BF16 && DH == 128)
    err = launch_bwd<__nv_bfloat16, 128>(q, k, v, key_valid, o, dout, lse, delta, dq, dk, dv, B,
                                         T, NH, KVH, scale, st);
  return static_cast<int>(err);
}
