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
// they share each staged K / V tile, and loops over the key tiles up to its
// last position itself; the ragged last tile and the padding mask are masked
// in the kernel, nothing is padded.
//
// What bounds it on an H100: operations. At T = 926, 28 heads, Dh 128 the
// forward is 4 * NH * T^2 * Dh / 2 = 6.1 GFLOP over 15 MB, far right of the
// roofline's ridge (295 operations a byte in bf16), so the products belong on
// the tensor cores, and what is left beside them (one exponential per score,
// the copies' address arithmetic) decides the time.
//
// bf16 with Dh 128, the 7B's shape, runs on wgmma (section "the tensor-core
// path" below): bf16 tiles as stored, copied by cp.async into a two-stage ring
// of 128-byte-swizzled tiles of 64 keys, both products of each kernel as
// m64n64k16 warpgroup products with f32 accumulators, the first from two tiles
// in shared memory, the second with the rounded accumulator of the first as
// its register operand and the other tile read transposed through its
// descriptor. Softmax state lives in registers, reductions are shuffles within
// a quad, exponentials are ex2.approx with scale * log2(e) folded into one FMA,
// only the diagonal tile and tiles with padded keys are masked, the blocks that
// see the most keys start first. A first version on mma.sync m16n8k16 with
// ldmatrix (16 rows a warp) was built and measured before this one; wgmma with
// the copies' offsets hoisted out of the loop took the forward at T = 926 from
// 0.056 to 0.031 ms and the backward from 0.163 to 0.107 ms (NVIDIA H100 80GB
// HBM3, 700 W), so the mma.sync kernels were dropped. Not done: TMA with a
// producer warp, two warpgroups that alternate on the tensor cores, 128-row
// blocks (with 64 rows at T = 4096 the copies from L2 are near its rate).
//
// The backward is the small delta pass, a dq kernel shaped like the forward,
// and a dk / dv kernel that owns a key tile; no sum crosses blocks out of order
// and no atomic is used, so the result is the same from run to run. The price
// is that the scores and do v^T are computed twice: 7 tile products instead of
// the 5 a fused backward with atomics on dq would need. The dk / dv work of a
// key tile is split over the query heads of its kv head (f32 partials in
// scratch, then a fixed-order sum), which makes 420 blocks of even length
// where 60 would leave half the card idle.
//
// f32 storage (the tiny preset trains in f32 and is held at 1e-4; tensor cores
// would make it TF32) and bf16 with Dh 16 keep f32 arithmetic on the CUDA cores
// (first section): a block of 8 warps owns 64 rows, a warp 8 of them, a lane one
// key of a 32-key tile for the scores and the columns lane, lane + 32, .. for
// the weighted sums; tiles are staged as f32, the probabilities pass through
// shared memory. The entry points choose by dtype and head size.
#include <math.h>

#include "attention.cuh"

namespace {

// ---- f32 storage, and bf16 with Dh 16: f32 arithmetic on the CUDA cores ----------------------

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
  if (DH % 128 == 0) {
    for (int d = lane * 4; d < DH; d += 128) {
      float x[4], y[4];
      load4(a + d, x);
      load4(c + d, y);
      s += x[0] * y[0] + x[1] * y[1] + x[2] * y[2] + x[3] * y[3];
    }
  } else {
    for (int d = lane; d < DH; d += 32) s += to_f32(a[d]) * to_f32(c[d]);
  }
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

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* key_valid, void* o,
                       void* lse, int B, int Tn, int NH, int KVH, float scale, cudaStream_t st) {
  constexpr int bytes = fwd_smem_floats<DH>() * 4;
  cudaError_t err = wg::allow_smem(flash_fwd_kernel<T, DH>, bytes);
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
  err = wg::allow_smem(flash_bwd_dq_kernel<T, DH>, dq_bytes);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((Tn * (NH / KVH) + kRows - 1) / kRows, KVH, B);
  flash_bwd_dq_kernel<T, DH><<<qgrid, kThreads, dq_bytes, st>>>(
      qp, kp, vp, valid, dop, lsep, deltap, static_cast<T*>(dq), Tn, NH, KVH, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkv_bytes = dkv_smem_floats<DH>() * 4;
  err = wg::allow_smem(flash_bwd_dkv_kernel<T, DH>, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kgrid((Tn + kKeys - 1) / kKeys, KVH, B);
  flash_bwd_dkv_kernel<T, DH><<<kgrid, kThreads, dkv_bytes, st>>>(
      qp, kp, vp, valid, dop, lsep, deltap, static_cast<T*>(dk), static_cast<T*>(dv), Tn, NH, KVH,
      scale);
  return cudaGetLastError();
}

// ---- bf16, Dh 128: the tensor-core path (wgmma) -----------------------------------------
//
// A block is one warpgroup that owns 64 rows of a product; wgmma.cuh has the
// primitives, the layout of an accumulator and of a register operand over the
// threads, and the swizzled tile. Here a tile is 64 rows of 128 bf16 as stored,
// kept as two halves of 64 columns (8 KB each), so the tensor cores read it
// either with its columns as the contraction (q k^T, do v^T) or, transposed,
// with its rows as the contraction (p v, ds k, p^T do, ds^T q), without bank
// conflicts and without a transposed copy. Tiles arrive by cp.async, 16 bytes a
// thread, zero-filled past the end of the sequence.
namespace tc {

using namespace attn;   // tiles, copies, warpgroup products: wgmma.cuh; the tile products,
                        // reductions and stores the attention kernels share: attention.cuh
typedef unsigned long long u64;

constexpr u64 kAllKeys = ~0ull;

// rows R0 .. R0 + 63 of group g (row R: position R / rep, head g * rep + R % rep)
__device__ __forceinline__ void load_group_rows(unsigned char* dst, const bf16* __restrict__ src,
                                                int b, int g, int R0, int nrows, int rep, int Tn,
                                                int NH) {
  load_tile_async(dst, [&](int r, bool& ok) {
    const int R = R0 + r;
    ok = R < nrows;
    const int Rc = ok ? R : 0;
    return src + (static_cast<size_t>(b * Tn + Rc / rep) * NH + g * rep + Rc % rep) * kDh;
  });
}

// bit i: key k0 + i exists and is no padding (one warp, all lanes)
__device__ __forceinline__ u64 key_mask(const uint8_t* __restrict__ key_valid, int b, int k0,
                                        int Tn, int lane) {
  if (key_valid == nullptr && k0 + kTile <= Tn) return kAllKeys;
  const int ka = k0 + lane, kb = ka + 32;
  const bool va = ka < Tn && (key_valid == nullptr || key_valid[static_cast<size_t>(b) * Tn + ka]);
  const bool vb = kb < Tn && (key_valid == nullptr || key_valid[static_cast<size_t>(b) * Tn + kb]);
  const unsigned lo = __ballot_sync(0xffffffffu, va), hi = __ballot_sync(0xffffffffu, vb);
  return (static_cast<u64>(hi) << 32) | lo;
}

// s, where the mask hides a key from a row, becomes `hidden`. Rows: this
// thread's, at positions pos_a and pos_b; columns: keys k0 .. k0 + 63, km their
// validity bits.
__device__ __forceinline__ void mask_scores(float (&s)[32], u64 km, int k0, int pos_a, int pos_b,
                                            int tig, float hidden) {
  const u64 mine = km >> (2 * tig);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * tig + (e & 1);
      const bool vis = ((mine >> (8 * j + (e & 1))) & 1ull) && key <= (e < 2 ? pos_a : pos_b);
      s[4 * j + e] = vis ? s[4 * j + e] : hidden;
    }
}

// A warp's 16 finished rows, rows gid and gid + 8 times f0 and f1, out to dst
// [B, T, NH, 128] (store_rows, attention.cuh)
__device__ __forceinline__ void store_group_rows(unsigned char* qs, const float (&lo)[32],
                                                 const float (&hi)[32], float f0, float f1,
                                                 bf16* __restrict__ dst, int b, int g, int R0,
                                                 int nrows, int rep, int Tn, int NH) {
  store_rows(qs, lo, hi, f0, f1, [&](int r) -> bf16* {
    const int R = R0 + r;
    return R < nrows ? dst + (static_cast<size_t>(b * Tn + R / rep) * NH + g * rep + R % rep) * kDh
                     : nullptr;
  });
}

// ---- forward -------------------------------------------------------------------------
//
// A block owns 64 (position, head) rows of one (batch, kv head) and walks the
// 64-key tiles up to its last position: s = q k(t)^T, online softmax in
// registers, o += p v(t). K runs one tile ahead of V in the two-stage ring, so
// that q k(t)^T and p(t - 1) v(t - 1) are in the tensor cores together and the
// exponentials of tile t are taken beside the second.

constexpr int fwd_smem_bytes() { return 5 * kTileBytes + 16 + kAlignSlack; }

__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                       bf16* __restrict__ o, float* __restrict__ lse, int Tn, int NH, int KVH,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* qs = align_tiles(smem_tc);
  unsigned char* ks = qs + kTileBytes;       // two stages
  unsigned char* vs = ks + 2 * kTileBytes;   // two stages
  u64* kmask = reinterpret_cast<u64*>(vs + 2 * kTileBytes);   // [2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int rep = NH / KVH, g = blockIdx.y, b = blockIdx.z, nrows = Tn * rep;
  // the last rows see the most keys: their blocks start first
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kTile, row0 = warp * 16;
  const int ntiles = min(Tn - 1, (R0 + kTile - 1) / rep) / kTile + 1;
  const float sl2 = scale * kLog2e;

  const TileCopy copy(static_cast<size_t>(KVH) * kDh);
  const size_t kv0 = (static_cast<size_t>(b) * Tn * KVH + g) * kDh;   // key 0 of this kv head
  auto load_keys = [&](const bf16* src, unsigned char* stages, int t) {
    copy(stages + (t & 1) * kTileBytes, src + kv0 + static_cast<size_t>(t) * kTile * KVH * kDh,
         Tn - t * kTile);
  };
  auto load_k = [&](int t) {
    load_keys(k, ks, t);
    if (warp == 0) {
      const u64 m = key_mask(key_valid, b, t * kTile, Tn, lane);
      if (lane == 0) kmask[t & 1] = m;
    }
  };
  load_group_rows(qs, q, b, g, R0, nrows, rep, Tn, NH);
  load_k(0);
  cp_async_commit();

  // this thread's two rows; a row past the end takes the last position and is never written
  const int Ra = R0 + row0 + gid, Rb = Ra + 8;
  const int pos_a = min(Ra, nrows - 1) / rep, pos_b = min(Rb, nrows - 1) / rep;
  const int warp_first = min(R0 + row0, nrows - 1) / rep;

  float o_lo[32], o_hi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_lo[i] = o_hi[i] = 0.f;
  // running maxima (of the unscaled scores) and this thread's share of the row sums
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t pa[4][4];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // k(t) and v(t - 1) have arrived; k(t - 1) and v(t - 2) are consumed
    if (t + 1 < ntiles) load_k(t + 1);
    load_keys(v, vs, t);
    cp_async_commit();

    float s[32];
    wg_fence();
    wg_products_nt(s, qs, ks + (t & 1) * kTileBytes);
    wg_commit();
    if (t > 0) {
      wg_products_pn(o_lo, o_hi, pa, vs + ((t - 1) & 1) * kTileBytes);
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    keep(s);

    // masked only on the diagonal and where keys are padding or past the end
    const int k0 = t * kTile;
    const u64 km = kmask[t & 1];
    if (km != kAllKeys || k0 + kTile - 1 > warp_first)
      mask_scores(s, km, k0, pos_a, pos_b, tig, -INFINITY);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    // p = 2^(s sl2 - m sl2); while a row has seen no key its maximum stays -inf: subtract 0
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a * sl2;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b * sl2;
    const float al_a = fast_exp2(m_a * sl2 - mu_a), al_b = fast_exp2(m_b * sl2 - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], sl2, -mu_a));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sl2, -mu_a));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sl2, -mu_b));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sl2, -mu_b));
      sum_a += s[4 * j] + s[4 * j + 1];
      sum_b += s[4 * j + 2] + s[4 * j + 3];
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;

    wg_wait<0>();      // p(t - 1) v(t - 1) is in o
    keep(o_lo);
    keep(o_hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o_lo[4 * j] *= al_a; o_lo[4 * j + 1] *= al_a; o_lo[4 * j + 2] *= al_b; o_lo[4 * j + 3] *= al_b;
      o_hi[4 * j] *= al_a; o_hi[4 * j + 1] *= al_a; o_hi[4 * j + 2] *= al_b; o_hi[4 * j + 3] *= al_b;
    }
    wg_round(pa, s);   // p, rounded to bf16, is the A operand of p v
  }
  cp_async_wait_all();
  __syncthreads();     // the last v has arrived
  keep(o_lo);
  keep(o_hi);
  wg_fence();
  wg_products_pn(o_lo, o_hi, pa, vs + ((ntiles - 1) & 1) * kTileBytes);
  wg_commit();
  wg_wait<0>();
  keep(o_lo);
  keep(o_hi);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (tig == 0) {
    if (Ra < nrows)
      lse[(static_cast<size_t>(b) * NH + g * rep + Ra % rep) * Tn + pos_a] =
          l_a > 0.f ? m_a * scale + logf(l_a) : -INFINITY;
    if (Rb < nrows)
      lse[(static_cast<size_t>(b) * NH + g * rep + Rb % rep) * Tn + pos_b] =
          l_b > 0.f ? m_b * scale + logf(l_b) : -INFINITY;
  }
  store_group_rows(qs, o_lo, o_hi, l_a > 0.f ? 1.f / l_a : 0.f, l_b > 0.f ? 1.f / l_b : 0.f, o, b,
                   g, R0, nrows, rep, Tn, NH);
}

// ---- backward: dq ----------------------------------------------------------------------
//
// The forward's shape: a block owns 64 rows with their q and do, and per key
// tile computes s = q k^T and dp = do v^T, p = 2^((s scale - lse) log2 e),
// ds = p (dp - delta) in registers, and dq += ds k with K read transposed.

constexpr int dq_smem_bytes() { return 6 * kTileBytes + 16 + kAlignSlack; }

__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int Tn, int NH,
                          int KVH, float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* qs = align_tiles(smem_tc);
  unsigned char* dos = qs + kTileBytes;
  unsigned char* ks = dos + kTileBytes;      // two stages
  unsigned char* vs = ks + 2 * kTileBytes;   // two stages
  u64* kmask = reinterpret_cast<u64*>(vs + 2 * kTileBytes);   // [2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int rep = NH / KVH, g = blockIdx.y, b = blockIdx.z, nrows = Tn * rep;
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kTile, row0 = warp * 16;
  const int ntiles = min(Tn - 1, (R0 + kTile - 1) / rep) / kTile + 1;
  const float sl2 = scale * kLog2e;

  const TileCopy copy(static_cast<size_t>(KVH) * kDh);
  const size_t kv0 = (static_cast<size_t>(b) * Tn * KVH + g) * kDh;
  auto load_kv = [&](int t) {
    const size_t at = kv0 + static_cast<size_t>(t) * kTile * KVH * kDh;
    copy(ks + (t & 1) * kTileBytes, k + at, Tn - t * kTile);
    copy(vs + (t & 1) * kTileBytes, v + at, Tn - t * kTile);
    if (warp == 0) {
      const u64 m = key_mask(key_valid, b, t * kTile, Tn, lane);
      if (lane == 0) kmask[t & 1] = m;
    }
    cp_async_commit();
  };
  load_group_rows(qs, q, b, g, R0, nrows, rep, Tn, NH);
  load_group_rows(dos, dout, b, g, R0, nrows, rep, Tn, NH);
  load_kv(0);

  const int Ra = R0 + row0 + gid, Rb = Ra + 8;
  const int pos_a = min(Ra, nrows - 1) / rep, pos_b = min(Rb, nrows - 1) / rep;
  const int warp_first = min(R0 + row0, nrows - 1) / rep;
  // lse in units of log 2, and delta; a row past the end gets 0 and 0
  float lse_a = 0.f, lse_b = 0.f, dl_a = 0.f, dl_b = 0.f;
  if (Ra < nrows) {
    const size_t at = (static_cast<size_t>(b) * NH + g * rep + Ra % rep) * Tn + pos_a;
    lse_a = lse[at] * kLog2e;
    dl_a = delta[at];
  }
  if (Rb < nrows) {
    const size_t at = (static_cast<size_t>(b) * NH + g * rep + Rb % rep) * Tn + pos_b;
    lse_b = lse[at] * kLog2e;
    dl_b = delta[at];
  }

  float dq_lo[32], dq_hi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_lo[i] = dq_hi[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    wg_wait<0>();      // ds(t - 1) k(t - 1) has read its stage
    __syncthreads();
    if (t + 1 < ntiles) load_kv(t + 1);
    const unsigned char* kt = ks + (t & 1) * kTileBytes;

    float s[32], dp[32];
    keep(dq_lo);
    keep(dq_hi);
    wg_fence();
    wg_products_nt(s, qs, kt);                              // s = q k^T
    wg_products_nt(dp, dos, vs + (t & 1) * kTileBytes);     // dp = do v^T
    wg_commit();
    wg_wait<0>();
    keep(s);
    keep(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], sl2, -lse_a));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sl2, -lse_a));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sl2, -lse_b));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sl2, -lse_b));
    }
    const int k0 = t * kTile;
    const u64 km = kmask[t & 1];
    if (km != kAllKeys || k0 + kTile - 1 > warp_first)
      mask_scores(s, km, k0, pos_a, pos_b, tig, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] *= dp[4 * j] - dl_a;
      s[4 * j + 1] *= dp[4 * j + 1] - dl_a;
      s[4 * j + 2] *= dp[4 * j + 2] - dl_b;
      s[4 * j + 3] *= dp[4 * j + 3] - dl_b;
    }
    uint32_t da[4][4];
    wg_round(da, s);   // ds, rounded to bf16, is the A operand of ds k
    wg_fence();
    wg_products_pn(dq_lo, dq_hi, da, kt);
    wg_commit();
  }
  wg_wait<0>();
  keep(dq_lo);
  keep(dq_hi);
  store_group_rows(qs, dq_lo, dq_hi, scale, scale, dq, b, g, R0, nrows, rep, Tn, NH);
}

// ---- backward: dk and dv -------------------------------------------------------------------
//
// A block owns 64 keys of one kv head and ONE of the rep query heads that read
// them (grid: key tiles x NH x B; the first key tile, which every position
// sees, starts first), a warp 16 of the keys. It walks the tiles of 64
// positions from the diagonal on, q and do of its head arriving through the
// two-stage ring, computes the transposed s^T = k q^T and dp^T = v do^T, and
// dv += p^T do, dk += ds^T q with the position tiles read transposed. Its f32
// partial dk and dv go to scratch [2, B, T, NH, 128]; flash_bwd_sum_heads adds
// the rep partials of a kv head in a fixed order. 420 even blocks at T = 926
// where a block per (key tile, kv head) would be 60.

constexpr int dkv_smem_bytes() { return 6 * kTileBytes + 4 * kTile * 4 + 16 + kAlignSlack; }

__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                           const bf16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ part_dk,
                           float* __restrict__ part_dv, int Tn, int NH, int KVH, float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* ks = align_tiles(smem_tc);
  unsigned char* vs = ks + kTileBytes;
  unsigned char* qs = vs + kTileBytes;             // two stages
  unsigned char* dos = qs + 2 * kTileBytes;        // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileBytes);   // [2][64]
  float* delta_s = lse_s + 2 * kTile;                              // [2][64]
  u64* kmask = reinterpret_cast<u64*>(delta_s + 2 * kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int rep = NH / KVH, h = blockIdx.y, g = h / rep, b = blockIdx.z;
  const int tile0 = blockIdx.x, k0 = tile0 * kTile, key0 = warp * 16;
  const int ntiles = (Tn + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;

  const TileCopy copy_rows(static_cast<size_t>(NH) * kDh);
  const size_t head0 = (static_cast<size_t>(b) * Tn * NH + h) * kDh;   // position 0 of head h
  auto load_rows = [&](int t) {
    const int st = t & 1, p0 = t * kTile;
    const size_t at = head0 + static_cast<size_t>(p0) * NH * kDh;
    copy_rows(qs + st * kTileBytes, q + at, Tn - p0);
    copy_rows(dos + st * kTileBytes, dout + at, Tn - p0);
    // lse and delta of the tile's positions; zeros past the end
    const int r = threadIdx.x & (kTile - 1);
    const bool ok = p0 + r < Tn;
    const size_t ld = (static_cast<size_t>(b) * NH + h) * Tn + (ok ? p0 + r : 0);
    if (threadIdx.x < kTile) cp_async4(smem_addr(lse_s + st * kTile + r), lse + ld, ok);
    else cp_async4(smem_addr(delta_s + st * kTile + r), delta + ld, ok);
    cp_async_commit();
  };
  {
    const TileCopy copy_keys(static_cast<size_t>(KVH) * kDh);
    const size_t at = (static_cast<size_t>(b * Tn + k0) * KVH + g) * kDh;
    copy_keys(ks, k + at, Tn - k0);
    copy_keys(vs, v + at, Tn - k0);
  }
  if (warp == 0) {
    const u64 m = key_mask(key_valid, b, k0, Tn, lane);
    if (lane == 0) kmask[0] = m;
  }
  load_rows(tile0);

  float dk_lo[32], dk_hi[32], dv_lo[32], dv_hi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_lo[i] = dk_hi[i] = dv_lo[i] = dv_hi[i] = 0.f;

  for (int t = tile0; t < ntiles; ++t) {
    cp_async_wait_all();
    wg_wait<0>();      // the products of tile t - 1 have read their stage
    __syncthreads();
    if (t + 1 < ntiles) load_rows(t + 1);
    const int st = t & 1, p0 = t * kTile;
    const unsigned char* qt = qs + st * kTileBytes;
    const unsigned char* dot = dos + st * kTileBytes;
    const float* lse_t = lse_s + st * kTile;
    const float* delta_t = delta_s + st * kTile;

    // transposed: rows are this block's keys, columns the tile's positions
    float s[32], dp[32];
    keep(dk_lo);
    keep(dk_hi);
    keep(dv_lo);
    keep(dv_hi);
    wg_fence();
    wg_products_nt(s, ks, qt);      // s^T = k q^T
    wg_products_nt(dp, vs, dot);    // dp^T = v do^T
    wg_commit();
    wg_wait<0>();
    keep(s);
    keep(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * tig);
      const float lx = l2.x * kLog2e, ly = l2.y * kLog2e;
      s[4 * j] = fast_exp2(fmaf(s[4 * j], sl2, -lx));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sl2, -ly));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sl2, -lx));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sl2, -ly));
    }
    // masked only on the diagonal and where this block's keys are padding or past the end
    const u64 km = kmask[0];
    if (km != kAllKeys || t == tile0) {
      const bool vis_a = (km >> (key0 + gid)) & 1ull, vis_b = (km >> (key0 + gid + 8)) & 1ull;
      const int key_a = k0 + key0 + gid;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = p0 + 8 * j + 2 * tig + (e & 1);
          const bool vis = e < 2 ? vis_a && key_a <= pos : vis_b && key_a + 8 <= pos;
          s[4 * j + e] = vis ? s[4 * j + e] : 0.f;
        }
    }
    uint32_t pa[4][4], da[4][4];
    wg_round(pa, s);   // p^T, rounded to bf16
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * j + 2 * tig);
      s[4 * j] *= dp[4 * j] - d2.x;
      s[4 * j + 1] *= dp[4 * j + 1] - d2.y;
      s[4 * j + 2] *= dp[4 * j + 2] - d2.x;
      s[4 * j + 3] *= dp[4 * j + 3] - d2.y;
    }
    wg_round(da, s);   // ds^T, rounded to bf16
    wg_fence();
    wg_products_pn(dv_lo, dv_hi, pa, dot);   // dv += p^T do
    wg_products_pn(dk_lo, dk_hi, da, qt);    // dk += ds^T q
    wg_commit();
  }
  wg_wait<0>();
  keep(dk_lo);
  keep(dk_hi);
  keep(dv_lo);
  keep(dv_hi);

  // f32 partials of this head: a quad writes 32 contiguous bytes
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + key0 + gid + 8 * half;
    if (key >= Tn) continue;
    const size_t at = (static_cast<size_t>(b * Tn + key) * NH + h) * kDh + 2 * tig;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = 4 * j + 2 * half;
      *reinterpret_cast<float2*>(part_dk + at + 8 * j) = make_float2(dk_lo[e], dk_lo[e + 1]);
      *reinterpret_cast<float2*>(part_dk + at + 64 + 8 * j) = make_float2(dk_hi[e], dk_hi[e + 1]);
      *reinterpret_cast<float2*>(part_dv + at + 8 * j) = make_float2(dv_lo[e], dv_lo[e + 1]);
      *reinterpret_cast<float2*>(part_dv + at + 64 + 8 * j) = make_float2(dv_hi[e], dv_hi[e + 1]);
    }
  }
}

// dk[b, t, g] = scale * sum over the rep heads of g, in order, of part_dk[b, t, g * rep + r];
// dv likewise without the scale. One thread per four columns.
__global__ void flash_bwd_sum_heads(const float* __restrict__ part_dk,
                                    const float* __restrict__ part_dv, bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, size_t quads, int rep, float scale) {
  constexpr int Q4 = kDh / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < quads;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / Q4, c = (i % Q4) * 4;   // row = (b * T + t) * KVH + g
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), d = a;
    for (int r = 0; r < rep; ++r) {
      const size_t at = (row * rep + r) * kDh + c;
      const float4 x = *reinterpret_cast<const float4*>(part_dk + at);
      const float4 y = *reinterpret_cast<const float4*>(part_dv + at);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      d.x += y.x; d.y += y.y; d.z += y.z; d.w += y.w;
    }
    *reinterpret_cast<uint2*>(dk + row * kDh + c) =
        make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
    *reinterpret_cast<uint2*>(dv + row * kDh + c) =
        make_uint2(pack_bf16(d.x, d.y), pack_bf16(d.z, d.w));
  }
}

}  // namespace tc

// ---- launchers of the tensor-core path ---------------------------------------------------

cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, const void* key_valid,
                          void* o, void* lse, int B, int Tn, int NH, int KVH, float scale,
                          cudaStream_t st) {
  using tc::bf16;
  cudaError_t err = wg::allow_smem(tc::flash_fwd_wgmma_kernel, tc::fwd_smem_bytes());
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn * (NH / KVH) + tc::kTile - 1) / tc::kTile, KVH, B);
  tc::flash_fwd_wgmma_kernel<<<grid, tc::kWgThreads, tc::fwd_smem_bytes(), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<bf16*>(o), static_cast<float*>(lse), Tn,
      NH, KVH, scale);
  return cudaGetLastError();
}

// f32 partial dk and dv, [2, B, T, NH, 128]
size_t bwd_tc_scratch_bytes(int B, int Tn, int NH) {
  return 2 * static_cast<size_t>(B) * Tn * NH * tc::kDh * sizeof(float);
}

cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* key_valid,
                          const void* o, const void* dout, const void* lse, void* delta,
                          void* scratch, void* dq, void* dk, void* dv, int B, int Tn, int NH,
                          int KVH, float scale, cudaStream_t st) {
  using tc::bf16;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
  const float* lsep = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);
  float* part_dk = static_cast<float*>(scratch);
  float* part_dv = part_dk + static_cast<size_t>(B) * Tn * NH * tc::kDh;

  const long long rows = static_cast<long long>(B) * Tn * NH;
  const int warps = kThreads / 32;
  flash_delta_kernel<bf16><<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0, st>>>(
      static_cast<const bf16*>(o), dop, deltap, B, Tn, NH, tc::kDh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = wg::allow_smem(tc::flash_bwd_dq_wgmma_kernel, tc::dq_smem_bytes());
  if (err != cudaSuccess) return err;
  const dim3 qgrid((Tn * (NH / KVH) + tc::kTile - 1) / tc::kTile, KVH, B);
  tc::flash_bwd_dq_wgmma_kernel<<<qgrid, tc::kWgThreads, tc::dq_smem_bytes(), st>>>(
      qp, kp, vp, valid, dop, lsep, deltap, static_cast<bf16*>(dq), Tn, NH, KVH, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = wg::allow_smem(tc::flash_bwd_dkv_wgmma_kernel, tc::dkv_smem_bytes());
  if (err != cudaSuccess) return err;
  const dim3 kgrid((Tn + tc::kTile - 1) / tc::kTile, NH, B);
  tc::flash_bwd_dkv_wgmma_kernel<<<kgrid, tc::kWgThreads, tc::dkv_smem_bytes(), st>>>(
      qp, kp, vp, valid, dop, lsep, deltap, part_dk, part_dv, Tn, NH, KVH, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t quads = static_cast<size_t>(B) * Tn * KVH * (tc::kDh / 4);
  const size_t want = (quads + 255) / 256;
  tc::flash_bwd_sum_heads<<<static_cast<unsigned>(want < 65535 ? want : 65535), 256, 0, st>>>(
      part_dk, part_dv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), quads, NH / KVH, scale);
  return cudaGetLastError();
}

bool shape_ok(int B, int Tn, int NH, int KVH) {
  return B > 0 && Tn > 0 && NH > 0 && KVH > 0 && NH % KVH == 0 && B <= 65535 && NH <= 65535;
}

}  // namespace

// q, o: [B, T, NH, DH]; k, v: [B, T, KVH, DH], contiguous, of dtype (AHA_F32 or
// AHA_BF16), 16-byte aligned; key_valid: [B, T] bytes (nonzero = a real key) or
// null; lse: [B, NH, T] f32. DH 16 or 128. bf16 with DH 128 runs on the tensor
// cores, everything else in f32 on the CUDA cores.
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
    err = launch_fwd_tc(q, k, v, key_valid, o, lse, B, T, NH, KVH, scale, st);
  return static_cast<int>(err);
}

// Bytes of scratch the backward needs for these shapes (0: none).
extern "C" long long aha_flash_attention_bwd_scratch_bytes(int B, int T, int NH, int DH,
                                                           int dtype) {
  if (dtype == AHA_BF16 && DH == 128) return static_cast<long long>(bwd_tc_scratch_bytes(B, T, NH));
  return 0;
}

// As above, plus o and dout [B, T, NH, DH], delta [B, NH, T] f32 scratch,
// scratch of aha_flash_attention_bwd_scratch_bytes bytes (may be null where
// that is 0), and the outputs dq [B, T, NH, DH], dk, dv [B, T, KVH, DH] of
// dtype. Launches: delta, dq, then dk and dv (on the tensor-core path: per
// query head into scratch, then the sum over a kv head's query heads).
extern "C" int aha_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* key_valid, const void* o, const void* dout,
                                       const void* lse, void* delta, void* scratch, void* dq,
                                       void* dk, void* dv, int B, int T, int NH, int KVH, int DH,
                                       int dtype, float scale, void* stream) {
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
    err = launch_bwd_tc(q, k, v, key_valid, o, dout, lse, delta, scratch, dq, dk, dv, B, T, NH,
                        KVH, scale, st);
  return static_cast<int>(err);
}
