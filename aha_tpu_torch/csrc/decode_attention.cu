// Cached GQA attention of S query rows against the ring-buffer KV cache.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/decode_attention.py::
// cached_decode_attention (_kernel): for each (batch row, kv head) the
// n_rep query heads that share the kv head are grouped onto rows, ordered
// (rep, s); cached keys get a per-slot residual RoPE rotation (rotate-half,
// cos/sin tables per slot); a slot is visible to a row iff
// order[slot] >= 0 && order[slot] <= g[row]; softmax is online; the output
// is P.V normalised by the row sum, and a row that sees no slot gives zeros.
// In int8 KV mode the per-(slot, head) K scales multiply the score columns
// and the V scales the probability columns.
//
// What bounds it on an H100: bytes. One layer's cache is 2049 slots x 4 kv
// heads x 128 x 2 (K, V) x 2 bytes = 4.2 MB in bf16 for the 7B, read in about
// 1.3 us at 3.35 TB/s; the products are 4 x rows x visible slots x 128
// operations, 1.4 GFLOP at 49 rows (1.5 us on the tensor cores, 21 us in f32 on
// the CUDA cores). The TPU kernel walks the slots as the sequential axis of its
// grid and carries the softmax state in scratch from one step to the next; on
// this card that leaves one block per (row tile, kv head, batch row): 4 blocks
// on 132 SMs for a token. So here the window is split over blocks
// (flash-decoding) and every block of a (row tile, kv head, batch row) owns one
// contiguous slot range:
//
//   1. each block walks its range in slot tiles and keeps its rows' running
//      maximum m, sum l and f32 accumulator; with one split it normalises and
//      writes the output itself, else it writes (m, l, acc) to scratch;
//   2. a merge kernel combines the splits of each row in split order:
//      M = max m_i, l = sum l_i e^(m_i - M), o = sum acc_i e^(m_i - M) / max(l, 1e-30);
//      a split in which a row saw nothing has m = -inf and adds nothing, a
//      row that saw nothing anywhere gives zeros. No atomics: two launches on
//      the same inputs give the same bits.
//
// The wrapper (ops/kernels/decode_attention.py::plan) picks the path, the
// slots per split and the number of splits (as many as one round of resident
// blocks holds, 4 a SM on the CUDA cores, 2 on the bf16 tensor-core path and 1
// on the f32 one, with at least 3 slot tiles a split on the tensor cores; one
// split, and no merge, where the row tiles fill the round; a token: 65 splits
// of 32 slots, 260 blocks) and allocates the scratch, whose size comes from
// aha_decode_attention_steps_scratch_bytes. One C call launches what a path needs;
// splits start on slot-tile boundaries, and the ragged end of the 2049-slot
// cache is masked in the kernels, not padded.
//
// The verify pass's form (aha_decode_attention_steps): the rows of n composed
// steps of S rows each (a fused pass: 4 frames of 49 rows; speculative generation:
// 4 or 8 tokens) in one launch, read-only. Step j's rows attend as its write pass
// would: its own rotation tables, order and g, and the cache with the in-flight
// rows of the steps up to j at their slots, as the write passes would have stored
// them (src [n, B, Wp]: the in-flight row a slot holds in step j, -1 for the
// cache's own; the rows come in the cache's type, rounded as a write rounds
// them). The steps sit side by side on the grid's third axis, each with the
// write pass's plan of S rows (path, slot tiles, splits) and merged in its order,
// so that each row gets its write pass's bits. Where keys are rotated into
// scratch, each step has its own rotated copy (the rotation reads each slot from
// its source); values that are read as they lie (a bf16 cache) come slot by slot
// from the cache or the in-flight rows, by cp.async from either address. A write
// pass is one step with no in-flight rows.
//
// Three paths:
//
// * Tensor cores (wgmma), bf16 q at head size 128 with a bf16 or int8 cache,
//   from 16 rows per kv head on (S = 13 .. 220 on the 7B: 91 .. 1540 rows). A
//   first kernel rotates every cached key once, in f32 from the f32 tables,
//   and rounds it to bf16 into scratch (an int8 V is widened to bf16 there,
//   exactly); then a block is one warpgroup that owns 64 rows, as the flash
//   forward (flash_attention.cu) is: the rotated K and the V tiles of 64 slots
//   arrive by cp.async in a two-stage ring of 128-byte-swizzled tiles,
//   s = q k^T is a warpgroup product of two tiles in shared memory, the
//   online softmax runs in registers (order / g mask and int8 K scales on the
//   score columns), and o += p v takes p, times the int8 V scales and rounded
//   to bf16, as its register operand and V through its descriptor. The
//   rotated K and p are rounded to bf16 where the TPU kernel rounds them
//   (k_rot.astype(cdt), pv.astype(cdt)). Rotating in the attention blocks
//   themselves would make every row tile and every kv head read the f32
//   tables again: 64 of every 96 KB a slot tile brings, three times the
//   traffic of the rotated bf16 key.
// * Tensor cores, f32 q at head size 128 with a bf16 or f32 cache, from 16
//   rows per kv head on: the frame chunks behind a peft artifact's f32
//   projector (f32 q, the bf16 cache read as it lies) and the local judge's
//   f32 cache. The TPU kernel keeps everything f32 here (cdt = f32: the
//   rotated key and p are not rounded), which the H100 offers only on the
//   CUDA cores (67 TFLOP/s); so every f32 operand goes to the bf16 tensor
//   cores as planes whose sum is the value, and the products of the planes
//   add into f32 accumulators:
//   - q: three planes hi + mid + lo == q (split3, as split_bf16x3 writes
//     them), split as the block loads its rows;
//   - the rotated key: two planes hi + lo, written by the rotation kernel
//     (16 significant bits, |k - hi - lo| <= 2^-18 |k|). On ring slots the
//     residual rotation is the identity (cos 1, sin 0), the key is the bf16
//     cache value and lo is 0: there s is q k exactly, but for the f32 sums.
//     Rotating in the blocks would read the f32 tables once a row tile, as
//     above; two planes are the bytes of one f32 key. s = (hi + mid + lo) k_hi
//     + (hi + mid) k_lo, five products (lo k_lo, below 2^-26 of q k, is left);
//   - p: three planes in the register operand of o += p v, so p stays f32;
//   - V: a bf16 cache as it lies (exact, three products); an f32 cache as two
//     planes written beside the key's, o += (p_hi + p_mid + p_lo) v_hi + p_hi
//     v_lo (four products; p_mid v_lo is below 2^-17 of p v, as the residual
//     of v's planes is).
//   The accumulators add in f32 the tensor cores' way, and their error grows
//   with the k16 steps a sum takes: a tile's scores add the small products
//   first, then q_hi k_hi; o takes 12 steps a tile (16 with an f32 V) over up
//   to 65 tiles (the judge's window of 4,097 slots).
//   Three q planes and two stages of two key planes and one or two V planes
//   take 144 or 176 KB of shared memory: one block a SM. The output is f32.
//   What bounds it: at a frame chunk, as on the bf16 path, the bytes and a
//   tile's chain of copies, products and softmax; at the judge's rubric prefix
//   (1,695 rows) the products, nine bf16 ones a tile where the TPU kernel does
//   two f32 ones: 0.36 ms at the bf16 peak, where the f32 peak allows 1.18.
// * CUDA cores, f32 arithmetic, everything else: fewer than 16 rows (S = 1
//   and 2 on the 7B: a token, 7 rows), head sizes 16 / 32 / 64, an int8 cache
//   under f32 q. A block of 4 warps owns 16 rows and walks its slot range in
//   tiles of 32: the tile's K (rotated in f32 from its own cos / sin) and V
//   are staged in shared memory with 4-element vector loads (a bf16 or int8
//   cache widened to f32 there, exactly), each warp scores its 4 rows against
//   the 32 slots (one slot per lane), updates the running max / sum with warp
//   shuffles and accumulates P.V with each lane owning Dh/32 output dims. Only
//   the order of the f32 sums differs from the plain version.
#include <math.h>

#include "attention.cuh"

namespace {

enum Path { kCudaCores = 0, kWgmma = 1, kWgmmaF32 = 2 };

// The composed steps of a verify pass; a write pass is one step with src nullptr.
struct Steps {
  const int* src;   // [n, B, Wp]: the in-flight row slot w of row b holds in step j, or -1
  const void* ki;   // in-flight keys (pre-rotated) and values [B, N, KVH, Dh], the cache's type
  const void* vi;
  int N;            // rows of q, g and out a batch row: n x S
  int BK;           // B * KVH: the blocks of one step along the grid's third axis
};

// ---- merge: the splits of each row, in split order ----------------------------------
//
// part_o [n * B * KVH][splits][M][Dh] f32, part_ml [n * B * KVH][splits][M][2] (m, l);
// m is the running maximum of the scaled scores, in log2 units when log2dom
// (the tensor-core kernel's), natural ones otherwise. One warp a row, a lane V
// neighbouring dims: the lanes read the splits' maxima and weights side by
// side, then the sums run over the splits in split order, the weights handed
// out by shuffles, so that the loads of many splits' partials are in flight
// together.
template <int V> struct Vec;
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[1]) { o[0] = *p; }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
};
template <> struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <typename QT, int DH>
__global__ void __launch_bounds__(128)
decode_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                    QT* __restrict__ out, int rows, int M, int S, int NH, int KVH, int splits,
                    int log2dom, int N, int BK) {
  constexpr int V = DH >= 128 ? 4 : (DH >= 64 ? 2 : 1);   // dims a lane owns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * 4 + warp;
  if (r >= rows) return;
  const bool owner = lane * V < DH;
  // z: (step, batch row, kv head), as the attention blocks' third axis
  const int z = r / M, R = r % M, jstep = z / BK, bk = z - jstep * BK, b = bk / KVH, kvh = bk % KVH;
  const size_t base = static_cast<size_t>(z) * splits * M + R;   // split i: base + i * M
  float mx = -INFINITY;
#pragma unroll 4
  for (int i = lane; i < splits; i += 32) mx = fmaxf(mx, part_ml[2 * (base + static_cast<size_t>(i) * M)]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float l = 0.f, acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (mx != -INFINITY) {   // else the row saw no slot: zeros
    for (int c0 = 0; c0 < splits; c0 += 32) {
      float w = 0.f, li = 0.f;   // split c0 + lane's weight (0 where it saw nothing) and sum
      if (c0 + lane < splits) {
        const size_t p = base + static_cast<size_t>(c0 + lane) * M;
        const float mi = part_ml[2 * p];
        w = log2dom ? exp2f(mi - mx) : expf(mi - mx);
        li = part_ml[2 * p + 1];
      }
      const int n = min(32, splits - c0);
#pragma unroll 16
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j), lj = __shfl_sync(0xffffffffu, li, j);
        l = fmaf(lj, wj, l);
        if (owner) {
          float x[V];
          Vec<V>::load(part_o + (base + static_cast<size_t>(c0 + j) * M) * DH + lane * V, x);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(x[e], wj, acc[e]);
        }
      }
    }
  }
  if (!owner) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const int n_rep = NH / KVH, rep = R / S, s = R % S;
  QT* o = out + ((static_cast<size_t>(b) * N + jstep * S + s) * NH + kvh * n_rep + rep) * DH + lane * V;
#pragma unroll
  for (int e = 0; e < V; ++e) o[e] = from_f32<QT>(acc[e] * inv);
}

template <typename QT>
cudaError_t launch_merge(const float* part_o, const float* part_ml, QT* out, int B, int S, int NH,
                         int KVH, int Dh, int splits, bool log2dom, int steps, cudaStream_t st) {
  const int M = (NH / KVH) * S, rows = steps * B * KVH * M, N = steps * S, BK = B * KVH;
  const int blocks = (rows + 3) / 4;
  switch (Dh) {
    case 16: decode_merge_kernel<QT, 16><<<blocks, 128, 0, st>>>(part_o, part_ml, out, rows, M, S, NH, KVH, splits, log2dom, N, BK); break;
    case 32: decode_merge_kernel<QT, 32><<<blocks, 128, 0, st>>>(part_o, part_ml, out, rows, M, S, NH, KVH, splits, log2dom, N, BK); break;
    case 64: decode_merge_kernel<QT, 64><<<blocks, 128, 0, st>>>(part_o, part_ml, out, rows, M, S, NH, KVH, splits, log2dom, N, BK); break;
    case 128: decode_merge_kernel<QT, 128><<<blocks, 128, 0, st>>>(part_o, part_ml, out, rows, M, S, NH, KVH, splits, log2dom, N, BK); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- CUDA cores: f32 arithmetic ------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBW = 32;                        // cache slots per tile
constexpr int kThreads = kWarps * 32;

// grid (splits, row tiles, n * B * KVH); the split owns slots [split * span, min(Wp, + span))
template <typename QT, typename KT, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ kc,
                        const KT* __restrict__ vc, const float* __restrict__ cosb,
                        const float* __restrict__ sinb, const int* __restrict__ order,
                        const int* __restrict__ g, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, QT* __restrict__ out,
                        float* __restrict__ part_o, float* __restrict__ part_ml, int S, int NH,
                        int KVH, int Wp, int span, float scale, Steps st) {
  constexpr int DPL = (DH + 31) / 32;  // output dims per lane
  constexpr int HALF = DH / 2;
  const int split = blockIdx.x, tile = blockIdx.y, z = blockIdx.z;
  const int jstep = z / st.BK, bk = z - jstep * st.BK;   // step, (batch row, kv head)
  const int b = bk / KVH, kvh = bk % KVH;
  // the step's tables; its rows of q, g and out start at row qrow of the batch row
  const size_t tab = static_cast<size_t>(jstep) * (st.BK / KVH) * Wp;
  cosb += tab * DH;
  sinb += tab * DH;
  order += tab;
  const int* src = st.src != nullptr ? st.src + tab : nullptr;
  const KT* ki = static_cast<const KT*>(st.ki);
  const KT* vi = static_cast<const KT*>(st.vi);
  const int qrow = b * st.N + jstep * S;
  const int n_rep = NH / KVH;
  const int M = n_rep * S;
  const int w_begin = split * span, w_end = min(Wp, w_begin + span);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  __shared__ __align__(16) float q_s[kRows][DH];
  // K rows padded to DH + 4 floats: 16-byte rows, and a lane-per-slot
  // float4 read touches distinct banks in each quarter warp
  __shared__ __align__(16) float k_s[kBW][DH + 4];
  __shared__ __align__(16) float v_s[kBW][DH];
  __shared__ int g_s[kRows];
  __shared__ int ord_s[kBW];
  __shared__ float ks_s[kBW], vs_s[kBW];

  // the query rows, 4 dims a thread (no barrier between these loads and the
  // first tile's: both are in flight together)
#pragma unroll
  for (int it = 0; it < (kRows * DH / 4 + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < kRows * DH / 4) {
      const int r = i / (DH / 4), d = (i % (DH / 4)) * 4, R = tile * kRows + r;
      float val[4] = {0.f, 0.f, 0.f, 0.f};
      if (R < M) {
        const int rep = R / S, s = R % S;
        load4(q + ((static_cast<size_t>(qrow) + s) * NH + kvh * n_rep + rep) * DH + d, val);
      }
      *reinterpret_cast<float4*>(&q_s[r][d]) = make_float4(val[0], val[1], val[2], val[3]);
    }
  }
  if (threadIdx.x < kRows) {
    const int R = tile * kRows + threadIdx.x;
    // rows past M see no slot (order <= -2 never holds for order >= 0)
    g_s[threadIdx.x] = R < M ? g[qrow + R % S] : -2;
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
  for (int w0 = w_begin; w0 < w_end; w0 += kBW) {
    if (w0 != w_begin) __syncthreads();  // the previous tile is consumed
    // stage the tile: each thread takes 4 consecutive dims of a slot (vector
    // loads of K, its rotate-half partner, cos, sin and V), DH / 16 items
#pragma unroll
    for (int it = 0; it < DH / 16; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int j = i / (DH / 4), d = (i % (DH / 4)) * 4, slot = w0 + j;
      float kr[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (slot < w_end) {
        const size_t base = ((static_cast<size_t>(b) * Wp + slot) * KVH + kvh) * DH;
        const size_t tb = (static_cast<size_t>(b) * Wp + slot) * DH;
        const KT* kp = kc + base;
        const KT* vp = vc + base;
        if (src != nullptr) {   // the slot as the step's write pass left it
          const int r = src[static_cast<size_t>(b) * Wp + slot];
          if (r >= 0) {
            const size_t ib = ((static_cast<size_t>(b) * st.N + r) * KVH + kvh) * DH;
            kp = ki + ib;
            vp = vi + ib;
          }
        }
        float x[4], xp[4], cs[4], sn[4];
        load4(kp + d, x);
        load4(kp + (d < HALF ? d + HALF : d - HALF), xp);
        load4(cosb + tb + d, cs);
        load4(sinb + tb + d, sn);
        load4(vp + d, vv);
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
      const bool in = slot < w_end;
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
    if (part_o != nullptr) {   // one split of several: the partial state, unnormalised
      const size_t p = (static_cast<size_t>(z) * gridDim.x + split) * M + R;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < DH) part_o[p * DH + d] = acc[rr][dd];
      }
      if (lane == 0) {
        part_ml[2 * p] = m_i[rr];
        part_ml[2 * p + 1] = l_i[rr];
      }
      continue;
    }
    const int rep = R / S, s = R % S;
    const float inv = 1.f / fmaxf(l_i[rr], 1e-30f);
    QT* o = out + ((static_cast<size_t>(qrow) + s) * NH + kvh * n_rep + rep) * DH;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (d < DH) o[d] = from_f32<QT>(acc[rr][dd] * inv);
    }
  }
}

template <typename QT, typename KT, int DH>
cudaError_t launch_cuda_cores(const void* q, const void* k, const void* v, const void* cs,
                              const void* sn, const void* order, const void* g, const void* ks,
                              const void* vs, void* out, float* part_o, float* part_ml, int B,
                              int S, int NH, int KVH, int Wp, int span, int splits, float scale,
                              Steps steps, int n, cudaStream_t st) {
  const int M = (NH / KVH) * S;
  const dim3 grid(splits, (M + kRows - 1) / kRows, n * B * KVH);
  decode_attention_kernel<QT, KT, DH><<<grid, kThreads, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(cs), static_cast<const float*>(sn),
      static_cast<const int*>(order), static_cast<const int*>(g),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<QT*>(out),
      part_o, part_ml, S, NH, KVH, Wp, span, scale, steps);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_dim(int Dh, const void* q, const void* k, const void* v, const void* cs,
                   const void* sn, const void* order, const void* g, const void* ks,
                   const void* vs, void* out, float* po, float* pml, int B, int S, int NH,
                   int KVH, int Wp, int span, int splits, float scale, Steps sp, int n,
                   cudaStream_t st) {
  switch (Dh) {
    case 16: return launch_cuda_cores<QT, KT, 16>(q, k, v, cs, sn, order, g, ks, vs, out, po, pml, B, S, NH, KVH, Wp, span, splits, scale, sp, n, st);
    case 32: return launch_cuda_cores<QT, KT, 32>(q, k, v, cs, sn, order, g, ks, vs, out, po, pml, B, S, NH, KVH, Wp, span, splits, scale, sp, n, st);
    case 64: return launch_cuda_cores<QT, KT, 64>(q, k, v, cs, sn, order, g, ks, vs, out, po, pml, B, S, NH, KVH, Wp, span, splits, scale, sp, n, st);
    case 128: return launch_cuda_cores<QT, KT, 128>(q, k, v, cs, sn, order, g, ks, vs, out, po, pml, B, S, NH, KVH, Wp, span, splits, scale, sp, n, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- tensor cores: head size 128 -----------------------------------------------------

namespace tc {

using namespace attn;   // tiles, copies, products, stores: wgmma.cuh, attention.cuh

// eight consecutive values of a cached row as f32 (16 bytes of bf16, 8 of int8)
__device__ __forceinline__ void load8(const bf16* p, float (&o)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    o[2 * i] = __low2float(h);
    o[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&o)[8]) {
  const int2 u = __ldg(reinterpret_cast<const int2*>(p));
  const char4 a = *reinterpret_cast<const char4*>(&u.x), c = *reinterpret_cast<const char4*>(&u.y);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = c.x; o[5] = c.y; o[6] = c.z; o[7] = c.w;
}
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldg(reinterpret_cast<const float4*>(p + 4));
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = c.x; o[5] = c.y; o[6] = c.z; o[7] = c.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                            pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}
// eight values as two bf16 planes, hi = bf16(x) and lo = bf16(x - hi) (x - hi is
// exact in f32): 16 significant bits, |x - hi - lo| <= 2^-18 |x|, lo 0 where x is bf16
__device__ __forceinline__ void store8_planes(bf16* hi, bf16* lo, const float (&x)[8]) {
  float h[8], l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    h[e] = __bfloat162float(__float2bfloat16_rn(x[e]));
    l[e] = x[e] - h[e];
  }
  store8(hi, h);
  store8(lo, l);
}

// Every cached key rotated by its slot's cos / sin in f32: krot [B, Wp, KVH, 128].
// bf16 q (PLANES false): the key rounded to bf16, and with an int8 cache V widened to
// bf16 (exact) into vwide. f32 q (PLANES true): the key as two bf16 planes hi, lo at
// krot and krot + plane, and with an f32 cache V the same at vwide and vwide + plane.
// A thread takes dims 8c .. 8c + 7 and their rotate-half partners 64 + 8c .. of one
// (slot, head). The steps of a verify pass: step j's copy `step` elements after step
// j - 1's, from step j's tables, each slot read from the in-flight row it holds in
// step j (src) or from the cache.
template <typename KT, bool PLANES>
__global__ void __launch_bounds__(256)
decode_rotate_keys_kernel(const KT* __restrict__ kc, const KT* __restrict__ vc,
                          const float* __restrict__ cosb, const float* __restrict__ sinb,
                          bf16* __restrict__ krot, bf16* __restrict__ vwide, size_t plane, int n,
                          int KVH, int Wp, Steps st, size_t step) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // row: (step, b, slot, head); in: (b, slot, head) within the step; bs: (b, slot)
  const int c = i & 7, row = i >> 3, per = st.BK * Wp, jstep = row / per, in = row - jstep * per;
  const int bs = in / KVH, kvh = in - bs * KVH;
  const size_t tab = static_cast<size_t>(jstep) * (per / KVH);   // the step's tables
  const size_t at = static_cast<size_t>(in) * kDh + 8 * c, tb = (tab + bs) * kDh + 8 * c;
  const KT* kp = kc + at;
  const KT* vp = vc == nullptr ? nullptr : vc + at;
  if (st.src != nullptr) {
    const int r = st.src[tab + bs];
    if (r >= 0) {
      const size_t ib = ((static_cast<size_t>(bs / Wp) * st.N + r) * KVH + kvh) * kDh + 8 * c;
      kp = static_cast<const KT*>(st.ki) + ib;
      vp = static_cast<const KT*>(st.vi) + ib;
    }
  }
  krot += jstep * step;
  if (vwide != nullptr) vwide += jstep * step;
  float x1[8], x2[8], c1[8], c2[8], s1[8], s2[8], r1[8], r2[8];
  load8(kp, x1);
  load8(kp + 64, x2);
  load8(cosb + tb, c1);
  load8(cosb + tb + 64, c2);
  load8(sinb + tb, s1);
  load8(sinb + tb + 64, s2);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    r1[e] = x1[e] * c1[e] - x2[e] * s1[e];   // rotate_half: (-x2, x1)
    r2[e] = x2[e] * c2[e] + x1[e] * s2[e];
  }
  if constexpr (PLANES) {
    store8_planes(krot + at, krot + plane + at, r1);
    store8_planes(krot + at + 64, krot + plane + at + 64, r2);
  } else {
    store8(krot + at, r1);
    store8(krot + at + 64, r2);
  }
  if (vwide != nullptr) {
    load8(vp, x1);
    load8(vp + 64, x2);
    if constexpr (PLANES) {
      store8_planes(vwide + at, vwide + plane + at, x1);
      store8_planes(vwide + at + 64, vwide + plane + at + 64, x2);
    } else {
      store8(vwide + at, x1);
      store8(vwide + at + 64, x2);
    }
  }
}

// p [64 x 64] (f32, an accumulator) as the A fragments of three planes hi, mid, lo
// (split3: hi + mid + lo == p), the register operands of o += p v
__device__ __forceinline__ void wg_split3(uint32_t (&pa)[3][4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bf16 h[2], m[2], l[2];
      split3(s[8 * kk + 2 * i], h[0], m[0], l[0]);
      split3(s[8 * kk + 2 * i + 1], h[1], m[1], l[1]);
      pa[0][kk][i] = as_u32(__halves2bfloat162(h[0], h[1]));
      pa[1][kk][i] = as_u32(__halves2bfloat162(m[0], m[1]));
      pa[2][kk][i] = as_u32(__halves2bfloat162(l[0], l[1]));
    }
}

// o += p v over PP planes of p and VP tiles of V (`v`: a stage's first V tile): each p
// plane against V's first tile, then p hi against its second (an f32 cache's lo)
template <int PP, int VP>
__device__ __forceinline__ void products_pv(float (&lo)[32], float (&hi)[32],
                                            const uint32_t (&pa)[PP][4][4],
                                            const unsigned char* v) {
#pragma unroll
  for (int i = 0; i < PP; ++i) wg_products_pn(lo, hi, pa[i], v);
  if constexpr (VP == 2) wg_products_pn(lo, hi, pa[0], v + kTileBytes);
}

// A block is one warpgroup that owns 64 rows (rows R: rep R / S, position R % S)
// of one (batch row, kv head) and walks the 64-slot tiles of its split: s = q k^T,
// mask and K scales, online softmax in registers, o += p v. K runs one tile ahead
// of V in the two-stage ring (as in the flash forward), so that q k(t)^T and
// p(t - 1) v(t - 1) are in the tensor cores together; each stage also holds its
// tile's order (and the int8 scales, and the in-flight rows its slots hold),
// copied beside its keys. Grid (splits, row tiles, n * B * KVH): step j's blocks
// read its rotated keys `kstep` elements after step j - 1's and its V `vstep`
// after (0: V is the cache as it lies, and vsrc, where not nullptr, says which
// slots step j reads from the in-flight rows st.vi instead). QT bf16: one tile of
// q, of K and of V a stage; QT f32: three q planes, two K planes and VP V planes
// (planes `plane` elements apart in scratch), p in three planes, f32 out.
constexpr int kMeta = 4 * 2 * kTile * 4;   // order, K scales, V scales, V sources of two stages
template <int QP, int KP, int VP>
constexpr int smem_bytes() { return (QP + 2 * KP + 2 * VP) * kTileBytes + kMeta + kAlignSlack; }

template <typename QT, bool SCALED, int VP>
__device__ __forceinline__ void attend(const QT* __restrict__ q, const bf16* __restrict__ krot,
                                       const bf16* __restrict__ vb, size_t plane,
                                       const int* __restrict__ order, const int* __restrict__ g,
                                       const float* __restrict__ ksc,
                                       const float* __restrict__ vsc, QT* __restrict__ out,
                                       float* __restrict__ part_o, float* __restrict__ part_ml,
                                       int S, int NH, int KVH, int Wp, int span, float scale,
                                       const Steps& st, size_t kstep, size_t vstep,
                                       const int* __restrict__ vsrc) {
  constexpr bool F32 = sizeof(QT) == 4;
  constexpr int QP = F32 ? 3 : 1, KP = F32 ? 2 : 1, PP = F32 ? 3 : 1;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* qs = align_tiles(smem_tc);    // QP tiles
  unsigned char* ks = qs + QP * kTileBytes;    // two stages of KP tiles
  unsigned char* vs = ks + 2 * KP * kTileBytes;   // two stages of VP tiles
  int* ord_s = reinterpret_cast<int*>(vs + 2 * VP * kTileBytes);      // [2][64]
  float* ksc_s = reinterpret_cast<float*>(ord_s + 2 * kTile);          // [2][64]
  float* vsc_s = ksc_s + 2 * kTile;                                    // [2][64]
  int* src_s = reinterpret_cast<int*>(vsc_s + 2 * kTile);              // [2][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x, z = blockIdx.z, jstep = z / st.BK, bk = z - jstep * st.BK;
  const int b = bk / KVH, kvh = bk % KVH;
  const int n_rep = NH / KVH, M = n_rep * S, R0 = blockIdx.y * kTile, row0 = warp * 16;
  // the step's order, rotated keys, V and V sources; its rows of q, g and out from row qrow
  const size_t tab = static_cast<size_t>(jstep) * (st.BK / KVH) * Wp;
  order += tab;
  krot += jstep * kstep;
  vb += jstep * vstep;
  if (vsrc != nullptr) vsrc += tab;
  const bf16* vi = static_cast<const bf16*>(st.vi);
  const int qrow = b * st.N + jstep * S;
  const int w_begin = split * span, w_end = min(Wp, w_begin + span);
  const int ntiles = (w_end - w_begin + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;
  // row R's first element in q and out
  auto row_at = [&](int R) {
    return ((static_cast<size_t>(qrow) + R % S) * NH + kvh * n_rep + R / S) * kDh;
  };

  const TileCopy copy(static_cast<size_t>(KVH) * kDh);   // a slot's rows lie KVH * 128 apart
  const size_t kv0 = (static_cast<size_t>(b) * Wp * KVH + kvh) * kDh;   // slot 0 of this head
  // tile t of `planes` planes into its stage of `stages`
  auto load_slots = [&](const bf16* src, unsigned char* stages, int planes, int t) {
    const int s0 = w_begin + t * kTile;
#pragma unroll
    for (int p = 0; p < planes; ++p)
      copy(stages + ((t & 1) * planes + p) * kTileBytes,
           src + p * plane + kv0 + static_cast<size_t>(s0) * KVH * kDh, w_end - s0);
  };
  auto load_k = [&](int t) {
    load_slots(krot, ks, KP, t);
    const int s0 = w_begin + t * kTile, stage = (t & 1) * kTile;
    // slots past the split's end are empty (order -1)
    for (int i = threadIdx.x; i < (SCALED ? 3 : 1) * kTile; i += kWgThreads) {
      const int which = i / kTile, j = i % kTile, slot = s0 + j;
      const size_t bsl = static_cast<size_t>(b) * Wp + slot;
      if (which == 0) {
        if (slot < w_end) cp_async4(smem_addr(ord_s + stage + j), order + bsl, true);
        else ord_s[stage + j] = -1;
      } else {
        float* dst = (which == 1 ? ksc_s : vsc_s) + stage + j;
        const float* src = (which == 1 ? ksc : vsc) + bsl * KVH + kvh;
        if (slot < w_end) cp_async4(smem_addr(dst), src, true);
        else *dst = 0.f;
      }
    }
    if (vsrc != nullptr)
      for (int i = threadIdx.x; i < kTile; i += kWgThreads) {
        const int slot = s0 + i;
        if (slot < w_end) cp_async4(smem_addr(src_s + stage + i), vsrc + static_cast<size_t>(b) * Wp + slot, true);
        else src_s[stage + i] = -1;
      }
  };
  // V of tile t; through the in-flight rows: its stage's sources have landed (they came
  // with k(t)), each of the thread's rows from the cache or the row its slot holds
  auto load_v = [&](int t) {
    if (vsrc == nullptr) {
      load_slots(vb, vs, VP, t);
      return;
    }
    const int s0 = w_begin + t * kTile, rows = w_end - s0, c = threadIdx.x & 15;
    const int* sr = src_s + (t & 1) * kTile;
    const uint32_t dst = smem_addr(vs + (t & 1) * VP * kTileBytes);
#pragma unroll
    for (int i = 0; i < kTile * 16 / kWgThreads; ++i) {
      const int r = (threadIdx.x >> 4) + i * (kWgThreads / 16);
      const bool ok = r < rows;
      const int from = ok ? sr[r] : -1;
      const bf16* p = from >= 0 ? vi + ((static_cast<size_t>(b) * st.N + from) * KVH + kvh) * kDh
                                : vb + kv0 + static_cast<size_t>(ok ? s0 + r : s0) * KVH * kDh;
      cp_async16(dst + swz(r, c), p + c * 8, ok);
    }
  };
  if constexpr (F32) {
    load_k(0);
    cp_async_commit();
    // the f32 rows, split into the three planes as they land (plain loads, in flight
    // beside the first keys' copies; rows past M are zeros)
#pragma unroll
    for (int i = 0; i < kTile * 16 / kWgThreads; ++i) {
      const int idx = threadIdx.x + i * kWgThreads, r = idx >> 4, c = idx & 15, R = R0 + r;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (R < M) load8(q + row_at(R) + 8 * c, x);
      uint32_t w[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bf16 h[2], m[2], l[2];
        split3(x[2 * e], h[0], m[0], l[0]);
        split3(x[2 * e + 1], h[1], m[1], l[1]);
        w[0][e] = as_u32(__halves2bfloat162(h[0], h[1]));
        w[1][e] = as_u32(__halves2bfloat162(m[0], m[1]));
        w[2][e] = as_u32(__halves2bfloat162(l[0], l[1]));
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint4*>(qs + p * kTileBytes + swz(r, c)) =
            make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    }
  } else {
    load_tile_async(qs, [&](int r, bool& ok) {
      const int R = R0 + r;
      ok = R < M;
      return q + row_at(ok ? R : 0);
    });
    load_k(0);
    cp_async_commit();
  }

  // this thread's two rows; a row past M sees nothing (order <= -2 never holds) and is not written
  const int Ra = R0 + row0 + gid, Rb = Ra + 8;
  const int g_a = Ra < M ? g[qrow + Ra % S] : -2, g_b = Rb < M ? g[qrow + Rb % S] : -2;

  float o_lo[32], o_hi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_lo[i] = o_hi[i] = 0.f;
  // running maxima (of the scores before scale * log2 e) and this thread's share of the row sums
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  uint32_t pa[PP][4][4];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // k(t) and v(t - 1) have arrived; k(t - 1) and v(t - 2) are consumed
    if (t + 1 < ntiles) load_k(t + 1);
    load_v(t);
    cp_async_commit();

    float s[32];
    const unsigned char* kt = ks + (t & 1) * KP * kTileBytes;
    wg_fence();
    if constexpr (F32) {
      // the small products first (q mid and lo against the key's hi plane, q hi and mid
      // against its lo), so that they add into a small sum, then q hi k hi
      wg_products_nt(s, qs + kTileBytes, kt);
      wg_products_nt(s, qs + 2 * kTileBytes, kt, 1);
      wg_products_nt(s, qs, kt + kTileBytes, 1);
      wg_products_nt(s, qs + kTileBytes, kt + kTileBytes, 1);
      wg_products_nt(s, qs, kt, 1);
    } else {
      wg_products_nt(s, qs, kt);
    }
    wg_commit();
    if (t > 0) {
      products_pv<PP, VP>(o_lo, o_hi, pa, vs + ((t - 1) & 1) * VP * kTileBytes);
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    keep(s);

    // the order mask of each (row, slot); int8 K scales on the score columns
    const int* ord = ord_s + (t & 1) * kTile;
    const float* ksct = ksc_s + (t & 1) * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1), o = ord[col];
        const bool vis = o >= 0 && o <= (e < 2 ? g_a : g_b);
        const float x = SCALED ? s[4 * j + e] * ksct[col] : s[4 * j + e];
        s[4 * j + e] = vis ? x : -INFINITY;
      }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    // p = 2^(s sl2 - m sl2); while a row has seen no slot its maximum stays -inf: subtract 0
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
    if (SCALED) {   // int8 V scales on the probability columns, after the row sums
      const float* vsct = vsc_s + (t & 1) * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * j + e] *= vsct[8 * j + 2 * tig + (e & 1)];
    }

    wg_wait<0>();      // p(t - 1) v(t - 1) is in o
    keep(o_lo);
    keep(o_hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o_lo[4 * j] *= al_a; o_lo[4 * j + 1] *= al_a; o_lo[4 * j + 2] *= al_b; o_lo[4 * j + 3] *= al_b;
      o_hi[4 * j] *= al_a; o_hi[4 * j + 1] *= al_a; o_hi[4 * j + 2] *= al_b; o_hi[4 * j + 3] *= al_b;
    }
    // p is the A operand of p v: rounded to bf16, or (f32) as its three planes
    if constexpr (F32) wg_split3(pa, s);
    else wg_round(pa[0], s);
  }
  cp_async_wait_all();
  __syncthreads();     // the last v has arrived
  keep(o_lo);
  keep(o_hi);
  wg_fence();
  products_pv<PP, VP>(o_lo, o_hi, pa, vs + ((ntiles - 1) & 1) * VP * kTileBytes);
  wg_commit();
  wg_wait<0>();
  keep(o_lo);
  keep(o_hi);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float f_a = l_a > 0.f ? 1.f / l_a : 0.f, f_b = l_b > 0.f ? 1.f / l_b : 0.f;
  if constexpr (!F32) {
    if (part_o == nullptr) {   // the only split: normalise and write the rows
      store_rows(qs, o_lo, o_hi, f_a, f_b, [&](int r) -> bf16* {
        const int R = R0 + r;
        return R < M ? out + row_at(R) : nullptr;
      });
      return;
    }
  }
  // one split of several: (m in log2 units, l, acc) of each row, for the merge; the only
  // split of f32 rows: the rows, normalised, in 8-byte stores
  const size_t pbase = (static_cast<size_t>(z) * gridDim.x + split) * M;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = h ? Rb : Ra;
    if (R >= M) continue;
    const float f = part_o == nullptr ? (h ? f_b : f_a) : 1.f;
    float* po = (part_o == nullptr ? reinterpret_cast<float*>(out) + row_at(R)
                                   : part_o + (pbase + R) * kDh) + 2 * tig;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(po + 8 * j) =
          make_float2(o_lo[4 * j + 2 * h] * f, o_lo[4 * j + 2 * h + 1] * f);
      *reinterpret_cast<float2*>(po + 64 + 8 * j) =
          make_float2(o_hi[4 * j + 2 * h] * f, o_hi[4 * j + 2 * h + 1] * f);
    }
    if (part_o != nullptr && tig == 0) {
      part_ml[2 * (pbase + R)] = (h ? m_b : m_a) * sl2;
      part_ml[2 * (pbase + R) + 1] = h ? l_b : l_a;
    }
  }
}

template <bool SCALED>
__global__ void __launch_bounds__(kWgThreads)
decode_attention_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ krot,
                              const bf16* __restrict__ vb, const int* __restrict__ order,
                              const int* __restrict__ g, const float* __restrict__ ksc,
                              const float* __restrict__ vsc, bf16* __restrict__ out,
                              float* __restrict__ part_o, float* __restrict__ part_ml, int S,
                              int NH, int KVH, int Wp, int span, float scale, Steps st,
                              size_t kstep, const int* __restrict__ vsrc) {
  attend<bf16, SCALED, 1>(q, krot, vb, 0, order, g, ksc, vsc, out, part_o, part_ml, S, NH, KVH,
                          Wp, span, scale, st, kstep, 0, vsrc);
}

// f32 q; VP 1: V the bf16 cache as it lies, VP 2: an f32 cache's V as two planes
template <int VP>
__global__ void __launch_bounds__(kWgThreads)
decode_attention_wgmma_f32_kernel(const float* __restrict__ q, const bf16* __restrict__ kpl,
                                  const bf16* __restrict__ vb, size_t plane,
                                  const int* __restrict__ order, const int* __restrict__ g,
                                  float* __restrict__ out, float* __restrict__ part_o,
                                  float* __restrict__ part_ml, int S, int NH, int KVH, int Wp,
                                  int span, float scale, Steps st, size_t kstep, size_t vstep,
                                  const int* __restrict__ vsrc) {
  attend<float, false, VP>(q, kpl, vb, plane, order, g, nullptr, nullptr, out, part_o, part_ml,
                           S, NH, KVH, Wp, span, scale, st, kstep, vstep, vsrc);
}

}  // namespace tc

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// bytes of one bf16 plane [B, Wp, KVH, 128] of the tensor-core paths' scratch
size_t plane_bytes(int B, int Wp, int KVH) {
  return align256(static_cast<size_t>(B) * Wp * KVH * attn::kDh * 2);
}

// bytes of one step's rotated keys (and of the widened int8 V) on the bf16 tensor-core
// path; of the key's two planes (and an f32 cache's two V planes) on the f32 one
size_t rotated_bytes(int B, int Wp, int KVH, int kv_dtype, int path) {
  const size_t one = plane_bytes(B, Wp, KVH);
  if (path == kWgmma) return kv_dtype == AHA_I8 ? 2 * one : one;
  if (path == kWgmmaF32) return kv_dtype == AHA_F32 ? 4 * one : 2 * one;
  return 0;
}

long long scratch_bytes(int B, int S, int steps, int NH, int KVH, int Dh, int Wp, int kv_dtype,
                        int path, int splits) {
  if (B <= 0 || S <= 0 || steps <= 0 || KVH <= 0 || NH % KVH != 0 || Wp <= 0 || splits <= 0)
    return -1;
  size_t n = steps * rotated_bytes(B, Wp, KVH, kv_dtype, path);
  if (splits > 1) {
    const size_t rows = static_cast<size_t>(steps) * B * KVH * splits * (NH / KVH) * S;
    n += align256(rows * Dh * 4) + rows * 2 * 4;
  }
  return static_cast<long long>(n);
}

// One launch of `n` steps of S rows each (a write pass: n 1, no in-flight rows).
int run(const void* q, const void* k, const void* v, const Steps& sp, int nsteps, const void* cs,
        const void* sn, const void* order, const void* g, const void* ks, const void* vs,
        void* out, void* scratch, int B, int S, int NH, int KVH, int Dh, int Wp, int q_dtype,
        int kv_dtype, float scale, int path, int span, int splits, cudaStream_t st) {
  const int tile = path == kCudaCores ? kBW : wg::kTile;
  if (B <= 0 || S <= 0 || nsteps <= 0 || KVH <= 0 || NH % KVH != 0 || Wp <= 0 ||
      (kv_dtype == AHA_I8) != (ks != nullptr) || splits <= 0 || span <= 0 || span % tile != 0 ||
      static_cast<long long>(splits - 1) * span >= Wp || static_cast<long long>(splits) * span < Wp ||
      (path != kCudaCores && path != kWgmma && path != kWgmmaF32) ||
      static_cast<long long>(nsteps) * B * KVH > 65535 ||
      (sp.src != nullptr && (kv_dtype == AHA_I8 || sp.ki == nullptr || sp.vi == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = (NH / KVH) * S;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const size_t rot1 = rotated_bytes(B, Wp, KVH, kv_dtype, path), rot = nsteps * rot1;
  float* part_o = nullptr;
  float* part_ml = nullptr;
  if (splits > 1 || rot > 0) {
    if (sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const size_t rows = static_cast<size_t>(nsteps) * B * KVH * splits * M;
    part_o = reinterpret_cast<float*>(sc + rot);
    part_ml = reinterpret_cast<float*>(sc + rot + align256(rows * Dh * 4));
  }
  using tc::bf16;
  const int n = nsteps * B * Wp * KVH * 8;   // threads of the rotation kernel
  const size_t kstep = rot1 / sizeof(bf16);  // elements between two steps' rotated copies
  const float* cosp = static_cast<const float*>(cs);
  const float* sinp = static_cast<const float*>(sn);
  const int* ord = static_cast<const int*>(order);
  const int* gp = static_cast<const int*>(g);
  const dim3 wgrid(splits, (M + wg::kTile - 1) / wg::kTile, nsteps * B * KVH);
  cudaError_t err = cudaErrorInvalidValue;
  if (path == kWgmma) {
    if (q_dtype != AHA_BF16 || Dh != attn::kDh || (kv_dtype != AHA_BF16 && kv_dtype != AHA_I8))
      return static_cast<int>(cudaErrorInvalidValue);
    bf16* krot = reinterpret_cast<bf16*>(sc);
    bf16* vwide = kv_dtype == AHA_I8 ? reinterpret_cast<bf16*>(sc + rot1 / 2) : nullptr;
    if (kv_dtype == AHA_I8)
      tc::decode_rotate_keys_kernel<int8_t, false><<<(n + 255) / 256, 256, 0, st>>>(
          static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), cosp, sinp, krot, vwide,
          0, n, KVH, Wp, sp, kstep);
    else
      tc::decode_rotate_keys_kernel<bf16, false><<<(n + 255) / 256, 256, 0, st>>>(
          static_cast<const bf16*>(k), nullptr, cosp, sinp, krot, nullptr, 0, n, KVH, Wp, sp,
          kstep);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // a bf16 V is read as it lies, each slot from where step j's write pass left it
    const bf16* vsrc = vwide != nullptr ? vwide : static_cast<const bf16*>(v);
    const int* vfrom = vwide != nullptr ? nullptr : sp.src;
    const int smem = tc::smem_bytes<1, 1, 1>();
    if (ks != nullptr) {
      err = wg::allow_smem(tc::decode_attention_wgmma_kernel<true>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      tc::decode_attention_wgmma_kernel<true><<<wgrid, wg::kWgThreads, smem, st>>>(
          static_cast<const bf16*>(q), krot, vsrc, ord, gp, static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<bf16*>(out), part_o, part_ml, S, NH, KVH,
          Wp, span, scale, sp, kstep, vfrom);
    } else {
      err = wg::allow_smem(tc::decode_attention_wgmma_kernel<false>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      tc::decode_attention_wgmma_kernel<false><<<wgrid, wg::kWgThreads, smem, st>>>(
          static_cast<const bf16*>(q), krot, vsrc, ord, gp, nullptr, nullptr,
          static_cast<bf16*>(out), part_o, part_ml, S, NH, KVH, Wp, span, scale, sp, kstep,
          vfrom);
    }
    err = cudaGetLastError();
  } else if (path == kWgmmaF32) {
    if (q_dtype != AHA_F32 || Dh != attn::kDh || (kv_dtype != AHA_BF16 && kv_dtype != AHA_F32))
      return static_cast<int>(cudaErrorInvalidValue);
    // a step's key planes, then an f32 cache's V planes, each plane `plane` elements on
    const size_t plane = plane_bytes(B, Wp, KVH) / sizeof(bf16);
    bf16* kpl = reinterpret_cast<bf16*>(sc);
    const float* qf = static_cast<const float*>(q);
    float* o = static_cast<float*>(out);
    if (kv_dtype == AHA_F32) {
      bf16* vpl = kpl + 2 * plane;
      tc::decode_rotate_keys_kernel<float, true><<<(n + 255) / 256, 256, 0, st>>>(
          static_cast<const float*>(k), static_cast<const float*>(v), cosp, sinp, kpl, vpl, plane,
          n, KVH, Wp, sp, kstep);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int smem = tc::smem_bytes<3, 2, 2>();
      err = wg::allow_smem(tc::decode_attention_wgmma_f32_kernel<2>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      tc::decode_attention_wgmma_f32_kernel<2><<<wgrid, wg::kWgThreads, smem, st>>>(
          qf, kpl, vpl, plane, ord, gp, o, part_o, part_ml, S, NH, KVH, Wp, span, scale, sp,
          kstep, kstep, nullptr);
    } else {
      tc::decode_rotate_keys_kernel<bf16, true><<<(n + 255) / 256, 256, 0, st>>>(
          static_cast<const bf16*>(k), nullptr, cosp, sinp, kpl, nullptr, plane, n, KVH, Wp, sp,
          kstep);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int smem = tc::smem_bytes<3, 2, 1>();
      err = wg::allow_smem(tc::decode_attention_wgmma_f32_kernel<1>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      tc::decode_attention_wgmma_f32_kernel<1><<<wgrid, wg::kWgThreads, smem, st>>>(
          qf, kpl, static_cast<const bf16*>(v), plane, ord, gp, o, part_o, part_ml, S, NH, KVH,
          Wp, span, scale, sp, kstep, 0, sp.src);
    }
    err = cudaGetLastError();
  } else if (q_dtype == AHA_F32 && kv_dtype == AHA_F32) {
    err = by_dim<float, float>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, part_o, part_ml, B, S, NH, KVH, Wp, span, splits, scale, sp, nsteps, st);
  } else if (q_dtype == AHA_F32 && kv_dtype == AHA_BF16) {
    err = by_dim<float, __nv_bfloat16>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, part_o, part_ml, B, S, NH, KVH, Wp, span, splits, scale, sp, nsteps, st);
  } else if (q_dtype == AHA_F32 && kv_dtype == AHA_I8) {
    err = by_dim<float, int8_t>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, part_o, part_ml, B, S, NH, KVH, Wp, span, splits, scale, sp, nsteps, st);
  } else if (q_dtype == AHA_BF16 && kv_dtype == AHA_BF16) {
    err = by_dim<__nv_bfloat16, __nv_bfloat16>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, part_o, part_ml, B, S, NH, KVH, Wp, span, splits, scale, sp, nsteps, st);
  } else if (q_dtype == AHA_BF16 && kv_dtype == AHA_I8) {
    err = by_dim<__nv_bfloat16, int8_t>(Dh, q, k, v, cs, sn, order, g, ks, vs, out, part_o, part_ml, B, S, NH, KVH, Wp, span, splits, scale, sp, nsteps, st);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  if (q_dtype == AHA_F32)
    err = launch_merge<float>(part_o, part_ml, static_cast<float*>(out), B, S, NH, KVH, Dh, splits,
                              path != kCudaCores, nsteps, st);
  else
    err = launch_merge<__nv_bfloat16>(part_o, part_ml, static_cast<__nv_bfloat16*>(out), B, S, NH,
                                      KVH, Dh, splits, path != kCudaCores, nsteps, st);
  return static_cast<int>(err);
}

}  // namespace

// Scratch of a launch of `steps` steps of S rows (a write pass: steps 1).
extern "C" long long aha_decode_attention_steps_scratch_bytes(int B, int S, int steps, int NH,
                                                              int KVH, int Dh, int Wp,
                                                              int kv_dtype, int path,
                                                              int splits) {
  return scratch_bytes(B, S, steps, NH, KVH, Dh, Wp, kv_dtype, path, splits);
}

// A write pass: S rows against the cache.
extern "C" int aha_decode_attention(const void* q, const void* k, const void* v,
                                    const void* cs, const void* sn, const void* order,
                                    const void* g, const void* ks, const void* vs, void* out,
                                    void* scratch, int B, int S, int NH, int KVH, int Dh, int Wp,
                                    int q_dtype, int kv_dtype, float scale, int path, int span,
                                    int splits, void* stream) {
  const Steps one{nullptr, nullptr, nullptr, S, B * KVH};
  return run(q, k, v, one, 1, cs, sn, order, g, ks, vs, out, scratch, B, S, NH, KVH, Dh, Wp,
             q_dtype, kv_dtype, scale, path, span, splits, static_cast<cudaStream_t>(stream));
}

// The verify pass: `steps` composed steps of S rows, q / g / out [B, steps * S, ...], the
// tables [steps, B, Wp, ...], the in-flight rows ki / vi [B, steps * S, KVH, Dh] in the
// cache's type and src [steps, B, Wp]; the cache is only read. No int8 cache.
extern "C" int aha_decode_attention_steps(const void* q, const void* k, const void* v,
                                          const void* ki, const void* vi, const void* src,
                                          const void* cs, const void* sn, const void* order,
                                          const void* g, const void* ks, const void* vs,
                                          void* out, void* scratch, int B, int S, int steps,
                                          int NH, int KVH, int Dh, int Wp, int q_dtype,
                                          int kv_dtype, float scale, int path, int span,
                                          int splits, void* stream) {
  if (src == nullptr || ks != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Steps sp{static_cast<const int*>(src), ki, vi, steps * S, B * KVH};
  return run(q, k, v, sp, steps, cs, sn, order, g, ks, vs, out, scratch, B, S, NH, KVH, Dh, Wp,
             q_dtype, kv_dtype, scale, path, span, splits, static_cast<cudaStream_t>(stream));
}
