// y[M, N] = (x[M, K] @ W[K, N]) * scale[N]  with W int8, f32 accumulation; or,
// with int8 activations (a8), y = (xq[M, K] @ W[K, N]) * scale[N] * sx[M] with
// exact int32 accumulation, xq / sx from csrc/quantize_rows.cu.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/fused_matmul.py::int8_matmul
// (_kernel_int8, both a8 values): the int8 product behind every decoder
// projection, the projector and the lm_head of the --int8 config. The same
// entry serves aha_tpu/ops/pallas/quant_matmul.py::quant_matmul (the same
// function, a8=False, unstacked).
//
// What bounds it on an H100: a decoder layer's four weights are 233 MB of
// int8, 0.0696 ms at 3.35 TB/s. At the streaming path's M (1 for generation,
// 2..59 for verify passes and frame chunks) the weight bytes are the traffic;
// from about M = 150 (171 / 196 / 220 for prompts and fused passes, 392 / 1568
// for the projector) the 2 M K N operations at 989 TFLOP/s take longer (with
// int8 activations at 1,979 TOP/s, from about M = 300). Every path reads each
// weight byte from device memory once and takes it into registers as it is
// (int8 activations) or converted to bf16; the per-channel scale multiplies the
// finished sum once (it factors out of the contraction), as in the TPU kernel's
// epilogue. Five paths, chosen by the wrapper's plan() from the operands:
//   * decode (1 <= M <= 16, bf16 x weight-only or int8 x with a bf16 output,
//     K % 64 == 0, N % 16 == 0, 16-byte aligned operands): section "decode rows"
//     below. mma.sync per warp with x as the 16-row A operand, the weight bytes
//     as the B operand (converted to bf16, or transposed as int8), a cp.async
//     ring, one plan and one order of sums for every M, so a row gives the same
//     bits at every width.
//   * wgmma (as decode, M >= 17; also f32 x weight-only from 17 rows, with an
//     f32 output): section "tensor-core path, wgmma" below. The
//     product is turned round (y^T = W^T x^T), the weight bytes (converted to
//     bf16, or transposed as int8) are the register operand of the warpgroup
//     products, raw bytes and x tiles arrive by cp.async through a ring of up to
//     six stages, one accumulator set over all of K, the scales in the epilogue.
//     An f32 x arrives as three bf16 planes (csrc/quantize_rows.cu,
//     split_bf16x3) whose three products a stage share the converted weight.
//   * mma.sync (bf16 x where neither applies, M > 1, K % 32 == 0, N % 8 == 0):
//     a block owns a 64 x 128 output tile and walks K in steps of
//     32. It stages the x tile (bf16) and the weight tile (int8 -> bf16,
//     transposed so a thread's fragment pair is one 32-bit shared load) in
//     shared memory and runs mma.sync m16n8k16 bf16 with f32 accumulators (4
//     warps, 32 x 64 each); the copies are synchronous.
//   * mma.sync on int8 activations (a8, M > 1, where neither Hopper path
//     applies: an f32 output, ragged or misaligned operands): both tiles staged
//     as int8, m16n8k32 s8 with int32 accumulators, whatever the output type.
//   * CUDA cores (everything else: f32 at 1 .. 16 rows, ragged or misaligned
//     operands at one row): a block covers 128 output columns; each of its
//     256 threads owns 16 contiguous columns (one 16-byte int8 load per
//     weight row) and one of 32 lanes along K, so a warp reads 4 rows x 128
//     contiguous bytes; rows of x are taken BM at a time.
// int8 values and bf16 activations are exact in bf16, so the bf16 paths differ
// from the plain version only in the order of the f32 sums. With a8 the int32
// sum is exact; it becomes f32 once, before the two scales (the TPU kernel adds
// its K-block partials in f32, which is the same number while the sum stays
// below 2^24).
// When the grid would leave SMs idle, K is split over grid z: each split
// writes an f32 partial and a second kernel sums the splits in a fixed order
// (deterministic, no atomics), scales and casts.
#include <algorithm>
#include <type_traits>

#include "wgmma.cuh"

namespace {

// ---- CUDA-core path ---------------------------------------------------------

constexpr int kCols = 16;                  // columns per thread (one 16B load)
constexpr int kColGroups = 8;              // threads along N
constexpr int kBN = kCols * kColGroups;    // 128 columns per block
constexpr int kKLanes = 32;                // threads along K

template <typename X> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int8_t x) { return x; }

// X: activation type (float, bf16, or int8 with the per-row scales sx);
// Y: output type.
template <typename X, typename Y, int BM>
__global__ void __launch_bounds__(kColGroups * kKLanes)
int8_mm_kernel(const X* __restrict__ x, const float* __restrict__ sx,
               const int8_t* __restrict__ w, const float* __restrict__ scale,
               Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
               int k_per_split, int splits, int vec) {
  using Acc = typename AccOf<X>::type;
  const int cg = threadIdx.x;   // column group
  const int kl = threadIdx.y;   // K lane
  const int n0 = blockIdx.x * kBN + cg * kCols;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  Acc acc[BM][kCols];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0;

  const bool full = vec && (n0 + kCols <= N);
#pragma unroll 4
  for (int k = kbeg + kl; k < kend; k += kKLanes) {
    Acc wf[kCols];
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
      for (int j = 0; j < kCols; ++j) wf[j] = (n0 + j < N) ? static_cast<Acc>(wrow[j]) : 0;
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const Acc xv = (m0 + r < M) ? to_acc(x[static_cast<size_t>(m0 + r) * K + k]) : 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = mad(xv, wf[j], acc[r][j]);
    }
  }

  // sum the 32 K lanes through shared memory, one row at a time
  __shared__ Acc red[kKLanes][kBN + 4];
  const int t = kl * kColGroups + cg;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[kl][cg * kCols + j] = acc[r][j];
    __syncthreads();
    if (t < kBN) {
      Acc si = 0;
#pragma unroll 8
      for (int l = 0; l < kKLanes; ++l) si += red[l][t];
      const float s = static_cast<float>(si);
      const int row = m0 + r, col = blockIdx.x * kBN + t;
      if (row < M && col < N) {
        if (splits == 1) {
          float v = s * scale[col];
          if (sx != nullptr) v *= sx[row];
          y[static_cast<size_t>(row) * N + col] = from_f32<Y>(v);
        } else {
          ws[(static_cast<size_t>(blockIdx.z) * M + row) * N + col] = s;
        }
      }
    }
    __syncthreads();
  }
}

// ---- tensor-core path, mma.sync (bf16 x where the wgmma path does not apply) ----

constexpr int kTPad = 8;   // bf16 pad per shared row (20-word stride)

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

// ---- tensor-core path, int8 activations --------------------------------------------

template <typename Y>
__global__ void __launch_bounds__(128)
int8_mm_tc_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                     const int8_t* __restrict__ w, const float* __restrict__ scale,
                     Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
                     int k_per_split, int splits) {
  constexpr int RB = TileRow<true>::kBytes;
  __shared__ __align__(16) unsigned char xs[kTM * RB];
  __shared__ __align__(16) unsigned char wt[kTN * RB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    stage_x_tile<true>(xs, xq, m0, M, K, k0, tid);
    // weight tile: 8 quads of K rows x 16 groups of 8 columns, one item per
    // thread; the four K values of a column become one 32-bit word of wt[n][k]
    {
      const int kq = tid & 7, ng = (tid >> 3) * 8;
      const int k = k0 + 4 * kq, n = n0 + ng;
      uint2 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r[i] = make_uint2(0u, 0u);
        if (n < N)   // N % 8 == 0: a group is all in or all out
          r[i] = __ldg(reinterpret_cast<const uint2*>(w + static_cast<size_t>(k + i) * N + n));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word |= byte_of(r[i], j) << (8 * i);
        *reinterpret_cast<uint32_t*>(wt + (ng + j) * RB + kq * 4) = word;
      }
    }
    __syncthreads();
    mma_tile<true>(acc, xs, wt, wm, wn, gid, tig);
    __syncthreads();
  }
  store_tile<Y>(acc, y, ws, scale, sx, M, N, m0, n0, wm, wn, gid, tig, splits, blockIdx.z);
}

// ---- tensor-core path, wgmma (K % 64 == 0, N % 16 == 0): bf16 x weight-only, int8 x, or -----
// ---- f32 x weight-only as three bf16 planes -----------------------------------------------
//
// The product turned round: y^T = W^T x^T. The 64-row side of a warpgroup
// product runs over weight columns, its register operand is a piece of W^T built
// in registers from the raw weight bytes, and its width is the token tile. The
// weight never exists in memory in any other form: the raw bytes travel device
// memory -> ring -> registers.
//
// A block is one warpgroup that owns 128 weight columns (two slabs of 64) and a
// token tile of TM <= 128 rows, and walks K in stages of 64 rows through a ring
// of stages(TM) slots (up to six, as many as fit when two or three blocks share
// an SM) filled by cp.async, all but two slots in flight (all but one, the slot
// refilled as soon as both slabs' products of its stage are done, was no faster).
// A stage holds the x tile (TM rows, the B operand as it lies, swizzled) and the
// weight bytes (64 rows of 128 columns), all in 16-byte copies. The thread whose
// accumulator rows are gid and gid + 8 of warp w owns the four neighbouring
// columns 4 (8 w + gid) .. + 3 (rows gid and gid + 8 of slab 0, then of slab 1:
// the accumulator rows are relabelled, no data is shuffled): a 32-bit word of a
// weight row is its share of that row.
//
// Two operand types, one kernel (A8):
//   * bf16 x, weight-only: x rows of 128 bytes in the 128-byte swizzle, weight
//     rows 144 bytes apart (the rows a warp reads at once fall in distinct banks),
//     products m64nTMk16 bf16 into f32. The operand registers of a 16-deep piece
//     need rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9: a register pairs the same
//     column of two rows, so each is one byte permute of two words, two logic
//     operations and one bf16x2 addition (pair_bf16): four instructions for two
//     values, 128 a stage.
//   * int8 x (xq, sx from csrc/quantize_rows.cu): x rows of 64 bytes in the
//     64-byte swizzle, weight rows 128 bytes apart with their chunks swizzled
//     (a8_weight_chunk), products m64nTMk32 s8 into exact int32 sums. The operand
//     register of a 32-deep piece is four consecutive K rows of one column: rows
//     4 tig .. + 3 and 16 + 4 tig .. + 3, a 4 x 4 byte transpose of the four words
//     the thread reads anyway (byte_columns): two byte permutes a register, no
//     conversion, 32 a stage. The token tile is a width the s8 product takes
//     (24, 32, then multiples of 16).
//   * f32 x, weight-only, f32 output (PL = 3; replaces the CUDA-core kernel
//     above at 17 rows and more: a 7B decoder layer at M = 49 takes 0.24 ms here
//     and took 2.86 there, at 196 0.73 against 9.69; NVIDIA H100 80GB HBM3,
//     700 W): x arrives as three bf16 planes hi = bf16(x), mid = bf16(x - hi), lo =
//     bf16(x - hi - mid) ([3, M, K], split_bf16x3 in csrc/quantize_rows.cu), whose
//     sum is x: each residual is exact in f32, and three planes hold 24 bits and
//     more of x's significand. Every weight value (-127 .. 127) is exact in bf16,
//     so each plane's product with it is exact; the sums are f32 in the tensor
//     cores' adder, whose error grows with the products a sum takes (down at 196
//     rows, 1,776 a split: 2.6e-5 of the largest output, on the same card). A
//     stage holds the three x tiles one after another (as the bf16
//     tile, 1024-byte aligned each), and each piece's converted weight register
//     is the operand of three products, hi, mid and lo, into one accumulator:
//     the conversion is paid once for three times the tensor work. The epilogue
//     scales and stores f32, or writes the f32 partial of a split; nothing is
//     rounded to bf16. The kernel starts while the split ahead of it runs, as
//     the int8 one does behind the quantiser. The price: 2 M K bytes more of x
//     tiles a stage (from L2), and three products where bf16 x has one, which at
//     M = 196 make the operations and not the weight bytes its bound (3 x 2 M K N
//     at 989 TFLOP/s). Two blocks an SM; the ring as deep as that leaves room for
//     (three to six slots).
//
// The two slabs alternate: while the tensor cores run one slab's products of a
// stage, the threads build the other's operand. Each slab keeps one accumulator
// over all of the block's K: the products always accumulate (the sums start at
// zero), the only wait is the ring's, and the epilogue multiplies the finished
// sum (int32 made f32 once) by the column scale, then by the row scale sx. A K
// split covers whole stages and writes its sums as an f32 partial; splitk_reduce
// adds them in a fixed order, then scales. An int32 partial is exact in f32 below
// 2^24, so the int8 path equals the plain version (an exact sum rounded to f32
// once, times the scale, times sx) bit for bit while every split's sum and the
// running total stay below 2^24, and always with one split.
namespace w8 {

using namespace wg;

constexpr int kSlabs = 2;             // 64-column slabs of the weight per block
constexpr int kBN = 64 * kSlabs;      // weight columns per block
constexpr int kKS = 64;               // contraction depth of a stage
constexpr int kSmemPerSm = 233472;    // 228 KB, of which each block costs 1 KB more
constexpr int kMaxStages = 6;

// what the two operand types change: the x tile's row bytes, the weight rows'
// stride, the pieces of a stage, the accumulator (f32 x: bf16 planes, as bf16 x)
template <bool A8> struct Operand {
  using X = bf16;
  using Acc = float;
  static constexpr int kXRow = 128, kWRow = 144, kPieces = 4;
};
template <> struct Operand<true> {
  using X = int8_t;
  using Acc = int;
  static constexpr int kXRow = 64, kWRow = 128, kPieces = 2;
};
// where a stage keeps the 16-byte chunk c of weight row r
template <bool A8> __device__ __forceinline__ int weight_chunk(int r, int c) {
  return A8 ? a8_weight_chunk(r, c) : c;
}

// Blocks an SM holds: three up to 64 rows (the 296 column blocks of gate_up
// then run in one round), else two (the accumulators of wider tiles need more
// than a third of the registers); two for f32 x (PL = 3 planes), whose x tiles
// take three times the room.
__host__ __device__ constexpr int blocks_per_sm(int TM, int PL = 1) {
  return PL == 1 && TM <= 64 ? 3 : 2;
}
template <bool A8, int PL = 1> __host__ __device__ constexpr int stage_bytes(int TM) {
  return PL * TM * Operand<A8>::kXRow + kKS * Operand<A8>::kWRow;
}
template <bool A8, int PL = 1> __host__ __device__ constexpr int stages(int TM) {
  return (kSmemPerSm / blocks_per_sm(TM, PL) - 1024 - kAlignSlack) / stage_bytes<A8, PL>(TM) <
                 kMaxStages
             ? (kSmemPerSm / blocks_per_sm(TM, PL) - 1024 - kAlignSlack) / stage_bytes<A8, PL>(TM)
             : kMaxStages;
}
template <bool A8, int PL = 1> __host__ __device__ constexpr int smem_bytes(int TM) {
  return stages<A8, PL>(TM) * stage_bytes<A8, PL>(TM) + kAlignSlack;
}

// The bf16 pair (byte C of a, byte C of b) as int8 values, exactly: a byte
// permute puts the two bytes in the low byte of each half; 0x4300 | (v & 0x7f)
// is the bf16 128 + (v & 127) (its ulp is 1 there), 0xC300 ^ (v & 0x80) is -128,
// or -256 where v is negative, and their sum is v.
template <int C>
__device__ __forceinline__ uint32_t pair_bf16(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = C | (C << 4) | ((4 + C) << 8) | ((4 + C) << 12);
  const uint32_t p = __byte_perm(a, b, sel);
  const uint32_t low = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t high = (p & 0x00800080u) ^ 0xC300C300u;
  return as_u32(__hadd2(as_bf162(low), as_bf162(high)));
}
// the operands of a stage's products for slab SLAB, from this thread's words.
// bf16: wq[p][r] is weight row 16 p + 2 tig + (0, 1, 8, 9)[r] of its four
// columns, the slab's two in bytes 2 SLAB and 2 SLAB + 1. int8: wq[2 p + g][d] is
// row 32 p + 16 g + 4 tig + d.
template <bool A8, int SLAB>
__device__ __forceinline__ void convert(uint32_t (&a)[Operand<A8>::kPieces][4],
                                        const uint32_t (&wq)[4][4]) {
#pragma unroll
  for (int p = 0; p < Operand<A8>::kPieces; ++p) {
    if constexpr (A8) {
      byte_columns<SLAB>(a[p][0], a[p][1], wq[2 * p][0], wq[2 * p][1], wq[2 * p][2],
                         wq[2 * p][3]);                                  // k 4 tig ..
      byte_columns<SLAB>(a[p][2], a[p][3], wq[2 * p + 1][0], wq[2 * p + 1][1],
                         wq[2 * p + 1][2], wq[2 * p + 1][3]);            // k 16 + 4 tig ..
    } else {
      a[p][0] = pair_bf16<2 * SLAB>(wq[p][0], wq[p][1]);       // row gid: k 2 tig, 2 tig + 1
      a[p][1] = pair_bf16<2 * SLAB + 1>(wq[p][0], wq[p][1]);   // row gid + 8
      a[p][2] = pair_bf16<2 * SLAB>(wq[p][2], wq[p][3]);       // row gid: k 2 tig + 8, + 9
      a[p][3] = pair_bf16<2 * SLAB + 1>(wq[p][2], wq[p][3]);
    }
  }
}

// a slab's products of a stage: piece p of each x plane times the piece's weight
// operand, into one accumulator (piece after piece, plane after plane: hi, mid, lo)
template <bool A8, int TM, int PL, typename Acc, int P>
__device__ __forceinline__ void slab_products(Acc (&acc)[TM / 2], const uint32_t (&a)[P][4],
                                              const uint64_t (&xd)[PL][P]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = 0; q < PL; ++q) {
      if constexpr (A8)
        wgmma_rs_s8<TM>(acc, a[p], xd[q][p]);
      else
        wgmma_rs<TM>(acc, a[p], xd[q][p], 1);
    }
}

// PL: the x planes (1; 3 for f32 x split into bf16 planes [3, M, K], f32 output)
template <bool A8, int TM, int PL>
__global__ void __launch_bounds__(kWgThreads, blocks_per_sm(TM, PL))
int8_mm_wgmma_kernel(const typename Operand<A8>::X* __restrict__ x, const float* __restrict__ sx,
                     const int8_t* __restrict__ w, const float* __restrict__ scale,
                     std::conditional_t<PL == 3, float, bf16>* __restrict__ y,
                     float* __restrict__ ws, int M, int K, int N, int k_per_split, int splits) {
  using Op = Operand<A8>;
  constexpr int kStages = stages<A8, PL>(TM), kStage = stage_bytes<A8, PL>(TM), NA = TM / 2;
  constexpr int P = Op::kPieces, kWRow = Op::kWRow;
  // the kernels launched to start while the grid ahead of them (quantiser, split) runs
  constexpr bool kBehindPrior = A8 || PL == 3;
  static_assert(PL == 1 || (PL == 3 && !A8), "planes of bf16 x only");
  static_assert(kStages >= 3, "the ring needs a slot in use, one in flight and one free");
  extern __shared__ __align__(128) unsigned char smem_w8[];
  unsigned char* ring = align_tiles(smem_w8);
  const uint32_t ring_a = smem_addr(ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int nst = max(0, min(K, kbeg + k_per_split) - kbeg) / kKS;   // whole stages a split

  // this thread's four weight columns (N % 16 == 0: all four exist, or none)
  const int n4 = n0 + 4 * (8 * warp + gid);
  // its share of a stage's copies: rows of the x tile, four 16-byte chunks of
  // the weight bytes (row idx / 8, columns 16 (idx % 8) ..)
  const std::conditional_t<A8, Rows64Copy<TM>, RowsCopy<TM>> copy_x(static_cast<size_t>(K));
  const typename Op::X* xsrc = x + static_cast<size_t>(m0) * K + kbeg;
  const size_t plane = static_cast<size_t>(M) * K;   // elements of an x plane
  constexpr int kXTile = TM * Op::kXRow;              // bytes of an x tile (a plane's)
  constexpr int kWOff = PL * kXTile;
  const int8_t* wsrc[4];
  uint32_t wdst[4];
  bool wok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int idx = tid + c * kWgThreads, row = idx >> 3, col = n0 + (idx & 7) * 16;
    wok[c] = col < N;
    wsrc[c] = w + static_cast<size_t>(kbeg + row) * N + (wok[c] ? col : 0);
    wdst[c] = kWOff + row * kWRow + weight_chunk<A8>(row, idx & 7) * 16;
  }
  auto load_w = [&](int i) {   // the weight bytes of stage i of this split into its slot
    const uint32_t st = ring_a + (i % kStages) * kStage;
    const size_t rows = static_cast<size_t>(i) * kKS * N;
#pragma unroll
    for (int c = 0; c < 4; ++c) cp_async16(st + wdst[c], wsrc[c] + rows, wok[c]);
  };
  auto load_x = [&](int i) {   // the x tiles of stage i of this split into its slot
#pragma unroll
    for (int q = 0; q < PL; ++q)
      copy_x(ring_a + (i % kStages) * kStage + q * kXTile, xsrc + q * plane + i * kKS, M - m0);
  };
  auto load = [&](int i) {     // stage i of this split into its slot
    load_x(i);
    load_w(i);
  };
  // bf16: weight row 2 tig of a stage at this thread's four columns; int8: row
  // 4 tig, whose chunks are swizzled by tig (a8_weight_chunk)
  const int w_off = A8 ? kWOff + 4 * tig * kWRow + 4 * ((8 * warp + gid) ^ (8 * tig))
                       : kWOff + 2 * tig * kWRow + (8 * warp + gid) * 4;

  typename Op::Acc acc0[NA], acc1[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc0[e] = acc1[e] = 0;
  uint32_t a0[P][4], a1[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) a0[p][e] = a1[p][e] = 0u;

  if constexpr (kBehindPrior) {
    // the weight bytes of the first stages do not depend on the quantiser (the
    // split) ahead of this kernel: in flight before waiting for its xq and sx (planes)
#pragma unroll
    for (int i = 0; i < kStages - 2; ++i)
      if (i < nst) load_w(i);
    wait_prior_grid();
#pragma unroll
    for (int i = 0; i < kStages - 2; ++i) {
      if (i < nst) load_x(i);
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int i = 0; i < kStages - 2; ++i) {
      if (i < nst) load(i);
      cp_async_commit();
    }
  }
  // The assembler follows which products are in flight only so far: whatever
  // defines an input of a product (operand registers, descriptors) is pinned
  // before the first product of its batch, the products' scale-d is the constant
  // 1, no wait is conditional, and nothing but the wait and the conversion lies
  // between the two slabs' products (a copy placed there, with its branches, was
  // enough). Otherwise it makes every product wait for the one before it.
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<kStages - 3>();   // stage i has landed
    wg_wait<1>();                   // slab 0 of stage i - 1 is done: a0 is free
    __syncthreads();                // ... and every warp is past stage i - 2
    if (i + kStages - 2 < nst) load(i + kStages - 2);
    cp_async_commit();

    const int slot = i % kStages;
    const unsigned char* st = ring + slot * kStage + w_off;
    uint32_t wq[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int d = 0; d < 4; ++d)   // past w_off's row: 16 p + d (int8), 16 p + (0, 1, 8, 9)[d]
        wq[p][d] = lds32(st + (A8 ? 16 * p + d : 16 * p + (d & 1) + 8 * (d >> 1)) * kWRow);
    uint64_t xd[PL][P];   // plane q's pieces
#pragma unroll
    for (int q = 0; q < PL; ++q) {
      if constexpr (A8)
        wg_desc64_pieces(xd[q], ring_a + slot * kStage);
      else
        wg_desc_pieces(xd[q], ring_a + slot * kStage + q * kXTile);
    }
    keep(a0);
    convert<A8, 0>(a0, wq);
    keep(a0);
    wg_fence();
    slab_products<A8, TM, PL>(acc0, a0, xd);
    wg_commit();

    wg_wait<1>();                   // slab 1 of stage i - 1 is done: a1 is free
    keep(a1);
    convert<A8, 1>(a1, wq);
    keep(a1);
    wg_fence();
    slab_products<A8, TM, PL>(acc1, a1, xd);
    wg_commit();
  }
  wg_wait<0>();
  keep(acc0);
  keep(acc1);

  // token 8 j + 2 tig + b: this thread's four columns side by side
  if (n4 >= N) return;
  const float4 sc = splits == 1 ? *reinterpret_cast<const float4*>(scale + n4)
                                : make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
  for (int j = 0; j < TM / 8; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int m = m0 + 8 * j + 2 * tig + b;
      if (m >= M) continue;
      const float v0 = static_cast<float>(acc0[4 * j + b]);
      const float v1 = static_cast<float>(acc0[4 * j + 2 + b]);
      const float v2 = static_cast<float>(acc1[4 * j + b]);
      const float v3 = static_cast<float>(acc1[4 * j + 2 + b]);
      if (splits == 1) {
        float o[4] = {v0 * sc.x, v1 * sc.y, v2 * sc.z, v3 * sc.w};
        if constexpr (A8) {
          const float s = sx[m];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] *= s;
        }
        if constexpr (PL == 3) {
          *reinterpret_cast<float4*>(y + static_cast<size_t>(m) * N + n4) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
          *reinterpret_cast<uint2*>(y + static_cast<size_t>(m) * N + n4) =
              make_uint2(as_u32(lo), as_u32(hi));
        }
      } else {
        *reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.z) * M + m) * N + n4) =
            make_float4(v0, v1, v2, v3);
      }
    }
}

template <bool A8, int TM, int PL>
cudaError_t launch_tile(const void* x, const float* sx, const int8_t* w, const float* scale,
                        void* y, float* ws, int M, int K, int N, int splits, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<A8, PL>(TM);
  cudaError_t err = allow_smem(int8_mm_wgmma_kernel<A8, TM, PL>, kSmem);
  if (err != cudaSuccess) return err;
  // whole stages a split; a split past K writes zeros
  const int kps = ((K / kKS + splits - 1) / splits) * kKS;
  // token tiles run fastest: the blocks in flight share a few column blocks of W
  const dim3 grid((M + TM - 1) / TM, (N + kBN - 1) / kBN, splits);
  const auto* xp = static_cast<const typename Operand<A8>::X*>(x);
  auto* yp = static_cast<std::conditional_t<PL == 3, float, bf16>*>(y);
  if constexpr (A8 || PL == 3)   // starts while the quantiser (the split) ahead of it runs
    return launch_after_prior_grid(int8_mm_wgmma_kernel<A8, TM, PL>, grid, dim3(kWgThreads),
                                   kSmem, st, xp, sx, w, scale, yp, ws, M, K, N, kps, splits);
  int8_mm_wgmma_kernel<A8, TM, PL><<<grid, kWgThreads, kSmem, st>>>(xp, sx, w, scale, yp, ws, M,
                                                                      K, N, kps, splits);
  return cudaGetLastError();
}

// the token tiles of each operand type: multiples of 8 for bf16; for int8 the
// widths the s8 product takes from 17 rows on; for f32 x (three planes) the
// multiples of 8 from 24 (17 rows) to 64
#define AHA_W8_TILES(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96) X(104) X(112) X(120) X(128)
#define AHA_W8A8_TILES(X) X(24) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
#define AHA_W8X3_TILES(X) X(24) X(32) X(40) X(48) X(56) X(64)

// the operand types' codes (the wrapper's): 0 bf16 x, 1 int8 x, 2 f32 x as three bf16 planes
template <bool A8, int PL>
cudaError_t launch(const void* x, const float* sx, const void* w, const void* scale, void* y,
                   float* ws, int M, int K, int N, int splits, int tile, cudaStream_t st) {
  if (K % kKS != 0 || N % 16 != 0 || (N + kBN - 1) / kBN > 65535) return cudaErrorInvalidValue;
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
#define AHA_TILE(TM) \
  case TM: return launch_tile<A8, TM, PL>(x, sx, wp, sp, y, ws, M, K, N, splits, st);
  if constexpr (A8) {
    switch (tile) {
      AHA_W8A8_TILES(AHA_TILE)
      default: return cudaErrorInvalidValue;
    }
  } else if constexpr (PL == 3) {
    switch (tile) {
      AHA_W8X3_TILES(AHA_TILE)
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (tile) {
      AHA_W8_TILES(AHA_TILE)
      default: return cudaErrorInvalidValue;
    }
  }
#undef AHA_TILE
}

int smem_of(int tile, int operand) {
#define AHA_TILE(TM) \
  case TM: return operand == 1 ? smem_bytes<true>(TM) : operand == 2 ? smem_bytes<false, 3>(TM) \
                                                                     : smem_bytes<false>(TM);
  if (operand == 1) {
    switch (tile) {
      AHA_W8A8_TILES(AHA_TILE)
      default: return -1;
    }
  }
  if (operand == 2) {
    switch (tile) {
      AHA_W8X3_TILES(AHA_TILE)
      default: return -1;
    }
  }
  if (operand != 0) return -1;
  switch (tile) {
    AHA_W8_TILES(AHA_TILE)
    default: return -1;
  }
#undef AHA_TILE
}

}  // namespace w8

// ---- decode rows (1 .. 16), K % 64 == 0, N % 16 == 0: mma.sync, bf16 x or int8 x ----------
//
// A token (1 row), a verify pass (4 or 8 candidates, 5 or 9 rows with the last
// token) and the generation prompt (13 rows) move K N weight bytes for at most
// 32 K N operations: the bytes bound them by two orders of magnitude, so the
// design keeps weight bytes in flight and the conversion cheap and off the
// copies' path. One kernel, one plan and one order of sums for every M from 1 to
// 16: x is the A operand of mma.sync (16 token rows, those past M zero), so a
// row's output is the same bits whether it goes alone or with 15 others. The
// model is int4_matmul.cu's decode kernel (section w4d there).
//
// Four warps a block, each on its own 32 weight columns. A block owns 128 weight
// columns and a K split of whole 64-row stages, and walks it through a ring of
// STAGES slots filled by cp.async, all but one in flight. A stage holds the x
// tile (16 rows, swizzled: ldmatrix reads it without conflicts) and the weight
// bytes (64 rows of the block's 128 columns), all in 16-byte copies. The thread
// (gid, tig) of warp w reads 32-bit words of weight rows at columns 32 w + 4 gid
// .. + 3; byte t of a word is column 32 w + 4 gid + t, which is column gid of its
// n-tile t (the columns are relabelled, no data is shuffled). Its accumulator
// element (n-tile t, column 2 tig + e) is weight column 32 w + 8 tig + 4 e + t:
// the eight columns 32 w + 8 tig .. + 7 of tokens gid and gid + 8 leave as 16-byte
// stores. Two operand types, one kernel (A8):
//   * bf16 x, weight-only: m16n8k16 bf16 into f32, x rows of 128 bytes in the
//     128-byte swizzle, weight rows 144 bytes apart (rows 2 tig + d of a warp's
//     read fall in distinct banks). The thread reads rows 16 p + 2 tig + (0, 1, 8,
//     9): byte t of the first two words is the (k, k + 1) pair of its n-tile t,
//     the register b0, the other two words give b1. A register is pair_bf16: one
//     byte permute, two logic operations and one bf16x2 addition, exact, with its
//     four constants held in registers.
//   * int8 x (xq, sx from csrc/quantize_rows.cu): m16n8k32 s8 into exact int32
//     sums, x rows of 64 bytes in the 64-byte swizzle, weight rows 128 bytes apart
//     with their chunks swizzled (a8_weight_chunk). The thread reads rows 32 p +
//     4 tig + d and 32 p + 16 + 4 tig + d (d = 0 .. 3): byte t of the four words
//     of each group, transposed (byte_columns), is its b0 and b1 of n-tile t, with
//     no conversion.
//
// One accumulator set over the split; the wait for a stage carries no proxy fence
// (copies_landed). With one split the epilogue multiplies by the column scale (and
// for int8 x the row scale sx, after the int32 sum is made f32 once) and rounds
// once; otherwise each split writes its f32 sums and splitk_reduce adds them in
// split order, then scales and rounds.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): the weight bytes, and how
// evenly a grid of short blocks fills 132 SMs. For bf16 x, with the conversion
// and the products switched off the copies alone were only 5-10% faster; what
// moved the time was the blocks an SM holds against the grid. Three slots (two
// stages in flight, six blocks an SM) were the fastest for a layer's products,
// whose grids the plan keeps within one round; a grid of more than a round (the
// lm_head's 1,188 blocks) takes the ring that holds three blocks an SM (six slots
// for bf16 x, eight for int8 x, whose slots are smaller), three even rounds. Ring
// depths 4 and 5 (five and four blocks an SM) and two blocks an SM were slower;
// the 256-byte L2 prefetch hint on the weight copies was a little faster.
namespace w8d {

using namespace wg;

constexpr int kThreads = 128;                 // four warps, 32 weight columns each
constexpr int kBN = 128;                      // weight columns per block
constexpr int kTM = 16;                       // token rows, the A operand's 16
constexpr int kKS = 64;                       // contraction depth of a stage

// a ring slot: the x tile and the weight rows (bf16 x: 11264 bytes, int8 x: 9216)
template <bool A8> struct Slot {
  static constexpr int kXRow = A8 ? 64 : 128;
  static constexpr int kWRow = A8 ? 128 : kBN + 16;
  static constexpr int kXBytes = kTM * kXRow;
  static constexpr int kBytes = kXBytes + kKS * kWRow;
};

// a ring of STAGES slots, and the blocks an SM holds with it (each costs 1 KB more);
// the kernel is compiled for at most six (its registers then fit)
template <bool A8> __host__ __device__ constexpr int smem_bytes(int stages) {
  return stages * Slot<A8>::kBytes;
}
template <bool A8> __host__ __device__ constexpr int blocks_per_sm(int stages) {
  return w8::kSmemPerSm / (smem_bytes<A8>(stages) + 1024);
}
template <bool A8> __host__ __device__ constexpr int min_blocks(int stages) {
  return blocks_per_sm<A8>(stages) < 6 ? blocks_per_sm<A8>(stages) : 6;
}

// 16 bytes global -> shared, asynchronously, with the 256-byte L2 prefetch hint;
// zeros where !ok (src stays a valid address)
__device__ __forceinline__ void cp_async16_l2(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

// The int8 values of byte C of a (low half) and of b (high half) as a bf16 pair,
// exactly: as w8::pair_bf16, with the masks and biases m7f = 0x007F007F,
// m43 = 0x43004300, m80 = 0x00800080, mc3 = 0xC300C300 held in registers
// ((p & m7f) | m43 and (p & m80) ^ mc3 are one logic operation each)
template <int C>
__device__ __forceinline__ uint32_t pair_bf16(uint32_t a, uint32_t b, uint32_t m7f, uint32_t m43,
                                              uint32_t m80, uint32_t mc3) {
  constexpr uint32_t sel = C | (C << 4) | ((4 + C) << 8) | ((4 + C) << 12);
  const uint32_t p = __byte_perm(a, b, sel);
  uint32_t low, high;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(low) : "r"(p), "r"(m7f), "r"(m43));
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(high) : "r"(p), "r"(m80), "r"(mc3));
  return as_u32(__hadd2(as_bf162(low), as_bf162(high)));
}

template <bool A8, int STAGES>
__global__ void __launch_bounds__(kThreads, min_blocks<A8>(STAGES))
int8_mm_decode_kernel(const typename w8::Operand<A8>::X* __restrict__ x,
                      const float* __restrict__ sx, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, bf16* __restrict__ y,
                      float* __restrict__ ws, int M, int K, int N, int stages_per_split,
                      int splits) {
  using S = Slot<A8>;
  constexpr int kStage = S::kBytes, kXBytes = S::kXBytes, kWRow = S::kWRow;
  extern __shared__ __align__(128) unsigned char smem_w8d[];
  const uint32_t ring_a = smem_addr(smem_w8d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int sbeg = blockIdx.y * stages_per_split;
  const int nst = max(0, min(K / kKS, sbeg + stages_per_split) - sbeg);   // stages of this split
  const int kbeg = sbeg * kKS;

  // this thread's share of a stage's copies, as running sources: one chunk of the
  // x tile (rows past M are zeros) and four 16-byte chunks of the weight bytes
  // (row idx / 8, columns 16 (idx % 8) ..)
  const std::conditional_t<A8, Rows64Copy<kTM>, RowsCopy<kTM>> copy_x(static_cast<size_t>(K));
  const typename w8::Operand<A8>::X* xsrc = x + kbeg;
  const int8_t* wsrc[4];
  uint32_t wdst[4];
  bool wok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int idx = tid + c * kThreads, row = idx >> 3, col = n0 + (idx & 7) * 16;
    wok[c] = col < N;
    wsrc[c] = w + static_cast<size_t>(kbeg + row) * N + (wok[c] ? col : 0);
    wdst[c] = kXBytes + row * kWRow + w8::weight_chunk<A8>(row, idx & 7) * 16;
  }
  const size_t wstep = static_cast<size_t>(kKS) * N;
  int lslot = 0, lstage = 0;   // the next load: its slot and stage
  auto load = [&]() {
    if (lstage < nst) {
      const uint32_t st = ring_a + lslot * kStage;
      copy_x(st, xsrc, M);
#pragma unroll
      for (int c = 0; c < 4; ++c) cp_async16_l2(st + wdst[c], wsrc[c], wok[c]);
      xsrc += kKS;
#pragma unroll
      for (int c = 0; c < 4; ++c) wsrc[c] += wstep;
    }
    cp_async_commit();
    ++lstage;
    lslot = lslot == STAGES - 1 ? 0 : lslot + 1;
  };
  // weight row 2 tig (int8: 4 tig, its chunks swizzled by tig) of a stage at its
  // four columns; the row of the x tile that this lane names to ldmatrix (matrix
  // lane / 8: token rows 8 (lane / 8 % 2) .., the second 16 bytes of a piece
  // from lane 16)
  const int w_off = A8 ? kXBytes + 4 * tig * kWRow + 4 * ((8 * warp + gid) ^ (8 * tig))
                       : kXBytes + 2 * tig * kWRow + (32 * warp + 4 * gid);
  const int xr = (lane & 7) + ((lane >> 3) & 1) * 8;
  constexpr int P = A8 ? 2 : 4;   // pieces of a stage: 32 deep (int8) or 16 (bf16)
  uint32_t x_off[P];   // the piece's 16-byte chunk of that row, swizzled
#pragma unroll
  for (int p = 0; p < P; ++p)
    x_off[p] = A8 ? xr * 64 + (((2 * p + (lane >> 4)) ^ ((xr >> 1) & 3)) << 4)
                  : xr * 128 + (((2 * p + (lane >> 4)) ^ (xr & 7)) << 4);

  typename w8::Operand<A8>::Acc acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;
  uint32_t m7f = 0, m43 = 0, m80 = 0, mc3 = 0;
  if constexpr (!A8) {
    m7f = pinned(0x007F007Fu), m43 = pinned(0x43004300u);
    m80 = pinned(0x00800080u), mc3 = pinned(0xC300C300u);
  }

  if constexpr (A8) {
    // the weight bytes of the first stages do not depend on the quantiser ahead of
    // this kernel: in flight before waiting for its xq and sx
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nst) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cp_async16_l2(ring_a + i * kStage + wdst[c], wsrc[c] + i * wstep, wok[c]);
      }
    }
    wait_prior_grid();
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nst) copy_x(ring_a + i * kStage, xsrc + i * kKS, M);
      cp_async_commit();
    }
    xsrc += (STAGES - 1) * kKS;
#pragma unroll
    for (int c = 0; c < 4; ++c) wsrc[c] += (STAGES - 1) * wstep;
    lstage = lslot = STAGES - 1;
  } else {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) load();
  }
  int slot = 0;   // of the stage being multiplied
  for (int i = 0; i < nst; ++i) {
    copies_landed<STAGES - 2>();   // this stage has landed
    __syncthreads();                // ... for every thread, and every warp is past the last one
    load();                         // into the slot the last stage freed
    const unsigned char* st = smem_w8d + slot * kStage + w_off;
    const uint32_t sa = ring_a + slot * kStage;
    slot = slot == STAGES - 1 ? 0 : slot + 1;
    uint32_t wq[4][4];   // rows past w_off's: 16 p + d (int8), 16 p + (0, 1, 8, 9)[d] (bf16)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int d = 0; d < 4; ++d)
        wq[p][d] = lds32(st + (A8 ? 16 * p + d : 16 * p + (d & 1) + 8 * (d >> 1)) * kWRow);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t a[4];
      ldmatrix_x4(a, sa + x_off[p]);
      if constexpr (A8) {
        uint32_t b0[4], b1[4];   // n-tile t: k 4 tig .. + 3, and 16 + 4 tig .. + 3
        byte_columns<0>(b0[0], b0[1], wq[2 * p][0], wq[2 * p][1], wq[2 * p][2], wq[2 * p][3]);
        byte_columns<1>(b0[2], b0[3], wq[2 * p][0], wq[2 * p][1], wq[2 * p][2], wq[2 * p][3]);
        byte_columns<0>(b1[0], b1[1], wq[2 * p + 1][0], wq[2 * p + 1][1], wq[2 * p + 1][2],
                        wq[2 * p + 1][3]);
        byte_columns<1>(b1[2], b1[3], wq[2 * p + 1][0], wq[2 * p + 1][1], wq[2 * p + 1][2],
                        wq[2 * p + 1][3]);
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_s8(acc[t], a, b0[t], b1[t]);
      } else {
        mma_bf16(acc[0], a, pair_bf16<0>(wq[p][0], wq[p][1], m7f, m43, m80, mc3),
                 pair_bf16<0>(wq[p][2], wq[p][3], m7f, m43, m80, mc3));
        mma_bf16(acc[1], a, pair_bf16<1>(wq[p][0], wq[p][1], m7f, m43, m80, mc3),
                 pair_bf16<1>(wq[p][2], wq[p][3], m7f, m43, m80, mc3));
        mma_bf16(acc[2], a, pair_bf16<2>(wq[p][0], wq[p][1], m7f, m43, m80, mc3),
                 pair_bf16<2>(wq[p][2], wq[p][3], m7f, m43, m80, mc3));
        mma_bf16(acc[3], a, pair_bf16<3>(wq[p][0], wq[p][1], m7f, m43, m80, mc3),
                 pair_bf16<3>(wq[p][2], wq[p][3], m7f, m43, m80, mc3));
      }
    }
  }

  // tokens gid and gid + 8: this thread's eight columns side by side
  const int nc = n0 + 32 * warp + 8 * tig;
  if (nc >= N) return;   // N % 16 == 0: all eight exist, or none
  float sc[8];
  if (splits == 1) {
    const float4 s0 = *reinterpret_cast<const float4*>(scale + nc);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + nc + 4);
    sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
    sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = gid + 8 * h;
    if (m >= M) continue;
    float v[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[t] = static_cast<float>(acc[t][2 * h]);
      v[4 + t] = static_cast<float>(acc[t][2 * h + 1]);
    }
    if (splits == 1) {
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = v[i] * sc[i];
      if constexpr (A8) {
        const float s = sx[m];
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] *= s;
      }
      uint32_t q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = as_u32(__floats2bfloat162_rn(o[2 * i], o[2 * i + 1]));
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * N + nc) =
          make_uint4(q[0], q[1], q[2], q[3]);
    } else {
      float4* o =
          reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.y) * M + m) * N + nc);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <bool A8, int STAGES>
cudaError_t launch_ring(const void* x, const float* sx, const void* w, const void* scale, void* y,
                        float* ws, int M, int K, int N, int splits, cudaStream_t st) {
  cudaError_t err = allow_smem(int8_mm_decode_kernel<A8, STAGES>, smem_bytes<A8>(STAGES));
  if (err != cudaSuccess) return err;
  // whole stages a split; a split past K writes zeros
  const int sps = (K / kKS + splits - 1) / splits;
  const dim3 grid((N + kBN - 1) / kBN, splits);
  const auto* xp = static_cast<const typename w8::Operand<A8>::X*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  if constexpr (A8)   // starts while the quantiser ahead of it runs
    return launch_after_prior_grid(int8_mm_decode_kernel<A8, STAGES>, grid, dim3(kThreads),
                                   smem_bytes<A8>(STAGES), st, xp, sx, wp, sp,
                                   static_cast<bf16*>(y), ws, M, K, N, sps, splits);
  int8_mm_decode_kernel<A8, STAGES><<<grid, kThreads, smem_bytes<A8>(STAGES), st>>>(
      xp, sx, wp, sp, static_cast<bf16*>(y), ws, M, K, N, sps, splits);
  return cudaGetLastError();
}

// the ring's slots: 3 (six blocks an SM) or, for grids of more than a round, the
// ring that holds three blocks an SM: 6 with bf16 x, 8 with int8 x
constexpr int big_ring(bool a8) { return a8 ? 8 : 6; }

template <bool A8>
cudaError_t launch(const void* x, const float* sx, const void* w, const void* scale, void* y,
                   float* ws, int M, int K, int N, int splits, int stages, cudaStream_t st) {
  if (M > kTM || K % kKS != 0 || N % 16 != 0 || splits > 65535) return cudaErrorInvalidValue;
  if (stages == 3) return launch_ring<A8, 3>(x, sx, w, scale, y, ws, M, K, N, splits, st);
  if (stages == big_ring(A8))
    return launch_ring<A8, big_ring(A8)>(x, sx, w, scale, y, ws, M, K, N, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace w8d

enum Path { kScalar = 0, kVec16 = 1, kTensorCore = 2, kWgmma = 3, kDecode = 4 };

// X = activation type as stored (int8 with sx for a8), Y = output type
template <typename X, typename Y>
cudaError_t launch(const void* x, const float* sx, const void* w, const void* scale, void* y,
                   void* ws, int M, int K, int N, int splits, int path, cudaStream_t st) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const X* xp = static_cast<const X*>(x);
  Y* yp = static_cast<Y*>(y);
  float* wsf = static_cast<float*>(ws);
  if (path == kTensorCore) {
    // split boundaries on the 32-row K step; a split past K writes zeros
    const int kps = ((K + splits - 1) / splits + kTK - 1) / kTK * kTK;
    const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, splits);
    if constexpr (std::is_same<X, int8_t>::value) {
      int8_mm_tc_a8_kernel<Y><<<grid, 128, 0, st>>>(xp, sx, wq, sc, yp, wsf, M, K, N, kps,
                                                    splits);
    } else if constexpr (std::is_same<X, __nv_bfloat16>::value &&
                         std::is_same<Y, __nv_bfloat16>::value) {
      int8_mm_tc_kernel<<<grid, 128, 0, st>>>(xp, wq, sc, yp, wsf, M, K, N, kps, splits);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const int k_per_split = (K + splits - 1) / splits;
    const dim3 block(kColGroups, kKLanes);
    const int nb = (N + kBN - 1) / kBN;
    const int vec = path == kVec16;
    if (M == 1) {
      int8_mm_kernel<X, Y, 1><<<dim3(nb, M, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, k_per_split, splits, vec);
    } else {
      constexpr int BM = 4;
      int8_mm_kernel<X, Y, BM><<<dim3(nb, (M + BM - 1) / BM, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, k_per_split, splits, vec);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_reduce<Y>(wsf, sc, sx, yp, M, N, splits, st);
}

// the tensor-core paths of either operand type (bf16 output), then the sum of the splits
template <bool A8>
cudaError_t launch_hopper(const void* x, const float* sx, const void* w, const void* scale,
                          void* y, void* workspace, int M, int K, int N, int splits, int path,
                          int tile, cudaStream_t st) {
  float* wsf = static_cast<float*>(workspace);
  cudaError_t err = path == kWgmma
                        ? w8::launch<A8, 1>(x, sx, w, scale, y, wsf, M, K, N, splits, tile, st)
                        : w8d::launch<A8>(x, sx, w, scale, y, wsf, M, K, N, splits, tile, st);
  if (err == cudaSuccess && splits > 1)
    err = launch_splitk_reduce<__nv_bfloat16>(wsf, static_cast<const float*>(scale), sx,
                                              static_cast<__nv_bfloat16*>(y), M, N, splits, st);
  return err;
}

// f32 x as three bf16 planes [3, M, K] on the wgmma path (f32 output), then the sum of
// the splits
cudaError_t launch_planes(const void* planes, const void* w, const void* scale, void* y,
                          void* workspace, int M, int K, int N, int splits, int tile,
                          cudaStream_t st) {
  float* wsf = static_cast<float*>(workspace);
  cudaError_t err = w8::launch<false, 3>(planes, nullptr, w, scale, y, wsf, M, K, N, splits, tile,
                                         st);
  if (err == cudaSuccess && splits > 1)
    err = launch_splitk_reduce<float>(wsf, static_cast<const float*>(scale), nullptr,
                                      static_cast<float*>(y), M, N, splits, st);
  return err;
}

}  // namespace

// path: 0 scalar CUDA-core loads, 1 16-byte CUDA-core loads (N % 16 == 0,
// 16-byte aligned weight), 2 tensor cores through mma.sync (bf16 x, M > 1,
// K % 32 == 0, N % 8 == 0, x 16-byte and weight 8-byte aligned), 3 tensor cores
// through wgmma (bf16 x, K % 64 == 0, N % 16 == 0, x, weight and scale 16-byte
// aligned; tile: the token tile, a multiple of 8 from 8 to 128; whole 64-row
// stages a split; or x_dtype AHA_BF16X3: x is an f32 x's three bf16 planes
// [3, M, K] and y f32, tile a multiple of 8 from 24 to 64), 4 the decode rows on
// mma.sync (as 3 with bf16 x, M <= 16, tile: the ring's slots, 3 or 6; whole
// 64-row stages a split); the wrapper's plan checks.
extern "C" int aha_int8_matmul(const void* x, const void* w, const void* scale, void* y,
                               void* workspace, int M, int K, int N, int x_dtype, int splits,
                               int path, int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == kWgmma && x_dtype == AHA_BF16X3)
    return static_cast<int>(launch_planes(x, w, scale, y, workspace, M, K, N, splits, tile, st));
  if (path == kWgmma || path == kDecode) {
    if (x_dtype != AHA_BF16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_hopper<false>(x, nullptr, w, scale, y, workspace, M, K, N,
                                                 splits, path, tile, st));
  }
  if (x_dtype == AHA_F32 && path != kTensorCore)
    return static_cast<int>(launch<float, float>(x, nullptr, w, scale, y, workspace, M, K, N,
                                                 splits, path, st));
  if (x_dtype == AHA_BF16)
    return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(
        x, nullptr, w, scale, y, workspace, M, K, N, splits, path, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of dynamic shared memory the wgmma path asks for at token tile `tile`
// with bf16 x (operand 0), int8 x (1) or an f32 x's three bf16 planes (2); -1: no
// such tile. The wrapper's plan computes the same number
extern "C" int aha_int8_matmul_wgmma_smem(int tile, int operand) {
  return w8::smem_of(tile, operand);
}

// bytes of dynamic shared memory the decode path asks for with a ring of `slots`
// (-1: no such ring); the wrapper's plan computes the same number
extern "C" int aha_int8_matmul_decode_smem(int slots, int a8) {
  if (slots == 3) return a8 ? w8d::smem_bytes<true>(3) : w8d::smem_bytes<false>(3);
  if (slots == w8d::big_ring(a8 != 0))
    return a8 ? w8d::smem_bytes<true>(slots) : w8d::smem_bytes<false>(slots);
  return -1;
}

// int8 activations xq [M, K] with per-row scales sx [M] (csrc/quantize_rows.cu);
// y_dtype is the output's type. Paths 3 (wgmma, from 17 rows; tile: the token
// tile, 24, 32 or a multiple of 16 up to 128) and 4 (decode rows; tile: the
// ring's slots, 3 or 8) take a bf16 output, K % 64 == 0, N % 16 == 0 and 16-byte
// aligned operands; path 2 (mma.sync) M > 1, K % 32 == 0, N % 8 == 0, xq 16-byte
// and weight 8-byte aligned, whatever y_dtype; 0 and 1 the CUDA cores.
extern "C" int aha_int8_matmul_a8(const void* xq, const void* sx, const void* w,
                                  const void* scale, void* y, void* workspace, int M, int K,
                                  int N, int y_dtype, int splits, int path, int tile,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || sx == nullptr ||
      (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sxf = static_cast<const float*>(sx);
  if (path == kWgmma || path == kDecode) {
    if (y_dtype != AHA_BF16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_hopper<true>(xq, sxf, w, scale, y, workspace, M, K, N,
                                                splits, path, tile, st));
  }
  if (y_dtype == AHA_F32)
    return static_cast<int>(launch<int8_t, float>(xq, sxf, w, scale, y, workspace, M, K, N,
                                                  splits, path, st));
  if (y_dtype == AHA_BF16)
    return static_cast<int>(launch<int8_t, __nv_bfloat16>(xq, sxf, w, scale, y, workspace, M,
                                                          K, N, splits, path, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* aha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
