// y[M, N] = sum over groups g of (x[M, g] @ W4[g, N]) * scale4[g, N]
//
// W4 is packed int4: byte (j, n) of q4value [K/2, N] holds row 2j of column n
// in its low nibble and row 2j + 1 in its high nibble, each value offset by 8
// (stored 0..15 for -8..7). scale4 [K/G, N] is bf16, one scale per group of G
// consecutive rows and output column; it multiplies the f32 partial sum of its
// group, the groups are added in f32, and the result is cast once. With int8
// activations (a8: xq [M, K] and per-row scales sx [M] from
// csrc/quantize_rows.cu) a group's sum is exact int32, converted to f32 before
// its scale, and the finished sum is multiplied by sx.
//
// Replaces the TPU kernel aha_tpu/ops/pallas/fused_matmul.py::int4_matmul
// (_kernel_int4, both a8 values): every decoder projection, the projector and
// the lm_head of the --int4 config. That kernel is handed x split into even
// and odd columns, prepared outside, because interleaving rows is costly
// there; here a thread reads x[2j], x[2j + 1] next to byte j and the split is
// never materialised.
//
// What bounds it on an H100: bytes for a generated token (M = 1) and a verify
// pass (4 .. 13 rows): the K*N/2 weight bytes (+ 2*(K/G)*N of scales) are the
// traffic, each packed byte is read from device memory once and its two
// nibbles are unpacked in registers. From a frame chunk's 49 rows on, and
// clearly at a fused pass's 196 and a training sequence's 926, operations: 2*M*K*N
// against the tensor cores' 989 TFLOP/s, so the products belong on wgmma and
// what is left beside them (unpacking a [128 x 64] piece of W per 64 rows of K,
// the copies, the group scales) decides the time (with int8 activations the
// 1,979 TOP/s of the s8 tensor cores). Four paths, chosen by the wrapper's plan()
// from the operands:
//   * decode (bf16 x weight-only, or int8 x with a bf16 output; 1 <= M <= 16,
//     G % 64 == 0, N % 16 == 0, 16-byte aligned operands): section "decode rows"
//     below. One kernel and one launch plan for every M up to 16, mma.sync per
//     warp with x as the 16-row A operand (m16n8k16 bf16, or m16n8k32 s8 with
//     exact int32 group sums), the packed bytes through a cp.async ring of seven
//     slots, 16 warps an SM. A 7B layer's four products at M = 1 .. 16 take
//     0.07-0.08 ms (bf16 x) where the CUDA-core kernel below took 0.17 (M = 1)
//     and the mma.sync kernel 0.35 (M = 4 .. 13), the lm_head 0.11 ms where they
//     took 0.24 and 0.59 (NVIDIA H100 80GB HBM3, 700 W; bounds 0.036 and
//     0.084 ms, bytes).
//   * wgmma (as decode, M >= 17; also f32 x weight-only from 17 rows, as three
//     bf16 planes, with an f32 output): section "tensor-core path, wgmma" below. The
//     product is turned round (y^T = W^T x^T), the unpacked weight is the
//     register operand of the warpgroup products (m64nTMk16 bf16, or m64nTMk32
//     s8) and never touches shared memory, raw bytes, x tiles and scales arrive
//     by cp.async through a six-slot ring, two accumulator sets (a group's sum,
//     f32 or exact int32, and the f32 total). At M = 926 a decoder layer's four
//     products take 1.23 ms (bf16 x) where the mma.sync kernel below took 4.34
//     (NVIDIA H100 80GB HBM3, 700 W; bound 0.44 ms).
//   * mma.sync (M > 1, G % 32 == 0, N % 8 == 0, where neither path above
//     applies: an f32 output of int8 x, ragged or misaligned operands): the 64 x 128 tile
//     scheme of common.cuh, one buffer a tile, no copy overlaps a product. A
//     packed byte is exactly the (k, k + 1) pair of one column, i.e. one
//     32-bit bf16x2 word of the transposed weight tile (int8 activations:
//     two bytes make one word of four int8). Values -8..7 are exact in
//     bf16. A warp keeps two accumulator sets: the running group's (f32 or
//     int32) and the total (f32); at a group's last K step the first is
//     scaled into the second.
//   * CUDA cores (M = 1 off the decode path, f32 x at 1 .. 16 rows, ragged shapes): a
//     block covers 128 columns;
//     each of its 256 threads owns 16 contiguous columns (one 16-byte load
//     = 16 columns x 2 rows) and one of 32 lanes along K. The lanes are 4
//     group slots x 8 row lanes: a thread walks whole groups, so that it
//     applies each group's scale once to its own partial sum.
// When the grid would leave SMs idle, K is split over the grid (whole groups on
// the CUDA-core, decode and wgmma paths, 32-row steps on the mma.sync path; a group cut
// by a split boundary is scaled on both sides, which is the same sum): each
// split writes an f32 partial and splitk_reduce adds them in a fixed order.
#include <type_traits>

#include "wgmma.cuh"

namespace {

// ---- CUDA-core path ---------------------------------------------------------

constexpr int kCols = 16;                  // columns per thread (one 16B load)
constexpr int kColGroups = 8;              // threads along N
constexpr int kBN = kCols * kColGroups;    // 128 columns per block
constexpr int kKLanes = 32;                // threads along K
constexpr int kRowLanes = 8;               // lanes sharing one group
constexpr int kSlots = kKLanes / kRowLanes;   // groups in flight per block

template <typename X> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

// A stored nibble n (0..15) as its value n - 8 in the accumulator's type. The
// f32 form avoids the quarter-rate int -> float conversion: 0x4B000000 | n is
// the float 2^23 + n, and subtracting 2^23 + 8 is exact.
template <typename Acc> __device__ __forceinline__ Acc nibble_value(uint32_t n);
template <> __device__ __forceinline__ float nibble_value<float>(uint32_t n) {
  return __uint_as_float(0x4B000000u | n) - 8388616.0f;
}
template <> __device__ __forceinline__ int nibble_value<int>(uint32_t n) {
  return static_cast<int>(n) - 8;
}

// A packed byte b as the bf16 pair (low nibble - 8, high nibble - 8): 0x4300 | n
// is the bf16 128 + n (its ulp is 1 there), and subtracting 136 is exact.
__device__ __forceinline__ __nv_bfloat162 nibbles_bf162(uint32_t b) {
  const uint32_t biased = 0x43004300u | (b & 0xFu) | ((b >> 4) << 16);
  const uint32_t offset = 0x43084308u;
  return __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                 *reinterpret_cast<const __nv_bfloat162*>(&offset));
}

template <typename X, typename Y, int BM>
__global__ void __launch_bounds__(kColGroups * kKLanes)
int4_mm_kernel(const X* __restrict__ x, const float* __restrict__ sx,
               const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ scale4,
               Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N, int G,
               int groups_per_split, int splits, int vec) {
  using Acc = typename AccOf<X>::type;
  const int cg = threadIdx.x;               // column group
  const int kl = threadIdx.y;               // K lane
  const int slot = kl / kRowLanes, rl = kl % kRowLanes;
  const int n0 = blockIdx.x * kBN + cg * kCols;
  const int m0 = blockIdx.y * BM;
  const int Gh = G / 2;                     // packed rows per group
  const int gbeg = blockIdx.z * groups_per_split;
  const int gend = min(K / G, gbeg + groups_per_split);

  float tot[BM][kCols];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) tot[r][c] = 0.f;

  const bool full = vec && (n0 + kCols <= N);
  for (int g = gbeg + slot; g < gend; g += kSlots) {
    Acc grp[BM][kCols];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) grp[r][c] = 0;

#pragma unroll 2
    for (int j = g * Gh + rl; j < (g + 1) * Gh; j += kRowLanes) {
      Acc lo[kCols], hi[kCols];
      const uint8_t* wrow = w + static_cast<size_t>(j) * N + n0;
      if (full) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(wrow));
        const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t b = (word[c >> 2] >> (8 * (c & 3))) & 0xffu;
          lo[c] = nibble_value<Acc>(b & 0xFu);
          hi[c] = nibble_value<Acc>(b >> 4);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t b = (n0 + c < N) ? wrow[c] : 0x88u;   // 0x88: both nibbles zero
          lo[c] = nibble_value<Acc>(b & 0xFu);
          hi[c] = nibble_value<Acc>(b >> 4);
        }
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        Acc x0 = 0, x1 = 0;
        if (m0 + r < M) load2(x + static_cast<size_t>(m0 + r) * K + 2 * j, x0, x1);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          grp[r][c] = mad(x1, hi[c], mad(x0, lo[c], grp[r][c]));
      }
    }
    // the group's scale, once, on this thread's share of the group's sum
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float s =
          (n0 + c < N) ? __bfloat162float(scale4[static_cast<size_t>(g) * N + n0 + c]) : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) tot[r][c] += static_cast<float>(grp[r][c]) * s;
    }
  }

  // sum the 32 K lanes through shared memory, one row at a time
  __shared__ float red[kKLanes][kBN + 4];
  const int t = kl * kColGroups + cg;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[kl][cg * kCols + c] = tot[r][c];
    __syncthreads();
    if (t < kBN) {
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < kKLanes; ++l) s += red[l][t];
      const int row = m0 + r, col = blockIdx.x * kBN + t;
      if (row < M && col < N) {
        if (splits == 1) {
          if (sx != nullptr) s *= sx[row];
          y[static_cast<size_t>(row) * N + col] = from_f32<Y>(s);
        } else {
          ws[(static_cast<size_t>(blockIdx.z) * M + row) * N + col] = s;
        }
      }
    }
    __syncthreads();
  }
}

// ---- tensor-core path, mma.sync ------------------------------------------------------

// A8 = false: x bf16, group sums in f32. A8 = true: x int8 (+ sx), group sums
// in int32.
template <bool A8, typename Y>
__global__ void __launch_bounds__(128)
int4_mm_tc_kernel(const void* __restrict__ x, const float* __restrict__ sx,
                  const uint8_t* __restrict__ w, const __nv_bfloat16* __restrict__ scale4,
                  Y* __restrict__ y, float* __restrict__ ws, int M, int K, int N, int G,
                  int k_per_split, int splits) {
  using Acc = typename std::conditional<A8, int, float>::type;
  constexpr int RB = TileRow<A8>::kBytes;
  __shared__ __align__(16) unsigned char xs[kTM * RB];
  __shared__ __align__(16) unsigned char wt[kTN * RB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;   // the warp's 32 x 64 sub-tile

  float tot[2][8][4];
  Acc grp[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[mi][ni][e] = 0.f;
        grp[mi][ni][e] = 0;
      }

  for (int k0 = kbeg; k0 < kend; k0 += kTK) {
    stage_x_tile<A8>(xs, x, m0, M, K, k0, tid);
    const uint8_t* wp = w + static_cast<size_t>(k0 / 2) * N;   // 16 packed rows of this step
    if constexpr (A8) {
      // 8 pairs of packed rows (four K values) x 16 groups of 8 columns, one
      // item per thread; a column's four values become one word of wt[n][k]
      const int kq = tid & 7, ng = (tid >> 3) * 8, n = n0 + ng;
      uint2 p0 = make_uint2(0u, 0u), p1 = make_uint2(0u, 0u);
      if (n < N) {   // N % 8 == 0: a group of columns is all in or all out
        p0 = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(2 * kq) * N + n));
        p1 = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(2 * kq + 1) * N + n));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t a = byte_of(p0, j), b = byte_of(p1, j);
        // (nibble - 8) as int8: 0..15 -> 0xF8..0x07
        const uint32_t word = (((a & 0xFu) - 8u) & 0xffu) | ((((a >> 4) - 8u) & 0xffu) << 8) |
                              ((((b & 0xFu) - 8u) & 0xffu) << 16) |
                              ((((b >> 4) - 8u) & 0xffu) << 24);
        *reinterpret_cast<uint32_t*>(wt + (ng + j) * RB + kq * 4) = word;
      }
    } else {
      // 16 packed rows x 16 groups of 8 columns, two items per thread; a
      // packed byte is the (k, k + 1) bf16 pair of its column
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int c = tid + it * 128;
        const int kp = c & 15, ng = (c >> 4) * 8, n = n0 + ng;
        uint2 p = make_uint2(0u, 0u);
        if (n < N) p = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(kp) * N + n));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(wt + (ng + j) * RB + kp * 4) =
              nibbles_bf162(byte_of(p, j));
        }
      }
    }
    __syncthreads();
    mma_tile<A8>(grp, xs, wt, wm, wn, gid, tig);
    __syncthreads();

    const int knext = k0 + kTK;
    if (knext % G == 0 || knext >= kend) {
      // last step of a group (or of this split's share of it): scale the
      // group's sum into the total
      const __nv_bfloat16* srow = scale4 + static_cast<size_t>(k0 / G) * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn + ni * 8 + tig * 2;
        float s0 = 0.f, s1 = 0.f;
        if (col < N) {   // col even, N % 8 == 0: col + 1 < N too
          s0 = __bfloat162float(srow[col]);
          s1 = __bfloat162float(srow[col + 1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          tot[mi][ni][0] += static_cast<float>(grp[mi][ni][0]) * s0;
          tot[mi][ni][1] += static_cast<float>(grp[mi][ni][1]) * s1;
          tot[mi][ni][2] += static_cast<float>(grp[mi][ni][2]) * s0;
          tot[mi][ni][3] += static_cast<float>(grp[mi][ni][3]) * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) grp[mi][ni][e] = 0;
        }
      }
    }
  }
  store_tile<Y>(tot, y, ws, nullptr, sx, M, N, m0, n0, wm, wn, gid, tig, splits, blockIdx.z);
}

// ---- tensor-core path, wgmma (G % 64 == 0, N % 16 == 0): bf16 x weight-only, or int8 x -------
//
// The product turned round: y^T = W^T x^T. The 64-row side of a warpgroup
// product runs over weight columns, its register operand is a piece of W^T built
// in registers from the packed bytes, and its width is the token tile: the
// unpacked weight never exists in memory of any kind, the raw bytes travel device
// memory -> ring -> registers. The group scale belongs to an accumulator ROW
// here, two scales a thread and slab.
//
// A block is one warpgroup that owns 128 weight columns (two slabs of 64) and a
// token tile of TM <= 80 rows, and walks K in stages of 64 through a ring of
// kStages slots filled by cp.async, four stages ahead. A stage holds the x tile
// (TM rows, the B operand as it lies, swizzled), the packed bytes (32 packed rows
// of 128 columns, rows apart by a stride at which the rows a warp reads at once
// fall in distinct banks) and the group's 128 scales, all in 16-byte copies
// (4-byte copies of a thread's own words cost a quarter of the kernel's time).
// The thread whose accumulator rows are gid and gid + 8 of warp w owns the four
// neighbouring columns 4 (8 w + gid) .. + 3 (rows gid and gid + 8 of slab 0, then
// of slab 1: the accumulator rows are relabelled, no data is shuffled): a 32-bit
// word of a packed row is its share of that row, and y leaves as 8-byte stores of
// those four columns.
//
// Two operand types, one kernel (A8):
//   * bf16 x, weight-only: x rows of 128 bytes in the 128-byte swizzle, packed
//     rows 160 bytes apart, products m64nTMk16 bf16 into f32 group sums. A packed
//     byte is the (2 j, 2 j + 1) bf16 pair of its column, i.e. one register of
//     the operand; the thread reads packed rows tig + 4 q (unpack).
//   * int8 x (xq, sx from csrc/quantize_rows.cu): x rows of 64 bytes in the
//     64-byte swizzle, products m64nTMk32 s8 into exact int32 group sums. A
//     register of the operand is four consecutive K rows of one column, i.e. two
//     bytes of two packed rows: the thread reads packed rows 2 tig + 8 m and the
//     next (m = 0 .. 3: k 4 tig .. + 3 and 16 + 4 tig .. + 3 of the stage's two
//     32-deep pieces), 144 bytes apart, and builds each register with
//     nibble_columns (wgmma.cuh): the nibbles as n - 8 in s8, a byte permute, two
//     masks, two permutes and two logic / add pairs for two registers. The token
//     tile is a width the s8 product takes (24, 32, 48, 64, 80). A group's int32
//     sum is exact (|sum| <= 128 * 127 * 8 < 2^24) and becomes f32 once; it is
//     multiplied by its scale and added into the f32 total as two roundings, in
//     group order, as the TPU kernel does (acc += part * s); the total times sx,
//     one cast. The kernel starts while the quantiser ahead of it runs
//     (programmatic dependent launch): the weight and scale copies of the first
//     stages are in flight before it waits for xq and sx.
//   * f32 x, weight-only, f32 output (PL = 3), as int8_matmul.cu's: x arrives as
//     its three bf16 planes ([3, M, K], split_bf16x3 in csrc/quantize_rows.cu),
//     the stage holds the three x tiles one after another, and each piece's
//     unpacked register is the operand of three products (hi, mid, lo) into the
//     group's f32 sum, which then takes its scale as with bf16 x: the planes add
//     up within the group before the bf16 group scale, as the TPU kernel's f32
//     dot of a group does (acc += part * s). Values -8 .. 7 and the planes are
//     exact in bf16, so each product is exact, and a group's sum takes 24 of them
//     (G 128). The ring is as deep as two blocks an SM leave room for (three to
//     six slots); the kernel starts while the split ahead of it runs, as behind
//     the quantiser. A 7B decoder layer at M = 49 takes 0.31 ms, where the
//     CUDA-core kernel took 4.65; at 196 0.91 against 17.26 (NVIDIA H100 80GB
//     HBM3, 700 W).
//
// The two slabs alternate: while the tensor cores run one slab's products of a
// stage, the threads unpack the other's operand. After a group's last stage the
// block waits for its products and adds both slabs' group sums times their
// scales into the totals (f32); a group's first product starts its sum anew
// (scale-d 0, a separate instruction known when compiled). Two blocks share an SM
// and fill each other's gaps. A K split covers whole groups and writes its f32
// totals as a partial.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, bf16 x, M = 926, 300-375
// TFLOP/s): not the tensor cores (about a third of their rate). Builds with parts
// switched off: no unpacking 3%, no wait at a group's end 5%, half the x tile's
// bytes 5%, no weight and scale copies 24% while those were 4-byte copies
// (16-byte ones took 10% off). What is left is the chain of a stage on one
// warpgroup, some 300 instructions, many on the half-rate integer pipe. Tried and
// dropped: a scale pass per slab beside the other slab's products (the assembler
// then makes every product wait for the one before it, see stage()); three blocks
// an SM at 56 rows (slower by a third).
namespace w4 {

using namespace wg;

constexpr int kSlabs = 2;             // 64-column slabs of the weight per block
constexpr int kBN = 64 * kSlabs;      // weight columns per block
constexpr int kKS = 64;               // contraction depth of a stage
constexpr int kMaxStages = 6;         // ring slots at most; all but two stages are in flight
constexpr int kSBytes = kBN * 2;      // the group's scales of the block's columns
constexpr int kSmemPerSm = 233472;    // 228 KB, of which each block costs 1 KB more

// what the two operand types change: the x tile's row bytes, the packed rows'
// stride, the pieces of a stage, the group sums' type
template <bool A8> struct Operand {
  using X = bf16;
  using Grp = float;
  static constexpr int kXRow = 128, kWRow = 160, kPieces = 4;
};
template <> struct Operand<true> {
  using X = int8_t;
  using Grp = int;
  static constexpr int kXRow = 64, kWRow = 144, kPieces = 2;
};

// the x tile (PL tiles: the planes of an f32 x), then the packed bytes and the scales
// from a multiple of 1024 bytes
template <bool A8, int PL = 1> __host__ __device__ constexpr int stage_bytes(int TM) {
  return PL * TM * Operand<A8>::kXRow +
         ((kKS / 2) * Operand<A8>::kWRow + kSBytes + 1023) / 1024 * 1024;
}
// ring slots: six, or as many as two blocks an SM leave room for (f32 x)
template <bool A8, int PL = 1> __host__ __device__ constexpr int stages(int TM) {
  return PL == 1 ? kMaxStages
         : (kSmemPerSm / 2 - 1024 - kAlignSlack) / stage_bytes<A8, PL>(TM) < kMaxStages
             ? (kSmemPerSm / 2 - 1024 - kAlignSlack) / stage_bytes<A8, PL>(TM)
             : kMaxStages;
}
template <bool A8, int PL = 1> __host__ __device__ constexpr int smem_bytes(int TM) {
  return stages<A8, PL>(TM) * stage_bytes<A8, PL>(TM) + kAlignSlack;
}

// the constants the unpacking holds in registers: 0x43 in every byte (bf16 x), the
// masks and biases of nibble_columns (int8 x)
struct UnpackConsts {
  uint32_t bias, m0f, m78, m80;
};

// bf16 x: the [64 x 16] operands of a stage's four products for slab SLAB, from
// this thread's eight words (word q: packed row tig + 4 q of its four columns, the
// slab's two in bytes 2 SLAB and 2 SLAB + 1). 0x4300 | n is the bf16 128 + n
// (its ulp is 1 there), and subtracting 136 is exact: byte permutes put the low
// and the high nibbles of the two columns beside 0x43, one subtraction makes
// each a pair of values, two more permutes sort them by column.
template <int SLAB>
__device__ __forceinline__ void unpack(uint32_t (&a)[4][4], const uint32_t (&wq)[8],
                                       const UnpackConsts& k) {
  const uint32_t bias = k.bias;
  const __nv_bfloat162 offset = as_bf162(0x43084308u);   // the bf16 pair (136, 136)
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t lo = wq[q] & 0x0F0F0F0Fu, hi = (wq[q] >> 4) & 0x0F0F0F0Fu;
    constexpr uint32_t two_columns = SLAB == 0 ? 0x4140u : 0x4342u;
    // rows 2 j (low nibbles) and 2 j + 1 (high nibbles) of the slab's two columns
    const uint32_t even = as_u32(__hsub2(as_bf162(__byte_perm(lo, bias, two_columns)), offset));
    const uint32_t odd = as_u32(__hsub2(as_bf162(__byte_perm(hi, bias, two_columns)), offset));
    a[q >> 1][2 * (q & 1)] = __byte_perm(even, odd, 0x5410u);       // column 0: rows 2 j, 2 j + 1
    a[q >> 1][2 * (q & 1) + 1] = __byte_perm(even, odd, 0x7632u);   // column 1
  }
}
// int8 x: the [64 x 32] s8 operands of a stage's two products for slab SLAB, from
// this thread's eight words (words 2 m, 2 m + 1: packed rows 2 tig + 8 m and the
// next, i.e. K rows 16 m + 4 tig .. + 3): piece p takes m = 2 p (registers 0, 1:
// k 4 tig ..) and 2 p + 1 (registers 2, 3: k 16 + 4 tig ..), row gid the slab's
// first column, row gid + 8 its second
template <int SLAB>
__device__ __forceinline__ void unpack(uint32_t (&a)[2][4], const uint32_t (&wq)[8],
                                       const UnpackConsts& k) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    nibble_columns<SLAB>(a[p][0], a[p][1], wq[4 * p], wq[4 * p + 1], k.m0f, k.m78, k.m80);
    nibble_columns<SLAB>(a[p][2], a[p][3], wq[4 * p + 2], wq[4 * p + 3], k.m0f, k.m78, k.m80);
  }
}
// a slab's products of a stage (ACC 0: the first of a group's, whose sums start
// anew); the descriptors of a stage's pieces (128-byte rows, or 64-byte int8 rows)
template <int TM, int ACC>
__device__ __forceinline__ void slab_products(float (&grp)[TM / 2], const uint32_t (&a)[4][4],
                                              const uint64_t (&xd)[4]) {
  wgmma_rs<TM>(grp, a[0], xd[0], ACC);
#pragma unroll
  for (int p = 1; p < 4; ++p) wgmma_rs<TM>(grp, a[p], xd[p], 1);
}
template <int TM, int ACC>
__device__ __forceinline__ void slab_products(int (&grp)[TM / 2], const uint32_t (&a)[2][4],
                                              const uint64_t (&xd)[2]) {
  wgmma_rs_s8<TM>(grp, a[0], xd[0], ACC);
  wgmma_rs_s8<TM>(grp, a[1], xd[1], 1);
}
// the same with the three planes of an f32 x: piece p of each plane (hi, mid, lo) times
// the piece's operand, one after another into the group's sum
template <int TM, int ACC>
__device__ __forceinline__ void slab_products(float (&grp)[TM / 2], const uint32_t (&a)[4][4],
                                              const uint64_t (&xd)[3][4]) {
  wgmma_rs<TM>(grp, a[0], xd[0][0], ACC);
  wgmma_rs<TM>(grp, a[0], xd[1][0], 1);
  wgmma_rs<TM>(grp, a[0], xd[2][0], 1);
#pragma unroll
  for (int p = 1; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) wgmma_rs<TM>(grp, a[p], xd[q][p], 1);
}
__device__ __forceinline__ void desc_pieces(uint64_t (&d)[4], uint32_t tile) {
  wg_desc_pieces(d, tile);
}
__device__ __forceinline__ void desc_pieces(uint64_t (&d)[2], uint32_t tile) {
  wg_desc64_pieces(d, tile);
}
// tot + grp * s: f32 group sums by one fused multiply-add; int32 ones made f32 once
// (exactly: |sum| <= 128 * 127 * 8 < 2^24), then a product and a sum rounded each,
// as the TPU kernel's acc += part * s
__device__ __forceinline__ float scaled_add(float tot, float grp, float s) {
  return fmaf(grp, s, tot);
}
__device__ __forceinline__ float scaled_add(float tot, int grp, float s) {
  return __fadd_rn(tot, __fmul_rn(static_cast<float>(grp), s));
}
// tot += grp * (the row's scale): rows gid (elements 4 j, 4 j + 1) and gid + 8
template <int NA, typename Grp>
__device__ __forceinline__ void add_scaled(float (&tot)[NA], const Grp (&grp)[NA], float s_a,
                                           float s_b) {
#pragma unroll
  for (int e = 0; e < NA; ++e) tot[e] = scaled_add(tot[e], grp[e], (e & 2) ? s_b : s_a);
}

// PL: the x planes (1; 3 for f32 x split into bf16 planes [3, M, K], f32 output)
template <bool A8, int TM, int PL>
__global__ void __launch_bounds__(kWgThreads, 2)
int4_mm_wgmma_kernel(const typename Operand<A8>::X* __restrict__ x, const float* __restrict__ sx,
                     const uint8_t* __restrict__ w, const bf16* __restrict__ scale4,
                     std::conditional_t<PL == 3, float, bf16>* __restrict__ y,
                     float* __restrict__ ws, int M, int K, int N, int G, int k_per_split,
                     int splits) {
  using Op = Operand<A8>;
  constexpr int kStages = stages<A8, PL>(TM), kStage = stage_bytes<A8, PL>(TM), NA = TM / 2;
  constexpr int P = Op::kPieces, kWRow = Op::kWRow;
  // the kernels launched to start while the grid ahead of them (quantiser, split) runs
  constexpr bool kBehindPrior = A8 || PL == 3;
  static_assert(PL == 1 || (PL == 3 && !A8), "planes of bf16 x only");
  static_assert(kStages >= 3, "the ring needs a slot in use, one in flight and one free");
  extern __shared__ __align__(128) unsigned char smem_w4[];
  unsigned char* ring = align_tiles(smem_w4);
  const uint32_t ring_a = smem_addr(ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int nst = max(0, min(K, kbeg + k_per_split) - kbeg) / kKS;   // whole groups a split
  const int gs = G / kKS;                                            // stages per group

  // this thread's four weight columns (N % 16 == 0: all four exist, or none)
  const int n4 = n0 + 4 * (8 * warp + gid);
  const bool n_ok = n4 < N;
  // its share of a stage's copies: rows of the x tile, two 16-byte chunks of the
  // packed bytes (row idx / 8, columns 16 (idx % 8) ..), and for 16 threads 8 scales
  const std::conditional_t<A8, Rows64Copy<TM>, RowsCopy<TM>> copy_x(static_cast<size_t>(K));
  const typename Op::X* xsrc = x + static_cast<size_t>(m0) * K + kbeg;
  const size_t plane = static_cast<size_t>(M) * K;   // elements of an x plane
  constexpr int kXTile = TM * Op::kXRow;              // bytes of an x tile (a plane's)
  constexpr int kWOff = PL * kXTile, kSOff = kWOff + (kKS / 2) * kWRow;
  const uint8_t* wsrc[2];
  uint32_t wdst[2];
  bool wok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * kWgThreads, row = idx >> 3, col = n0 + (idx & 7) * 16;
    wok[c] = col < N;
    wsrc[c] = w + static_cast<size_t>(kbeg / 2 + row) * N + (wok[c] ? col : 0);
    wdst[c] = kWOff + row * kWRow + (idx & 7) * 16;
  }
  const bool sok = tid < 16 && n0 + tid * 8 < N;
  const bf16* ssrc = scale4 + (sok ? n0 + tid * 8 : 0);
  auto load_w = [&](int i) {   // the packed bytes and scales of stage i of this split into its slot
    const uint32_t st = ring_a + (i % kStages) * kStage;
    const size_t rows = static_cast<size_t>(i) * (kKS / 2) * N;
#pragma unroll
    for (int c = 0; c < 2; ++c) cp_async16(st + wdst[c], wsrc[c] + rows, wok[c]);
    if (tid < 16)
      cp_async16(st + kSOff + tid * 16, ssrc + static_cast<size_t>((kbeg + i * kKS) / G) * N, sok);
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
  // bf16: packed row tig of a stage at this thread's four columns (its words: rows
  // tig + 4 q); int8: row 2 tig (its words: rows 2 tig + (q & 1) + 8 (q >> 1));
  // and their scales
  const int w_off = kWOff + (A8 ? 2 : 1) * tig * kWRow + (8 * warp + gid) * 4;
  const int s_off = kSOff + (8 * warp + gid) * 8;

  float tot[kSlabs][NA];
  typename Op::Grp grp[kSlabs][NA];
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      tot[s][e] = 0.f;
      grp[s][e] = 0;
    }
  uint32_t a0[P][4], a1[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) a0[p][e] = a1[p][e] = 0u;
  const UnpackConsts k = A8 ? UnpackConsts{0u, pinned(0x0F0F0F0Fu), pinned(0x78787878u),
                                            pinned(0x80808080u)}
                            : UnpackConsts{bias_bytes(), 0u, 0u, 0u};

  if constexpr (kBehindPrior) {
    // the packed bytes and scales of the first stages do not depend on the
    // quantiser (the split) ahead of this kernel: in flight before waiting for its
    // xq and sx (planes)
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
  // One stage; first: it opens a group, whose sums start anew (known when
  // compiled). The assembler follows which products are in flight only so far:
  // whatever defines an input of a product (operand registers, descriptors) is
  // pinned before the first product of its batch, and no accumulator is read
  // while a product of an earlier stage may be in flight. Otherwise it makes
  // every product wait for the one before it.
  auto stage = [&](int i, auto first) {
    constexpr int kAccumulate = decltype(first)::value ? 0 : 1;
    cp_async_wait<kStages - 3>();   // stage i has landed
    wg_wait<1>();                   // slab 0 of stage i - 1 is done: a0 is free
    __syncthreads();                // ... and every warp is past stage i - 2
    if (i + kStages - 2 < nst) load(i + kStages - 2);
    cp_async_commit();

    const int slot = i % kStages;
    const unsigned char* st = ring + slot * kStage + w_off;
    uint32_t wq[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      wq[q] = lds32(st + (A8 ? (q & 1) + 8 * (q >> 1) : 4 * q) * kWRow);
    std::conditional_t<PL == 3, uint64_t[3][P], uint64_t[P]> xd;   // (plane q's) pieces
    if constexpr (PL == 3) {
#pragma unroll
      for (int q = 0; q < 3; ++q) desc_pieces(xd[q], ring_a + slot * kStage + q * kXTile);
    } else {
      desc_pieces(xd, ring_a + slot * kStage);
    }
    keep(a0);
    unpack<0>(a0, wq, k);
    keep(a0);
    wg_fence();
    slab_products<TM, kAccumulate>(grp[0], a0, xd);
    wg_commit();

    wg_wait<1>();                   // slab 1 of stage i - 1 is done: a1 is free
    keep(a1);
    unpack<1>(a1, wq, k);
    keep(a1);
    wg_fence();
    slab_products<TM, kAccumulate>(grp[1], a1, xd);
    wg_commit();
  };
  for (int i = 0; i < nst; i += gs) {
    stage(i, std::true_type{});
    for (int j = 1; j < gs; ++j) stage(i + j, std::false_type{});
    // the group's four scales of this thread's columns (every stage of the group
    // brought them), bf16 -> f32, and its sums into the totals; the block that
    // shares the SM has the tensor cores meanwhile
    const uint2 sc =
        *reinterpret_cast<const uint2*>(ring + ((i + gs - 1) % kStages) * kStage + s_off);
    wg_wait<0>();
    keep(a0);
    keep(a1);
    keep(grp[0]);
    keep(grp[1]);
    add_scaled(tot[0], grp[0], __uint_as_float(sc.x << 16), __uint_as_float(sc.x & 0xffff0000u));
    add_scaled(tot[1], grp[1], __uint_as_float(sc.y << 16), __uint_as_float(sc.y & 0xffff0000u));
  }

  // token 8 j + 2 tig + b: this thread's four columns side by side
  if (!n_ok) return;
#pragma unroll
  for (int j = 0; j < TM / 8; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int m = m0 + 8 * j + 2 * tig + b;
      if (m >= M) continue;
      float v[4] = {tot[0][4 * j + b], tot[0][4 * j + 2 + b], tot[1][4 * j + b],
                    tot[1][4 * j + 2 + b]};
      if (splits == 1) {
        if constexpr (A8) {
          const float s = sx[m];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] *= s;
        }
        if constexpr (PL == 3) {
          *reinterpret_cast<float4*>(y + static_cast<size_t>(m) * N + n4) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(y + static_cast<size_t>(m) * N + n4) =
              make_uint2(as_u32(lo), as_u32(hi));
        }
      } else {
        *reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.z) * M + m) * N + n4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
}

template <bool A8, int TM, int PL>
cudaError_t launch_tile(const void* x, const float* sx, const uint8_t* w, const bf16* scale4,
                        void* y, float* ws, int M, int K, int N, int G, int splits,
                        cudaStream_t st) {
  constexpr int kSmem = smem_bytes<A8, PL>(TM);
  cudaError_t err = allow_smem(int4_mm_wgmma_kernel<A8, TM, PL>, kSmem);
  if (err != cudaSuccess) return err;
  // whole groups a split; a split past K writes zeros
  const int kps = ((K / G + splits - 1) / splits) * G;
  // token tiles run fastest: the blocks in flight share a few column blocks of W
  const dim3 grid((M + TM - 1) / TM, (N + kBN - 1) / kBN, splits);
  const auto* xp = static_cast<const typename Operand<A8>::X*>(x);
  auto* yp = static_cast<std::conditional_t<PL == 3, float, bf16>*>(y);
  if constexpr (A8 || PL == 3)   // starts while the quantiser (the split) ahead of it runs
    return launch_after_prior_grid(int4_mm_wgmma_kernel<A8, TM, PL>, grid, dim3(kWgThreads),
                                   kSmem, st, xp, sx, w, scale4, yp, ws, M, K, N, G, kps, splits);
  int4_mm_wgmma_kernel<A8, TM, PL><<<grid, kWgThreads, kSmem, st>>>(xp, sx, w, scale4, yp, ws, M,
                                                                      K, N, G, kps, splits);
  return cudaGetLastError();
}

// the token tiles of each operand type: multiples of 8 from 16 to 80 for bf16; for
// int8 the widths the s8 product takes up to 80; for f32 x (three planes) the
// multiples of 8 from 24 (17 rows) to 64
#define AHA_W4_TILES(X) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80)
#define AHA_W4A8_TILES(X) X(24) X(32) X(48) X(64) X(80)
#define AHA_W4X3_TILES(X) X(24) X(32) X(40) X(48) X(56) X(64)

template <bool A8, int PL>
cudaError_t launch(const void* x, const float* sx, const uint8_t* w, const bf16* scale4, void* y,
                   float* ws, int M, int K, int N, int G, int splits, int tile, cudaStream_t st) {
  if (G % kKS != 0 || N % 16 != 0 || (N + kBN - 1) / kBN > 65535) return cudaErrorInvalidValue;
#define AHA_TILE(TM) \
  case TM: return launch_tile<A8, TM, PL>(x, sx, w, scale4, y, ws, M, K, N, G, splits, st);
  if constexpr (A8) {
    switch (tile) {
      AHA_W4A8_TILES(AHA_TILE)
      default: return cudaErrorInvalidValue;
    }
  } else if constexpr (PL == 3) {
    switch (tile) {
      AHA_W4X3_TILES(AHA_TILE)
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (tile) {
      AHA_W4_TILES(AHA_TILE)
      default: return cudaErrorInvalidValue;
    }
  }
#undef AHA_TILE
}

// operand: 0 bf16 x, 1 int8 x, 2 f32 x as three bf16 planes
int smem_of(int tile, int operand) {
#define AHA_TILE(TM) \
  case TM: return operand == 1 ? smem_bytes<true>(TM) : operand == 2 ? smem_bytes<false, 3>(TM) \
                                                                     : smem_bytes<false>(TM);
  if (operand == 1) {
    switch (tile) {
      AHA_W4A8_TILES(AHA_TILE)
      default: return -1;
    }
  }
  if (operand == 2) {
    switch (tile) {
      AHA_W4X3_TILES(AHA_TILE)
      default: return -1;
    }
  }
  if (operand != 0) return -1;
  switch (tile) {
    AHA_W4_TILES(AHA_TILE)
    default: return -1;
  }
#undef AHA_TILE
}

}  // namespace w4

// ---- decode rows (1 .. 16), G % 64 == 0, N % 16 == 0: mma.sync, bf16 x or int8 x ----------
//
// A token (1 row) and a verify pass (2 .. 16 rows) move K N / 2 weight bytes for
// at most 32 M K N operations: bytes bound them by two orders of magnitude, so
// the design is about weight bytes in flight, with the unpacking cheap and off
// the copies' path. One kernel, one plan and one order of sums for every M from
// 1 to 16: x is the A operand of mma.sync (16 token rows, those past M zero), so
// a row's output is the same bits whether it goes alone or with 15 others.
//
// Route: mma.sync per warp rather than wgmma. Four warps a block, each on its
// own 32 weight columns, and four blocks an SM: 16 warps an SM, none of which
// waits on a warpgroup's products, and no accumulator is ever in flight (the
// assembler's serialisation of wgmma, section above, cannot arise).
//
// A block owns 128 weight columns and a K split of whole groups, and walks it in
// stages of 64 rows through a ring of kStages slots filled by cp.async, all but
// one in flight. A stage holds the x tile (16 rows, swizzled: ldmatrix reads it
// without conflicts), the packed bytes (32 packed rows of the block's 128
// columns, rows apart by a stride at which the rows a warp reads at once fall in
// distinct banks) and the group's 128 scales, all in 16-byte copies. The thread
// (gid, tig) of warp w reads 32-bit words of packed rows at columns 32 w + 4 gid
// .. + 3: byte t of a word is column 32 w + 4 gid + t, its B register for column
// gid of n-tile t (the columns are relabelled, no data is shuffled). Its
// accumulator element (n-tile t, column 2 tig + e) is weight column
// 32 w + 8 tig + 4 e + t: the eight columns 32 w + 8 tig .. + 7 of tokens gid and
// gid + 8 leave as 16-byte stores. Two operand types, one kernel (A8):
//   * bf16 x, weight-only: m16n8k16 bf16 into f32 group sums, x rows of 128
//     bytes in the 128-byte swizzle, packed rows 160 bytes apart. The thread reads
//     packed rows tig + 4 q: byte t of a word is the (2 j, 2 j + 1) pair of its
//     n-tile t. One byte permute, one logic operation and one bf16x2 subtraction
//     make a register (nibble_pair).
//   * int8 x (xq, sx from csrc/quantize_rows.cu): m16n8k32 s8 into exact int32
//     group sums, x rows of 64 bytes in the 64-byte swizzle, packed rows 144 bytes
//     apart. A B register is four consecutive K rows of one column, two bytes of
//     two packed rows: the thread reads rows 2 tig + 8 m and the next (m = 0 .. 3:
//     k 4 tig .. + 3 and 16 + 4 tig .. + 3 of the stage's two 32-deep pieces) and
//     builds its registers with nibble_columns (wgmma.cuh): the nibbles as
//     n - 8 in s8, ten instructions for two registers, 80 a stage where the bf16
//     kernel spends 96 on twice the registers. A group's int32 sum (exact,
//     |sum| < 2^24) becomes f32 once and is multiplied by its scale and added
//     into the total as two roundings, in group order, as the TPU kernel's
//     acc += part * s. The kernel starts while the quantiser ahead of it runs
//     (programmatic dependent launch): the weight and scale copies of the first
//     stages are in flight before it waits for xq and sx.
//
// The group sums alternate between two register sets: group g sums into set
// g % 2, and the set of group g - 1 is scaled into the totals (f32) after the
// first stage of group g has issued its products, so no warp waits for a
// group's last product. With one split the epilogue multiplies int8 x's totals
// by sx; a K split writes its f32 totals as a partial and splitk_reduce adds the
// splits in a fixed order (then sx).
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, bf16 x): not the memory but each
// SM's issue of the instructions a warp spends on a stage (one third of them the
// unpacking). With parts switched off, the copies alone came near the memory
// rate, the unpacking and the products alone took longer than the copies, and
// weights that stay in L2 were no faster. Three things helped: the wait for a
// stage carries no proxy fence (mma.sync and ldmatrix read shared memory as
// ordinary loads; the fence compiled to a MEMBAR a stage), the unpacking's mask
// and 0x43 bytes sit in registers (as two immediates the assembler made two
// logic operations of one), and splits that leave every SM about the same work
// (plan). Tried and dropped: 8 warps (256 columns) a block, 2 warps a block,
// fewer ring slots, and the weight unpacked without the subtraction (128 + n,
// with 136 sum x taken off each group by one more product a piece): none faster.
namespace w4d {

using namespace wg;

constexpr int kThreads = 128;                 // four warps, 32 weight columns each
constexpr int kBN = 128;                      // weight columns per block
constexpr int kTM = 16;                       // token rows, the A operand's 16
constexpr int kKS = 64;                       // contraction depth of a stage
constexpr int kStages = 7;                    // ring slots; kStages - 1 stages in flight
constexpr int kBlocksPerSm = 4;               // 16 warps an SM

// a ring slot: the x tile, the packed rows and the scales (bf16 x: 7424 bytes, int8
// x: 5888; multiples of 128)
template <bool A8> struct Slot {
  static_assert(kBN == w4::kBN && kKS == w4::kKS, "w4::Operand's rows are for this block");
  static constexpr int kXRow = w4::Operand<A8>::kXRow, kWRow = w4::Operand<A8>::kWRow;
  static constexpr int kXBytes = kTM * kXRow;
  static constexpr int kWBytes = (kKS / 2) * kWRow;
  static constexpr int kSBytes = kBN * 2;
  static constexpr int kBytes = kXBytes + kWBytes + kSBytes;
  static constexpr int kSmem = kStages * kBytes;
};

// the bf16 pair (low nibble - 8, high nibble - 8) of byte T of v (v4 = v >> 4):
// the permute puts byte T of v in byte 0 and byte T of v4 in byte 2, one logic
// operation ((p & mask) | magic, with mask = 0x000F000F and magic = 0x43004300
// held in registers: as two immediates it takes two) keeps their low nibbles
// beside 0x43 (the bf16 128 + n, whose ulp is 1), and subtracting 136 is exact
template <int T>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v, uint32_t v4, uint32_t mask,
                                                uint32_t magic) {
  constexpr uint32_t sel = T | (T << 4) | ((4 + T) << 8) | ((4 + T) << 12);
  uint32_t biased;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(biased)
      : "r"(__byte_perm(v, v4, sel)), "r"(mask), "r"(magic));
  return as_u32(__hsub2(as_bf162(biased), as_bf162(0x43084308u)));
}
// A 16-deep (bf16 x) or 32-deep (int8 x) piece p of a stage: its four products
// (n-tiles 0 .. 3) on the x registers a and the thread's eight words wq, into acc.
// bf16: words 2 p, 2 p + 1 (packed rows 8 p + tig, + 4), one nibble_pair a register;
// int8: words 4 p .. 4 p + 3 (k 4 tig .. + 3 and 16 + 4 tig .. + 3), nibble_columns.
// c0, c1, c2: the unpacking's constants (mask and magic; m0f, m78 and m80)
__device__ __forceinline__ void piece_products(float (&acc)[4][4], const uint32_t (&a)[4],
                                               const uint32_t (&wq)[8], int p, uint32_t c0,
                                               uint32_t c1, uint32_t) {
  const uint32_t v0 = wq[2 * p], v1 = wq[2 * p + 1], v04 = v0 >> 4, v14 = v1 >> 4;
  mma_bf16(acc[0], a, nibble_pair<0>(v0, v04, c0, c1), nibble_pair<0>(v1, v14, c0, c1));
  mma_bf16(acc[1], a, nibble_pair<1>(v0, v04, c0, c1), nibble_pair<1>(v1, v14, c0, c1));
  mma_bf16(acc[2], a, nibble_pair<2>(v0, v04, c0, c1), nibble_pair<2>(v1, v14, c0, c1));
  mma_bf16(acc[3], a, nibble_pair<3>(v0, v04, c0, c1), nibble_pair<3>(v1, v14, c0, c1));
}
__device__ __forceinline__ void piece_products(int (&acc)[4][4], const uint32_t (&a)[4],
                                               const uint32_t (&wq)[8], int p, uint32_t c0,
                                               uint32_t c1, uint32_t c2) {
  uint32_t b0[4], b1[4];   // n-tile t: k 4 tig .. + 3, and 16 + 4 tig .. + 3
  nibble_columns<0>(b0[0], b0[1], wq[4 * p], wq[4 * p + 1], c0, c1, c2);
  nibble_columns<1>(b0[2], b0[3], wq[4 * p], wq[4 * p + 1], c0, c1, c2);
  nibble_columns<0>(b1[0], b1[1], wq[4 * p + 2], wq[4 * p + 3], c0, c1, c2);
  nibble_columns<1>(b1[2], b1[3], wq[4 * p + 2], wq[4 * p + 3], c0, c1, c2);
#pragma unroll
  for (int t = 0; t < 4; ++t) mma_s8(acc[t], a, b0[t], b1[t]);
}
// bf16 h (0: the low half, 1: the high half) of a word, as f32
__device__ __forceinline__ float half_f32(uint32_t word, int h) {
  return __uint_as_float(h ? (word & 0xffff0000u) : (word << 16));
}

template <bool A8>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
int4_mm_decode_kernel(const typename w4::Operand<A8>::X* __restrict__ x,
                      const float* __restrict__ sx, const uint8_t* __restrict__ w,
                      const bf16* __restrict__ scale4, bf16* __restrict__ y,
                      float* __restrict__ ws, int M, int K, int N, int G, int groups_per_split,
                      int splits) {
  using S = Slot<A8>;
  constexpr int kStage = S::kBytes, kXBytes = S::kXBytes, kWRow = S::kWRow;
  constexpr int kSOff = kXBytes + S::kWBytes;
  extern __shared__ __align__(128) unsigned char smem_w4d[];
  const uint32_t ring_a = smem_addr(smem_w4d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int gs = G / kKS;                                          // stages a group
  const int gbeg = blockIdx.y * groups_per_split;
  const int ng = max(0, min(K / G, gbeg + groups_per_split) - gbeg);   // groups of this split
  const int nst = ng * gs;
  const int kbeg = gbeg * G;

  // this thread's share of a stage's copies, as running sources: one chunk of
  // the x tile (rows past M are zeros), two 16-byte chunks of the packed bytes
  // (row idx / 8, columns 16 (idx % 8) ..), and for 16 threads 8 scales
  const std::conditional_t<A8, Rows64Copy<kTM>, RowsCopy<kTM>> copy_x(static_cast<size_t>(K));
  const typename w4::Operand<A8>::X* xsrc = x + kbeg;
  const uint8_t* wsrc[2];
  uint32_t wdst[2];
  bool wok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = tid + c * kThreads, row = idx >> 3, col = n0 + (idx & 7) * 16;
    wok[c] = col < N;
    wsrc[c] = w + static_cast<size_t>(kbeg / 2 + row) * N + (wok[c] ? col : 0);
    wdst[c] = kXBytes + row * kWRow + (idx & 7) * 16;
  }
  const size_t wstep = static_cast<size_t>(kKS / 2) * N;
  const bool sok = tid < 16 && n0 + tid * 8 < N;
  const bf16* ssrc = scale4 + static_cast<size_t>(gbeg) * N + (sok ? n0 + tid * 8 : 0);
  int lj = 0;   // the stage of its group that the packed bytes' and scales' sources are at
  // the next stage's packed bytes and scales, or its x tile, into ring slot i; each
  // source then moves on a stage
  auto load_w = [&](int i) {
    const uint32_t st = ring_a + i * kStage;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      cp_async16(st + wdst[c], wsrc[c], wok[c]);
      wsrc[c] += wstep;
    }
    if (tid < 16) cp_async16(st + kSOff + tid * 16, ssrc, sok);
    if (++lj == gs) {
      lj = 0;
      ssrc += N;
    }
  };
  auto load_x = [&](int i) {
    copy_x(ring_a + i * kStage, xsrc, M);
    xsrc += kKS;
  };
  int lslot = kStages - 1, lstage = kStages - 1;   // the next load after the first stages
  auto load = [&]() {
    if (lstage < nst) {
      load_x(lslot);
      load_w(lslot);
    }
    cp_async_commit();
    ++lstage;
    lslot = lslot == kStages - 1 ? 0 : lslot + 1;
  };
  // bf16: packed row tig of a stage at its four columns (its words: rows tig + 4 q);
  // int8: row 2 tig (its words: rows 2 tig + (q & 1) + 8 (q >> 1)); the scales of
  // its eight output columns; the row of the x tile that this lane names to
  // ldmatrix (matrix lane / 8: token rows 8 (lane / 8 % 2) .., the second 16 bytes
  // of a piece (bf16: k 8 ..) from lane 16)
  const int w_off = kXBytes + (A8 ? 2 : 1) * tig * kWRow + (32 * warp + 4 * gid);
  const int s_off = kSOff + (32 * warp + 8 * tig) * 2;
  const int xr = (lane & 7) + ((lane >> 3) & 1) * 8;
  constexpr int P = A8 ? 2 : 4;   // pieces of a stage: 32 deep (int8) or 16 (bf16)
  uint32_t x_off[P];   // the piece's 16-byte chunk of that row, swizzled
#pragma unroll
  for (int p = 0; p < P; ++p)
    x_off[p] = A8 ? xr * 64 + (((2 * p + (lane >> 4)) ^ ((xr >> 1) & 3)) << 4)
                  : xr * 128 + (((2 * p + (lane >> 4)) ^ (xr & 7)) << 4);

  using Acc = typename w4::Operand<A8>::Grp;
  float tot[4][4];
  Acc acc[2][4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tot[t][e] = 0.f;
      acc[0][t][e] = acc[1][t][e] = 0;
    }
  uint4 sc = make_uint4(0u, 0u, 0u, 0u);   // the scales of the group whose sums wait in a set
  // bf16: the mask and 0x43 bytes of nibble_pair; int8: those of nibble_columns
  const uint32_t mask = A8 ? pinned(0x0F0F0F0Fu) : pinned(0x000F000Fu);
  const uint32_t magic = A8 ? pinned(0x78787878u) : pinned(0x43004300u);
  const uint32_t m80 = A8 ? pinned(0x80808080u) : 0u;

  // the first stages into slots 0 .. kStages - 2; with int8 x their packed bytes
  // and scales, which do not depend on the quantiser ahead of this kernel, are in
  // flight before waiting for its xq and sx
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nst) {
      if constexpr (!A8) load_x(i);
      load_w(i);
    }
    if constexpr (!A8) cp_async_commit();
  }
  if constexpr (A8) {
    wait_prior_grid();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < nst) load_x(i);
      cp_async_commit();
    }
  }
  int slot = 0;   // of the stage being multiplied
  // one stage: its 16-deep (bf16) or 32-deep (int8) pieces, each one ldmatrix of x
  // and four products (n-tiles 0 .. 3) into set SET; returns the stage's slot
  auto stage = [&](auto set) {
    constexpr int SET = decltype(set)::value;
    copies_landed<kStages - 2>();   // this stage has landed
    __syncthreads();                // ... for every thread, and every warp is past the last one
    load();                         // into the slot the last stage freed
    const unsigned char* st = smem_w4d + slot * kStage;
    const uint32_t sa = ring_a + slot * kStage;
    slot = slot == kStages - 1 ? 0 : slot + 1;
    uint32_t wq[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      wq[q] = lds32(st + w_off + (A8 ? (q & 1) + 8 * (q >> 1) : 4 * q) * kWRow);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t a[4];
      ldmatrix_x4(a, sa + x_off[p]);
      piece_products(acc[SET], a, wq, p, mask, magic, m80);
    }
    return st;
  };
  // the group sums of set SET times their scales into the totals (w4::scaled_add);
  // the set starts anew
  auto flush = [&](auto set) {
    constexpr int SET = decltype(set)::value;
    const uint32_t s[4] = {sc.x, sc.y, sc.z, sc.w};   // columns 8 tig + (0, 1), (2, 3), ..
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float s0 = half_f32(s[t >> 1], t & 1), s1 = half_f32(s[2 + (t >> 1)], t & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float se = (e & 1) ? s1 : s0;
        tot[t][e] = w4::scaled_add(tot[t][e], acc[SET][t][e], se);
        acc[SET][t][e] = 0;
      }
    }
  };
  // a group into set SET: after its first stage, the set of the group before is
  // scaled and this group's scales are taken from the slot
  auto group = [&](bool first, auto set) {
    constexpr int SET = decltype(set)::value;
    const unsigned char* st = stage(set);
    if (!first) flush(std::integral_constant<int, 1 - SET>{});
    sc = *reinterpret_cast<const uint4*>(st + s_off);
    for (int j = 1; j < gs; ++j) stage(set);
  };
  for (int g = 0; g < ng; g += 2) {
    group(g == 0, std::integral_constant<int, 0>{});
    if (g + 1 < ng) group(false, std::integral_constant<int, 1>{});
  }
  if (ng & 1) flush(std::integral_constant<int, 0>{});
  else if (ng > 0) flush(std::integral_constant<int, 1>{});

  // tokens gid and gid + 8: this thread's eight columns side by side
  const int nc = n0 + 32 * warp + 8 * tig;
  if (nc >= N) return;   // N % 16 == 0: all eight exist, or none
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = gid + 8 * h;
    if (m >= M) continue;
    float v[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[t] = tot[t][2 * h];
      v[4 + t] = tot[t][2 * h + 1];
    }
    if (splits == 1) {
      if constexpr (A8) {
        const float s = sx[m];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] *= s;
      }
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = as_u32(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * N + nc) =
          make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      float4* o =
          reinterpret_cast<float4*>(ws + (static_cast<size_t>(blockIdx.y) * M + m) * N + nc);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <bool A8>
cudaError_t launch(const void* x, const float* sx, const uint8_t* w, const bf16* scale4, void* y,
                   float* ws, int M, int K, int N, int G, int splits, cudaStream_t st) {
  if (M > kTM || G % kKS != 0 || N % 16 != 0 || splits > 65535) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(int4_mm_decode_kernel<A8>, Slot<A8>::kSmem);
  if (err != cudaSuccess) return err;
  // whole groups a split; a split past K writes zeros
  const int gps = (K / G + splits - 1) / splits;
  const dim3 grid((N + kBN - 1) / kBN, splits);
  const auto* xp = static_cast<const typename w4::Operand<A8>::X*>(x);
  bf16* yp = static_cast<bf16*>(y);
  if constexpr (A8)   // starts while the quantiser ahead of it runs
    return launch_after_prior_grid(int4_mm_decode_kernel<A8>, grid, dim3(kThreads),
                                   Slot<A8>::kSmem, st, xp, sx, w, scale4, yp, ws, M, K, N, G,
                                   gps, splits);
  int4_mm_decode_kernel<A8><<<grid, kThreads, Slot<A8>::kSmem, st>>>(xp, sx, w, scale4, yp, ws,
                                                                       M, K, N, G, gps, splits);
  return cudaGetLastError();
}

}  // namespace w4d

enum Path { kScalar = 0, kVec16 = 1, kTensorCore = 2, kWgmma = 3, kDecode = 4 };

template <typename X, typename Y>
cudaError_t launch(const void* x, const float* sx, const void* w, const void* scale4, void* y,
                   void* ws, int M, int K, int N, int G, int splits, int path,
                   cudaStream_t st) {
  const uint8_t* wq = static_cast<const uint8_t*>(w);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale4);
  Y* yp = static_cast<Y*>(y);
  float* wsf = static_cast<float*>(ws);
  if (path == kTensorCore) {
    // split boundaries on the 32-row K step; a split past K writes zeros
    const int kps = ((K + splits - 1) / splits + kTK - 1) / kTK * kTK;
    const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN, splits);
    if constexpr (std::is_same<X, int8_t>::value) {
      int4_mm_tc_kernel<true, Y><<<grid, 128, 0, st>>>(x, sx, wq, sc, yp, wsf, M, K, N, G, kps,
                                                       splits);
    } else if constexpr (std::is_same<X, __nv_bfloat16>::value &&
                         std::is_same<Y, __nv_bfloat16>::value) {
      int4_mm_tc_kernel<false, Y><<<grid, 128, 0, st>>>(x, nullptr, wq, sc, yp, wsf, M, K, N, G,
                                                        kps, splits);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const int groups = K / G;
    const int gps = (groups + splits - 1) / splits;
    const dim3 block(kColGroups, kKLanes);
    const int nb = (N + kBN - 1) / kBN;
    const int vec = path == kVec16;
    const X* xp = static_cast<const X*>(x);
    if (M == 1) {
      int4_mm_kernel<X, Y, 1><<<dim3(nb, 1, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, G, gps, splits, vec);
    } else {
      constexpr int BM = 2;
      int4_mm_kernel<X, Y, BM><<<dim3(nb, (M + BM - 1) / BM, splits), block, 0, st>>>(
          xp, sx, wq, sc, yp, wsf, M, K, N, G, gps, splits, vec);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_reduce<Y>(wsf, nullptr, sx, yp, M, N, splits, st);
}

}  // namespace

// x: [M, K] of x_dtype (AHA_F32, AHA_BF16, or AHA_I8 with the per-row scales
// sx [M]); y: [M, N] of y_dtype (x's own type unless x is int8). K % G == 0,
// G even. path: 0 scalar CUDA-core loads, 1 16-byte CUDA-core loads
// (N % 16 == 0, 16-byte aligned weight), 2 tensor cores through mma.sync (M > 1,
// G % 32 == 0, N % 8 == 0, x 16-byte and weight 8-byte aligned; bf16 x -> bf16 y,
// or int8 x), 3 tensor cores through wgmma (bf16 x, or int8 x, -> bf16 y,
// G % 64 == 0, N % 16 == 0, x, weight and scales 16-byte aligned, tile: the token
// tile, a multiple of 8 from 16 to 80 for bf16 x, 24, 32, 48, 64 or 80 for int8 x;
// whole groups a split; or x_dtype AHA_BF16X3: x is an f32 x's three bf16 planes
// [3, M, K], y f32, tile a multiple of 8 from 24 to 64), 4 the decode rows on
// mma.sync (as 3 with bf16 or int8 x, M <= 16, tile unused; whole groups a split);
// the wrapper checks.
extern "C" int aha_int4_matmul(const void* x, const void* sx, const void* w, const void* scale4,
                               void* y, void* workspace, int M, int K, int N, int G,
                               int x_dtype, int y_dtype, int splits, int path, int tile,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 2 != 0 || K % G != 0 || splits < 1 ||
      (splits > 1 && workspace == nullptr) || (x_dtype == AHA_I8) != (sx != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sxf = static_cast<const float*>(sx);
  cudaError_t err = cudaErrorInvalidValue;
  if (path == kWgmma && x_dtype == AHA_BF16X3) {   // an f32 x's three bf16 planes
    if (y_dtype != AHA_F32) return static_cast<int>(err);
    float* wsf = static_cast<float*>(workspace);
    err = w4::launch<false, 3>(x, nullptr, static_cast<const uint8_t*>(w),
                               static_cast<const __nv_bfloat16*>(scale4), y, wsf, M, K, N, G,
                               splits, tile, st);
    if (err == cudaSuccess && splits > 1)
      err = launch_splitk_reduce<float>(wsf, nullptr, nullptr, static_cast<float*>(y), M, N,
                                        splits, st);
    return static_cast<int>(err);
  }
  if (path == kWgmma || path == kDecode) {
    if ((x_dtype != AHA_BF16 && x_dtype != AHA_I8) || y_dtype != AHA_BF16)
      return static_cast<int>(err);
    const bool a8 = x_dtype == AHA_I8;
    float* wsf = static_cast<float*>(workspace);
    const uint8_t* wq = static_cast<const uint8_t*>(w);
    const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scale4);
    if (path == kWgmma)
      err = a8 ? w4::launch<true, 1>(x, sxf, wq, sc, y, wsf, M, K, N, G, splits, tile, st)
               : w4::launch<false, 1>(x, nullptr, wq, sc, y, wsf, M, K, N, G, splits, tile, st);
    else
      err = a8 ? w4d::launch<true>(x, sxf, wq, sc, y, wsf, M, K, N, G, splits, st)
               : w4d::launch<false>(x, nullptr, wq, sc, y, wsf, M, K, N, G, splits, st);
    if (err == cudaSuccess && splits > 1)
      err = launch_splitk_reduce<__nv_bfloat16>(wsf, nullptr, a8 ? sxf : nullptr,
                                                static_cast<__nv_bfloat16*>(y), M, N, splits, st);
    return static_cast<int>(err);
  }
  if (x_dtype == AHA_F32 && y_dtype == AHA_F32 && path != kTensorCore)
    err = launch<float, float>(x, sxf, w, scale4, y, workspace, M, K, N, G, splits, path, st);
  else if (x_dtype == AHA_BF16 && y_dtype == AHA_BF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, sxf, w, scale4, y, workspace, M, K, N, G,
                                               splits, path, st);
  else if (x_dtype == AHA_I8 && y_dtype == AHA_F32)
    err = launch<int8_t, float>(x, sxf, w, scale4, y, workspace, M, K, N, G, splits, path, st);
  else if (x_dtype == AHA_I8 && y_dtype == AHA_BF16)
    err = launch<int8_t, __nv_bfloat16>(x, sxf, w, scale4, y, workspace, M, K, N, G, splits,
                                        path, st);
  return static_cast<int>(err);
}

// bytes of dynamic shared memory path 3 (wgmma, at token tile `tile`) or 4 (decode)
// asks for with bf16 x (operand 0), int8 x (1) or, on path 3, an f32 x's three bf16
// planes (2); -1: no such path or tile. The wrapper's plan computes the same number
extern "C" int aha_int4_matmul_smem(int path, int tile, int operand) {
  if (path == kWgmma) return w4::smem_of(tile, operand);
  if (path == kDecode && operand != 2)
    return operand == 1 ? w4d::Slot<true>::kSmem : w4d::Slot<false>::kSmem;
  return -1;
}
