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
// What bounds it on an H100: at the streaming path's M (1 for a generated
// token, 4..8 for a verify pass, 49..220 for frame and text chunks, 196 for a
// fused pass of four frames, 1568 for the projector) the K*N/2 weight bytes
// (+ 2*(K/G)*N of scales) dominate the traffic, so each packed byte is read
// from device memory once and its two nibbles are unpacked in registers. Two
// paths, chosen by the wrapper from the operands:
//   * tensor cores (M > 1, G % 32 == 0, N % 8 == 0; bf16 x, or int8 x
//     whatever the output type): the 64 x 128 tile scheme of common.cuh. A
//     packed byte is exactly the (k, k + 1) pair of one column, i.e. one
//     32-bit bf16x2 word of the transposed weight tile (int8 activations:
//     two bytes make one word of four int8). Values -8..7 are exact in
//     bf16. A warp keeps two accumulator sets: the running group's (f32 or
//     int32) and the total (f32); at a group's last K step the first is
//     scaled into the second.
//   * CUDA cores (M = 1, f32 x, ragged shapes): a block covers 128 columns;
//     each of its 256 threads owns 16 contiguous columns (one 16-byte load
//     = 16 columns x 2 rows) and one of 32 lanes along K. The lanes are 4
//     group slots x 8 row lanes: a thread walks whole groups, so that it
//     applies each group's scale once to its own partial sum.
// When the grid would leave SMs idle, K is split over grid z (whole groups on
// the CUDA-core path, 32-row steps on the tensor-core path; a group cut by a
// split boundary is scaled on both sides, which is the same sum): each split
// writes an f32 partial and splitk_reduce adds them in a fixed order.
#include <type_traits>

#include "common.cuh"

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

// ---- tensor-core path ---------------------------------------------------------------

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

enum Path { kScalar = 0, kVec16 = 1, kTensorCore = 2 };

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
// (N % 16 == 0, 16-byte aligned weight), 2 tensor cores (M > 1, G % 32 == 0,
// N % 8 == 0, x 16-byte and weight 8-byte aligned; bf16 x -> bf16 y, or int8
// x); the wrapper checks.
extern "C" int aha_int4_matmul(const void* x, const void* sx, const void* w, const void* scale4,
                               void* y, void* workspace, int M, int K, int N, int G,
                               int x_dtype, int y_dtype, int splits, int path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || G % 2 != 0 || K % G != 0 || splits < 1 ||
      (splits > 1 && workspace == nullptr) || (x_dtype == AHA_I8) != (sx != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sxf = static_cast<const float*>(sx);
  cudaError_t err = cudaErrorInvalidValue;
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
