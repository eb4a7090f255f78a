// Row-gather GEMM over a rulebook, the scalar body every instance of the
// serving conv (sparse_conv.cu, with its fused epilogue), the training
// forward and the input gradient (sparse_conv_train.cu) ran first. The
// main path no longer runs it: gather_mma.cuh's tensor-core tile took the
// 16-64-channel instances and gather_direct.cuh's direct body the first
// conv's 4-channel side. It stays as the comparison entries'
// (fused_sparse_conv_scalar_kernel, sparse_conv_fwd_scalar_kernel,
// sparse_conv_dfeat_scalar_kernel), which the card tests and the smoke
// check hold the new bodies against on the same calls.
//
// Computes, for every output row n (row-major [N, C] features):
//   acc[n, :] = sum_k feats[rb[n, k], :] @ w2[k]          (f32 accumulator)
// rb[n, k] == n_in (or any index outside [0, n_in)) is a miss and reads a
// zero row. w2 is [K, Cin, Cout], or with W_T [K, Cout, Cin] (the input
// gradient's weights as the conv holds them), staged transposed; feats, w2
// and out are f32 or bf16; rb is int16 or int32. With EPI (the serving
// epilogue) the store is
//   out[n] = relu?(acc[n] + bias) if any tap of row n hits, else 0;
// without it
//   out[n] = acc[n] if row_mask is null or row_mask[n], else 0.
//
// What bounds it on Hopper: gather bytes. Each output row reads K rows of
// Cin values (K*Cin loads) for 2*K*Cin*Cout flops, i.e. at most 2*Cout flops
// per loaded value -- 128 at Cout = 64, far below the card's ridge of ~295
// flops per byte in bf16. The gathered rows are also scattered, so each load
// is a short row rather than a streamed tile.
//
// What the design does about it: one block owns a tile of 64 output rows and
// stages, per tap, the 64 gathered rows and that tap's [Cin, Cout] weights in
// shared memory once; all 256 threads then reuse them for a 64 x Cout
// register tile of f32 accumulators (4 output channels x Cout/16 rows each),
// so every gathered value is loaded from device memory once per output row
// and used Cout times from shared memory. The rulebook tile is read once per
// block and the epilogue is fused into the store, so the output is written
// once and never re-read. Neighbouring rows in a tile are neighbouring voxels
// (z-minor ids), so their gathers share cache lines in L2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sessd {

constexpr int kRows = 64;      // output rows per block
constexpr int kThreads = 256;  // threads per block
constexpr int kMaxTaps = 27;   // 3x3x3; the last down conv has 3 taps

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The body of one block of kThreads threads over output rows
// [blockIdx.x * kRows, + kRows). Each entry point wraps it in a __global__
// of its own name, so a profile tells the serving conv, the training
// forward and the input gradient apart.
template <typename T, typename IdxT, int CIN, int COUT, bool EPI,
          bool W_T = false>
__device__ __forceinline__ void gather_gemm_tile(
    const T* __restrict__ feats, const IdxT* __restrict__ rb,
    const T* __restrict__ w2, const float* __restrict__ bias,
    const uint8_t* __restrict__ row_mask, T* __restrict__ out, int n_in,
    int n_out, int taps, int relu) {
  constexpr int kCols = 4;                   // output channels per thread
  constexpr int kTx = COUT / kCols;          // threads across channels
  // threads across rows: at COUT = 4 (the input gradient of the Cin = 4
  // first conv) more threads than rows, and those past kRows only stage
  constexpr int kTyAll = kThreads / kTx;
  constexpr int kTy = kTyAll < kRows ? kTyAll : kRows;
  constexpr int kRowsPerThread = kRows / kTy;
  constexpr int kGStride = CIN + 1;          // padded: row reads hit distinct banks
  static_assert((COUT == 4 || COUT % 16 == 0) && kRowsPerThread * kTy == kRows,
                "tile");

  __shared__ int s_rb[kRows * kMaxTaps];
  __shared__ int s_hit[kRows];
  __shared__ float s_g[kRows * kGStride];
  __shared__ __align__(16) float s_w[CIN * COUT];

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  // every thread multiplies unless the block has more row slots than rows
  const bool computes = kTyAll <= kRows || ty < kTy;
  const int row0 = blockIdx.x * kRows;

  // the tile's rulebook, read once (consecutive threads walk one row's taps,
  // which are contiguous in rb); rows past n_out read as all-miss
  for (int i = tid; i < kRows * taps; i += kThreads) {
    const int n = row0 + i / taps;
    s_rb[i] = n < n_out ? static_cast<int>(rb[(size_t)row0 * taps + i]) : n_in;
  }
  __syncthreads();
  if (tid < kRows) {
    int keep = 1;
    if (EPI) {
      keep = 0;
      for (int k = 0; k < taps; ++k) keep |= s_rb[tid * taps + k] != n_in;
    } else if (row_mask != nullptr) {
      keep = row0 + tid < n_out ? row_mask[row0 + tid] != 0 : 0;
    }
    s_hit[tid] = keep;  // read after the tap loop's barriers
  }

  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int k = 0; k < taps; ++k) {
    // gather this tap's 64 input rows; a miss (or any index outside
    // [0, n_in)) is a zero row
    for (int i = tid; i < kRows * CIN; i += kThreads) {
      const int r = i / CIN;
      const int c = i % CIN;
      const int src = s_rb[r * taps + k];
      s_g[r * kGStride + c] =
          static_cast<unsigned>(src) < static_cast<unsigned>(n_in)
              ? to_f32(feats[(size_t)src * CIN + c])
              : 0.f;
    }
    const T* wk = w2 + (size_t)k * CIN * COUT;
    for (int i = tid; i < CIN * COUT; i += kThreads)
      s_w[i] = to_f32(W_T ? wk[(i % COUT) * CIN + i / COUT] : wk[i]);
    __syncthreads();

    if (computes) {
#pragma unroll 4
      for (int c = 0; c < CIN; ++c) {
        const float4 b =
            *reinterpret_cast<const float4*>(&s_w[c * COUT + tx * kCols]);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float a = s_g[(ty + r * kTy) * kGStride + c];
          acc[r][0] = fmaf(a, b.x, acc[r][0]);
          acc[r][1] = fmaf(a, b.y, acc[r][1]);
          acc[r][2] = fmaf(a, b.z, acc[r][2]);
          acc[r][3] = fmaf(a, b.w, acc[r][3]);
        }
      }
    }
    __syncthreads();
  }

  if (!computes) return;
  float bv[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) bv[j] = EPI ? bias[tx * kCols + j] : 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int lr = ty + r * kTy;
    const int n = row0 + lr;
    if (n >= n_out) continue;
    const bool keep = s_hit[lr] != 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[r][j] + bv[j];
      if (EPI && relu) v = fmaxf(v, 0.f);
      out[(size_t)n * COUT + tx * kCols + j] = from_f32<T>(keep ? v : 0.f);
    }
  }
}

// blocks of kThreads threads covering n_out rows
inline dim3 gather_gemm_grid(int n_out) {
  return dim3((n_out + kRows - 1) / kRows);
}

}  // namespace sessd
