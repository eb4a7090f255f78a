// What the row-gather GEMM bodies of the sparse convs share: the tile's
// rows and threads, the most taps a conv has, and the conversions between
// the stored types and the f32 every body sums in. The bodies are
// gather_mma.cuh's tensor-core tile (16-128 channels, bf16 and f32 through
// 3xTF32) and gather_direct.cuh's body on the CUDA cores (the first conv's
// 4-channel side); sparse_conv.cu, sparse_conv_stream.cu and
// sparse_conv_train.cu launch them.
//
// Every body computes, for every output row n (row-major [N, C] features):
//   acc[n, :] = sum_k feats[rb[n, k], :] @ w2[k]          (f32 accumulator)
// rb[n, k] == n_in (or any index outside [0, n_in)) is a miss and reads a
// zero row.
//
// What bounds it on Hopper: gather bytes. Each output row reads K rows of
// Cin values (K*Cin loads) for 2*K*Cin*Cout flops, i.e. at most 2*Cout flops
// per loaded value -- 128 at Cout = 64, far below the card's ridge of ~295
// flops per byte in bf16. The gathered rows are also scattered, so each load
// is a short row rather than a streamed tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sessd {

constexpr int kRows = 64;      // output rows per tile
constexpr int kThreads = 256;  // the conv kernels' __launch_bounds__
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

// one tile of kRows rows per block over n_out rows
inline dim3 gather_gemm_grid(int n_out) {
  return dim3((n_out + kRows - 1) / kRows);
}

}  // namespace sessd
