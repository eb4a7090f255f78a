// Fused sparse convolution + folded BatchNorm + ReLU + occupancy mask.
//
// Replaces sessd_tpu/ops/pallas/wconv.py:_fused_kernel (the serving conv of
// the all-sparse backbone plan). The TPU kernel reads each tap's inputs
// through a one-hot GEMM over a window of the feature buffer, and a second
// Pallas kernel, _patch_kernel, recomputes the few blocks whose rulebook span
// exceeds that window. Here every rulebook entry is a direct row address, so
// there is no window and no span limit: any row may be read, and
// _patch_kernel has nothing left to cover.
//
// Computes, for every output row n (row-major [N, C] features):
//   out[n, :] = relu(sum_k feats[rb[n, k], :] @ w2[k] + bias)
//               if any(rb[n, :] != n_in) else 0
// rb[n, k] == n_in is a miss and contributes zero. w2 [K, Cin, Cout] carries
// the BatchNorm scale already (w2 = W * s); bias [Cout] is f32. feats, w2 and
// out are f32 or bf16; the sum is taken in f32. rb is int16 or int32.
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
// block and the epilogue (bias, ReLU, hit mask, cast) is fused into the
// store, so the output is written once and never re-read. Neighbouring rows
// in a tile are neighbouring voxels (z-minor ids), so their gathers share
// cache lines in L2. wgmma, TMA and pipelining of the gathers are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
fused_sparse_conv_kernel(const T* __restrict__ feats,
                         const IdxT* __restrict__ rb,
                         const T* __restrict__ w2,
                         const float* __restrict__ bias,
                         T* __restrict__ out,
                         int n_in, int n_out, int taps, int relu) {
  constexpr int kCols = 4;                   // output channels per thread
  constexpr int kTx = COUT / kCols;          // threads across channels
  constexpr int kTy = kThreads / kTx;        // threads across rows
  constexpr int kRowsPerThread = kRows / kTy;
  constexpr int kGStride = CIN + 1;          // padded: row reads hit distinct banks
  static_assert(COUT % 16 == 0 && kRowsPerThread * kTy == kRows, "tile");

  __shared__ int s_rb[kRows * kMaxTaps];
  __shared__ int s_hit[kRows];
  __shared__ float s_g[kRows * kGStride];
  __shared__ __align__(16) float s_w[CIN * COUT];

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kRows;

  // the tile's rulebook, read once (consecutive threads walk one row's taps,
  // which are contiguous in rb); rows past n_out read as all-miss
  for (int i = tid; i < kRows * taps; i += kThreads) {
    const int n = row0 + i / taps;
    s_rb[i] = n < n_out ? static_cast<int>(rb[(size_t)row0 * taps + i]) : n_in;
  }
  __syncthreads();
  if (tid < kRows) {
    int hit = 0;
    for (int k = 0; k < taps; ++k) hit |= s_rb[tid * taps + k] != n_in;
    s_hit[tid] = hit;  // read after the tap loop's barriers
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
    for (int i = tid; i < CIN * COUT; i += kThreads) s_w[i] = to_f32(wk[i]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < CIN; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(&s_w[c * COUT + tx * kCols]);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float a = s_g[(ty + r * kTy) * kGStride + c];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

  float bv[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) bv[j] = bias[tx * kCols + j];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int lr = ty + r * kTy;
    const int n = row0 + lr;
    if (n >= n_out) continue;
    const bool hit = s_hit[lr] != 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[r][j] + bv[j];
      if (relu) v = fmaxf(v, 0.f);
      out[(size_t)n * COUT + tx * kCols + j] = from_f32<T>(hit ? v : 0.f);
    }
  }
}

template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch(const void* feats, const void* rb, const void* w2,
                   const float* bias, void* out, int n_in, int n_out,
                   int taps, int relu, cudaStream_t stream) {
  const dim3 grid((n_out + kRows - 1) / kRows);
  fused_sparse_conv_kernel<T, IdxT, CIN, COUT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const IdxT*>(rb),
      static_cast<const T*>(w2), bias, static_cast<T*>(out), n_in, n_out,
      taps, relu);
  return cudaGetLastError();
}

// the (Cin, Cout) pairs of the SpMiddleFHD plan
template <typename T, typename IdxT>
cudaError_t dispatch_channels(int cin, int cout, const void* feats,
                              const void* rb, const void* w2,
                              const float* bias, void* out, int n_in,
                              int n_out, int taps, int relu,
                              cudaStream_t stream) {
#define SESSD_CASE(CI, CO)                                                  \
  if (cin == CI && cout == CO)                                              \
    return launch<T, IdxT, CI, CO>(feats, rb, w2, bias, out, n_in, n_out,   \
                                   taps, relu, stream);
  SESSD_CASE(4, 16)
  SESSD_CASE(16, 16)
  SESSD_CASE(16, 32)
  SESSD_CASE(32, 32)
  SESSD_CASE(32, 64)
  SESSD_CASE(64, 64)
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success). dtype: 0 = f32, 1 = bf16; idx_bytes: 2 (int16) or 4 (int32).
extern "C" int sessd_fused_sparse_conv(const void* feats, const void* rb,
                                       const void* w2, const float* bias,
                                       void* out, int n_in, int n_out,
                                       int cin, int cout, int taps,
                                       int dtype, int idx_bytes, int relu,
                                       void* stream) {
  if (n_out <= 0 || taps <= 0 || taps > kMaxTaps) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && idx_bytes == 2)
    return dispatch_channels<float, int16_t>(cin, cout, feats, rb, w2, bias,
                                             out, n_in, n_out, taps, relu, s);
  if (dtype == 0 && idx_bytes == 4)
    return dispatch_channels<float, int32_t>(cin, cout, feats, rb, w2, bias,
                                             out, n_in, n_out, taps, relu, s);
  if (dtype == 1 && idx_bytes == 2)
    return dispatch_channels<__nv_bfloat16, int16_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, s);
  if (dtype == 1 && idx_bytes == 4)
    return dispatch_channels<__nv_bfloat16, int32_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* sessd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
