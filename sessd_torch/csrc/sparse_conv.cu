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
// The kernel is gather_gemm.cuh's body with its epilogue on; that header
// says what bounds it on Hopper and what the design does about it.

#include "gather_gemm.cuh"

namespace {

template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(sessd::kThreads)
fused_sparse_conv_kernel(const T* __restrict__ feats,
                         const IdxT* __restrict__ rb,
                         const T* __restrict__ w2,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int n_in, int n_out, int taps, int relu) {
  sessd::gather_gemm_tile<T, IdxT, CIN, COUT, true>(
      feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu);
}

template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch(const void* feats, const void* rb, const void* w2,
                   const float* bias, void* out, int n_in, int n_out,
                   int taps, int relu, cudaStream_t stream) {
  fused_sparse_conv_kernel<T, IdxT, CIN, COUT>
      <<<sessd::gather_gemm_grid(n_out), sessd::kThreads, 0, stream>>>(
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
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch<T, IdxT, CI, CO>(feats, rb, w2, bias, out, n_in, n_out,    \
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
  if (n_out <= 0 || taps <= 0 || taps > sessd::kMaxTaps)
    return cudaErrorInvalidValue;
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
