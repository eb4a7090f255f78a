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
// What bounds it on Hopper: the gather (at most 2*Cout flops per loaded
// value, below the card's ridge) and, at batch 1, the grid: a request's
// convs have 63-344 tiles of 64 rows, fewer than the card holds at once.
// fused_sparse_conv_kernel takes one of three bodies by type and shape,
// fixed at compile time (no fallback at run time):
// - bf16 with Cin, Cout in {16, 32, 64}: gather_mma.cuh's tensor-core tile
//   (wgmma out of a 4-stage cp.async ring, taps no row of a tile hits
//   skipped), 128 threads and dynamic shared memory per block, the body the
//   stream kernel runs in bf16. A launch whose tiles fill less than one wave
//   runs each tile as a cluster of S = 2 or 4 CTAs that split its hit taps
//   and add their partials in rank order (sessd::cluster_split; the header
//   says how). At S = 1 it equals the bf16 stream kernel bit for bit.
// - f32 at those channels (the eval path on host chains and f32 serving,
//   held to 1e-4): the same tile through 3xTF32 with the same epilogue, one
//   CTA per tile (the 3xTF32 tile runs whole tiles: no cluster split). It
//   is the f32 stream kernel's instance under this kernel's name, so f32
//   K1 equals f32 K3, and the f32 forward (K4) plus bias, ReLU and the
//   any-hit mask, bit for bit.
// - bf16 at (64, 128) and (128, 128) (kWideTile, the last stages of
//   CenterPoint's SpMiddleResNetFHD): the same tile and cluster split with
//   64 accumulators a thread; a 128 -> 128 tap is 48 KB, so its ring holds
//   2 taps, and two blocks of either instance fit an SM. f32 has no
//   instance of these pairs.
// - the Cin = 4 first conv, in both types: gather_direct.cuh's direct body
//   on the CUDA cores (all 27 taps' weights staged once per block, one
//   thread per row walking its taps without a barrier), 128 threads, 128
//   rows a block; a row's sum runs over its taps in index order, within a
//   tap over channels 0..3 by fmaf into one f32 accumulator.

#include "gather_direct.cuh"
#include "gather_mma.cuh"

namespace {

// RES: the store adds residual [n_out, COUT] before the ReLU (the second
// conv of a residual block; bf16 tensor-core instances with CIN == COUT)
template <typename T, typename IdxT, int CIN, int COUT, bool RES = false>
__global__ void __launch_bounds__(sessd::kThreads)
fused_sparse_conv_kernel(const T* __restrict__ feats,
                         const IdxT* __restrict__ rb,
                         const T* __restrict__ w2,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int n_in, int n_out, int taps, int relu,
                         const T* __restrict__ residual) {
  if constexpr ((sessd::kMmaTile<T, CIN, COUT> ||
                 sessd::kWideTile<T, CIN, COUT>) && RES)
    sessd::gather_mma_tile<IdxT, CIN, COUT, true, true, false,
                           sessd::kTileFull, true>(
        feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu,
        residual);
  else if constexpr (sessd::kMmaTile<T, CIN, COUT> ||
                     sessd::kWideTile<T, CIN, COUT>)
    sessd::gather_mma_tile<IdxT, CIN, COUT, true, true>(
        feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu);
  else if constexpr (sessd::kTf32Tile<T, CIN, COUT>)
    sessd::gather_mma_tile<IdxT, CIN, COUT, true>(
        feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu);
  else if constexpr (sessd::kDirect<T, CIN, COUT>)
    sessd::gather_direct<T, IdxT, CIN, COUT, true>(
        feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu);
  else
    static_assert(sessd::kDirect<T, CIN, COUT>, "no body for this pair");
}

// above 48 KB a block's shared memory must be asked for, once per kernel
template <typename T, typename IdxT, int CIN, int COUT, bool RES = false>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_sparse_conv_kernel<T, IdxT, CIN, COUT, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      sessd::kTileSmemBytes<T, CIN, COUT>);
  return attr;
}

// blocks of the bf16 tensor-core instance of (CIN, COUT) that fit on the
// card at once: blocks per SM at its shared memory, registers and threads
// (the int32-rulebook instance's, so both index types take the same S) x
// SMs; once per instance, 0 where it cannot be read
template <int CIN, int COUT>
int mma_wave() {
  static const int wave = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        allow_smem<__nv_bfloat16, int32_t, CIN, COUT>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm,
            fused_sparse_conv_kernel<__nv_bfloat16, int32_t, CIN, COUT>,
            sessd::kMmaThreads,
            sessd::MmaLayout<CIN, COUT>::kSmemBytes) != cudaSuccess)
      return 0;
    return per_sm * sms;
  }();
  return wave;
}

template <int CIN, int COUT>
int wave_of() {
  if constexpr (sessd::kMmaTile<__nv_bfloat16, CIN, COUT> ||
                sessd::kWideTile<__nv_bfloat16, CIN, COUT>)
    return mma_wave<CIN, COUT>();
  else
    return 0;
}

// split: 0 = the rule's S (sessd::cluster_split), else that S (the
// comparison entry, which takes tensor-core instances only); residual:
// null, or the RES instance's [n_out, COUT] (bf16 tensor-core tiles with
// CIN == COUT: the residual blocks' second convs)
template <typename T, typename IdxT, int CIN, int COUT, bool RES = false>
cudaError_t launch(const void* feats, const void* rb, const void* w2,
                   const float* bias, void* out, int n_in, int n_out,
                   int taps, int relu, int split, cudaStream_t stream,
                   const void* residual = nullptr) {
  constexpr bool kBf16 = sessd::kMmaTile<T, CIN, COUT> ||
                         sessd::kWideTile<T, CIN, COUT>;
  if constexpr (!RES && kBf16 && CIN == COUT) {
    if (residual != nullptr)
      return launch<T, IdxT, CIN, COUT, true>(feats, rb, w2, bias, out, n_in,
                                             n_out, taps, relu, split, stream,
                                             residual);
  } else if constexpr (!RES) {
    if (residual != nullptr) return cudaErrorInvalidValue;
  }
  auto* kern = fused_sparse_conv_kernel<T, IdxT, CIN, COUT, RES>;
  const T* res = static_cast<const T*>(residual);
  const int tiles = sessd::gather_gemm_grid(n_out).x;
  if constexpr (sessd::kMmaTile<T, CIN, COUT> ||
                sessd::kWideTile<T, CIN, COUT>) {
    const int wave = mma_wave<CIN, COUT>();
    if (wave <= 0) return cudaErrorInvalidConfiguration;
    const cudaError_t smem_ok = allow_smem<T, IdxT, CIN, COUT, RES>();
    if (smem_ok != cudaSuccess) return smem_ok;
    if (split == 0) split = sessd::cluster_split(tiles, wave);
    if (split != 1 && split != 2 && split != sessd::kMaxSplit)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * split);
    cfg.blockDim = dim3(sessd::kMmaThreads);
    cfg.dynamicSmemBytes = sessd::MmaLayout<CIN, COUT>::kSmemBytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kern, static_cast<const T*>(feats),
        static_cast<const IdxT*>(rb), static_cast<const T*>(w2), bias,
        static_cast<T*>(out), n_in, n_out, taps, relu, res);
    return err != cudaSuccess ? err : cudaGetLastError();
  } else if constexpr (sessd::kTf32Tile<T, CIN, COUT>) {
    if (split > 1) return cudaErrorInvalidValue;  // whole tiles only
    const cudaError_t smem_ok = allow_smem<T, IdxT, CIN, COUT, RES>();
    if (smem_ok != cudaSuccess) return smem_ok;
    kern<<<tiles, sessd::kMmaThreads, sessd::kTileSmemBytes<T, CIN, COUT>,
           stream>>>(static_cast<const T*>(feats),
                     static_cast<const IdxT*>(rb), static_cast<const T*>(w2),
                     bias, static_cast<T*>(out), n_in, n_out, taps, relu,
                     res);
    return cudaGetLastError();
  } else {
    if (split > 1) return cudaErrorInvalidValue;  // no cluster
    kern<<<sessd::direct_grid<CIN, COUT>(n_out), sessd::kDirectThreads, 0,
           stream>>>(static_cast<const T*>(feats),
                     static_cast<const IdxT*>(rb), static_cast<const T*>(w2),
                     bias, static_cast<T*>(out), n_in, n_out, taps, relu,
                     res);
    return cudaGetLastError();
  }
}

// the (Cin, Cout) pairs of the SpMiddleFHD plan
#define SESSD_FUSED_PAIRS(CASE) \
  CASE(4, 16)                   \
  CASE(16, 16)                  \
  CASE(16, 32)                  \
  CASE(32, 32)                  \
  CASE(32, 64)                  \
  CASE(64, 64)

// the bf16-only pairs of SpMiddleResNetFHD's last stages (kWideTile): the
// 3xTF32 tile does not fit 128 -> 128 in an SM's shared memory, so f32 has
// no instance of them
#define SESSD_FUSED_WIDE_PAIRS(CASE) \
  CASE(64, 128)                      \
  CASE(128, 128)

template <typename T>
constexpr bool kHasWide = std::is_same<T, __nv_bfloat16>::value;

template <typename T, typename IdxT>
cudaError_t dispatch_channels(int cin, int cout, const void* feats,
                              const void* rb, const void* w2,
                              const float* bias, void* out, int n_in,
                              int n_out, int taps, int relu, int split,
                              cudaStream_t stream, const void* residual) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch<T, IdxT, CI, CO>(feats, rb, w2, bias, out, n_in, n_out,    \
                                   taps, relu, split, stream, residual);
  SESSD_FUSED_PAIRS(SESSD_CASE)
  if constexpr (kHasWide<T>) {
    SESSD_FUSED_WIDE_PAIRS(SESSD_CASE)
  }
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

// 3 where the instance for (T, cin, cout) is the tensor-core tile through
// 3xTF32, 2 the tile in bf16, 1 the direct body, 0 where there is none
template <typename T>
int fused_instance(int cin, int cout) {
#define SESSD_CASE(CI, CO)                                               \
  if (cin == CI && cout == CO)                                           \
    return sessd::kTf32Tile<T, CI, CO> ? 3                               \
                                       : (sessd::kMmaTile<T, CI, CO> ? 2 \
                                                                    : 1);
  SESSD_FUSED_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  if constexpr (kHasWide<T>) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO) return 2;
    SESSD_FUSED_WIDE_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  }
  return 0;
}

// the wave of the tensor-core instance for (cin, cout), 0 where the
// instance is the direct body or missing
int fused_wave(int cin, int cout) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO) return wave_of<CI, CO>();
  SESSD_FUSED_PAIRS(SESSD_CASE)
  SESSD_FUSED_WIDE_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return 0;
}

int fused(const void* feats, const void* rb, const void* w2,
          const float* bias, void* out, int n_in, int n_out, int cin,
          int cout, int taps, int dtype, int idx_bytes, int relu, int split,
          void* stream, const void* residual = nullptr) {
  if (n_out <= 0 || taps <= 0 || taps > sessd::kMaxTaps)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && idx_bytes == 2)
    return dispatch_channels<float, int16_t>(cin, cout, feats, rb, w2, bias,
                                             out, n_in, n_out, taps, relu,
                                             split, s, residual);
  if (dtype == 0 && idx_bytes == 4)
    return dispatch_channels<float, int32_t>(cin, cout, feats, rb, w2, bias,
                                             out, n_in, n_out, taps, relu,
                                             split, s, residual);
  if (dtype == 1 && idx_bytes == 2)
    return dispatch_channels<__nv_bfloat16, int16_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, split,
        s, residual);
  if (dtype == 1 && idx_bytes == 4)
    return dispatch_channels<__nv_bfloat16, int32_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, split,
        s, residual);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success). dtype: 0 = f32, 1 = bf16; idx_bytes: 2 (int16) or 4 (int32).
// The tensor-core instances want feats and w2 16-byte aligned.
extern "C" int sessd_fused_sparse_conv(const void* feats, const void* rb,
                                       const void* w2, const float* bias,
                                       void* out, int n_in, int n_out,
                                       int cin, int cout, int taps,
                                       int dtype, int idx_bytes, int relu,
                                       void* stream) {
  return fused(feats, rb, w2, bias, out, n_in, n_out, cin, cout, taps, dtype,
               idx_bytes, relu, 0, stream);
}

// sessd_fused_sparse_conv whose store adds `residual` [n_out, cout] (bf16,
// 16-byte aligned) before the ReLU: the second conv of a residual block.
// bf16 tensor-core instances with cin == cout only.
extern "C" int sessd_fused_sparse_conv_residual(
    const void* feats, const void* rb, const void* w2, const float* bias,
    const void* residual, void* out, int n_in, int n_out, int cin, int cout,
    int taps, int dtype, int idx_bytes, int relu, void* stream) {
  if (residual == nullptr) return cudaErrorInvalidValue;
  return fused(feats, rb, w2, bias, out, n_in, n_out, cin, cout, taps, dtype,
               idx_bytes, relu, 0, stream, residual);
}

// sessd_fused_sparse_conv with the cluster size S fixed to `split` (1, 2 or
// 4) instead of the rule's; tensor-core instances only. For comparisons.
extern "C" int sessd_fused_sparse_conv_at_split(
    const void* feats, const void* rb, const void* w2, const float* bias,
    void* out, int n_in, int n_out, int cin, int cout, int taps, int dtype,
    int idx_bytes, int relu, int split, void* stream) {
  if (split < 1 || fused_instance<__nv_bfloat16>(cin, cout) != 2 ||
      dtype != 1)
    return cudaErrorInvalidValue;
  return fused(feats, rb, w2, bias, out, n_in, n_out, cin, cout, taps, dtype,
               idx_bytes, relu, split, stream);
}

// Which body sessd_fused_sparse_conv launches for (cin, cout, dtype): 3 the
// tensor-core tile through 3xTF32, 2 the tensor-core tile in bf16, 1 the
// direct body (gather_direct.cuh), 0 none.
extern "C" int sessd_fused_sparse_conv_instance(int cin, int cout,
                                                int dtype) {
  if (dtype == 0) return fused_instance<float>(cin, cout);
  if (dtype == 1) return fused_instance<__nv_bfloat16>(cin, cout);
  return 0;
}

// The wave sessd::cluster_split compares a launch's tiles with, for the
// bf16 tensor-core instance of (cin, cout): 0 where there is none.
extern "C" int sessd_fused_sparse_conv_wave(int cin, int cout) {
  return fused_wave(cin, cout);
}

// The cluster size S sessd_fused_sparse_conv launches with for n_out rows:
// 1 on the direct body and the 3xTF32 tile, 0 where there is no instance.
extern "C" int sessd_fused_sparse_conv_split(int n_out, int cin, int cout,
                                             int dtype) {
  const int inst = sessd_fused_sparse_conv_instance(cin, cout, dtype);
  if (inst == 0) return 0;
  if (inst != 2 || n_out <= 0) return 1;
  const int wave = fused_wave(cin, cout);
  return wave > 0 ? sessd::cluster_split(
                        static_cast<int>(sessd::gather_gemm_grid(n_out).x),
                        wave)
                  : 0;
}

extern "C" const char* sessd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
