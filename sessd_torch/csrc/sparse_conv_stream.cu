// Streaming fused sparse convolution + folded BatchNorm + ReLU + occupancy
// mask: the serving conv of the stages whose feature buffer is large.
//
// Replaces sessd_tpu/ops/pallas/wconv.py:_fused_stream_kernel (wconv.py:277),
// and with it _patch_stream_kernel. The TPU kernel keeps the features in HBM
// and, per tap, DMAs a [Cin, window] slice into one of two VMEM slots while
// the one-hot GEMM of the previous tap runs out of the other
// (pltpu.make_async_copy + two DMA semaphores). Here every rulebook entry is
// a direct row address, so there is no window and no over-span block for a
// patch kernel to recompute; what carries over is the overlap: the gathers
// of the taps ahead are in flight while the current tap computes.
//
// Computes the same function as fused_sparse_conv_kernel (sparse_conv.cu):
//   out[n, :] = relu(sum_k feats[rb[n, k], :] @ w2[k] + bias)
//               if any(rb[n, :] != n_in) else 0
//
// What bounds it on Hopper: gather bytes, as for K1: at most 2*Cout flops
// per loaded value, below the card's ridge. The kernel takes
// gather_mma.cuh's tensor-core tile with its bias + ReLU + any-hit store,
// fixed at compile time (no fallback at run time), in both types:
// - bf16: wgmma on bf16. The tile stays in bf16 from gather to wgmma,
//   keeps three taps' gathers in flight in a 4-stage cp.async ring, and
//   skips the taps no row of the tile hits. It sums in the tensor cores'
//   order; bf16 K1 runs the same tile, so the two agree bit for bit
//   wherever K1 runs one CTA per tile. bf16 alone has the 128-channel
//   pairs (64, 128) and (128, 128) of CenterPoint's residual backbone
//   (gather_mma.cuh: kWideTile).
// - f32 (the eval path on host chains and f32 serving, held to 1e-4):
//   the same tile through 3xTF32, each operand split into two TF32 parts
//   and each tap's three products summed from zero and added on the CUDA
//   cores (gather_mma.cuh says how). f32 K1 runs the same instance, so
//   the two agree bit for bit, and both equal the f32 forward
//   (sparse_conv_fwd_kernel, the same tile without the epilogue) plus bias,
//   ReLU and the any-hit mask. A row's sum runs over its tile's hit taps in
//   order, and a tap that misses the row adds a zero partial, so a row's
//   bits do not depend on the rows batched with it.

#include "gather_mma.cuh"

namespace {

using sessd::kMaxTaps;
using sessd::kThreads;

// RES: the store adds residual [n_out, COUT] before the ReLU (the second
// conv of a residual block: bf16, CIN == COUT)
template <typename T, typename IdxT, int CIN, int COUT, bool RES = false>
__global__ void __launch_bounds__(kThreads)
fused_sparse_conv_stream_kernel(const T* __restrict__ feats,
                                const IdxT* __restrict__ rb,
                                const T* __restrict__ w2,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int n_in, int n_out,
                                int taps, int relu,
                                const T* __restrict__ residual) {
  // every pair of SESSD_STREAM_PAIRS has 16-64 channels (the 4-channel
  // first conv never streams), SESSD_STREAM_WIDE_PAIRS' 64-128, bf16 only
  if constexpr (RES)
    sessd::gather_mma_tile<IdxT, CIN, COUT, true, false, false,
                           sessd::kTileFull, true>(
        feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu,
        residual);
  else if constexpr (sessd::kMmaTile<T, CIN, COUT> ||
                     sessd::kTf32Tile<T, CIN, COUT> ||
                     sessd::kWideTile<T, CIN, COUT>)
    sessd::gather_mma_tile<IdxT, CIN, COUT, true>(
        feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu);
  else {
    static_assert(sizeof(T) == 0, "the stream kernel takes 16-64 channels");
  }
}

template <typename T, typename IdxT, int CIN, int COUT>
using StreamKernel = void (*)(const T*, const IdxT*, const T*, const float*,
                              T*, int, int, int, int, const T*);

// the stream kernel of the instance (RES: with the residual store), its
// threads and its dynamic shared memory
template <typename T, typename IdxT, int CIN, int COUT, bool RES = false>
struct Launch {
  static constexpr int kBlock = sessd::kMmaThreads;
  static constexpr int kSmem = sessd::kTileSmemBytes<T, CIN, COUT>;
  static StreamKernel<T, IdxT, CIN, COUT> kernel() {
    return fused_sparse_conv_stream_kernel<T, IdxT, CIN, COUT, RES>;
  }
  // above 48 KB a block's shared memory must be asked for, once per kernel
  static cudaError_t allow_smem() {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    return attr;
  }
};

// residual: null, or the RES instance's [n_out, COUT] (bf16, CIN == COUT:
// the residual blocks' second convs)
template <typename T, typename IdxT, int CIN, int COUT, bool RES = false>
cudaError_t launch(const void* feats, const void* rb, const void* w2,
                   const float* bias, void* out, int n_in, int n_out,
                   int taps, int relu, cudaStream_t stream,
                   const void* residual = nullptr) {
  if constexpr (!RES && CIN == COUT &&
                std::is_same<T, __nv_bfloat16>::value) {
    if (residual != nullptr)
      return launch<T, IdxT, CIN, COUT, true>(
          feats, rb, w2, bias, out, n_in, n_out, taps, relu, stream,
          residual);
  } else if constexpr (!RES) {
    if (residual != nullptr) return cudaErrorInvalidValue;
  }
  using L = Launch<T, IdxT, CIN, COUT, RES>;
  const cudaError_t attr = L::allow_smem();
  if (attr != cudaSuccess) return attr;
  L::kernel()<<<sessd::gather_gemm_grid(n_out), L::kBlock, L::kSmem,
                stream>>>(static_cast<const T*>(feats),
                          static_cast<const IdxT*>(rb),
                          static_cast<const T*>(w2), bias,
                          static_cast<T*>(out), n_in, n_out, taps, relu,
                          static_cast<const T*>(residual));
  return cudaGetLastError();
}

// the (Cin, Cout) pairs of the SpMiddleFHD plan that can stream: Cin = 4
// (the first conv) never does, its buffer is small
#define SESSD_STREAM_PAIRS(CASE) \
  CASE(16, 16)                   \
  CASE(16, 32)                   \
  CASE(32, 32)                   \
  CASE(32, 64)                   \
  CASE(64, 64)

// the bf16-only pairs of SpMiddleResNetFHD's last stages (kWideTile)
#define SESSD_STREAM_WIDE_PAIRS(CASE) \
  CASE(64, 128)                       \
  CASE(128, 128)

template <typename T>
constexpr bool kHasWide = std::is_same<T, __nv_bfloat16>::value;

template <typename T, typename IdxT>
cudaError_t dispatch_channels(int cin, int cout, const void* feats,
                              const void* rb, const void* w2,
                              const float* bias, void* out, int n_in,
                              int n_out, int taps, int relu,
                              cudaStream_t stream,
                              const void* residual = nullptr) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch<T, IdxT, CI, CO>(feats, rb, w2, bias, out, n_in, n_out,    \
                                   taps, relu, stream, residual);
  SESSD_STREAM_PAIRS(SESSD_CASE)
  if constexpr (kHasWide<T>) {
    SESSD_STREAM_WIDE_PAIRS(SESSD_CASE)
  }
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

// 3 where the instance for (T, cin, cout) is the tensor-core tile through
// 3xTF32, 2 the tile in bf16, 0 where there is none
template <typename T>
int stream_instance(int cin, int cout) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO) return sessd::kTf32Tile<T, CI, CO> ? 3 : 2;
  SESSD_STREAM_PAIRS(SESSD_CASE)
  if constexpr (kHasWide<T>) {
    SESSD_STREAM_WIDE_PAIRS(SESSD_CASE)
  }
#undef SESSD_CASE
  return 0;
}

// blocks of the stream kernel's int32-rulebook instance for (T, cin, cout)
// that fit one SM at its threads, registers and shared memory; 0 where
// there is none or it cannot be read
template <typename T>
int stream_blocks_per_sm(int cin, int cout) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO) {                                             \
    using L = Launch<T, int32_t, CI, CO>;                                    \
    int blocks = 0;                                                          \
    cudaError_t err = L::allow_smem();                                       \
    if (err == cudaSuccess)                                                  \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
          &blocks, L::kernel(), L::kBlock, L::kSmem);                        \
    return err == cudaSuccess ? blocks : 0;                                  \
  }
  SESSD_STREAM_PAIRS(SESSD_CASE)
  if constexpr (kHasWide<T>) {
    SESSD_STREAM_WIDE_PAIRS(SESSD_CASE)
  }
#undef SESSD_CASE
  return 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success). dtype: 0 = f32, 1 = bf16; idx_bytes: 2 (int16) or 4 (int32).
// feats and w2 must be 16-byte aligned.
extern "C" int sessd_fused_sparse_conv_stream(const void* feats,
                                              const void* rb, const void* w2,
                                              const float* bias, void* out,
                                              int n_in, int n_out, int cin,
                                              int cout, int taps, int dtype,
                                              int idx_bytes, int relu,
                                              void* stream) {
  if (n_out <= 0 || taps <= 0 || taps > kMaxTaps) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && idx_bytes == 2)
    return dispatch_channels<float, int16_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, s);
  if (dtype == 0 && idx_bytes == 4)
    return dispatch_channels<float, int32_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, s);
  if (dtype == 1 && idx_bytes == 2)
    return dispatch_channels<__nv_bfloat16, int16_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, s);
  if (dtype == 1 && idx_bytes == 4)
    return dispatch_channels<__nv_bfloat16, int32_t>(
        cin, cout, feats, rb, w2, bias, out, n_in, n_out, taps, relu, s);
  return cudaErrorInvalidValue;
}

// sessd_fused_sparse_conv_stream whose store adds `residual` [n_out, cout]
// (bf16, 16-byte aligned) before the ReLU: the second conv of a residual
// block; bf16 with cin == cout only.
extern "C" int sessd_fused_sparse_conv_stream_residual(
    const void* feats, const void* rb, const void* w2, const float* bias,
    const void* residual, void* out, int n_in, int n_out, int cin, int cout,
    int taps, int dtype, int idx_bytes, int relu, void* stream) {
  if (n_out <= 0 || taps <= 0 || taps > kMaxTaps || residual == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SESSD_CALL(T, I)                                                     \
  return dispatch_channels<T, I>(cin, cout, feats, rb, w2, bias, out, n_in, \
                                 n_out, taps, relu, s, residual)
  if (dtype == 0 && idx_bytes == 2) SESSD_CALL(float, int16_t);
  if (dtype == 0 && idx_bytes == 4) SESSD_CALL(float, int32_t);
  if (dtype == 1 && idx_bytes == 2) SESSD_CALL(__nv_bfloat16, int16_t);
  if (dtype == 1 && idx_bytes == 4) SESSD_CALL(__nv_bfloat16, int32_t);
#undef SESSD_CALL
  return cudaErrorInvalidValue;
}

// Which body sessd_fused_sparse_conv_stream launches for (cin, cout,
// dtype): 3 the tensor-core tile through 3xTF32, 2 the tile in bf16, 0
// none.
extern "C" int sessd_fused_sparse_conv_stream_instance(int cin, int cout,
                                                       int dtype) {
  if (dtype == 0) return stream_instance<float>(cin, cout);
  if (dtype == 1) return stream_instance<__nv_bfloat16>(cin, cout);
  return 0;
}

// Blocks of sessd_fused_sparse_conv_stream's int32-rulebook instance for
// (cin, cout, dtype) that fit one SM at once; 0 for a pair it has no
// instance of, or where it cannot be read.
extern "C" int sessd_fused_sparse_conv_stream_blocks_per_sm(int cin,
                                                            int cout,
                                                            int dtype) {
  if (dtype == 0) return stream_blocks_per_sm<float>(cin, cout);
  if (dtype == 1) return stream_blocks_per_sm<__nv_bfloat16>(cin, cout);
  return 0;
}
