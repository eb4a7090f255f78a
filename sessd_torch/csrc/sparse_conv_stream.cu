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
// per loaded value, below the card's ridge. The kernel takes one of two
// bodies by type, fixed at compile time (no fallback at run time):
// - bf16: gather_mma.cuh's tensor-core tile with its bias + ReLU + any-hit
//   store. The scalar two-slot ring it replaces converted each staged bf16
//   value to f32 at every use and ran a scalar FMA loop over every tap of
//   every tile (7% slower than K1 in bf16, PERF.md). The new tile stays in
//   bf16 from gather to wgmma, keeps three taps' gathers in flight in a
//   4-stage cp.async ring, and skips the taps no row of the tile hits. It
//   sums in the tensor cores' order, so in bf16 it no longer equals K1 bit
//   for bit.
// - f32 (the eval path, held to 1e-4): the two-stage ring below, K1's tile,
//   thread mapping and summation order (tap by tap, input channel by input
//   channel, one fmaf per product), so f32 K3 equals K1 bit for bit. While
//   the block runs tap k out of slot k%2, every thread has already issued
//   tap k+1's gathered rows and weights into the other slot with cp.async
//   (16-byte chunks, L2 only); a miss row is a zero-fill copy (src-size 0).
//   Two slots of 64 rows plus a [Cin, Cout] weight tile each and the
//   rulebook tile take up to 73 KB (64x64), so it uses dynamic shared
//   memory.

#include "gather_mma.cuh"

namespace {

using sessd::kMaxTaps;
using sessd::kRows;
using sessd::kThreads;

template <typename T, int CIN, int COUT>
struct StreamLayout {
  static constexpr int kChunk = 16 / sizeof(T);  // elements per cp.async
  static_assert(CIN % kChunk == 0, "rows are whole 16-byte chunks");
  // one chunk of padding per staged row keeps rows 16-byte aligned and
  // puts the rows one thread group reads in distinct banks
  static constexpr int kGStride = CIN + kChunk;
  static constexpr int kRowChunks = CIN / kChunk;
  static constexpr int kWChunks = CIN * COUT / kChunk;
  static constexpr int kGBytes = kRows * kGStride * sizeof(T);
  static constexpr int kWBytes = CIN * COUT * sizeof(T);
  static constexpr int kSlotBytes = kGBytes + kWBytes;
  static constexpr int kSmemBytes =
      2 * kSlotBytes + (kRows * kMaxTaps + kRows) * sizeof(int);
};

__device__ __forceinline__ void load4(const float* p, float (&b)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}

// Issue tap k's 64 gathered rows and its [Cin, Cout] weights into `slot`,
// as one cp.async group of this thread.
template <typename T, int CIN, int COUT>
__device__ __forceinline__ void issue_tap(unsigned char* slot,
                                          const T* __restrict__ feats,
                                          const T* __restrict__ w2,
                                          const int* s_rb, int k, int taps,
                                          int n_in) {
  using L = StreamLayout<T, CIN, COUT>;
  T* g = reinterpret_cast<T*>(slot);
  T* w = reinterpret_cast<T*>(slot + L::kGBytes);
  for (int i = threadIdx.x; i < kRows * L::kRowChunks; i += kThreads) {
    const int r = i / L::kRowChunks;
    const int c = (i % L::kRowChunks) * L::kChunk;
    const int src = s_rb[r * taps + k];
    const bool hit = static_cast<unsigned>(src) < static_cast<unsigned>(n_in);
    // a miss reads nothing and fills the chunk with zeros
    sessd::cp_async16(sessd::smem_u32(g + r * L::kGStride + c),
                      feats + (size_t)(hit ? src : 0) * CIN + c,
                      hit ? 16 : 0);
  }
  const T* wk = w2 + (size_t)k * CIN * COUT;
  for (int i = threadIdx.x; i < L::kWChunks; i += kThreads)
    sessd::cp_async16(sessd::smem_u32(w + i * L::kChunk), wk + i * L::kChunk,
                      16);
  sessd::cp_async_commit();
}

// The scalar two-slot body (f32): K1's tile with each tap's gather issued
// one tap ahead.
template <typename T, typename IdxT, int CIN, int COUT>
__device__ __forceinline__ void stream_fma_tile(const T* __restrict__ feats,
                                                const IdxT* __restrict__ rb,
                                                const T* __restrict__ w2,
                                                const float* __restrict__ bias,
                                                T* __restrict__ out, int n_in,
                                                int n_out, int taps,
                                                int relu) {
  using L = StreamLayout<T, CIN, COUT>;
  constexpr int kCols = 4;                   // output channels per thread
  constexpr int kTx = COUT / kCols;          // threads across channels
  constexpr int kTy = kThreads / kTx;        // threads across rows
  constexpr int kRowsPerThread = kRows / kTy;
  static_assert(COUT % 16 == 0 && kRowsPerThread * kTy == kRows, "tile");

  extern __shared__ __align__(16) unsigned char smem[];
  int* s_rb = reinterpret_cast<int*>(smem + 2 * L::kSlotBytes);
  int* s_hit = s_rb + kRows * kMaxTaps;

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kRows;

  // the tile's rulebook, read once; rows past n_out read as all-miss
  for (int i = tid; i < kRows * taps; i += kThreads) {
    const int n = row0 + i / taps;
    s_rb[i] = n < n_out ? static_cast<int>(rb[(size_t)row0 * taps + i]) : n_in;
  }
  __syncthreads();
  if (tid < kRows) {
    int keep = 0;
    for (int k = 0; k < taps; ++k) keep |= s_rb[tid * taps + k] != n_in;
    s_hit[tid] = keep;  // read after the tap loop's barriers
  }
  issue_tap<T, CIN, COUT>(smem, feats, w2, s_rb, 0, taps, n_in);

  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int k = 0; k < taps; ++k) {
    // tap k has landed for every thread, and every thread is done with
    // tap k-1, whose slot tap k+1 now refills while tap k computes
    sessd::cp_async_wait<0>();
    __syncthreads();
    if (k + 1 < taps)
      issue_tap<T, CIN, COUT>(smem + ((k + 1) & 1) * L::kSlotBytes, feats,
                              w2, s_rb, k + 1, taps, n_in);
    const unsigned char* slot = smem + (k & 1) * L::kSlotBytes;
    const T* g = reinterpret_cast<const T*>(slot);
    const T* w = reinterpret_cast<const T*>(slot + L::kGBytes);

#pragma unroll 4
    for (int c = 0; c < CIN; ++c) {
      float b[kCols];
      load4(w + c * COUT + tx * kCols, b);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float a = sessd::to_f32(g[(ty + r * kTy) * L::kGStride + c]);
        acc[r][0] = fmaf(a, b[0], acc[r][0]);
        acc[r][1] = fmaf(a, b[1], acc[r][1]);
        acc[r][2] = fmaf(a, b[2], acc[r][2]);
        acc[r][3] = fmaf(a, b[3], acc[r][3]);
      }
    }
  }

  float bv[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) bv[j] = bias[tx * kCols + j];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int lr = ty + r * kTy;
    const int n = row0 + lr;
    if (n >= n_out) continue;
    const bool keep = s_hit[lr] != 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[r][j] + bv[j];
      if (relu) v = fmaxf(v, 0.f);
      out[(size_t)n * COUT + tx * kCols + j] =
          sessd::from_f32<T>(keep ? v : 0.f);
    }
  }
}

template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
fused_sparse_conv_stream_kernel(const T* __restrict__ feats,
                                const IdxT* __restrict__ rb,
                                const T* __restrict__ w2,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int n_in, int n_out,
                                int taps, int relu) {
  if constexpr (sessd::kMmaTile<T, CIN, COUT>)
    sessd::gather_mma_tile<IdxT, CIN, COUT, true>(
        feats, rb, w2, bias, nullptr, out, n_in, n_out, taps, relu);
  else
    stream_fma_tile<T, IdxT, CIN, COUT>(feats, rb, w2, bias, out, n_in,
                                        n_out, taps, relu);
}

// dynamic shared memory of one block of the instance
template <typename T, int CIN, int COUT>
constexpr int smem_bytes() {
  if constexpr (sessd::kMmaTile<T, CIN, COUT>)
    return sessd::MmaLayout<CIN, COUT>::kSmemBytes;
  else
    return StreamLayout<T, CIN, COUT>::kSmemBytes;
}

template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch(const void* feats, const void* rb, const void* w2,
                   const float* bias, void* out, int n_in, int n_out,
                   int taps, int relu, cudaStream_t stream) {
  constexpr bool kMma = sessd::kMmaTile<T, CIN, COUT>;
  constexpr int smem = smem_bytes<T, CIN, COUT>();
  auto* kern = fused_sparse_conv_stream_kernel<T, IdxT, CIN, COUT>;
  // above 48 KB a block's shared memory must be asked for, once per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kern<<<sessd::gather_gemm_grid(n_out), kMma ? sessd::kMmaThreads : kThreads,
         smem, stream>>>(static_cast<const T*>(feats),
                         static_cast<const IdxT*>(rb),
                         static_cast<const T*>(w2), bias,
                         static_cast<T*>(out), n_in, n_out, taps, relu);
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
  SESSD_STREAM_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

// 2 where the instance for (T, cin, cout) is the tensor-core tile, 1 where
// it is the scalar two-slot ring, 0 where there is none
template <typename T>
int stream_instance(int cin, int cout) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO) return sessd::kMmaTile<T, CI, CO> ? 2 : 1;
  SESSD_STREAM_PAIRS(SESSD_CASE)
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

// Which body sessd_fused_sparse_conv_stream launches for (cin, cout,
// dtype): 2 the tensor-core tile, 1 the scalar ring, 0 none.
extern "C" int sessd_fused_sparse_conv_stream_instance(int cin, int cout,
                                                       int dtype) {
  if (dtype == 0) return stream_instance<float>(cin, cout);
  if (dtype == 1) return stream_instance<__nv_bfloat16>(cin, cout);
  return 0;
}
