// The sparse convolution of a training step: forward, input gradient and
// weight gradient, for every (Cin, Cout, K) of the SpMiddleFHD plan.
//
// Replaces the custom VJP of sessd_tpu/ops/pallas/wconv.py:_core, i.e. the
// Pallas _fwd_kernel (wconv.py:51: out_t = w2t @ g over one-hot windows)
// and _bwd_kernel (wconv.py:67: dG = W^T dout, dFeat += dG_k onehot^T
// read-modify-written along the sequential grid, dW += dout g^T with g
// recomputed). On the TPU the grid runs in order on one core, so dFeat can
// be a running sum in VMEM. Here blocks run in parallel and in no order, so
// both reductions are recast to need no atomics and give the same bits on
// every run:
//
//   forward  out[n]   = sum_k feats[rb[n, k]] @ W[k]            (mask rows)
//   dFeat    dfeat[i] = sum_k dout[inv[i, k]] @ W[k]^T
//   dW       dW[k]    = sum_n feats[rb[n, k]]^T dout[n]
//
// dFeat is the forward's gather-GEMM over the inverse rulebook
// inv[rb[n, k], k] = n (each tap's map is injective: distinct outputs read
// distinct inputs), with W^T [K, Cout, Cin] as the weights: each input row
// owns its sum, so there is no scatter. dW is a reduction over up to ~88k
// rows per tap: split-K over row chunks into f32 partials
// [chunks, K, Cin, Cout], then a second pass sums the chunks in order.
//
// The forward, sparse_conv_fwd_kernel, takes one of two bodies by type and
// shape, fixed at compile time (no fallback at run time):
// - bf16 with Cin in {16, 32, 64}: gather_mma.cuh's tensor-core tile
//   (wgmma out of a 4-stage cp.async ring, taps that no row of the tile
//   hits skipped), 128 threads and dynamic shared memory per block. What
//   bounds it on this card and what that design does about it are in the
//   header. The training step's bf16 student chain runs 9 of its 10 convs
//   here.
// - f32 (the step-parity and eval paths, held to 1e-4) and the Cin = 4
//   first conv: gather_gemm.cuh's scalar tile, 256 threads.
// dFeat is gather_gemm.cuh's scalar tile under a name of its own. dW is
// bound by the same gathers: each (chunk, tap) block stages 64 gathered
// feature rows and the 64 matching dout rows in shared memory per step and
// accumulates its Cin x Cout tile in registers (up to 4 x 4 per thread, so
// each value read from shared memory feeds 4 FMAs); dout is read by the K
// blocks of a chunk and comes from L2 after the first. Tensor cores for
// dFeat and dW are later work.

#include "gather_mma.cuh"

namespace {

using sessd::kRows;
using sessd::kThreads;
using sessd::from_f32;
using sessd::to_f32;

// out [n_out, COUT] = gather-GEMM of x [n_in, CIN] over rb [n_out, taps]
// with w2 [taps, CIN, COUT], rows outside row_mask zero (no mask: all kept).
template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_fwd_kernel(const T* __restrict__ x, const IdxT* __restrict__ rb,
                           const T* __restrict__ w2,
                           const uint8_t* __restrict__ row_mask,
                           T* __restrict__ out, int n_in, int n_out,
                           int taps) {
  if constexpr (sessd::kMmaTile<T, CIN, COUT>)
    sessd::gather_mma_tile<IdxT, CIN, COUT, false>(
        x, rb, w2, nullptr, row_mask, out, n_in, n_out, taps, 0);
  else
    sessd::gather_gemm_tile<T, IdxT, CIN, COUT, false>(
        x, rb, w2, nullptr, row_mask, out, n_in, n_out, taps, 0);
}

// dfeat [n_in, CIN] = the same gather-GEMM over the inverse rulebook with
// the transposed weights, under a name of its own so a profile tells it
// from the forward
template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_dfeat_kernel(const T* __restrict__ x,
                             const IdxT* __restrict__ rb,
                             const T* __restrict__ w2,
                             const uint8_t* __restrict__ row_mask,
                             T* __restrict__ out, int n_in, int n_out,
                             int taps) {
  sessd::gather_gemm_tile<T, IdxT, CIN, COUT, false>(
      x, rb, w2, nullptr, row_mask, out, n_in, n_out, taps, 0);
}

template <typename T, typename IdxT>
using GatherKernel = void (*)(const T*, const IdxT*, const T*,
                              const uint8_t*, T*, int, int, int);

template <typename T, typename IdxT>
cudaError_t launch_gather(GatherKernel<T, IdxT> kernel,
                          const void* x, const void* rb, const void* w2,
                          const uint8_t* row_mask, void* out, int n_in,
                          int n_out, int taps, cudaStream_t stream) {
  kernel<<<sessd::gather_gemm_grid(n_out), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const IdxT*>(rb),
      static_cast<const T*>(w2), row_mask, static_cast<T*>(out), n_in, n_out,
      taps);
  return cudaGetLastError();
}

template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch_fwd(const void* x, const void* rb, const void* w2,
                       const uint8_t* row_mask, void* out, int n_in,
                       int n_out, int taps, cudaStream_t stream) {
  auto* kern = sparse_conv_fwd_kernel<T, IdxT, CIN, COUT>;
  if constexpr (sessd::kMmaTile<T, CIN, COUT>) {
    constexpr int smem = sessd::MmaLayout<CIN, COUT>::kSmemBytes;
    // above 48 KB a block's shared memory must be asked for, once per kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    kern<<<sessd::gather_gemm_grid(n_out), sessd::kMmaThreads, smem,
           stream>>>(static_cast<const T*>(x), static_cast<const IdxT*>(rb),
                     static_cast<const T*>(w2), row_mask,
                     static_cast<T*>(out), n_in, n_out, taps);
    return cudaGetLastError();
  } else {
    return launch_gather<T, IdxT>(kern, x, rb, w2, row_mask, out, n_in,
                                  n_out, taps, stream);
  }
}

// the forward's (Cin, Cout) pairs of both training plans
#define SESSD_FWD_PAIRS(CASE) \
  CASE(4, 16)                 \
  CASE(16, 16)                \
  CASE(16, 32)                \
  CASE(32, 32)                \
  CASE(32, 64)                \
  CASE(64, 64)

template <typename T, typename IdxT>
cudaError_t dispatch_fwd(int cin, int cout, const void* x, const void* rb,
                         const void* w2, const uint8_t* row_mask, void* out,
                         int n_in, int n_out, int taps, cudaStream_t stream) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch_fwd<T, IdxT, CI, CO>(x, rb, w2, row_mask, out, n_in,       \
                                       n_out, taps, stream);
  SESSD_FWD_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

// 2 where the forward's instance for (T, cin, cout) is the tensor-core
// tile, 1 where it is the scalar tile, 0 where there is none
template <typename T>
int fwd_instance(int cin, int cout) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO) return sessd::kMmaTile<T, CI, CO> ? 2 : 1;
  SESSD_FWD_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return 0;
}

// the swapped pairs the input gradient takes (Cout -> Cin of each conv but
// the first, 4 -> 16, whose input needs no gradient)
template <typename T, typename IdxT>
cudaError_t dispatch_dfeat(int cin, int cout, const void* x, const void* rb,
                           const void* w2, void* out, int n_in, int n_out,
                           int taps, cudaStream_t stream) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch_gather<T, IdxT>(                                           \
        sparse_conv_dfeat_kernel<T, IdxT, CI, CO>, x, rb, w2, nullptr, out,  \
        n_in, n_out, taps, stream);
  SESSD_CASE(16, 16)
  SESSD_CASE(32, 16)
  SESSD_CASE(32, 32)
  SESSD_CASE(64, 32)
  SESSD_CASE(64, 64)
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

template <int CIN, int COUT>
struct DwTile {
  static constexpr int kTj = 4;  // output channels per thread
  static constexpr int kTiRaw = CIN * COUT / (kThreads * kTj);
  static constexpr int kTi = kTiRaw < 1 ? 1 : kTiRaw;  // input channels
  static constexpr int kTx = COUT / kTj;
  static constexpr int kActive = kTx * (CIN / kTi);
  static_assert(COUT % kTj == 0 && CIN % kTi == 0 && kActive <= kThreads,
                "dW tile");
};

// partial[chunk, k] = sum over the chunk's rows n of
//   feats[rb[n, k]]^T dout[n]              ([CIN, COUT], f32)
template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_partial_kernel(const T* __restrict__ feats,
                              const IdxT* __restrict__ rb,
                              const T* __restrict__ dout,
                              float* __restrict__ partial, int n_in,
                              int n_out, int taps, int chunk_rows) {
  using Tile = DwTile<CIN, COUT>;
  constexpr int kTi = Tile::kTi;
  constexpr int kTj = Tile::kTj;
  __shared__ float s_g[kRows * CIN];
  __shared__ __align__(16) float s_d[kRows * COUT];

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int chunk = blockIdx.x;
  const int begin = chunk * chunk_rows;
  const int end = min(n_out, begin + chunk_rows);
  const bool active = tid < Tile::kActive;
  const int tj = tid % Tile::kTx;
  const int ti = tid / Tile::kTx;

  float acc[kTi][kTj];
#pragma unroll
  for (int i = 0; i < kTi; ++i)
#pragma unroll
    for (int j = 0; j < kTj; ++j) acc[i][j] = 0.f;

  for (int row0 = begin; row0 < end; row0 += kRows) {
    for (int i = tid; i < kRows * CIN; i += kThreads) {
      const int n = row0 + i / CIN;
      const int c = i % CIN;
      const int src = n < end ? static_cast<int>(rb[(size_t)n * taps + k])
                              : n_in;
      s_g[i] = static_cast<unsigned>(src) < static_cast<unsigned>(n_in)
                   ? to_f32(feats[(size_t)src * CIN + c])
                   : 0.f;
    }
    for (int i = tid; i < kRows * COUT; i += kThreads) {
      const int n = row0 + i / COUT;
      s_d[i] = n < end ? to_f32(dout[(size_t)row0 * COUT + i]) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        const float4 b =
            *reinterpret_cast<const float4*>(&s_d[r * COUT + tj * kTj]);
#pragma unroll
        for (int i = 0; i < kTi; ++i) {
          const float a = s_g[r * CIN + ti * kTi + i];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* dst = partial + ((size_t)chunk * taps + k) * CIN * COUT;
#pragma unroll
  for (int i = 0; i < kTi; ++i)
#pragma unroll
    for (int j = 0; j < kTj; ++j)
      dst[(ti * kTi + i) * COUT + tj * kTj + j] = acc[i][j];
}

// dw[e] = sum over chunks, in order, of partial[chunk, e]; e over K*Cin*Cout
template <typename T>
__global__ void sparse_conv_dw_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ dw, int chunks,
    int size) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * size + e];
  dw[e] = from_f32<T>(s);
}

template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch_dw(const void* feats, const void* rb, const void* dout,
                      float* partial, void* dw, int n_in, int n_out, int taps,
                      int chunk_rows, cudaStream_t stream) {
  const int chunks = (n_out + chunk_rows - 1) / chunk_rows;
  sparse_conv_dw_partial_kernel<T, IdxT, CIN, COUT>
      <<<dim3(chunks, taps), kThreads, 0, stream>>>(
          static_cast<const T*>(feats), static_cast<const IdxT*>(rb),
          static_cast<const T*>(dout), partial, n_in, n_out, taps,
          chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = taps * CIN * COUT;
  sparse_conv_dw_reduce_kernel<T><<<(size + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<T*>(dw), chunks, size);
  return cudaGetLastError();
}

template <typename T, typename IdxT>
cudaError_t dispatch_dw(int cin, int cout, const void* feats, const void* rb,
                        const void* dout, float* partial, void* dw, int n_in,
                        int n_out, int taps, int chunk_rows,
                        cudaStream_t stream) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch_dw<T, IdxT, CI, CO>(feats, rb, dout, partial, dw, n_in,    \
                                      n_out, taps, chunk_rows, stream);
  SESSD_CASE(4, 16)
  SESSD_CASE(16, 16)
  SESSD_CASE(16, 32)
  SESSD_CASE(32, 32)
  SESSD_CASE(32, 64)
  SESSD_CASE(64, 64)
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

bool bad_args(int n_in, int n_out, int taps) {
  return n_in <= 0 || n_out <= 0 || taps <= 0 || taps > sessd::kMaxTaps;
}

}  // namespace

// All entry points launch on `stream` and return cudaGetLastError() of their
// launches (0 on success); cudaErrorInvalidValue for a shape or type they
// have no instance of. dtype: 0 = f32, 1 = bf16; idx_bytes: 2 or 4.
#define SESSD_TYPES(CALL)                                                    \
  if (dtype == 0 && idx_bytes == 2) return CALL(float, int16_t);            \
  if (dtype == 0 && idx_bytes == 4) return CALL(float, int32_t);            \
  if (dtype == 1 && idx_bytes == 2) return CALL(__nv_bfloat16, int16_t);    \
  if (dtype == 1 && idx_bytes == 4) return CALL(__nv_bfloat16, int32_t);    \
  return cudaErrorInvalidValue;

// out [n_out, cout] = sum_k feats[rb[n, k]] @ w2[k] for feats [n_in, cin],
// rb [n_out, taps], w2 [taps, cin, cout]; rows with row_mask[n] == 0 are 0
// (row_mask may be null).
extern "C" int sessd_sparse_conv_fwd(const void* feats, const void* rb,
                                     const void* w2, const uint8_t* row_mask,
                                     void* out, int n_in, int n_out, int cin,
                                     int cout, int taps, int dtype,
                                     int idx_bytes, void* stream) {
  if (bad_args(n_in, n_out, taps)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SESSD_CALL(T, I)                                                     \
  dispatch_fwd<T, I>(cin, cout, feats, rb, w2, row_mask, out, n_in, n_out,  \
                     taps, s)
  SESSD_TYPES(SESSD_CALL)
#undef SESSD_CALL
}

// Which body sessd_sparse_conv_fwd launches for (cin, cout, dtype): 2 the
// tensor-core tile, 1 the scalar tile, 0 none (it answers
// cudaErrorInvalidValue).
extern "C" int sessd_sparse_conv_fwd_instance(int cin, int cout, int dtype) {
  if (dtype == 0) return fwd_instance<float>(cin, cout);
  if (dtype == 1) return fwd_instance<__nv_bfloat16>(cin, cout);
  return 0;
}

// dfeat [n_in, cin] = sum_k dout[inv[i, k]] @ wt[k] for dout [n_out, cout]
// (n_out = its miss), the inverse rulebook inv [n_in, taps] and the
// transposed weights wt [taps, cout, cin]: the forward's gather-GEMM with
// the roles of the two sides swapped.
extern "C" int sessd_sparse_conv_dfeat(const void* dout, const void* inv,
                                       const void* wt, void* dfeat, int n_out,
                                       int n_in, int cin, int cout, int taps,
                                       int dtype, int idx_bytes,
                                       void* stream) {
  if (bad_args(n_out, n_in, taps)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SESSD_CALL(T, I)                                                     \
  dispatch_dfeat<T, I>(cout, cin, dout, inv, wt, dfeat, n_out, n_in, taps, s)
  SESSD_TYPES(SESSD_CALL)
#undef SESSD_CALL
}

// dw [taps, cin, cout] = sum_n feats[rb[n, k]]^T dout[n]; partial is f32
// scratch of [ceil(n_out / chunk_rows), taps, cin, cout].
extern "C" int sessd_sparse_conv_dw(const void* feats, const void* rb,
                                    const void* dout, float* partial,
                                    void* dw, int n_in, int n_out, int cin,
                                    int cout, int taps, int chunk_rows,
                                    int dtype, int idx_bytes, void* stream) {
  if (bad_args(n_in, n_out, taps) || chunk_rows <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SESSD_CALL(T, I)                                                     \
  dispatch_dw<T, I>(cin, cout, feats, rb, dout, partial, dw, n_in, n_out,   \
                    taps, chunk_rows, s)
  SESSD_TYPES(SESSD_CALL)
#undef SESSD_CALL
}
