// Micro-benchmark kernels: an ablation of the gather-GEMM tile and an empty
// launch. Neither runs in serving or training; they split the cost of the
// sparse conv into its parts and measure the fixed cost of one launch.
//
// sparse_conv_ablate_kernel<MODE> replaces the ablated copies of the Pallas
// _fwd_kernel in scripts/bench_wconv_ablate.py (full_kernel, run through
// run_kernel). It is a copy of gather_gemm.cuh's scalar tile, instantiated
// only for the ablation's shape: bf16 features and weights, an int32
// rulebook, 16 -> 16 channels. Each mode removes one cost:
//   kFull      the real gather over the rulebook (K = 27, or 9 for the
//              "K=9" variant: the same mode on a 9-tap rulebook); the same
//              arithmetic in the same order as the scalar tile of K1
//              (fused_sparse_conv_kernel) with zero bias and no ReLU, so
//              the two agree bit for bit (the bf16 training forward now
//              runs the tensor-core tile, gather_mma.cuh);
//   kLinear    row n of every tap reads feature row n: no rulebook loads,
//              no indirection, the same staging and FMAs (the TPU's
//              "static lo" / "fully static window");
//   kNoGather  the rulebook is read, but a staged row is the constant
//              kNoGatherValue where the tap hits and 0 where it misses: no
//              feature loads (the TPU's "const one-hot");
//   kFmaOnly   rows (kLinear's, of tap 0) and tap 0's weights are staged
//              once; the tap loop runs only the FMAs and its barrier (the
//              TPU's "dots only").
// What bounds it: as for the real conv, bytes (about 3.5 MB at the
// ablation's shape: the rulebook is most of it) against 2*hits*16*16 flops,
// far below the card's ridge. The differences between the modes' times are
// the costs of the index loads, the feature gathers, the per-tap weight
// staging and the FMAs.
//
// empty_launch_kernel replaces the empty kernel of
// scripts/bench_wconv_ablate2.py (bench_empty): it writes zeros over a
// [rows, cols] output, `block_rows` rows per block, with 16-byte stores.
// Bound: the output's bytes over the memory rate (0.65 MB at [20224, 16]
// bf16). Its time is the fixed cost of one launch.

#include "gather_gemm.cuh"

namespace {

using sessd::from_f32;
using sessd::kMaxTaps;
using sessd::kRows;
using sessd::kThreads;
using sessd::to_f32;

enum AblateMode : int { kFull = 0, kLinear = 1, kNoGather = 2, kFmaOnly = 3 };
constexpr float kNoGatherValue = 1.0f;

template <int MODE>
__global__ void __launch_bounds__(kThreads) sparse_conv_ablate_kernel(
    const __nv_bfloat16* __restrict__ feats, const int32_t* __restrict__ rb,
    const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
    int n_in, int n_out, int taps) {
  constexpr int CIN = 16;
  constexpr int COUT = 16;
  constexpr int kCols = 4;
  constexpr int kTx = COUT / kCols;
  constexpr int kTy = kThreads / kTx;
  constexpr int kRowsPerThread = kRows / kTy;
  constexpr int kGStride = CIN + 1;
  constexpr bool kReadsRulebook = MODE == kFull || MODE == kNoGather;

  __shared__ int s_rb[kRows * kMaxTaps];
  __shared__ float s_g[kRows * kGStride];
  __shared__ __align__(16) float s_w[CIN * COUT];

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kRows;

  if (kReadsRulebook) {
    for (int i = tid; i < kRows * taps; i += kThreads) {
      const int n = row0 + i / taps;
      s_rb[i] = n < n_out ? static_cast<int>(rb[(size_t)row0 * taps + i])
                          : n_in;
    }
    __syncthreads();
  }

  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  if (MODE == kFmaOnly) {
    for (int i = tid; i < kRows * CIN; i += kThreads) {
      const int src = row0 + i / CIN;
      s_g[(i / CIN) * kGStride + i % CIN] =
          src < n_in ? to_f32(feats[(size_t)src * CIN + i % CIN]) : 0.f;
    }
    for (int i = tid; i < CIN * COUT; i += kThreads) s_w[i] = to_f32(w2[i]);
    __syncthreads();
  }

  for (int k = 0; k < taps; ++k) {
    if (MODE != kFmaOnly) {
      for (int i = tid; i < kRows * CIN; i += kThreads) {
        const int r = i / CIN;
        const int c = i % CIN;
        float v;
        if (MODE == kLinear) {
          const int src = row0 + r;
          v = src < n_in ? to_f32(feats[(size_t)src * CIN + c]) : 0.f;
        } else {
          const int src = s_rb[r * taps + k];
          const bool hit =
              static_cast<unsigned>(src) < static_cast<unsigned>(n_in);
          if (MODE == kFull)
            v = hit ? to_f32(feats[(size_t)src * CIN + c]) : 0.f;
          else
            v = hit ? kNoGatherValue : 0.f;
        }
        s_g[r * kGStride + c] = v;
      }
      const __nv_bfloat16* wk = w2 + (size_t)k * CIN * COUT;
      for (int i = tid; i < CIN * COUT; i += kThreads) s_w[i] = to_f32(wk[i]);
      __syncthreads();
    }

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
    __syncthreads();
  }

  // the store of gather_gemm_tile without epilogue or mask: acc + 0, so a
  // -0 sum is written as +0 there and here alike
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int n = row0 + ty + r * kTy;
    if (n >= n_out) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      out[(size_t)n * COUT + tx * kCols + j] =
          from_f32<__nv_bfloat16>(acc[r][j] + 0.f);
  }
}

__global__ void __launch_bounds__(256)
    empty_launch_kernel(uint4* __restrict__ out, long long n_vec,
                        int vec_per_block) {
  const long long base = (long long)blockIdx.x * vec_per_block;
  for (int i = threadIdx.x; i < vec_per_block; i += blockDim.x) {
    const long long j = base + i;
    if (j < n_vec) out[j] = make_uint4(0u, 0u, 0u, 0u);
  }
}

cudaError_t launch_empty(void* out, long long n_bytes, int block_bytes,
                         cudaStream_t stream) {
  const long long n_vec = n_bytes / 16;
  const int vec_per_block = block_bytes / 16;
  const long long blocks = (n_vec + vec_per_block - 1) / vec_per_block;
  empty_launch_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<uint4*>(out), n_vec, vec_per_block);
  return cudaGetLastError();
}

bool bad_empty_args(const void* out, long long n_bytes, int block_bytes) {
  return n_bytes <= 0 || block_bytes <= 0 || n_bytes % 16 ||
         block_bytes % 16 || reinterpret_cast<uintptr_t>(out) % 16;
}

}  // namespace

// The training forward's C entry (sparse_conv_train.cu).
extern "C" int sessd_sparse_conv_fwd(const void* feats, const void* rb,
                                     const void* w2, const uint8_t* row_mask,
                                     void* out, int n_in, int n_out, int cin,
                                     int cout, int taps, int dtype,
                                     int idx_bytes, void* stream);

// out [n_out, 16] bf16 = the ablated gather-GEMM of feats [n_in, 16] bf16
// over rb [n_out, taps] int32 with w2 [taps, 16, 16] bf16; mode: 0 full,
// 1 linear, 2 no gather, 3 FMAs only. Returns cudaGetLastError() of the
// launch; cudaErrorInvalidValue for arguments it has no instance of.
extern "C" int sessd_sparse_conv_ablate(const void* feats, const void* rb,
                                        const void* w2, void* out, int n_in,
                                        int n_out, int taps, int mode,
                                        void* stream) {
  if (n_in <= 0 || n_out <= 0 || taps <= 0 || taps > kMaxTaps)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = sessd::gather_gemm_grid(n_out);
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* r = static_cast<const int32_t*>(rb);
  const auto* w = static_cast<const __nv_bfloat16*>(w2);
  auto* o = static_cast<__nv_bfloat16*>(out);
#define SESSD_MODE(M)                                                        \
  case M:                                                                    \
    sparse_conv_ablate_kernel<M><<<grid, kThreads, 0, s>>>(f, r, w, o, n_in, \
                                                          n_out, taps);      \
    return cudaGetLastError();
  switch (mode) {
    SESSD_MODE(kFull)
    SESSD_MODE(kLinear)
    SESSD_MODE(kNoGather)
    SESSD_MODE(kFmaOnly)
  }
#undef SESSD_MODE
  return cudaErrorInvalidValue;
}

// Zeros over out (n_bytes, 16-byte aligned), block_bytes per block: one
// launch per call of sessd_empty_launch, `reps` back-to-back launches from
// one call of sessd_empty_launch_repeat (no Python between them).
extern "C" int sessd_empty_launch(void* out, long long n_bytes,
                                  int block_bytes, void* stream) {
  if (bad_empty_args(out, n_bytes, block_bytes)) return cudaErrorInvalidValue;
  return launch_empty(out, n_bytes, block_bytes,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int sessd_empty_launch_repeat(void* out, long long n_bytes,
                                         int block_bytes, int reps,
                                         void* stream) {
  if (bad_empty_args(out, n_bytes, block_bytes) || reps <= 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i < reps; ++i) {
    const cudaError_t err = launch_empty(out, n_bytes, block_bytes,
                                         static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// `reps` calls of the training forward's C entry from one C call: the bare
// launch cost of sparse_conv_fwd, without the Python wrapper.
extern "C" int sessd_sparse_conv_fwd_repeat(
    const void* feats, const void* rb, const void* w2, void* out, int n_in,
    int n_out, int cin, int cout, int taps, int dtype, int idx_bytes,
    int reps, void* stream) {
  if (reps <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < reps; ++i) {
    const int err =
        sessd_sparse_conv_fwd(feats, rb, w2, nullptr, out, n_in, n_out, cin,
                              cout, taps, dtype, idx_bytes, stream);
    if (err != 0) return err;
  }
  return 0;
}
