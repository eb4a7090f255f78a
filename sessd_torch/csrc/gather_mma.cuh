// Tensor-core gather tile over a rulebook, shared by the bf16 training
// forward (sparse_conv_train.cu: sparse_conv_fwd_kernel, masked store) and
// the bf16 streaming serving conv (sparse_conv_stream.cu:
// fused_sparse_conv_stream_kernel, bias + ReLU + any-hit store). Each keeps
// its own __global__; this is the body both call for bf16 and Cin, Cout in
// {16, 32, 64} (kMmaTile). Every other instance (f32, the Cin = 4 first
// conv) stays on gather_gemm.cuh's scalar tile.
//
// Computes, for the 64 output rows [blockIdx.x * 64, + 64):
//   acc[n, :] = sum_k feats[rb[n, k], :] @ w2[k]          (f32 accumulator)
// with rb[n, k] outside [0, n_in) a miss (a zero row), and stores
//   EPI:  out[n] = relu?(acc[n] + bias) if any rb[n, k] != n_in, else 0
//   else: out[n] = acc[n] if row_mask is null or row_mask[n], else 0.
// The sum runs over taps in order and, inside a tap, in the tensor cores'
// order, so it does not equal the scalar tile bit for bit.
//
// What bounds it on Hopper: the gather. Each output row reads K rows of Cin
// bf16 values for 2*K*Cin*Cout flops, at most 2*Cout flops per loaded byte
// pair, far below the card's ridge of ~295 flops per byte. The scalar tile
// never got near that: it converts every value to f32 in shared memory and
// runs a scalar FMA loop over all K taps of every tile (64% of the conv at
// 16 -> 16 channels, PERF.md S1), and multiplies the zero rows of taps that
// no row of the tile hits.
//
// What this design does about it:
// - Tensor cores: one warpgroup (128 threads) owns the 64 rows and issues
//   wgmma.mma_async m64n{Cout}k16 (bf16 in, f32 accumulators in registers),
//   Cin/16 instructions per tap, A (gathered rows) and B (the tap's
//   weights) both read from shared memory. Nothing is converted on the way.
// - Tap skipping: the tile's rulebook is read once; one warp ballots, per
//   tap, whether any row of the tile hits it and compacts the hit taps into
//   a list. Only those taps are gathered and multiplied (a miss adds zero).
// - A ring of kStages stages in dynamic shared memory, each one tap's
//   gathered rows [64, Cin] and weights [Cin, Cout]. Every thread issues its
//   16-byte cp.async chunks for the tap kStages - 1 ahead, then the tensor
//   cores run the current one; a miss is a zero-fill (src-size 0). The
//   copies land directly in wgmma's no-swizzle canonical layout: a 16-byte
//   chunk is one row of an 8 x 16-byte core matrix.
//     A (K-major): chunk (row r, channels 8c..8c+7) at
//       (r / 8) * (Cin / 8) * 128 + c * 128 + (r % 8) * 16;
//       LBO (next 8 channels) 128 B, SBO (next 8 rows) Cin / 8 * 128 B.
//     B (MN-major, the [Cin, Cout] weights as they lie, transposed operand):
//       chunk (channel i, outputs 8c..8c+7) at
//       (i / 8) * (Cout / 8) * 128 + c * 128 + (i % 8) * 16;
//       LBO (next 8 input channels) Cout / 8 * 128 B, SBO (next 8 outputs)
//       128 B.
//   So the kernel stages the [K, Cin, Cout] weights itself and the wrapper
//   needs no packing launch.
// - Order of a tap: cp.async.wait_group (this thread's chunks of the tap
//   have landed), fence.proxy.async (make them visible to the tensor cores'
//   async proxy), barrier (every thread's chunks, and every thread done
//   with the previous tap's wgmma), issue the refill of the slot the
//   previous tap used, then wgmma.fence / mma / commit_group / wait_group 0.
// Why one warpgroup of 64 rows with every thread copying, not a producer
// warp: a tile's tap is 128-512 gathered chunks plus 32-512 weight chunks,
// one to eight per thread; one warp alone would issue them four times
// slower and need mbarriers for completion, and 3-13 blocks per SM (17-72
// KB of shared memory each) already overlap one block's waits with
// another's tensor-core work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gather_gemm.cuh"

namespace sessd {

constexpr int kMmaThreads = 128;  // one warpgroup per 64-row tile
constexpr int kStages = 4;        // taps in the ring

// the instances that take this tile (the C entries' dispatch; mirrored by
// ops/cuda/sparse_conv.py:conv_instance)
template <typename T, int CIN, int COUT>
constexpr bool kMmaTile = std::is_same<T, __nv_bfloat16>::value &&
                          (CIN == 16 || CIN == 32 || CIN == 64) &&
                          (COUT == 16 || COUT == 32 || COUT == 64);

template <int CIN, int COUT>
struct MmaLayout {
  static constexpr int kKc = CIN / 8;   // 16-byte chunks of a gathered row
  static constexpr int kNc = COUT / 8;  // 16-byte chunks of a weight row
  static constexpr int kABytes = kRows * CIN * 2;
  static constexpr int kBBytes = CIN * COUT * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;  // multiple of 128
  static constexpr int kRingBytes = kStages * kStageBytes;
  // ring, then the rulebook tile, the row keep flags, the hit-tap list and
  // its length
  static constexpr int kSmemBytes =
      kRingBytes + (kRows * kMaxTaps + kRows + kMaxTaps + 1) * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one 16-byte global -> shared copy (L2 only); src_bytes 0 reads nothing and
// fills the chunk with zeros (a miss)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
}

// D[64, N] += A[64, 16] (K-major) @ B[16, N] (MN-major), bf16 in, f32 out
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <int N>
__device__ __forceinline__ void fence_accumulators(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The body of one block of kMmaThreads threads over output rows
// [blockIdx.x * kRows, + kRows), with MmaLayout<CIN, COUT>::kSmemBytes of
// dynamic shared memory. feats and w2 must be 16-byte aligned.
template <typename IdxT, int CIN, int COUT, bool EPI>
__device__ __forceinline__ void gather_mma_tile(
    const __nv_bfloat16* __restrict__ feats, const IdxT* __restrict__ rb,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ bias,
    const uint8_t* __restrict__ row_mask, __nv_bfloat16* __restrict__ out,
    int n_in, int n_out, int taps, int relu) {
  using L = MmaLayout<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char sessd_mma_smem[];
  unsigned char* ring = sessd_mma_smem;
  int* s_rb = reinterpret_cast<int*>(ring + L::kRingBytes);
  int* s_keep = s_rb + kRows * kMaxTaps;
  int* s_taps = s_keep + kRows;  // the taps some row hits, in order
  int* s_n_taps = s_taps + kMaxTaps;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;

  // the tile's rulebook, read once; rows past n_out read as all-miss
  for (int i = tid; i < kRows * taps; i += kMmaThreads) {
    const int n = row0 + i / taps;
    s_rb[i] = n < n_out ? static_cast<int>(rb[(size_t)row0 * taps + i]) : n_in;
  }
  __syncthreads();
  if (tid < kRows) {  // warps 0-1: the store's keep flag of each row
    int keep = 1;
    if (EPI) {
      keep = 0;
      for (int k = 0; k < taps; ++k) keep |= s_rb[tid * taps + k] != n_in;
    } else if (row_mask != nullptr) {
      keep = row0 + tid < n_out ? row_mask[row0 + tid] != 0 : 0;
    }
    s_keep[tid] = keep;
  } else if (tid < kRows + 32) {  // warp 2: lane k asks whether tap k hits
    const int k = tid - kRows;
    bool hit = false;
    if (k < taps)
      for (int r = 0; r < kRows && !hit; ++r)
        hit = static_cast<unsigned>(s_rb[r * taps + k]) <
              static_cast<unsigned>(n_in);
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (hit) s_taps[__popc(hits & ((1u << k) - 1u))] = k;
    if (k == 0) *s_n_taps = __popc(hits);
  }
  __syncthreads();
  const int n_taps = *s_n_taps;

  // tap k's gathered rows and weights into ring stage `stage`
  auto issue = [&](int k, int stage) {
    const uint32_t a_s = smem_u32(ring + stage * L::kStageBytes);
    const uint32_t b_s = a_s + L::kABytes;
    for (int j = tid; j < kRows * L::kKc; j += kMmaThreads) {
      const int r = (j / (8 * L::kKc)) * 8 + j % 8;
      const int c = (j / 8) % L::kKc;
      const int src = s_rb[r * taps + k];
      const bool hit = static_cast<unsigned>(src) < static_cast<unsigned>(n_in);
      cp_async16(a_s + j * 16, feats + (size_t)(hit ? src : 0) * CIN + c * 8,
                     hit ? 16 : 0);
    }
    const __nv_bfloat16* wk = w2 + (size_t)k * CIN * COUT;
    for (int j = tid; j < CIN * L::kNc; j += kMmaThreads) {
      const int i = (j / (8 * L::kNc)) * 8 + j % 8;
      const int c = (j / 8) % L::kNc;
      cp_async16(b_s + j * 16, wk + i * COUT + c * 8, 16);
    }
  };

  float acc[COUT / 2];
#pragma unroll
  for (int i = 0; i < COUT / 2; ++i) acc[i] = 0.f;

  // one cp.async group per slot, empty ones too, so that wait_group counts
  // taps
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_taps) issue(s_taps[s], s);
    cp_async_commit();
  }
  for (int t = 0; t < n_taps; ++t) {
    cp_async_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the slot of tap t - 1, whose wgmma every thread has waited for
    const int ahead = t + kStages - 1;
    if (ahead < n_taps) issue(s_taps[ahead], ahead % kStages);
    cp_async_commit();

    const uint32_t a_s = smem_u32(ring + (t % kStages) * L::kStageBytes);
    const uint32_t b_s = a_s + L::kABytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < CIN / 16; ++s)
      Wgmma<COUT>::mma(acc, wgmma_desc(a_s + s * 256, 128, L::kKc * 128),
                       wgmma_desc(b_s + s * 2 * L::kNc * 128, L::kNc * 128,
                                  128));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_accumulators(acc);
  }

  // accumulator fragment: register 4j + 2h + e of lane l in warp w holds
  // row 16w + l/4 + 8h, column 8j + 2(l%4) + e
  const int warp = tid / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int j = 0; j < COUT / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    const float b0 = EPI ? bias[col] : 0.f;
    const float b1 = EPI ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = warp * 16 + lane / 4 + 8 * h;
      const int n = row0 + lr;
      if (n >= n_out) continue;
      float v0 = acc[j * 4 + h * 2];
      float v1 = acc[j * 4 + h * 2 + 1];
      if (EPI) {
        v0 += b0;
        v1 += b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
      }
      const bool keep = s_keep[lr] != 0;
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)n * COUT + col) =
          __floats2bfloat162_rn(keep ? v0 : 0.f, keep ? v1 : 0.f);
    }
  }
}

}  // namespace sessd
