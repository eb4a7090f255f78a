// The direct gather body of the first sparse conv's 4-channel side, on the
// CUDA cores: the serving conv (sparse_conv.cu: fused_sparse_conv_kernel,
// with its fused epilogue) and the training forward (sparse_conv_train.cu:
// sparse_conv_fwd_kernel, with its row mask) at Cin = 4 -> Cout = 16, and
// the input gradient's gather at 16 -> 4 (sparse_conv_dfeat_kernel, the
// voxel features' gradient, with the conv's weights read transposed), in
// f32 and bf16 with int16 or int32 rulebooks. For those instances it
// replaces the Pallas kernels the JAX package sends every conv through
// (sessd_tpu/ops/pallas/wconv.py: _fused_kernel, _fwd_kernel, _bwd_kernel).
//
// Computes, for every output row n:
//   acc[n, :] = sum_k feats[rb[n, k], :] @ w2[k]          (f32 accumulator)
// rb[n, k] outside [0, n_in) reads a zero row. With EPI
//   out[n] = relu?(acc[n] + bias) if some rb[n, k] != n_in, else 0;
// without it out[n] = acc[n] where row_mask is null or row_mask[n], else 0.
//
// What bounds it on Hopper: the bytes. A 4 -> 16 row reads 27 rulebook
// entries (54 or 108 bytes) and at most 27 gathered rows of 8 or 16 bytes
// for 16 outputs; even with every tap hit its 2*27*4*16 flops on the CUDA
// cores take about as long as those bytes over the memory. K = 4 is below
// the k of any mma (8 in TF32, 16 in bf16), so tensor cores would multiply
// padding. A 64-row tile that staged 64 rows x 4 channels and a 4 x 16
// weight slab per tap behind two barriers would pass 54 barriers per 64
// rows, with 16 FMAs per thread between them.
//
// The design:
// - Every tap's weights in f32 shared memory once per block (27 x 4 x 16:
//   6.9 KB) and the block's rulebook rows (one contiguous run of rb) once,
//   coalesced; one barrier, none in the tap loop.
// - One thread per row with all its output channels (16 at 4 -> 16; at
//   16 -> 4 two rows a thread, each with its 4), 128 threads a block: 128
//   rows at 4 -> 16 (157 blocks at a batch-1 request's 20,000 rows, 625 at
//   a training batch's 80,000), 256 at 16 -> 4. All lanes of a warp then
//   read the same weights of a tap at once (shared-memory broadcasts), and
//   a warp's gathers of one tap cover 32 neighbouring rows. On the card it
//   beat both 4 threads a row (4 channels each) and 4 rows a thread (4
//   channels of each), though the one-thread-a-row grid at batch 1 is
//   fewer blocks than SMs (PERF.md, the direct body's layouts).
// - A thread walks the taps in index order, kGroup taps' loads issued
//   before their FMAs: a hit is one 16-byte (f32) or 8-byte (bf16) load per
//   4 channels, a miss loads nothing and reads as a zero row.
// - f32 accumulators in registers; the epilogue (bias, ReLU, the any-hit
//   mask) or the row mask fused into one 16-byte (f32) or 8-byte (bf16)
//   store per row and 4 channels.
// - The summation order: taps in index order, within a tap channels
//   0..Cin-1 by fmaf into one f32 accumulator, a miss adding fmaf(0, w,
//   acc) (a zero row), the store acc + bias (0 without EPI). A row's bits
//   depend on its own taps alone, not on the rows launched with it.
#pragma once

#include <type_traits>

#include "gather_common.cuh"

namespace sessd {

// the instances that take the direct body in every kernel that calls it
// (conv_instance names them "direct"): the first conv's 4 -> 16 and its
// input gradient's 16 -> 4, in f32 and bf16
template <typename T, int CIN, int COUT>
constexpr bool kDirect =
    (std::is_same<T, float>::value ||
     std::is_same<T, __nv_bfloat16>::value) &&
    ((CIN == 4 && COUT == 16) || (CIN == 16 && COUT == 4));

constexpr int kDirectThreads = 128;  // threads per block

// rows per thread of the shipped instances, each with all its COUT
// channels: 1 at 4 -> 16, 2 at 16 -> 4
template <int CIN>
constexpr int kDirectRows = CIN == 4 ? 1 : 2;

template <int CIN, int COUT>
struct DirectTile {
  static constexpr int kRowsPer = kDirectRows<CIN>;         // per thread
  static constexpr int kRows = kDirectThreads * kRowsPer;  // per block
  // taps whose gathers are in flight at once: about 32 registers
  static constexpr int kGroup = 32 / (CIN * kRowsPer);
  static_assert(COUT % 4 == 0 && CIN % 4 == 0 && kGroup > 0, "direct tile");
};

// the CIN values of row src of feats as f32, or zeros where `hit` is false
// (nothing is read); rows are 16-byte aligned in f32, 8-byte in bf16
template <typename T, int CIN>
__device__ __forceinline__ void gather_row(const T* __restrict__ feats,
                                           int src, bool hit,
                                           float (&a)[CIN]) {
  constexpr int kWords = CIN * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
  const T* row = feats + (size_t)(hit ? src : 0) * CIN;
  if constexpr (kWords % 4 == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int q = 0; q < kWords / 4; ++q) {
      const uint4 v = hit ? p[q] : make_uint4(0u, 0u, 0u, 0u);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
    static_assert(kWords == 2, "a bf16 row of 4 channels");
    const uint2 v = hit ? *reinterpret_cast<const uint2*>(row)
                        : make_uint2(0u, 0u);
    w[0] = v.x;
    w[1] = v.y;
  }
#pragma unroll
  for (int c = 0; c < CIN; ++c) {
    if constexpr (std::is_same<T, float>::value)
      a[c] = __uint_as_float(w[c]);
    else  // bf16 c is the low half of word c / 2 for even c: exact in f32
      a[c] = __uint_as_float(c % 2 ? w[c / 2] & 0xffff0000u : w[c / 2] << 16);
  }
}

// four values of one row into out (16 bytes in f32, 8 in bf16)
template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ out, const float (&v)[4]) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out) = u;
  }
}

// The body of one block of kDirectThreads threads over output rows
// [blockIdx.x * kRows, + kRows): thread t owns every output channel of
// rows t + kDirectThreads q, q < kRowsPer. w2 is [K, CIN,
// COUT], or with W_T [K, COUT, CIN] (the input gradient's: the conv's
// weights as it holds them), staged transposed. feats and out 16-byte
// aligned.
template <typename T, typename IdxT, int CIN, int COUT, bool EPI,
          bool W_T = false>
__device__ __forceinline__ void gather_direct(
    const T* __restrict__ feats, const IdxT* __restrict__ rb,
    const T* __restrict__ w2, const float* __restrict__ bias,
    const uint8_t* __restrict__ row_mask, T* __restrict__ out, int n_in,
    int n_out, int taps, int relu) {
  using D = DirectTile<CIN, COUT>;
  constexpr int ROWS = D::kRowsPer;
  __shared__ __align__(16) float s_w[kMaxTaps * CIN * COUT];
  __shared__ IdxT s_rb[D::kRows * kMaxTaps];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * D::kRows;
  const int rows = min(D::kRows, n_out - row0);
  for (int i = tid; i < rows * taps; i += kDirectThreads)
    s_rb[i] = rb[(size_t)row0 * taps + i];
  for (int i = tid; i < taps * CIN * COUT; i += kDirectThreads) {
    if constexpr (W_T) {
      const int k = i / (CIN * COUT);
      const int c = i / COUT % CIN;
      const int j = i % COUT;
      s_w[i] = to_f32(w2[((size_t)k * COUT + j) * CIN + c]);
    } else {
      s_w[i] = to_f32(w2[i]);
    }
  }
  __syncthreads();

  if (tid >= rows) return;
  float acc[ROWS][COUT];
#pragma unroll
  for (int q = 0; q < ROWS; ++q)
#pragma unroll
    for (int j = 0; j < COUT; ++j) acc[q][j] = 0.f;
  bool any[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) any[q] = false;
  for (int k0 = 0; k0 < taps; k0 += D::kGroup) {
    float a[D::kGroup][ROWS][CIN];
#pragma unroll
    for (int g = 0; g < D::kGroup; ++g)
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int lr = tid + kDirectThreads * q;
        const int src = k0 + g < taps && lr < rows
                            ? static_cast<int>(s_rb[lr * taps + k0 + g])
                            : n_in;
        if (EPI) any[q] |= src != n_in;
        gather_row<T, CIN>(
            feats, src,
            static_cast<unsigned>(src) < static_cast<unsigned>(n_in),
            a[g][q]);
      }
#pragma unroll
    for (int g = 0; g < D::kGroup; ++g) {
      if (k0 + g >= taps) break;
      const float* wk = s_w + (k0 + g) * CIN * COUT;
#pragma unroll
      for (int c = 0; c < CIN; ++c)
#pragma unroll
        for (int j = 0; j < COUT; j += 4) {
          const float4 b =
              *reinterpret_cast<const float4*>(wk + c * COUT + j);
#pragma unroll
          for (int q = 0; q < ROWS; ++q) {
            acc[q][j] = fmaf(a[g][q][c], b.x, acc[q][j]);
            acc[q][j + 1] = fmaf(a[g][q][c], b.y, acc[q][j + 1]);
            acc[q][j + 2] = fmaf(a[g][q][c], b.z, acc[q][j + 2]);
            acc[q][j + 3] = fmaf(a[g][q][c], b.w, acc[q][j + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int lr = tid + kDirectThreads * q;
    if (lr >= rows) break;
    const int n = row0 + lr;
    const bool keep =
        EPI ? any[q] : (row_mask == nullptr || row_mask[n] != 0);
#pragma unroll
    for (int j = 0; j < COUT; j += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc[q][j + e] + (EPI ? bias[j + e] : 0.f);
        if (EPI && relu) x = fmaxf(x, 0.f);
        v[e] = keep ? x : 0.f;
      }
      store4<T>(out + (size_t)n * COUT + j, v);
    }
  }
}

// blocks of kDirectThreads threads covering n_out rows
template <int CIN, int COUT>
inline dim3 direct_grid(int n_out) {
  constexpr int rows = DirectTile<CIN, COUT>::kRows;
  return dim3((n_out + rows - 1) / rows);
}

}  // namespace sessd
