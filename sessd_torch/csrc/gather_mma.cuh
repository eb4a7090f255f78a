// Tensor-core gather tile over a rulebook, shared by the training forward
// (sparse_conv_train.cu: sparse_conv_fwd_kernel, masked store), the input
// gradient (sparse_conv_train.cu: sparse_conv_dfeat_kernel, over the
// inverse rulebook with a K-major B), the streaming serving conv
// (sparse_conv_stream.cu: fused_sparse_conv_stream_kernel) and the
// resident serving conv (sparse_conv.cu: fused_sparse_conv_kernel), the
// serving convs with the bias + ReLU + any-hit store. Each keeps its own
// __global__; this is the body all four call for bf16 and Cin, Cout in
// {16, 32, 64} (kMmaTile), and for f32 at the same channels through 3xTF32
// (kTf32Tile, below). The Cin = 4 first conv runs gather_direct.cuh's
// direct body; f32 dW has a 3xTF32 body of its own (sparse_conv_train.cu:
// dw_mma_partial). The micro-benchmark sparse_conv_ablate_mma_kernel
// (sparse_conv_ablate.cu) runs the bf16 tile with one cost removed at a
// time (TileMode).
//
// Computes, for the 64 output rows of one tile:
//   acc[n, :] = sum_k feats[rb[n, k], :] @ w2[k]          (f32 accumulator)
// with rb[n, k] outside [0, n_in) a miss (a zero row), and stores
//   EPI:  out[n] = relu?(acc[n] + bias) if any rb[n, k] != n_in, else 0
//         (RES: relu?(acc[n] + bias + residual[n]), the residual block's
//         identity added in f32 before the ReLU, bf16 with CIN == COUT)
//   else: out[n] = acc[n] if row_mask is null or row_mask[n], else 0.
// The sum runs over taps in order and, inside a tap, in the tensor cores'
// order.
//
// What bounds it on Hopper: the gather. Each output row reads K rows of Cin
// bf16 values for 2*K*Cin*Cout flops, at most 2*Cout flops per loaded byte
// pair, far below the card's ridge of ~295 flops per byte. A scalar FMA
// tile does not get near that: converting every value to f32 in shared
// memory and a scalar FMA loop over all K taps of every tile take 64% of
// its conv at 16 -> 16 channels (sparse_conv_ablate.cu, PERF.md S1), and
// it multiplies the zero rows of taps that no row of the tile hits.
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
//     B (K-major, KMAJOR_B: the input gradient's weights, [Cout, Cin] per
//       tap with the reduction dimension Cin contiguous, i.e. the conv's
//       [Cin, Cout] as it lies with the roles swapped): laid out as A with
//       the Cout outputs in place of the 64 rows, chunk (output n, channels
//       8c..8c+7) at (n / 8) * (Cin / 8) * 128 + c * 128 + (n % 8) * 16;
//       LBO 128 B, SBO Cin / 8 * 128 B, and the instruction's tnsp-b 0.
//   So the kernel stages the weights itself in either layout and the
//   wrapper needs no packing or transposing launch.
// - Order of a tap: cp.async.wait_group (this thread's chunks of the tap
//   have landed), fence.proxy.async (make them visible to the tensor cores'
//   async proxy), barrier (every thread's chunks, and every thread done
//   with the previous tap's wgmma), issue the refill of the slot the
//   previous tap used, then wgmma.fence / mma / commit_group / wait_group 0.
// - f32 through 3xTF32 (kTf32Tile: the forward, the input gradient, and
//   both serving convs with the EPI store; f32 kernels are held to 1e-4 of
//   their twins). One
//   TF32 pass keeps 10 mantissa bits and misses that bound, so
//   each operand is split x = hi + lo with hi = tf32(x) and lo = tf32(x -
//   hi), both rounded by cvt.rna.tf32.f32 (to nearest, ties away; not the
//   tensor cores' truncation of the low 13 bits), and every k8 step adds
//   lo_a hi_b, then hi_a lo_b, then hi_a hi_b into the tap's accumulator
//   (the small products first; lo_a lo_b, ~2^-22 of the product, is
//   dropped). Each tap's sum starts from zero in registers of its own and
//   is added into the running sum by the CUDA cores: the tensor cores'
//   own additions do not round to nearest, and over all taps in one chain
//   (up to 3 * 8 * 27 instructions) they left the 64 -> 64 forward 1.5e-5
//   of its max off the plain model of this arithmetic on an H100, ten
//   times the error of per-tap sums (PERF.md, Findings). TF32 wgmma
//   (m64n{Cout}k8, Cin/8 instructions per tap and part) reads A and B
//   K-major only, and a 16-byte chunk holds 4 values:
//   the layouts above with chunks of 4 channels (Cin / 4 of them per row),
//   LBO 128 B, SBO Cin / 4 * 128 B, 256 B per k8 step. What changes:
//     * the ring holds only the gathered rows, as f32, by cp.async as in
//       bf16; after the tap's barrier every thread splits its share of
//       them, writing hi in place and lo to a second buffer. A is split in
//       shared memory and read by descriptor, not loaded into registers
//       and fed from there: the three products then share one verified
//       layout and the descriptors of the bf16 body, at 16-64 KB of shared
//       memory per tap that the gather does not use;
//     * the tap's weights are read from global memory (a few KB, L2
//       resident across the launch's blocks) into registers before A's
//       split, so their latency overlaps it, then split and written K-major
//       into B_hi and B_lo: the input gradient's [Cout, Cin] as it lies
//       (16-byte chunks), the forward's [Cin, Cout] transposed on the way
//       (4 x 4 blocks per thread), so no launch transposes or packs them;
//     * a second barrier (after fence.proxy.async) before the wgmma, since
//       the split is written by the generic proxy;
//     * 3 stages instead of 4 for 64 -> 64, so that two blocks fit an SM.
//   Tap skipping, zero-filled misses and the masked store are the bf16
//   tile's.
// - Tap split across a cluster (SPLIT, the resident serving conv only):
//   where a launch's tiles fill less than one wave of the card (batch-1
//   serving: 63-344 tiles against ~400-1700 resident blocks), each tile
//   runs as a cluster of S CTAs (cluster_split). Every CTA reads the tile's
//   rulebook and lists the hit taps k with k mod S equal to its rank, in
//   order, as above, and runs them through its own ring. Dealing by the
//   tap's index, not by its position in the tile's hit list, makes a row's
//   partial sums a function of its own taps and S alone: the rows a tile
//   shares with its neighbours (other scans of a batch, another alignment)
//   do not regroup them. So at equal S a scan's rows get the same bits
//   whatever scans share its batch; S itself follows the launch's tile
//   count, so a batch of another size (other stage capacities) may group
//   them otherwise. Full tiles get the hit list's round-robin deal all the
//   same (13-14 taps each at S = 2); a partly hit tile may load its ranks
//   unevenly. The S ranks gather neighbouring taps
//   (neighbouring voxel rows) at the same time, so they share L2 lines.
//   Ranks 1..S-1 then write their f32 accumulators into
//   their own (now idle) ring; after a cluster barrier rank 0 reads them
//   through distributed shared memory and adds them in rank order, so a
//   run gives the same bits every time, then stores as above. A second
//   cluster barrier keeps each rank's shared memory alive until it is read.
//   One tile's time was its hit taps' serial chain of round trips; the
//   split cuts that chain S-fold on the SMs that were idle. S = 1 is the
//   plain tile: bit-equal to the stream kernel's.
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

#include "gather_common.cuh"

namespace sessd {

constexpr int kMmaThreads = 128;  // one warpgroup per 64-row tile
constexpr int kStages = 4;        // taps in the ring
constexpr int kMaxSplit = 4;      // CTAs of a cluster that share one tile

// What a tile runs. Every conv runs kTileFull; the others exist for the
// ablation (sparse_conv_ablate.cu), each removing one cost:
//   kTileLinear    row n of every tap reads feature row n: no rulebook
//                  loads, no indirection, no tap skipped;
//   kTileNoGather  the rulebook is read and balloted, but every hit row
//                  is copied from feature row 0: no scattered rows, but
//                  every block reads one line (measured slower than
//                  kTileFull on the H100: the reads meet in one L2 slice);
//   kTileMmaOnly   tap 0's rows and weights are staged once; the loop over
//                  the hit taps runs only the wgmma chain, its fences and
//                  waits;
//   kTileCopyOnly  the ring's gathers and weight copies over the hit taps,
//                  with no wgmma (stores zeros);
//   kTileFixed     the rulebook read, keep flags, ballot and a store of
//                  zeros, with no taps: the tile's fixed cost.
enum TileMode : int {
  kTileFull = 0,
  kTileLinear = 1,
  kTileNoGather = 2,
  kTileMmaOnly = 3,
  kTileCopyOnly = 4,
  kTileFixed = 5
};

// The cluster size S of a resident serving conv's launch of `tiles` 64-row
// tiles, where `wave` blocks of the instance fit on the card at once (blocks
// per SM at its shared memory and registers x SMs): a launch that fills a
// wave runs one CTA per tile; one that fills less splits each tile's taps
// over 4 CTAs where 4 x tiles still fit one wave, else over 2. Mirrored by
// ops/cuda/sparse_conv.py:cluster_split.
inline int cluster_split(int tiles, int wave) {
  if (tiles >= wave) return 1;
  return tiles * 4 <= wave ? 4 : 2;
}

// the instances that take this tile (the C entries' dispatch; mirrored by
// ops/cuda/sparse_conv.py:conv_instance)
template <typename T, int CIN, int COUT>
constexpr bool kMmaTile = std::is_same<T, __nv_bfloat16>::value &&
                          (CIN == 16 || CIN == 32 || CIN == 64) &&
                          (COUT == 16 || COUT == 32 || COUT == 64);

// the bf16 instances at 128 output channels, (64, 128) and (128, 128), of
// the serving convs alone (K1 and K3): the last stages of CenterPoint's
// residual backbone (SpMiddleResNetFHD). The same tile with 64 accumulators
// a thread; mirrored by ops/cuda/sparse_conv.py:WIDE_PAIRS
template <typename T, int CIN, int COUT>
constexpr bool kWideTile = std::is_same<T, __nv_bfloat16>::value &&
                           (CIN == 64 || CIN == 128) && COUT == 128;

// the f32 instances that take it through 3xTF32 in every kernel that calls
// it (conv_instance names them "tf32")
template <typename T, int CIN, int COUT>
constexpr bool kTf32Tile = std::is_same<T, float>::value &&
                           (CIN == 16 || CIN == 32 || CIN == 64) &&
                           (COUT == 16 || COUT == 32 || COUT == 64);

// shared-memory layout of the tile for element type T (bf16, or f32 through
// 3xTF32)
template <int CIN, int COUT, bool KMAJOR_B = false,
          typename T = __nv_bfloat16>
struct MmaLayout {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int kKc = CIN / kVec;   // 16-byte chunks of a gathered row
  static constexpr int kNc = COUT / kVec;  // 16-byte chunks of an MN-major B row
  static constexpr int kABytes = kRows * CIN * static_cast<int>(sizeof(T));
  static constexpr int kBBytes = CIN * COUT * static_cast<int>(sizeof(T));
  // B's descriptor (leading and stride byte offsets) and the bytes between
  // the B operands of consecutive wgmma steps; TF32 reads B K-major only
  static constexpr bool kBKMajor = KMAJOR_B || kTf32;
  static constexpr int kBLbo = kBKMajor ? 128 : kNc * 128;
  static constexpr int kBSbo = kBKMajor ? kKc * 128 : 128;
  static constexpr int kBStep = kBKMajor ? 256 : 2 * kNc * 128;
  // taps in the ring: 3 for f32 64 -> 64, where 4 would leave one block
  // per SM; 2 for bf16 128 -> 128 (48 KB a tap), where 3 or 4 would
  static constexpr int kRingStages =
      kTf32 && CIN == 64 && COUT == 64 ? kStages - 1
      : !kTf32 && CIN == 128 && COUT == 128 ? 2
                                            : kStages;
  // a stage: bf16 the tap's gathered rows and weights; f32 the gathered rows
  // alone (their hi part in place once split)
  static constexpr int kStageBytes = kTf32 ? kABytes : kABytes + kBBytes;
  static constexpr int kRingBytes = kRingStages * kStageBytes;
  // f32: the current tap's A_lo, B_hi and B_lo after the ring
  static constexpr int kSplitBytes = kTf32 ? kABytes + 2 * kBBytes : 0;
  // ring, split buffers, then the rulebook tile, the row keep flags, the
  // hit-tap list and its length
  static constexpr int kSmemBytes = kRingBytes + kSplitBytes +
                                    (kRows * kMaxTaps + kRows + kMaxTaps + 1) *
                                        4;
  // a split rank's f32 accumulators, [COUT / 2][kMmaThreads], in its ring
  static_assert(kRows * COUT * 4 <= kRingBytes, "split partials fit");
};

// the dynamic shared memory a block of the tile takes for (T, CIN, COUT)
template <typename T, int CIN, int COUT>
constexpr int kTileSmemBytes = MmaLayout<CIN, COUT, false, T>::kSmemBytes;

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

// D[64, N] += A[64, 16] (K-major) @ B[16, N] (MN-major, or K-major with
// KMAJOR_B: the instruction's tnsp-b), bf16 in, f32 out
template <int N, bool KMAJOR_B = false>
struct Wgmma;

template <bool KMAJOR_B>
struct Wgmma<16, KMAJOR_B> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(KMAJOR_B ? 0 : 1));
  }
};

template <bool KMAJOR_B>
struct Wgmma<32, KMAJOR_B> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(KMAJOR_B ? 0 : 1));
  }
};

template <bool KMAJOR_B>
struct Wgmma<64, KMAJOR_B> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(KMAJOR_B ? 0 : 1));
  }
};

// the 128-column instances (kWideTile): 64 f32 accumulators a thread
template <bool KMAJOR_B>
struct Wgmma<128, KMAJOR_B> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(KMAJOR_B ? 0 : 1));
  }
};

// D[64, N] += A[64, 8] @ B[8, N], both K-major, tf32 in (f32 registers whose
// low 13 bits are zero), f32 out
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf32<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf32<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
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

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi), each rounded to nearest
// (ties away from zero) by cvt.rna; x - hi is exact in f32
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split_tf32(const float4& x, float4& hi,
                                           float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                   tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
}

// component i (a constant once unrolled) of v
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// How a 3xTF32 tile stages one tap's weights w [CIN, COUT] (or, K-major,
// [COUT, CIN]) into B_hi / B_lo: a thread's unit is one 16-byte chunk of a
// K-major row, or a 4 x 4 block of the MN-major array (four input channels
// of four outputs), transposed in registers.
template <int CIN, int COUT, bool KMAJOR_B>
struct Tf32Weights {
  static constexpr int kVecs = KMAJOR_B ? 1 : 4;  // float4 loads per unit
  static constexpr int kUnits = CIN * COUT / (4 * kVecs);
  static constexpr int kPer = (kUnits + kMmaThreads - 1) / kMmaThreads;
};

// the cluster of this CTA: its size and this CTA's rank in it (1 and 0 for a
// launch without clusters), a barrier over all its threads (release /
// acquire: shared-memory writes before it are visible to every CTA of the
// cluster after it), and a 4-byte load from rank `rank`'s shared memory at
// the offset of `local` in this CTA's
__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float ld_cluster_f32(const float* local,
                                                int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

template <int N>
__device__ __forceinline__ void fence_accumulators(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The body of one block of kMmaThreads threads over output rows
// [tile * kRows, + kRows), with kTileSmemBytes<T, CIN, COUT> of dynamic
// shared memory; tile is blockIdx.x, or with SPLIT blockIdx.x / S for a
// launch in clusters of S blocks along x. w2 is [taps, CIN, COUT], or with
// KMAJOR_B [taps, COUT, CIN]. feats and w2 must be 16-byte aligned. T (bf16,
// or f32 through 3xTF32) is deduced from feats. Every conv runs MODE
// kTileFull; the other modes are the bf16 ablation's (TileMode). RES (with
// EPI) adds residual [n_out, COUT] in the store.
template <typename IdxT, int CIN, int COUT, bool EPI, bool SPLIT = false,
          bool KMAJOR_B = false, int MODE = kTileFull, bool RES = false,
          typename T>
__device__ __forceinline__ void gather_mma_tile(
    const T* __restrict__ feats, const IdxT* __restrict__ rb,
    const T* __restrict__ w2, const float* __restrict__ bias,
    const uint8_t* __restrict__ row_mask, T* __restrict__ out, int n_in,
    int n_out, int taps, int relu, const T* __restrict__ residual = nullptr) {
  using L = MmaLayout<CIN, COUT, KMAJOR_B, T>;
  constexpr bool kTf32 = L::kTf32;
  static_assert(kTf32 || std::is_same<T, __nv_bfloat16>::value,
                "bf16, or f32 through 3xTF32");
  static_assert(!kTf32 || (!SPLIT && MODE == kTileFull),
                "the 3xTF32 tile runs whole tiles, unablated");
  static_assert(!RES || (EPI && CIN == COUT && !kTf32),
                "a residual joins a bf16 serving conv of equal widths");
  constexpr bool kLinear = MODE == kTileLinear;
  constexpr int kStages = L::kRingStages;  // this instance's ring
  extern __shared__ __align__(128) unsigned char sessd_mma_smem[];
  unsigned char* ring = sessd_mma_smem;
  unsigned char* a_lo = ring + L::kRingBytes;  // f32: the tap's split parts
  unsigned char* b_hi = a_lo + L::kABytes;
  unsigned char* b_lo = b_hi + L::kBBytes;
  int* s_rb = reinterpret_cast<int*>(ring + L::kRingBytes + L::kSplitBytes);
  int* s_keep = s_rb + kRows * kMaxTaps;
  int* s_taps = s_keep + kRows;  // this rank's taps some row hits, in order
  int* s_n_taps = s_taps + kMaxTaps;

  const int tid = threadIdx.x;
  int tile = blockIdx.x, rank = 0, split = 1;
  if constexpr (SPLIT) {
    split = cluster_size();
    rank = cluster_rank();
    tile = blockIdx.x / split;
  }
  const int row0 = tile * kRows;

  // the tile's rulebook, read once; rows past n_out read as all-miss
  if constexpr (!kLinear) {
    for (int i = tid; i < kRows * taps; i += kMmaThreads) {
      const int n = row0 + i / taps;
      s_rb[i] =
          n < n_out ? static_cast<int>(rb[(size_t)row0 * taps + i]) : n_in;
    }
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
    bool hit = kLinear && k < taps;
    if (!kLinear && k < taps)
      for (int r = 0; r < kRows && !hit; ++r)
        hit = static_cast<unsigned>(s_rb[r * taps + k]) <
              static_cast<unsigned>(n_in);
    // this rank's taps: the hit taps k with k % split == rank
    hit = hit && k % split == rank;
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (hit) s_taps[__popc(hits & ((1u << k) - 1u))] = k;
    if (k == 0) *s_n_taps = __popc(hits);
  }
  __syncthreads();
  const int n_taps = MODE != kTileFixed ? *s_n_taps : 0;
  const int* my_taps = s_taps;

  // tap k's gathered rows (and, in bf16, its weights) into ring stage
  // `stage`
  auto issue = [&](int k, int stage) {
    const uint32_t a_s = smem_u32(ring + stage * L::kStageBytes);
    const uint32_t b_s = a_s + L::kABytes;
    for (int j = tid; j < kRows * L::kKc; j += kMmaThreads) {
      const int r = (j / (8 * L::kKc)) * 8 + j % 8;
      const int c = (j / 8) % L::kKc;
      const int src = kLinear ? row0 + r : s_rb[r * taps + k];
      const bool hit = static_cast<unsigned>(src) < static_cast<unsigned>(n_in);
      const int row = MODE == kTileNoGather ? 0 : src;
      cp_async16(a_s + j * 16,
                 feats + (size_t)(hit ? row : 0) * CIN + c * L::kVec,
                 hit ? 16 : 0);
    }
    if constexpr (!kTf32) {  // f32 weights are split at the tap (split_tap)
      const T* wk = w2 + (size_t)k * CIN * COUT;
      if constexpr (KMAJOR_B) {  // wk [COUT, CIN]: laid out as A
        for (int j = tid; j < COUT * L::kKc; j += kMmaThreads) {
          const int n = (j / (8 * L::kKc)) * 8 + j % 8;
          const int c = (j / 8) % L::kKc;
          cp_async16(b_s + j * 16, wk + n * CIN + c * 8, 16);
        }
      } else {
        for (int j = tid; j < CIN * L::kNc; j += kMmaThreads) {
          const int i = (j / (8 * L::kNc)) * 8 + j % 8;
          const int c = (j / 8) % L::kNc;
          cp_async16(b_s + j * 16, wk + i * COUT + c * 8, 16);
        }
      }
    }
  };

  // f32: split tap k's gathered rows in ring stage `stage` (hi in place, lo
  // into a_lo) and its weights (read from global memory) into b_hi / b_lo,
  // K-major; the caller fences and synchronizes before the wgmma reads them.
  // Generic, so only the f32 tiles that call it instantiate it.
  auto split_tap = [&](auto k, int stage) {
    using W = Tf32Weights<CIN, COUT, KMAJOR_B>;
    const float* wk = reinterpret_cast<const float*>(w2) + (size_t)k * CIN *
                                                             COUT;
    float4 wv[W::kPer][W::kVecs];
#pragma unroll
    for (int p = 0; p < W::kPer; ++p) {
      const int j = tid + p * kMmaThreads;
      if (j >= W::kUnits) continue;
      if constexpr (KMAJOR_B) {  // chunk (output n, channels 4c..4c+3)
        const int n = (j / (8 * L::kKc)) * 8 + j % 8;
        const int c = (j / 8) % L::kKc;
        wv[p][0] = __ldg(reinterpret_cast<const float4*>(wk + n * CIN +
                                                         c * 4));
      } else {  // block (channels 4c..4c+3, outputs 4q..4q+3)
        const int q = j % (COUT / 4);
        const int c = j / (COUT / 4);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wv[p][u] = __ldg(reinterpret_cast<const float4*>(
              wk + (4 * c + u) * COUT + 4 * q));
      }
    }
    unsigned char* a_hi = ring + stage * L::kStageBytes;
    for (int j = tid; j < kRows * L::kKc; j += kMmaThreads) {
      float4 hi, lo;
      split_tf32(*reinterpret_cast<const float4*>(a_hi + j * 16), hi, lo);
      *reinterpret_cast<float4*>(a_hi + j * 16) = hi;
      *reinterpret_cast<float4*>(a_lo + j * 16) = lo;
    }
#pragma unroll
    for (int p = 0; p < W::kPer; ++p) {
      const int j = tid + p * kMmaThreads;
      if (j >= W::kUnits) continue;
      float4 hi, lo;
      if constexpr (KMAJOR_B) {
        split_tf32(wv[p][0], hi, lo);
        *reinterpret_cast<float4*>(b_hi + j * 16) = hi;
        *reinterpret_cast<float4*>(b_lo + j * 16) = lo;
      } else {
        const int q = j % (COUT / 4);
        const int c = j / (COUT / 4);
#pragma unroll
        for (int v = 0; v < 4; ++v) {  // output n = 4q + v: B[n, 4c..4c+3]
          const int n = 4 * q + v;
          split_tf32(make_float4(lane4(wv[p][0], v), lane4(wv[p][1], v),
                                 lane4(wv[p][2], v), lane4(wv[p][3], v)),
                     hi, lo);
          const int off = (n / 8) * L::kKc * 128 + c * 128 + (n % 8) * 16;
          *reinterpret_cast<float4*>(b_hi + off) = hi;
          *reinterpret_cast<float4*>(b_lo + off) = lo;
        }
      }
    }
  };

  float acc[COUT / 2];
#pragma unroll
  for (int i = 0; i < COUT / 2; ++i) acc[i] = 0.f;

  if constexpr (MODE == kTileMmaOnly) {
    // tap 0's rows and weights, staged once; the chain runs over them
    if (n_taps > 0) issue(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t a_s = smem_u32(ring);
    const uint32_t b_s = a_s + L::kABytes;
    for (int t = 0; t < n_taps; ++t) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < CIN / 16; ++s)
        Wgmma<COUT, KMAJOR_B>::mma(
            acc, wgmma_desc(a_s + s * 256, 128, L::kKc * 128),
            wgmma_desc(b_s + s * L::kBStep, L::kBLbo, L::kBSbo));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_accumulators(acc);
    }
  } else {
    // one cp.async group per slot, empty ones too, so that wait_group
    // counts taps
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_taps) issue(my_taps[s], s);
      cp_async_commit();
    }
    for (int t = 0; t < n_taps; ++t) {
      cp_async_wait<kStages - 2>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      // the slot of tap t - 1, whose wgmma every thread has waited for
      const int ahead = t + kStages - 1;
      if (ahead < n_taps) issue(my_taps[ahead], ahead % kStages);
      cp_async_commit();

      const uint32_t a_s = smem_u32(ring + (t % kStages) * L::kStageBytes);
      if constexpr (kTf32) {
        split_tap(my_taps[t], t % kStages);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();  // every thread's share of the split
        const uint32_t al = smem_u32(a_lo);
        const uint32_t bh = smem_u32(b_hi);
        const uint32_t bl = smem_u32(b_lo);
        // the tap's sum in registers of its own, added into acc on the
        // CUDA cores (round to nearest): the tensor cores' additions do
        // not round to nearest, and one chain over every tap's 3 * Cin / 8
        // instructions carried their error into f32 K4 and dFeat (PERF.md,
        // Findings)
        float part[COUT / 2];
#pragma unroll
        for (int i = 0; i < COUT / 2; ++i) part[i] = 0.f;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < CIN / 8; ++s) {  // the small products first
          WgmmaTf32<COUT>::mma(
              part, wgmma_desc(al + s * 256, 128, L::kKc * 128),
              wgmma_desc(bh + s * 256, 128, L::kKc * 128));
          WgmmaTf32<COUT>::mma(
              part, wgmma_desc(a_s + s * 256, 128, L::kKc * 128),
              wgmma_desc(bl + s * 256, 128, L::kKc * 128));
          WgmmaTf32<COUT>::mma(
              part, wgmma_desc(a_s + s * 256, 128, L::kKc * 128),
              wgmma_desc(bh + s * 256, 128, L::kKc * 128));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_accumulators(part);
#pragma unroll
        for (int i = 0; i < COUT / 2; ++i) acc[i] += part[i];
      } else if constexpr (MODE != kTileCopyOnly) {
        const uint32_t b_s = a_s + L::kABytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < CIN / 16; ++s)
          Wgmma<COUT, KMAJOR_B>::mma(
              acc, wgmma_desc(a_s + s * 256, 128, L::kKc * 128),
              wgmma_desc(b_s + s * L::kBStep, L::kBLbo, L::kBSbo));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_accumulators(acc);
      }
    }
  }

  if constexpr (SPLIT) {
    if (split > 1) {
      float* part = reinterpret_cast<float*>(ring);
      __syncthreads();  // every warp's last wgmma has read its ring slot
      if (rank != 0) {
#pragma unroll
        for (int i = 0; i < COUT / 2; ++i) part[i * kMmaThreads + tid] = acc[i];
      }
      cluster_sync();  // the partials are written and visible to rank 0
      if (rank == 0) {
        for (int r = 1; r < split; ++r) {  // rank order: the same bits
#pragma unroll
          for (int i = 0; i < COUT / 2; ++i)
            acc[i] += ld_cluster_f32(part + i * kMmaThreads + tid, r);
        }
      }
      cluster_sync();  // rank 0 is done reading the others' shared memory
      if (rank != 0) return;
    }
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
        if constexpr (RES) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  residual + (size_t)n * COUT + col));
          v0 += r.x;
          v1 += r.y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
      }
      const bool keep = s_keep[lr] != 0;
      if constexpr (kTf32)
        *reinterpret_cast<float2*>(out + (size_t)n * COUT + col) =
            make_float2(keep ? v0 : 0.f, keep ? v1 : 0.f);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)n * COUT + col) =
            __floats2bfloat162_rn(keep ? v0 : 0.f, keep ? v1 : 0.f);
    }
  }
}

}  // namespace sessd
