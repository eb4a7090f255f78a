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
// owns its sum, so there is no scatter. The kernel reads W [K, Cin, Cout] as
// it lies and takes its transpose on the way into shared memory, so the
// wrapper launches nothing to transpose it. dW is a reduction over up to ~120k
// rows per tap: split-K over row chunks into f32 partials
// [chunks, K, Cin, Cout], then a second pass sums the chunks in order.
//
// The forward, sparse_conv_fwd_kernel, takes one of two bodies by type and
// shape, fixed at compile time (no fallback at run time):
// - Cin, Cout in {16, 32, 64}: gather_mma.cuh's tensor-core tile (wgmma out
//   of a cp.async ring, taps that no row of the tile hits skipped), 128
//   threads and dynamic shared memory per block; in bf16 on bf16 operands,
//   in f32 (the reference config's precision: the training step and eval
//   on device chains) through 3xTF32 (each operand split into two TF32
//   parts, three products per k8 step, each tap's partial added on the
//   CUDA cores; the header says how). What bounds it on this card and what
//   that design does about it are in the header. Both training plans run
//   all their convs but the first here.
// - the Cin = 4 first conv, in both types: gather_direct.cuh's direct body
//   on the CUDA cores (every tap's weights staged once per block, one
//   thread per row walking its taps without a barrier), 128 threads, 128
//   rows a block; a row's sum runs over its taps in index order, within a
//   tap over channels 0..3 by fmaf into one f32 accumulator.
// One f32 step through the kernels is held to 1e-3 of each gradient's max
// against the same step through the cuBLAS twins. Any change of the
// forward's rounding, the exact conv's included, flips a few of the step's
// ReLU masks, each of which moves a weight gradient by ~1/sqrt(rows) of its
// max (PERF.md), so the gate that holds the 3xTF32 body replays the twin
// step's masks (scripts/probe_step_parity.py).
//
// The input gradient, sparse_conv_dfeat_kernel, takes the same two bodies
// by the same rule, fixed at compile time:
// - bf16 (five of its six pairs, Cout -> Cin of each conv but the first):
//   gather_mma.cuh's tensor-core tile over the inverse rulebook, with no
//   store mask (a padding row past a stage's voxels misses every tap and
//   comes out zero). Its B operand is W[k] read K-major: the reduction
//   dimension, the conv's Cout, is contiguous in W[k] [Cin, Cout], so the
//   tile stages each tap's weights in A's core-matrix layout with Cin in
//   place of the 64 rows and issues wgmma with tnsp-b 0, where the forward
//   reads the same array MN-major. What bounds it is the forward's gather:
//   2*K*Cin*Cout flops per row against K rows of Cout bf16 values. On top
//   of that the inverse rulebook of a strided conv hits at most 8 of 27
//   taps per input row (the row's coordinate parities pick them), so a
//   64-row tile of inputs gathers many zero-filled rows and skips few taps.
// - f32 at those pairs (held to 1e-4, step parity): the same tile through
//   3xTF32. Its B is the bf16 body's K-major W[k], split on the way into
//   shared memory.
// - the first conv's 16 -> 4 (the voxel features' gradient, in both
//   types): the forward's direct body at 16 -> 4, one thread per 2 rows,
//   256 rows a block, staging every W[k] transposed into shared memory
//   once (gather_direct's W_T). It is off the training step's path.
//
// The weight gradient's partial kernel, sparse_conv_dw_partial_kernel, also
// takes one of two bodies, the first in two types, fixed at compile time:
// - bf16 with Cin, Cout in {16, 32, 64}: dw_mma_partial below, on tensor
//   cores. What bounds dW on this card: the gather of feats[rb[n, k]] and
//   the dout rows, 2*Cin*Cout flops per (row, tap) hit against 2*(Cin +
//   Cout) bytes, below the ridge at 16-32 channels and near it at 64. A
//   scalar body that converts every gathered and dout value to f32 in
//   shared memory, synchronises, runs a scalar FMA loop and synchronises
//   again per 64-row step overlaps nothing with the next step's loads, and
//   reads and multiplies every (chunk, tap) pair even where no row hits
//   the tap. The design:
//   * Tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulators),
//     not wgmma. A step's product is G^T D with G the gathered rows
//     [64, Cin] and D the dout rows [64, Cout], both staged with channels
//     contiguous, so both operands are MN-major; ldmatrix.x4.trans turns
//     each 8 x 8 box of either into its mma fragment as it loads. m16n8k16
//     fits every (Cin, Cout) of the plan, where wgmma's M of 64 would pad
//     the 16- and 32-channel sides (computing dW^T with M = Cout pads the
//     same way), and the multiply is not what bounds dW.
//   * 4 warps of 128 threads: warps split Cin in up to 2 and Cout in up to
//     2 and the step's four 16-row k-slices among the rest (16 -> 16: one
//     slice each), so every instance keeps 8-32 accumulator registers per
//     thread; the warps' partial tiles are summed in shared memory in a
//     fixed order at the end.
//   * A 4-stage cp.async ring over the chunk's 64-row steps: each stage is
//     a step's gathered rows and its dout rows, 16-byte chunks, rows padded
//     by 16 bytes so the eight rows one ldmatrix reads fall in distinct
//     banks. A row that misses tap k is zero-filled on both sides (src-size
//     0): it reads neither feats nor dout. The dout rows of a step are one
//     contiguous box, but a TMA copy would land it unpadded (or need a
//     tensor map per call for a swizzled layout), so they take cp.async
//     like the gathered rows.
//   * Skipping: the block reads its chunk's rulebook column once into
//     shared memory, flags the steps some row of which hits tap k and
//     compacts them into a list (one warp's ballot); only those steps are
//     gathered and multiplied, and a (chunk, tap) pair with no hit writes a
//     zero partial without reading dout.
//   * Blocks run tap-fastest on a grid of one dimension (block b is tap
//     b % taps of chunk b / taps), so the K blocks of one chunk run
//     together and share its rulebook rows and dout in L2, and any chunk
//     count launches (a grid stops at 65535 blocks on y).
//   Sums run step by step in order, then over the warps' k-slices in order:
//   the same bits on every run.
// - f32 with Cin, Cout in {16, 32, 64} (the reference config's step: 1e-3
//   of its twin, a reduction over all rows, and of each gradient's max in
//   the step): the same
//   body through 3xTF32 on mma.sync.m16n8k8 (tf32 in, f32 accumulators).
//   ldmatrix.trans is 16-bit only, so each lane reads its fragment values
//   with 32-bit shared loads (staged row t, column g of the slice), rows
//   padded by 8 words so one load's 32 lanes fall in 32 banks, and splits
//   each value in registers into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna,
//   as gather_mma.cuh's 3xTF32 tile does in shared memory). Per 8-row
//   k-slice it issues lo_a hi_b, hi_a lo_b, hi_a hi_b into a partial of the
//   64-row step that starts from zero and is added into the running sum on
//   the CUDA cores: the tensor cores' own additions do not round to nearest,
//   and a chunk runs up to 1024 k8 slices. Three products per value make
//   the multiply what bounds it, so the block multiplies no zero row: it
//   compacts the chunk's rows that hit tap k, in order, into a list (one
//   scan over the block), and step u is list entries [64u, 64u + 64), all
//   hits but the last step's tail, where bf16's steps of 64 consecutive
//   rows zero-fill ~2/3 of a subm conv's rows. Each slice chains three mma
//   into one accumulator, so a block has 8 warps (256 threads), twice
//   bf16's: they split Cin and Cout as in bf16 and a step's eight slices
//   among the rest (2 at 32 -> 32 and up, 8 at 16 -> 16), so twice the
//   chains run side by side, each half as long. f32 doubles a stage (37 KB
//   at 64 -> 64), so the ring keeps 4, 3 or 2 steps, the most that leave
//   two blocks per SM (DwMma::kStages).
//   The rulebook column read once, the tap-fastest grid and the
//   fixed-order sums are the bf16 body's.
// - the Cin = 4 first conv (4 -> 16), in both types: dw_direct_partial, on
//   the CUDA cores. What bounds it: the bytes, the rulebook's 27 entries
//   and the 16 dout values of each row (a hit adds 4 gathered values and
//   2*4*16 flops); on the card, the serial sums of the densest tap and
//   each step's staging (PERF.md). One (chunk, tap) block of 256 threads
//   of which 16 multiply (4 x 4 sums each) would read dout 27 times,
//   multiply every miss, and put every 64-row step behind two barriers.
//   The design:
//   * One block of 4 warps per (chunk, tap group), a warp per tap, 7
//     groups: 280 blocks at batch 4's 40 chunks of 2048 rows. A block
//     reads the chunk's dout rows once and its taps' rulebook entries
//     once, coalesced (consecutive threads, consecutive entries of a row).
//     The grid is one dimension, chunk x group, group-fastest: any chunk
//     count launches, and a chunk's groups run together, sharing its dout
//     in L2 and spreading the centre tap's heavy group over the run
//     (chunk-fastest was 10% slower at 512-row chunks on the card).
//   * Every lane multiplies: a warp's 32 lanes hold its tap's Cin x Cout =
//     64 sums, two each (one input channel, two output channels).
//   * Steps of 256 rows staged in shared memory (the gathered f32 rows,
//     their hit flags and the dout rows) through registers: step u + 1's
//     loads (and step u + 2's rulebook entries) are issued before step
//     u's FMAs. A miss reads nothing.
//   * Each warp counts its tap's hits in the step (a ballot of the flags,
//     32 rows a word) and lists them in order. Most hits of the first conv
//     are the centre tap's (it hits ~64% of a training batch's rows, the
//     other taps 2-15%), so one warp of a group carries its block's sums:
//     a tap that hits more than an eighth of the step's rows multiplies
//     all of them (misses as zero rows, 2 shared loads and 2 FMAs a row at
//     fixed offsets), the others only their listed rows, 8 a round.
//   * The order: each sum runs over the chunk's rows in order by fmaf, a
//     miss a zero row; a listed step skips a miss's fmaf(0, d, acc), which
//     leaves the sum as it is (for finite d, and a sum that is not -0). So
//     a partial has the same bits whichever way its tap's steps are walked,
//     and depends on the chunk rows alone.
// Both write f32 partials [chunks, K, Cin, Cout]; sparse_conv_dw_reduce_kernel
// sums the chunks in order.

#include "gather_direct.cuh"
#include "gather_mma.cuh"

namespace {

using sessd::kRows;
using sessd::kThreads;
using sessd::from_f32;

// out [n_out, COUT] = gather-GEMM of x [n_in, CIN] over rb [n_out, taps]
// with w2 [taps, CIN, COUT], rows outside row_mask zero (no mask: all kept).
template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_fwd_kernel(const T* __restrict__ x, const IdxT* __restrict__ rb,
                           const T* __restrict__ w2,
                           const uint8_t* __restrict__ row_mask,
                           T* __restrict__ out, int n_in, int n_out,
                           int taps) {
  if constexpr (sessd::kMmaTile<T, CIN, COUT> ||
                sessd::kTf32Tile<T, CIN, COUT>)
    sessd::gather_mma_tile<IdxT, CIN, COUT, false>(
        x, rb, w2, nullptr, row_mask, out, n_in, n_out, taps, 0);
  else if constexpr (sessd::kDirect<T, CIN, COUT>)
    sessd::gather_direct<T, IdxT, CIN, COUT, false>(
        x, rb, w2, nullptr, row_mask, out, n_in, n_out, taps, 0);
  else
    static_assert(sessd::kDirect<T, CIN, COUT>, "no body for this pair");
}

// dfeat [n_out, COUT] = the same gather-GEMM of dout x [n_in, CIN] over the
// inverse rulebook rb [n_out, taps] with the transposed weights, read from
// w [taps, COUT, CIN] (the conv's [taps, Cin, Cout]), under a name of its
// own so a profile tells it from the forward. Here CIN is the conv's Cout
// and COUT its Cin; there is no row mask.
template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_dfeat_kernel(const T* __restrict__ x,
                             const IdxT* __restrict__ rb,
                             const T* __restrict__ w,
                             const uint8_t* __restrict__ row_mask,
                             T* __restrict__ out, int n_in, int n_out,
                             int taps) {
  if constexpr (sessd::kMmaTile<T, CIN, COUT> ||
                sessd::kTf32Tile<T, CIN, COUT>)
    sessd::gather_mma_tile<IdxT, CIN, COUT, false, false, true>(
        x, rb, w, nullptr, nullptr, out, n_in, n_out, taps, 0);
  else if constexpr (sessd::kDirect<T, CIN, COUT>)
    sessd::gather_direct<T, IdxT, CIN, COUT, false, true>(
        x, rb, w, nullptr, nullptr, out, n_in, n_out, taps, 0);
  else
    static_assert(sessd::kDirect<T, CIN, COUT>, "no body for this pair");
}

template <typename T, typename IdxT>
using GatherKernel = void (*)(const T*, const IdxT*, const T*,
                              const uint8_t*, T*, int, int, int);

// whether the instance for (T, CIN, COUT) of the forward or of the input
// gradient takes gather_mma.cuh's tile: bf16, and f32 through 3xTF32, at
// 16-64 channels
template <typename T, int CIN, int COUT>
constexpr bool kTensorTile = sessd::kMmaTile<T, CIN, COUT> ||
                             sessd::kTf32Tile<T, CIN, COUT>;

// the __global__ of entry E for (T, IdxT, CIN, COUT): 0 the forward, 1 the
// input gradient
template <int E, typename T, typename IdxT, int CIN, int COUT>
GatherKernel<T, IdxT> kernel_of() {
  if constexpr (E == 0)
    return sparse_conv_fwd_kernel<T, IdxT, CIN, COUT>;
  else
    return sparse_conv_dfeat_kernel<T, IdxT, CIN, COUT>;
}

// above 48 KB a block's shared memory must be asked for, once per kernel
template <int E, typename T, typename IdxT, int CIN, int COUT>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel_of<E, T, IdxT, CIN, COUT>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      sessd::kTileSmemBytes<T, CIN, COUT>);
  return attr;
}

// one launch of entry E's __global__ on the tensor-core tile for (T, CIN,
// COUT): kMmaThreads threads and the tile's shared memory
template <int E, typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch_mma(const void* x, const void* rb, const void* w2,
                       const uint8_t* row_mask, void* out, int n_in,
                       int n_out, int taps, cudaStream_t stream) {
  const cudaError_t attr = allow_smem<E, T, IdxT, CIN, COUT>();
  if (attr != cudaSuccess) return attr;
  const GatherKernel<T, IdxT> kern = kernel_of<E, T, IdxT, CIN, COUT>();
  kern<<<sessd::gather_gemm_grid(n_out), sessd::kMmaThreads,
         sessd::kTileSmemBytes<T, CIN, COUT>, stream>>>(
      static_cast<const T*>(x), static_cast<const IdxT*>(rb),
      static_cast<const T*>(w2), row_mask, static_cast<T*>(out), n_in, n_out,
      taps);
  return cudaGetLastError();
}

// one launch of the forward's (DFEAT false) or the input gradient's
// __global__: the tensor-core tile's block and shared memory where (T, CIN,
// COUT) takes it, else the direct body's block and grid.
template <typename T, typename IdxT, int CIN, int COUT, bool DFEAT>
cudaError_t launch_tile(const void* x, const void* rb, const void* w2,
                        const uint8_t* row_mask, void* out, int n_in,
                        int n_out, int taps, cudaStream_t stream) {
  constexpr int e = DFEAT ? 1 : 0;
  if constexpr (kTensorTile<T, CIN, COUT>) {
    return launch_mma<e, T, IdxT, CIN, COUT>(x, rb, w2, row_mask, out, n_in,
                                             n_out, taps, stream);
  } else {
    const GatherKernel<T, IdxT> kern = kernel_of<e, T, IdxT, CIN, COUT>();
    kern<<<sessd::direct_grid<CIN, COUT>(n_out), sessd::kDirectThreads, 0,
           stream>>>(static_cast<const T*>(x), static_cast<const IdxT*>(rb),
                     static_cast<const T*>(w2), row_mask,
                     static_cast<T*>(out), n_in, n_out, taps);
    return cudaGetLastError();
  }
}

template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch_fwd(const void* x, const void* rb, const void* w2,
                       const uint8_t* row_mask, void* out, int n_in,
                       int n_out, int taps, cudaStream_t stream) {
  return launch_tile<T, IdxT, CIN, COUT, false>(x, rb, w2, row_mask, out,
                                                n_in, n_out, taps, stream);
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

// the code of a forward or input-gradient instance's body: 3 the
// tensor-core tile through 3xTF32, 2 the tensor-core tile in bf16, 1 the
// direct body
template <typename T, int CIN, int COUT>
constexpr int tile_code() {
  if constexpr (!kTensorTile<T, CIN, COUT>)
    return 1;
  else
    return sessd::kTf32Tile<T, CIN, COUT> ? 3 : 2;
}

// tile_code of the forward's instance for (T, cin, cout), 0 where there is
// none
template <typename T>
int fwd_instance(int cin, int cout) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO) return tile_code<T, CI, CO>();
  SESSD_FWD_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return 0;
}

// the input gradient's (Cin, Cout) pairs as its gather sees them: the
// swapped (Cout, Cin) of each conv, the first's (16, 4) included (the
// gradient of the voxel features; the direct body in both types, since
// the tensor-core tile takes 16, 32 and 64 channels only)
#define SESSD_DFEAT_PAIRS(CASE) \
  CASE(16, 4)                   \
  CASE(16, 16)                  \
  CASE(32, 16)                  \
  CASE(32, 32)                  \
  CASE(64, 32)                  \
  CASE(64, 64)

template <typename T, typename IdxT>
cudaError_t dispatch_dfeat(int cin, int cout, const void* x, const void* rb,
                           const void* w, void* out, int n_in, int n_out,
                           int taps, cudaStream_t stream) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch_tile<T, IdxT, CI, CO, true>(x, rb, w, nullptr, out, n_in, \
                                              n_out, taps, stream);
  SESSD_DFEAT_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

// tile_code of the input gradient's instance for (T, cin, cout) (its
// gather's pair), 0 where there is none
template <typename T>
int dfeat_instance(int cin, int cout) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO) return tile_code<T, CI, CO>();
  SESSD_DFEAT_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return 0;
}

// blocks of entry E's int32-rulebook instance for (T, CIN, COUT) that fit
// one SM at its threads, registers and shared memory; 0 where it cannot be
// read
template <int E, typename T, int CIN, int COUT>
int tile_blocks_per_sm() {
  const auto kern = kernel_of<E, T, int32_t, CIN, COUT>();
  int blocks = 0;
  cudaError_t err;
  if constexpr (kTensorTile<T, CIN, COUT>) {
    err = allow_smem<E, T, int32_t, CIN, COUT>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, sessd::kMmaThreads,
          sessd::kTileSmemBytes<T, CIN, COUT>);
  } else {  // the direct body's block (launch_tile)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, sessd::kDirectThreads, 0);
  }
  return err == cudaSuccess ? blocks : 0;
}

// tile_blocks_per_sm of the forward (entry 0) or the input gradient (1,
// its gather's pair); 0 where there is no such instance
template <typename T>
int blocks_per_sm(int entry, int cin, int cout) {
#define SESSD_CASE(CI, CO)                   \
  if (entry == 0 && cin == CI && cout == CO) \
    return tile_blocks_per_sm<0, T, CI, CO>();
  SESSD_FWD_PAIRS(SESSD_CASE)
#undef SESSD_CASE
#define SESSD_CASE(CI, CO) \
  if (entry == 1 && cin == CI && cout == CO)  \
    return tile_blocks_per_sm<1, T, CI, CO>();
  SESSD_DFEAT_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return 0;
}

// the direct dW body's block: kDwDirectTaps warps, one per tap, over steps
// of kDwDirectStep rows of a chunk
constexpr int kDwDirectTaps = 4;
constexpr int kDwDirectStep = 256;
constexpr int kDwDirectThreads = kDwDirectTaps * 32;

// the instances that take dw_direct_partial: the first conv's 4 -> 16
template <typename T, int CIN, int COUT>
constexpr bool kDwDirect = sessd::kDirect<T, CIN, COUT> && CIN == 4;

// 4 values (16 bytes of f32, 8 of bf16) at p as f32, or zeros where `on`
// is false (nothing is read)
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, bool on,
                                      float (&v)[4]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 q = on ? *reinterpret_cast<const float4*>(p)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint2 q = on ? *reinterpret_cast<const uint2*>(p)
                       : make_uint2(0u, 0u);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

// partial[chunk, k] = sum over the chunk's rows n of
//   feats[rb[n, k]]^T dout[n]              ([CIN, COUT], f32)
// for the kDwDirectTaps taps of one group, k = 4 group + warp, of one chunk: block b is group b % groups
// of chunk b / groups (a grid of one dimension, so any chunk count
// launches, group-fastest);
// kDwDirectThreads threads; feats and dout 16-byte aligned. Lane l owns
// input channel l / 8 and output channels 2 (l % 8), + 1 of its warp's
// tap. Each step stages the gathered rows of the block's taps, their hit
// flags and the dout rows in shared memory (loaded into registers a step
// ahead, the rulebook entries two); each warp then sums over all the
// step's rows where its tap hits more than an eighth of them, else over
// its listed hit rows.
// Each sum runs over the chunk's rows in order by fmaf. A dense step adds
// fmaf(0, d, acc) for a miss; a listed step skips it, which leaves acc as
// it is for finite d and a sum that is not -0 (a sum from +0 by fmaf is -0
// only where a product underflows past the smallest denormal). So a
// partial's bits do not depend on which steps were dense.
template <typename T, typename IdxT, int CIN, int COUT>
__device__ __forceinline__ void dw_direct_partial(
    const T* __restrict__ feats, const IdxT* __restrict__ rb,
    const T* __restrict__ dout, float* __restrict__ partial, int n_in,
    int n_out, int taps, int chunk_rows) {
  constexpr int kG = kDwDirectTaps;
  constexpr int kStep = kDwDirectStep;
  constexpr int kBlock = kDwDirectThreads;
  static_assert(CIN == 4 && COUT == 16 && CIN * (COUT / 2) == 32,
                "the first conv's 4 -> 16: a warp's lanes hold a tap's sums");
  constexpr int kPairs = kStep * kG / kBlock;  // (row, tap) per thread
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per dout load
  constexpr int kDout = kStep * COUT / kVec / kBlock;      // per thread
  // one buffer: gathered rows [kStep][kG][CIN], dout rows [kStep][COUT]
  // (f32), hit flags [kStep][kG]
  __shared__ __align__(16) float s_g[kStep * kG * CIN];
  __shared__ __align__(16) float s_d[kStep * COUT];
  __shared__ uint8_t s_hit[kStep * kG];
  __shared__ uint8_t s_list[kG][kStep];  // each warp's hit rows, in order

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int groups = (taps + kG - 1) / kG;
  const int k0 = static_cast<int>(blockIdx.x) % groups * kG;
  const int g_act = min(kG, taps - k0);  // the last group may hold fewer
  const int chunk = static_cast<int>(blockIdx.x) / groups;
  const int begin = chunk * chunk_rows;
  const int end = min(n_out, begin + chunk_rows);
  const int steps = (end - begin + kStep - 1) / kStep;

  // staging: this thread's (row, tap) pairs p = tid + kBlock i, row p / kG
  // and tap p % kG, so consecutive threads read consecutive rulebook
  // entries of a row
  const int st_tap = tid % kG;
  const bool st_on = st_tap < g_act;
  int idx[kPairs];      // the source rows of the next step to gather
  float gv[kPairs][4];  // the next step's gathered rows
  unsigned hv = 0u;     // bit i: pair i hits
  float dv[kDout][kVec];  // the next step's dout rows
  auto load_idx = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int n = begin + s * kStep + (tid + kBlock * i) / kG;
      idx[i] = st_on && n < end
                   ? static_cast<int>(rb[(size_t)n * taps + k0 + st_tap])
                   : -1;
    }
  };
  auto load_step = [&](int s) {
    hv = 0u;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const bool hit =
          static_cast<unsigned>(idx[i]) < static_cast<unsigned>(n_in);
      load4<T>(feats + (size_t)(hit ? idx[i] : 0) * CIN, hit, gv[i]);
      hv |= static_cast<unsigned>(hit) << i;
    }
#pragma unroll
    for (int i = 0; i < kDout; ++i) {
      const int q = tid + kBlock * i;
      const int n = begin + s * kStep + q / (COUT / kVec);
      const bool on = n < end;
      const T* src = dout + (size_t)(on ? n : 0) * COUT +
                     q % (COUT / kVec) * kVec;
      if constexpr (std::is_same<T, float>::value) {
        const float4 v = on ? *reinterpret_cast<const float4*>(src)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        dv[i][0] = v.x;
        dv[i][1] = v.y;
        dv[i][2] = v.z;
        dv[i][3] = v.w;
      } else {
        const uint4 v = on ? *reinterpret_cast<const uint4*>(src)
                           : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[i][2 * e] = __uint_as_float(w[e] << 16);
          dv[i][2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
      }
    }
  };
  auto store_step = [&]() {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = tid + kBlock * i;
      *reinterpret_cast<float4*>(&s_g[p * CIN]) =
          make_float4(gv[i][0], gv[i][1], gv[i][2], gv[i][3]);
      s_hit[p] = (hv >> i) & 1u;
    }
#pragma unroll
    for (int i = 0; i < kDout; ++i) {
      const int q = tid + kBlock * i;
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(&s_d[q * kVec + e]) = make_float4(
            dv[i][e], dv[i][e + 1], dv[i][e + 2], dv[i][e + 3]);
    }
  };

  const int c = lane / (COUT / 2);
  const int j = 2 * (lane % (COUT / 2));
  float acc0 = 0.f, acc1 = 0.f;
  load_idx(0);
  load_step(0);
  if (steps > 1) load_idx(1);
  store_step();
  __syncthreads();
  for (int u = 0; u < steps; ++u) {
    if (u + 1 < steps) {  // the next step's loads in flight over this one
      load_step(u + 1);
      if (u + 2 < steps) load_idx(u + 2);
    }
    if (warp < g_act) {
      // the warp's tap's hit rows of the step, in order: a ballot of the
      // flags, 32 rows a word, each hit row placed by its rank
      int n_hit = 0;
#pragma unroll
      for (int w = 0; w < kStep / 32; ++w) {
        const bool hit = s_hit[(32 * w + lane) * kG + warp] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit)
          s_list[warp][n_hit + __popc(m & ((1u << lane) - 1u))] =
              static_cast<uint8_t>(32 * w + lane);
        n_hit += __popc(m);
      }
      __syncwarp();
      const float* g_col = s_g + warp * CIN + c;
      const float* d_col = s_d + j;
      if (n_hit > kStep / 8) {
        // a dense tap (the centre tap hits most rows): every row of the
        // step, misses as zero rows
#pragma unroll 8
        for (int r = 0; r < kStep; ++r) {
          const float a = g_col[r * kG * CIN];
          const float2 b = *reinterpret_cast<const float2*>(d_col + r * COUT);
          acc0 = fmaf(a, b.x, acc0);
          acc1 = fmaf(a, b.y, acc1);
        }
      } else {
        // the listed rows, kBatch a round, their loads issued together
        constexpr int kBatch = 8;
        for (int i0 = 0; i0 < n_hit; i0 += kBatch) {
          float a[kBatch];
          float2 b[kBatch];
#pragma unroll
          for (int t = 0; t < kBatch; ++t) {
            const int r = s_list[warp][min(i0 + t, kStep - 1)];
            a[t] = g_col[r * kG * CIN];
            b[t] = *reinterpret_cast<const float2*>(d_col + r * COUT);
          }
#pragma unroll
          for (int t = 0; t < kBatch; ++t) {
            if (i0 + t < n_hit) {
              acc0 = fmaf(a[t], b[t].x, acc0);
              acc1 = fmaf(a[t], b[t].y, acc1);
            }
          }
        }
      }
    }
    __syncthreads();
    if (u + 1 < steps) {
      store_step();
      __syncthreads();
    }
  }
  if (warp < g_act)
    *reinterpret_cast<float2*>(
        partial + (((size_t)chunk * taps + k0 + warp) * CIN + c) * COUT + j) =
        make_float2(acc0, acc1);
}

constexpr int kDwStages = 4;           // 64-row steps in the ring (bf16)
constexpr int kDwMaxChunkRows = 8192;  // the rulebook column in shared memory
// a grid's blocks on x: the tensor-core dW's taps x chunks at most
// (ops/cuda/sparse_conv_train.py: GRID_X_MAX)
constexpr long long kGridXMax = 2147483647;
// the f32 ring's bytes at most: with the rulebook column and the hit-row
// list of a 2048-row chunk (ops/cuda/sparse_conv_train.py: DW_CHUNK_ROWS)
// two blocks fit an SM
constexpr int kDwTf32RingBytes = 96 * 1024;

// shared-memory layout and warp split of the tensor-core dW tile, bf16
// (mma.sync m16n8k16) or f32 through 3xTF32 (m16n8k8)
template <typename T, int CIN, int COUT>
struct DwMma {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static constexpr int kElem = static_cast<int>(sizeof(T));
  static constexpr int kVec = 16 / kElem;  // values per 16-byte chunk
  // bytes per staged row: bf16 one chunk of padding, so the eight rows one
  // ldmatrix reads fall in distinct banks; f32 eight words, so a row's
  // stride is 8 or 24 words mod 32 and the 32 lanes of one fragment load
  // (staged row t, column g; lane 4g + t) fall in 32 distinct banks
  static constexpr int kGStride = CIN * kElem + (kTf32 ? 32 : 16);
  static constexpr int kDStride = COUT * kElem + (kTf32 ? 32 : 16);
  static constexpr int kGBytes = kRows * kGStride;
  static constexpr int kDBytes = kRows * kDStride;
  static constexpr int kStageBytes = kGBytes + kDBytes;
  // steps in the ring: bf16 4; f32 4, 3 or 2, the most that fit
  // kDwTf32RingBytes (f32 doubles a stage: 37 KB at 64 -> 64)
  static constexpr int kStages =
      !kTf32                                      ? kDwStages
      : kDwStages * kStageBytes <= kDwTf32RingBytes ? kDwStages
      : 3 * kStageBytes <= kDwTf32RingBytes         ? 3
                                                    : 2;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSliceRows = kTf32 ? 8 : 16;   // the mma's K
  static constexpr int kSlices = kRows / kSliceRows;  // k-slices of a step
  // warps of a block: f32 8, twice bf16's, so that twice the independent
  // mma chains hide their latency (a 3xTF32 slice chains three mma into
  // one accumulator)
  static constexpr int kWarps = kTf32 ? 8 : 4;
  static constexpr int kBlock = kWarps * 32;
  static constexpr int kWm = CIN / 16 < 2 ? CIN / 16 : 2;    // warps over Cin
  static constexpr int kWn = COUT / 16 < 2 ? COUT / 16 : 2;  // over Cout
  static constexpr int kWk = kWarps / (kWm * kWn);  // over a step's slices
  static constexpr int kMt = CIN / 16 / kWm;   // m16 tiles per warp
  static constexpr int kNt = COUT / 16 / kWn;  // n16 tiles (2 n8) per warp
  static_assert(kWm * kWn * kWk == kWarps && kSlices % kWk == 0,
                "warps split Cin, Cout and a step's slices");
  static_assert(kBlock <= kThreads, "the kernel's launch bounds");
  static_assert(kStages >= 2, "a step in flight while one computes");
  // the warps' partial tiles [kWk, CIN, COUT] f32, in the ring at the end
  static_assert(kWk * CIN * COUT * 4 <= kRingBytes, "reduction fits");
  // the ring and the rulebook column, then bf16 the step flags and the
  // hit-step list + count, f32 the hit-row list and the warps' counts
  static constexpr int smem_bytes(int chunk_rows) {
    return kRingBytes +
           (kTf32 ? 2 * chunk_rows + kWarps
                  : chunk_rows + 2 * (chunk_rows / kRows) + 1) *
               4;
  }
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d[16 x 8] += a[16 x 16] (row) @ b[16 x 8] (col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[16 x 8] += a[16 x 8] (row) @ b[8 x 8] (col), tf32 in (f32 bits whose
// low 13 are zero), f32 out
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo as two tf32 mma operands: hi = tf32(x), lo = tf32(x - hi),
// each rounded to nearest by cvt.rna (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32_u32(float x, uint32_t& hi,
                                               uint32_t& lo) {
  const float h = sessd::tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(sessd::tf32_rna(x - h));
}

// partial[chunk, k] = sum over the chunk's rows n of
//   feats[rb[n, k]]^T dout[n]              ([CIN, COUT], f32)
// on tensor cores: one block of
// DwMma<T, CIN, COUT>::kBlock threads per (tap, chunk), ::smem_bytes
// (chunk_rows) of dynamic shared memory; chunk_rows a multiple of kRows, at
// most kDwMaxChunkRows; feats and dout 16-byte aligned. T is bf16
// (mma.sync m16n8k16) or f32 through 3xTF32 (m16n8k8, three products per
// k8 slice, a fresh partial per 64-row step).
template <typename T, typename IdxT, int CIN, int COUT>
__device__ __forceinline__ void dw_mma_partial(
    const T* __restrict__ feats, const IdxT* __restrict__ rb,
    const T* __restrict__ dout, float* __restrict__ partial, int n_in,
    int n_out, int taps, int chunk_rows, int chunk, int k) {
  using L = DwMma<T, CIN, COUT>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(128) unsigned char sessd_dw_smem[];
  unsigned char* ring = sessd_dw_smem;
  int* s_col = reinterpret_cast<int*>(ring + L::kRingBytes);
  const int steps = chunk_rows / kRows;
  int* s_flag = s_col + chunk_rows;  // bf16
  int* s_steps = s_flag + steps;  // the steps some row of which hits tap k
  int* s_n_steps = s_steps + steps;
  int* s_list = s_col + chunk_rows;  // f32: the rows that hit tap k
  int* s_warp = s_list + chunk_rows;  // f32: each warp's count of them

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int begin = chunk * chunk_rows;
  const int rows = min(n_out - begin, chunk_rows);

  int n_hit = 0, n_steps;
  if constexpr (L::kTf32) {
    // the chunk's rulebook column, read once (the source row of each of its
    // rows through tap k, -1 for a miss and past n_out), and its hit rows
    // compacted in order: s_list[j] is the j-th row that hits tap k. Step
    // u is entries [64u, 64u + 64), so every row of a step hits but the
    // last step's tail: the f32 body multiplies no zero row where bf16's
    // 64-row steps zero-fill ~2/3 of a subm conv's rows. Each thread takes
    // a run of rows, a scan of the counts in thread order places them.
    const int per = (chunk_rows + L::kBlock - 1) / L::kBlock;
    const int lo = min(tid * per, chunk_rows);
    const int hi = min(lo + per, chunk_rows);
    int count = 0;
    for (int i = lo; i < hi; ++i) {
      const int src =
          i < rows ? static_cast<int>(rb[(size_t)(begin + i) * taps + k])
                   : -1;
      const bool hit =
          static_cast<unsigned>(src) < static_cast<unsigned>(n_in);
      s_col[i] = hit ? src : -1;
      count += hit;
    }
    int incl = count;  // inclusive scan over the warp's lanes
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int pos = incl - count;
    for (int w = 0; w < L::kWarps; ++w) {
      if (w < warp) pos += s_warp[w];
      n_hit += s_warp[w];
    }
    for (int i = lo; i < hi; ++i)
      if (s_col[i] >= 0) s_list[pos++] = i;
    __syncthreads();
    n_steps = (n_hit + kRows - 1) / kRows;
  } else {
    // the chunk's rulebook column, read once: the source row of each of
    // its rows through tap k, -1 for a miss (and past n_out), and which
    // steps hit
    for (int s = tid; s < steps; s += L::kBlock) s_flag[s] = 0;
    __syncthreads();
    for (int i = tid; i < chunk_rows; i += L::kBlock) {
      const int src =
          i < rows ? static_cast<int>(rb[(size_t)(begin + i) * taps + k])
                   : -1;
      const bool hit =
          static_cast<unsigned>(src) < static_cast<unsigned>(n_in);
      s_col[i] = hit ? src : -1;
      if (hit) s_flag[i / kRows] = 1;  // every writer writes 1
    }
    __syncthreads();
    if (warp == 0) {
      int count = 0;
      for (int base = 0; base < steps; base += 32) {
        const int s = base + lane;
        const bool hit = s < steps && s_flag[s] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) s_steps[count + __popc(m & ((1u << lane) - 1u))] = s;
        count += __popc(m);
      }
      if (lane == 0) *s_n_steps = count;
    }
    __syncthreads();
    n_steps = *s_n_steps;
  }

  // step s's gathered rows and dout rows into ring stage `stage`; a row
  // that misses tap k is zero on both sides and reads nothing. bf16's step
  // s is the chunk's rows [64s, 64s + 64), f32's the hit rows s_list[64s
  // ..] (zero rows past the last)
  auto issue = [&](int s, int stage) {
    const uint32_t g_s = sessd::smem_u32(ring + stage * L::kStageBytes);
    const uint32_t d_s = g_s + L::kGBytes;
    if constexpr (L::kTf32) {
      for (int j = tid; j < kRows * (CIN / L::kVec); j += L::kBlock) {
        const int r = j / (CIN / L::kVec);
        const int c = j % (CIN / L::kVec);
        const int e = s * kRows + r;
        const int src = e < n_hit ? s_col[s_list[e]] : 0;
        sessd::cp_async16(g_s + r * L::kGStride + c * 16,
                          feats + (size_t)src * CIN + c * L::kVec,
                          e < n_hit ? 16 : 0);
      }
      for (int j = tid; j < kRows * (COUT / L::kVec); j += L::kBlock) {
        const int r = j / (COUT / L::kVec);
        const int c = j % (COUT / L::kVec);
        const int e = s * kRows + r;
        const int row = e < n_hit ? begin + s_list[e] : 0;
        sessd::cp_async16(d_s + r * L::kDStride + c * 16,
                          dout + (size_t)row * COUT + c * L::kVec,
                          e < n_hit ? 16 : 0);
      }
    } else {
      for (int j = tid; j < kRows * (CIN / L::kVec); j += L::kBlock) {
        const int r = j / (CIN / L::kVec);
        const int c = j % (CIN / L::kVec);
        const int src = s_col[s * kRows + r];
        sessd::cp_async16(g_s + r * L::kGStride + c * 16,
                          feats + (size_t)(src >= 0 ? src : 0) * CIN +
                              c * L::kVec,
                          src >= 0 ? 16 : 0);
      }
      for (int j = tid; j < kRows * (COUT / L::kVec); j += L::kBlock) {
        const int r = j / (COUT / L::kVec);
        const int c = j % (COUT / L::kVec);
        const bool hit = s_col[s * kRows + r] >= 0;
        sessd::cp_async16(
            d_s + r * L::kDStride + c * 16,
            dout + (size_t)(hit ? begin + s * kRows + r : 0) * COUT +
                c * L::kVec,
            hit ? 16 : 0);
      }
    }
  };
  // the step the pipeline's u-th slot runs
  auto step_at = [&](int u) -> int {
    if constexpr (L::kTf32)
      return u;
    else
      return s_steps[u];
  };

  const int wm = warp % L::kWm;
  const int wn = (warp / L::kWm) % L::kWn;
  const int wk = warp / (L::kWm * L::kWn);
  float acc[L::kMt][2 * L::kNt][4];
#pragma unroll
  for (int m = 0; m < L::kMt; ++m)
#pragma unroll
    for (int n = 0; n < 2 * L::kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // one cp.async group per slot, empty ones too, so that wait_group counts
  // steps
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue(step_at(s), s);
    sessd::cp_async_commit();
  }
  // bf16: lane l addresses row l % 8 of 8 x 8 box l / 8 of an ldmatrix.x4;
  // f32: lane l holds fragment row (group) l / 4, column l % 4
  const int box = lane / 8;
  const int box_row = lane % 8;
  const int grp = lane / 4;
  const int thr = lane % 4;
  for (int u = 0; u < n_steps; ++u) {
    sessd::cp_async_wait<kStages - 2>();
    __syncthreads();  // every thread's chunks of step u; step u - 1 read
    const int ahead = u + kStages - 1;
    if (ahead < n_steps) issue(step_at(ahead), ahead % kStages);
    sessd::cp_async_commit();

    unsigned char* stage = ring + (u % kStages) * L::kStageBytes;
    if constexpr (L::kTf32) {
      // A = G^T [Cin x 8 rows], B = D [8 rows x Cout], from the staged
      // rows by 32-bit loads (ldmatrix.trans is b16 only): m16n8k8's a0-a3
      // are (m g, k t), (m g + 8, k t), (m g, k t + 4), (m g + 8, k t + 4)
      // and b0, b1 (k t, n g), (k t + 4, n g), i.e. staged rows t and t + 4
      // of the slice, columns g and g + 8. Each is split into tf32 hi and
      // lo in registers; per slice the small products first, lo_a hi_b,
      // hi_a lo_b, then hi_a hi_b (lo_a lo_b, ~2^-22 of the product, is
      // dropped), into a partial of the step that starts from zero and is
      // added into acc on the CUDA cores: the tensor cores' own additions
      // do not round to nearest, and a chunk is up to 8192 rows.
      const float* g = reinterpret_cast<const float*>(stage);
      const float* d = reinterpret_cast<const float*>(stage + L::kGBytes);
      constexpr int g_words = L::kGStride / 4;  // words per staged row
      constexpr int d_words = L::kDStride / 4;
      float part[L::kMt][2 * L::kNt][4];
#pragma unroll
      for (int m = 0; m < L::kMt; ++m)
#pragma unroll
        for (int n = 0; n < 2 * L::kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < L::kSlices / L::kWk; ++j) {  // the group's slices
        const int kk = wk + j * L::kWk;
        const int r0 = kk * 8 + thr;  // staged rows r0 and r0 + 4
        uint32_t a_hi[L::kMt][4], a_lo[L::kMt][4];
#pragma unroll
        for (int m = 0; m < L::kMt; ++m) {
          const int c = (wm * L::kMt + m) * 16 + grp;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32_u32(g[(r0 + (e >> 1) * 4) * g_words + c + (e & 1) * 8],
                           a_hi[m][e], a_lo[m][e]);
        }
#pragma unroll
        for (int n = 0; n < 2 * L::kNt; ++n) {
          const int c = (wn * 2 * L::kNt + n) * 8 + grp;
          uint32_t b_hi[2], b_lo[2];
          split_tf32_u32(d[r0 * d_words + c], b_hi[0], b_lo[0]);
          split_tf32_u32(d[(r0 + 4) * d_words + c], b_hi[1], b_lo[1]);
#pragma unroll
          for (int m = 0; m < L::kMt; ++m) {  // the small products first
            mma_tf32_1688(part[m][n], a_lo[m], b_hi[0], b_hi[1]);
            mma_tf32_1688(part[m][n], a_hi[m], b_lo[0], b_lo[1]);
            mma_tf32_1688(part[m][n], a_hi[m], b_hi[0], b_hi[1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < L::kMt; ++m)
#pragma unroll
        for (int n = 0; n < 2 * L::kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
    } else {
      const uint32_t g_s = sessd::smem_u32(stage);
      const uint32_t d_s = g_s + L::kGBytes;
#pragma unroll
      for (int kk = wk; kk < L::kSlices; kk += L::kWk) {  // 16-row slices
        // A = G^T [Cin x 16 rows]: boxes (m 0-7, k 0-7), (m 8-15, k 0-7),
        // (m 0-7, k 8-15), (m 8-15, k 8-15)
        uint32_t a[L::kMt][4];
#pragma unroll
        for (int m = 0; m < L::kMt; ++m) {
          const int row = kk * 16 + (box >> 1) * 8 + box_row;
          const int col = (wm * L::kMt + m) * 16 + (box & 1) * 8;
          ldmatrix_x4_trans(a[m], g_s + row * L::kGStride + col * 2);
        }
        // B = D [16 rows x Cout]: boxes (k 0-7, n 0-7), (k 8-15, n 0-7),
        // (k 0-7, n 8-15), (k 8-15, n 8-15): two n8 tiles' fragments
#pragma unroll
        for (int n = 0; n < L::kNt; ++n) {
          uint32_t b[4];
          const int row = kk * 16 + (box & 1) * 8 + box_row;
          const int col = (wn * L::kNt + n) * 16 + (box >> 1) * 8;
          ldmatrix_x4_trans(b, d_s + row * L::kDStride + col * 2);
#pragma unroll
          for (int m = 0; m < L::kMt; ++m) {
            mma_bf16_16816(acc[m][2 * n], a[m], b[0], b[1]);
            mma_bf16_16816(acc[m][2 * n + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }

  // the warps' tiles into shared memory ([kWk, CIN, COUT]), then summed
  // over the k-slice groups in order; fragment: register 2h + e of lane l
  // holds row (input channel) l/4 + 8h, column (output channel) 2(l%4) + e
  sessd::cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int m = 0; m < L::kMt; ++m)
#pragma unroll
    for (int n = 0; n < 2 * L::kNt; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (wm * L::kMt + m) * 16 + lane / 4 + 8 * h;
        const int j = (wn * 2 * L::kNt + n) * 8 + (lane % 4) * 2;
        float* dst = red + ((size_t)wk * CIN + i) * COUT + j;
        dst[0] = acc[m][n][2 * h];
        dst[1] = acc[m][n][2 * h + 1];
      }
  __syncthreads();
  float* dst = partial + ((size_t)chunk * taps + k) * CIN * COUT;
  for (int e = tid; e < CIN * COUT; e += L::kBlock) {
    float v = red[e];
#pragma unroll
    for (int w = 1; w < L::kWk; ++w) v += red[w * CIN * COUT + e];
    dst[e] = v;
  }
}

// whether the weight gradient's partial kernel for (T, CIN, COUT) takes
// the tensor-core body: bf16 (mma.sync m16n8k16) or f32 through 3xTF32
// (m16n8k8) with Cin, Cout in {16, 32, 64}
template <typename T, int CIN, int COUT>
constexpr bool kDwTensor =
    sessd::kMmaTile<T, CIN, COUT> || sessd::kTf32Tile<T, CIN, COUT>;

// The partial kernel of the weight gradient: the tensor-core body for
// bf16, and f32 through 3xTF32, with Cin, Cout in {16, 32, 64} (taps x
// chunks blocks on x, tap-fastest, DwMma::kBlock threads), the direct body
// for the first conv's 4 -> 16 (chunks x tap groups blocks on x,
// kDwDirectThreads threads).
template <typename T, typename IdxT, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_partial_kernel(const T* __restrict__ feats,
                              const IdxT* __restrict__ rb,
                              const T* __restrict__ dout,
                              float* __restrict__ partial, int n_in,
                              int n_out, int taps, int chunk_rows) {
  if constexpr (sessd::kMmaTile<T, CIN, COUT> ||
                sessd::kTf32Tile<T, CIN, COUT>)
    dw_mma_partial<T, IdxT, CIN, COUT>(
        feats, rb, dout, partial, n_in, n_out, taps, chunk_rows,
        static_cast<int>(blockIdx.x / taps),
        static_cast<int>(blockIdx.x % taps));
  else if constexpr (kDwDirect<T, CIN, COUT>)
    dw_direct_partial<T, IdxT, CIN, COUT>(feats, rb, dout, partial, n_in,
                                          n_out, taps, chunk_rows);
  else
    static_assert(kDwDirect<T, CIN, COUT>, "no body for this pair");
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

template <typename T>
cudaError_t launch_dw_reduce(const float* partial, void* dw, int chunks,
                             int size, cudaStream_t stream) {
  sparse_conv_dw_reduce_kernel<T><<<(size + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<T*>(dw), chunks, size);
  return cudaGetLastError();
}

// above 48 KB a block's shared memory must be asked for, once per
// tensor-core instance (at the largest chunk)
template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t dw_allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      sparse_conv_dw_partial_kernel<T, IdxT, CIN, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      DwMma<T, CIN, COUT>::smem_bytes(kDwMaxChunkRows));
  return attr;
}

template <typename T, typename IdxT, int CIN, int COUT>
cudaError_t launch_dw(const void* feats, const void* rb, const void* dout,
                      float* partial, void* dw, int n_in, int n_out, int taps,
                      int chunk_rows, cudaStream_t stream) {
  const int chunks = (n_out + chunk_rows - 1) / chunk_rows;
  auto* kern = sparse_conv_dw_partial_kernel<T, IdxT, CIN, COUT>;
  if constexpr (kDwTensor<T, CIN, COUT>) {
    using L = DwMma<T, CIN, COUT>;
    if (chunk_rows % kRows != 0 || chunk_rows > kDwMaxChunkRows)
      return cudaErrorInvalidValue;
    const cudaError_t attr = dw_allow_smem<T, IdxT, CIN, COUT>();
    if (attr != cudaSuccess) return attr;
    const long long blocks = static_cast<long long>(taps) * chunks;
    if (blocks > kGridXMax) return cudaErrorInvalidConfiguration;
    kern<<<static_cast<unsigned>(blocks), L::kBlock,
           L::smem_bytes(chunk_rows), stream>>>(
        static_cast<const T*>(feats), static_cast<const IdxT*>(rb),
        static_cast<const T*>(dout), partial, n_in, n_out, taps, chunk_rows);
  } else {
    kern<<<chunks * ((taps + kDwDirectTaps - 1) / kDwDirectTaps),
           kDwDirectThreads, 0, stream>>>(
        static_cast<const T*>(feats), static_cast<const IdxT*>(rb),
        static_cast<const T*>(dout), partial, n_in, n_out, taps, chunk_rows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw_reduce<T>(partial, dw, chunks, taps * CIN * COUT, stream);
}

// the weight gradient's (Cin, Cout) pairs: the forward's
#define SESSD_DW_PAIRS(CASE) \
  CASE(4, 16)                \
  CASE(16, 16)               \
  CASE(16, 32)               \
  CASE(32, 32)               \
  CASE(32, 64)               \
  CASE(64, 64)

template <typename T, typename IdxT>
cudaError_t dispatch_dw(int cin, int cout, const void* feats, const void* rb,
                        const void* dout, float* partial, void* dw, int n_in,
                        int n_out, int taps, int chunk_rows,
                        cudaStream_t stream) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return launch_dw<T, IdxT, CI, CO>(feats, rb, dout, partial, dw, n_in,    \
                                      n_out, taps, chunk_rows, stream);
  SESSD_DW_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return cudaErrorInvalidValue;
}

// the code of the weight gradient's partial kernel for (T, cin, cout), as
// tile_code: 3 the tensor-core body through 3xTF32, 2 the tensor-core body
// in bf16, 1 the direct body, 0 where there is none
template <typename T>
int dw_instance(int cin, int cout) {
#define SESSD_CASE(CI, CO)                                                   \
  if (cin == CI && cout == CO)                                               \
    return !kDwTensor<T, CI, CO> ? 1 : sessd::kTf32Tile<T, CI, CO> ? 3 : 2;
  SESSD_DW_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return 0;
}

// blocks of the int32-rulebook partial kernel for (T, CIN, COUT) that fit
// one SM at its threads, registers and the shared memory of a chunk of
// chunk_rows rows; 0 where it cannot be read
template <typename T, int CIN, int COUT>
int dw_tile_blocks_per_sm(int chunk_rows) {
  const auto kern = sparse_conv_dw_partial_kernel<T, int32_t, CIN, COUT>;
  int blocks = 0;
  cudaError_t err;
  if constexpr (kDwTensor<T, CIN, COUT>) {
    err = dw_allow_smem<T, int32_t, CIN, COUT>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, DwMma<T, CIN, COUT>::kBlock,
          DwMma<T, CIN, COUT>::smem_bytes(chunk_rows));
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, kDwDirectThreads, 0);
  }
  return err == cudaSuccess ? blocks : 0;
}

template <typename T>
int dw_blocks_per_sm(int cin, int cout, int chunk_rows) {
#define SESSD_CASE(CI, CO) \
  if (cin == CI && cout == CO)              \
    return dw_tile_blocks_per_sm<T, CI, CO>(chunk_rows);
  SESSD_DW_PAIRS(SESSD_CASE)
#undef SESSD_CASE
  return 0;
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

// Which body sessd_sparse_conv_fwd launches for (cin, cout, dtype), as
// tile_code: 3 the tensor-core tile through 3xTF32, 2 the tensor-core tile
// in bf16, 1 the direct body, 0 none (it answers cudaErrorInvalidValue).
extern "C" int sessd_sparse_conv_fwd_instance(int cin, int cout, int dtype) {
  if (dtype == 0) return fwd_instance<float>(cin, cout);
  if (dtype == 1) return fwd_instance<__nv_bfloat16>(cin, cout);
  return 0;
}

// dfeat [n_in, cin] = sum_k dout[inv[i, k]] @ w2[k]^T for dout [n_out, cout]
// (n_out = its miss), the inverse rulebook inv [n_in, taps] and the conv's
// weights w2 [taps, cin, cout] as it holds them: the forward's gather-GEMM
// with the roles of the two sides swapped. The tensor-core instances (bf16,
// and f32 through 3xTF32) want dout and w2 16-byte aligned.
extern "C" int sessd_sparse_conv_dfeat(const void* dout, const void* inv,
                                       const void* w2, void* dfeat,
                                       int n_out, int n_in, int cin, int cout,
                                       int taps, int dtype, int idx_bytes,
                                       void* stream) {
  if (bad_args(n_out, n_in, taps)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SESSD_CALL(T, I)                                                     \
  dispatch_dfeat<T, I>(cout, cin, dout, inv, w2, dfeat, n_out, n_in, taps, s)
  SESSD_TYPES(SESSD_CALL)
#undef SESSD_CALL
}

// Which body sessd_sparse_conv_dfeat launches for the gather pair (cin,
// cout) = (the conv's Cout, its Cin) and dtype: 3 the tensor-core tile
// through 3xTF32, 2 the tensor-core tile in bf16, 1 the direct body, 0
// none.
extern "C" int sessd_sparse_conv_dfeat_instance(int cin, int cout,
                                                int dtype) {
  if (dtype == 0) return dfeat_instance<float>(cin, cout);
  if (dtype == 1) return dfeat_instance<__nv_bfloat16>(cin, cout);
  return 0;
}

// dw [taps, cin, cout] = sum_n feats[rb[n, k]]^T dout[n]; partial is f32
// scratch of [ceil(n_out / chunk_rows), taps, cin, cout]. The tensor-core
// instances (bf16, and f32 through 3xTF32) want chunk_rows a multiple of 64
// up to 8192, and feats and dout 16-byte aligned.
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

// Which body sessd_sparse_conv_dw's partial kernel takes for (cin, cout,
// dtype): 3 the tensor-core body through 3xTF32, 2 the tensor-core body in
// bf16, 1 the direct body, 0 none.
extern "C" int sessd_sparse_conv_dw_instance(int cin, int cout, int dtype) {
  if (dtype == 0) return dw_instance<float>(cin, cout);
  if (dtype == 1) return dw_instance<__nv_bfloat16>(cin, cout);
  return 0;
}

// Blocks of the int32-rulebook partial kernel of sessd_sparse_conv_dw for
// (cin, cout, dtype) that fit one SM at once, at the shared memory of a
// chunk of chunk_rows rows; 0 for a pair it has no instance of, or where it
// cannot be read.
extern "C" int sessd_sparse_conv_dw_blocks_per_sm(int cin, int cout,
                                                  int dtype, int chunk_rows) {
  if (chunk_rows <= 0 || chunk_rows > kDwMaxChunkRows) return 0;
  if (dtype == 0) return dw_blocks_per_sm<float>(cin, cout, chunk_rows);
  if (dtype == 1)
    return dw_blocks_per_sm<__nv_bfloat16>(cin, cout, chunk_rows);
  return 0;
}

// Blocks of the int32-rulebook instance for (cin, cout, dtype) of
// sessd_sparse_conv_fwd (entry 0) or sessd_sparse_conv_dfeat (1, the
// gather's pair) that fit one SM at once; 0 for a pair it has no instance of, or where it cannot be read.
extern "C" int sessd_sparse_conv_train_blocks_per_sm(int entry, int cin,
                                                     int cout, int dtype) {
  if (dtype == 0) return blocks_per_sm<float>(entry, cin, cout);
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16>(entry, cin, cout);
  return 0;
}
