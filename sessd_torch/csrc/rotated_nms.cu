// Rotated-BEV greedy NMS for every scene of a batch: an IoU bit mask over
// the upper triangle, then one greedy scan per scene.
//
// Replaces no Pallas kernel: the JAX package's rotated NMS
// (sessd_tpu/core/nms.py) is XLA code. It exists because the serving
// pass's profile (PERF.md, section 5) put 94% of a batch's device idle in
// the host issuing the per-scene decode and NMS, ~320 small ops a scene
// (core/nms.py: rotate_nms, its [pre, pre, 4, 4] broadcast IoU passes and a
// host read per fixpoint pass of its greedy keep).
//
// Input per scene: `pre` boxes in descending score order (the caller's
// stable sort) as [pre, 7] f32 rows (x, y, z, w, l, h, r), and their
// scores, -inf (or NaN) for padding.
//
// rotated_nms_mask_kernel: grid (pre/64, pre/16, batch), one CTA per 16 x
//   64 tile of the IoU matrix (16 rows, one word of columns), 256 threads:
//   16 per row, 4 columns each, so that the few tiles a serving batch has
//   (its valid rows are a prefix) still spread over many threads. Tiles
//   below the diagonal, and tiles with no valid row or no valid column,
//   write zero words. A tile stages its rows' and columns' corners in
//   shared memory; bit j of word w of row i is set where rows i and j are
//   both valid, j = 64 w + bit > i, and iou(i, j) > threshold. Output
//   [batch, pre, words] u64.
// rotated_nms_scan_kernel: one warp per scene. Lane l holds words l and
//   l + 32 of the ranks still live (valid and not removed). The warp visits live ranks in
//   order; each is kept, appended to the next slot, and its mask row is
//   cleared from the live words. It stops at min(pre, post) slots. Output:
//   keep [batch, slots] int64 (rank into the sorted rows, 0 past the last
//   kept) and valid [batch, slots] bool. That is the greedy of
//   core/nms.py: _greedy_keep without its fixpoint passes, and the stable
//   argsort of the kept ranks that nms_sorted takes.
//
// The IoU is core/rotated_iou.py's Green's-theorem clip, operation for
// operation in f32: every product is __fmul_rn, which is never contracted
// into a multiply-add, and sinf/cosf are the accurate ones, so each
// product and sum rounds where torch's elementwise kernels round it, and
// the decisions match the plain version's on the card. The four edge
// contributions are summed as torch's CUDA reduction over a last dimension
// of 4 sums them: (c0 + c2) + (c1 + c3).
//
// What bounds it on Hopper: the triangle's IoU arithmetic (~300 f32
// operations a pair of valid boxes, 8 x 70 x 69 / 2 pairs at the serving
// shape: ~0.09 us at 67 TFLOP/s) and the scan's dependent chain, one
// mask-row read per kept box. The design keeps the IoUs out of device
// memory (one bit each) and the host out of the loop: two launches a
// batch, no sync.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;         // columns of a mask tile: one word
constexpr int kRows = 16;         // rows of a mask tile
constexpr int kParts = 16;        // threads per row of a tile
constexpr int kCols = kTile / kParts;  // columns per thread
constexpr int kMaskThreads = kRows * kParts;
constexpr int kWordsPerLane = 2;  // the scan's words a lane holds
constexpr int kMaxWords = 32 * kWordsPerLane;  // pre <= 4096
constexpr float kEps = 1e-8f;     // core/rotated_iou.py: _EPS
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum: NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ bool live_score(float s) {
  return s > -__int_as_float(0x7f800000);  // false for -inf and NaN
}

// box_torch.bev_corners, reversed to counter-clockwise as
// rotated_iou.overlap_bev flips them
__device__ __forceinline__ void corners(const float* box, float* cx,
                                        float* cy, float* area) {
  const float x = box[0], y = box[1], w = box[3], l = box[4], r = box[6];
  const float c = cosf(r), s = sinf(r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // box_torch._CORNERS2D: (-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5)
    const float lx = __fmul_rn(w, k < 2 ? -0.5f : 0.5f);
    const float ly = __fmul_rn(l, k == 1 || k == 2 ? 0.5f : -0.5f);
    const float gx = __fmul_rn(lx, c) + __fmul_rn(ly, s);
    const float gy = __fmul_rn(-lx, s) + __fmul_rn(ly, c);
    cx[3 - k] = gx + x;
    cy[3 - k] = gy + y;
  }
  *area = __fmul_rn(w, l);
}

// rotated_iou._clip_edge_contributions: P's edges clipped by Q's four
// half-planes, each surviving part's 0.5 * cross(u, v)
__device__ __forceinline__ float clip_edges(const float* px, const float* py,
                                            const float* qx, const float* qy,
                                            float tol) {
  float c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ax = px[k], ay = py[k];
    const float dx = px[(k + 1) & 3] - ax, dy = py[(k + 1) & 3] - ay;
    float lo = 0.0f, hi = 0.0f;
    bool infeasible = false;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float q0x = qx[m], q0y = qy[m];
      const float ex = qx[(m + 1) & 3] - q0x, ey = qy[(m + 1) & 3] - q0y;
      const float s0 = __fmul_rn(ex, ay - q0y) - __fmul_rn(ey, ax - q0x);
      const float sd = __fmul_rn(ex, dy) - __fmul_rn(ey, dx);
      const float t_at0 = -s0 / (fabsf(sd) < kEps ? 1.0f : sd);
      const float lo_m = sd > kEps ? t_at0 : 0.0f;
      const float hi_m = sd < -kEps ? t_at0 : 1.0f;
      infeasible |= fabsf(sd) <= kEps && s0 < tol;
      lo = m == 0 ? lo_m : nan_max(lo, lo_m);
      hi = m == 0 ? hi_m : nan_min(hi, hi_m);
    }
    const float t0 = nan_min(nan_max(lo, 0.0f), 1.0f);
    const float t1 = nan_min(nan_max(hi, 0.0f), 1.0f);
    const float ux = ax + __fmul_rn(t0, dx), uy = ay + __fmul_rn(t0, dy);
    const float vx = ax + __fmul_rn(t1, dx), vy = ay + __fmul_rn(t1, dy);
    const float part = __fmul_rn(0.5f, __fmul_rn(ux, vy) - __fmul_rn(uy, vx));
    c[k] = (t1 > t0 && !infeasible) ? part : 0.0f;
  }
  return (c[0] + c[2]) + (c[1] + c[3]);
}

// rotated_iou.iou_bev of row box P against column box Q
__device__ __forceinline__ float iou_pair(const float* px, const float* py,
                                          float pa, const float* qx,
                                          const float* qy, float qa) {
  float inter = clip_edges(px, py, qx, qy, -1e-6f) +
                clip_edges(qx, qy, px, py, 1e-6f);
  inter = nan_max(inter, 0.0f);
  const float uni = (pa + qa) - inter;
  return inter / nan_max(uni, 1e-7f);
}

__global__ void __launch_bounds__(kMaskThreads)
    rotated_nms_mask_kernel(const float* __restrict__ boxes,
                            const float* __restrict__ scores, int pre,
                            int words, float threshold,
                            unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x % kRows, part = threadIdx.x / kRows;
  const int row = rb * kRows + r;
  unsigned long long* out = mask + static_cast<size_t>(b) * pre * words;
  const float* sc = scores + static_cast<size_t>(b) * pre;
  const bool row_valid = row < pre && live_score(sc[row]);
  // threads 0-63 stage the tile's columns, 64-79 its rows
  const int jt = threadIdx.x, col_t = cb * kTile + jt;
  const bool col_valid = jt < kTile && col_t < pre && live_score(sc[col_t]);
  const bool any_row = __syncthreads_or(row_valid);
  const bool any_col = __syncthreads_or(col_valid);
  // no column of the tile lies past its first row, or no row or no column
  // is valid
  if ((cb + 1) * kTile <= rb * kRows + 1 || !any_row || !any_col) {
    if (part == 0 && row < pre)
      out[static_cast<size_t>(row) * words + cb] = 0;
    return;
  }

  __shared__ float rx[kRows][4], ry[kRows][4], ra[kRows];
  __shared__ float cx[kTile][4], cy[kTile][4], ca[kTile];
  __shared__ bool cv[kTile];
  __shared__ unsigned char bits[kParts][kRows];
  const float* scene = boxes + static_cast<size_t>(b) * pre * 7;
  if (jt < kTile) {
    cv[jt] = col_valid;
    if (col_valid)
      corners(scene + static_cast<size_t>(col_t) * 7, cx[jt], cy[jt], &ca[jt]);
  } else if (jt < kTile + kRows) {
    const int rr = jt - kTile, rw = rb * kRows + rr;
    if (rw < pre)
      corners(scene + static_cast<size_t>(rw) * 7, rx[rr], ry[rr], &ra[rr]);
  }
  __syncthreads();

  unsigned mine = 0;
  if (row_valid) {
    float px[4], py[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      px[k] = rx[r][k];
      py[k] = ry[r][k];
    }
    const float pa = ra[r];
    for (int c = 0; c < kCols; ++c) {
      const int jc = part * kCols + c, col = cb * kTile + jc;
      if (col > row && cv[jc] &&
          iou_pair(px, py, pa, cx[jc], cy[jc], ca[jc]) > threshold)
        mine |= 1u << c;
    }
  }
  bits[part][r] = static_cast<unsigned char>(mine);
  __syncthreads();
  if (part == 0 && row < pre) {
    unsigned long long word = 0;
#pragma unroll
    for (int q = 0; q < kParts; ++q)
      word |= static_cast<unsigned long long>(bits[q][r]) << (q * kCols);
    out[static_cast<size_t>(row) * words + cb] = word;
  }
}

__global__ void __launch_bounds__(32)
    rotated_nms_scan_kernel(const unsigned long long* __restrict__ mask,
                            const float* __restrict__ scores, int pre,
                            int words, int slots, long long* __restrict__ keep,
                            bool* __restrict__ valid) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const unsigned long long* m = mask + static_cast<size_t>(b) * pre * words;
  const float* sc = scores + static_cast<size_t>(b) * pre;
  long long* kb = keep + static_cast<size_t>(b) * slots;
  bool* vb = valid + static_cast<size_t>(b) * slots;

  // lane l: word l of the live ranks in lo_live, word l + 32 in hi_live
  static_assert(kWordsPerLane == 2, "two words a lane");
  unsigned long long lo_live = 0, hi_live = 0;
  for (int w = 0; w < words; ++w) {
    const int i0 = w * kTile + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(kFull, i0 < pre && live_score(sc[i0]));
    const unsigned hi = __ballot_sync(kFull, i1 < pre && live_score(sc[i1]));
    const unsigned long long word = static_cast<unsigned long long>(hi) << 32 |
                                    lo;
    if (lane == w) lo_live = word;
    if (lane + 32 == w) hi_live = word;
  }

  int kept = 0;
  for (int w = 0; w < words && kept < slots; ++w) {
    const bool upper = w >= 32;  // the same for every lane: no divergence
    unsigned long long cand =
        __shfl_sync(kFull, upper ? hi_live : lo_live, w % 32);
    while (cand != 0 && kept < slots) {
      const int bit = __ffsll(static_cast<long long>(cand)) - 1;
      const int i = w * kTile + bit;
      if (lane == 0) {
        kb[kept] = i;
        vb[kept] = true;
      }
      ++kept;
      const unsigned long long* row = m + static_cast<size_t>(i) * words;
      if (lane < words) lo_live &= ~row[lane];
      if (lane + 32 < words) hi_live &= ~row[lane + 32];
      // the ranks of this word above i that are still live
      cand = bit == 63 ? 0
                       : __shfl_sync(kFull, upper ? hi_live : lo_live,
                                     w % 32) &
                             (~0ull << (bit + 1));
    }
  }
  for (int k = kept + lane; k < slots; k += 32) {
    kb[k] = 0;
    vb[k] = false;
  }
}

}  // namespace

// Both kernels on `stream`: boxes [batch, pre, 7] f32 in descending score
// order, scores [batch, pre] f32, mask [batch, pre, ceil(pre / 64)] u64
// (scratch; the caller may read the bits after), keep [batch, slots] int64
// and valid [batch, slots] bool, pre <= 4096 and 0 < slots <= pre. Returns
// the first launch error, cudaErrorInvalidValue for arguments out of
// range.
extern "C" int sessd_rotated_nms(const float* boxes, const float* scores,
                                 void* mask, long long* keep, bool* valid,
                                 int batch, int pre, int slots,
                                 float threshold, void* stream) {
  const int words = (pre + kTile - 1) / kTile;
  if (batch <= 0 || batch > 65535 || pre <= 0 || words > kMaxWords ||
      slots <= 0 || slots > pre)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* bits = static_cast<unsigned long long*>(mask);
  const dim3 grid(words, (pre + kRows - 1) / kRows, batch);
  rotated_nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(
      boxes, scores, pre, words, threshold, bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rotated_nms_scan_kernel<<<batch, 32, 0, s>>>(bits, scores, pre, words,
                                               slots, keep, valid);
  return cudaGetLastError();
}
