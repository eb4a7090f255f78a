"""Anchor target assignment (host numpy, vectorized).

Port of the reference semantics:
- nearest-BEV-IoU similarity (region_similarity.NearestIouSimilarity via
  box_np_ops.rbbox2d_to_near_bbox + iou_jit),
- create_target_np matching rules (det3d/core/anchor/target_ops.py:28-200):
  label 1 for anchors with max-IoU >= matched_threshold, plus force-matching
  the argmax anchor(s) of every gt; label 0 below unmatched_threshold;
  -1 (don't care) in between; reg targets = SECOND encoding of the matched gt.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import box_np


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """[N, 5] (x, y, w, l, r) -> nearest axis-aligned [N, 4] (x1, y1, x2, y2).

    Swaps w/l when the heading is closer to +-pi/2 (box_np_ops semantics).
    """
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., None]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    centers, dims = bboxes_center[:, :2], bboxes_center[:, 2:]
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def nearest_iou_similarity(boxes1_rbv: np.ndarray, boxes2_rbv: np.ndarray) -> np.ndarray:
    """[N, 5] x [M, 5] -> [N, M] axis-aligned IoU of the nearest bboxes."""
    b1 = rbbox2d_to_near_bbox(boxes1_rbv)
    b2 = rbbox2d_to_near_bbox(boxes2_rbv)
    return box_np.iou_2d_aligned_matrix(b1, b2)


@dataclass(frozen=True)
class AnchorLattice:
    """Regular-lattice structure of a [1, H, W, NS, NR] anchor grid
    (core/anchors.create_anchors_3d_range flatten order): anchor index =
    (iy*W + ix)*per_cell + k. Lets create_targets compute per-gt candidate
    slabs by index arithmetic instead of the [A, M] near-bbox compare."""

    h: int
    w: int
    per_cell: int
    x0: float        # BEV center of cell ix = 0
    y0: float
    x_step: float
    y_step: float
    half_x_max: float  # max near-bbox half extents over (size, rotation)
    half_y_max: float


def anchor_lattice(feature_size, anchor_range, sizes=(1.6, 3.9, 1.56),
                   rotations=(0.0, np.pi / 2)):
    """Lattice descriptor matching create_anchors_3d_range's grid, or None
    when the grid has a z extent (D > 1) and BEV slabs don't apply."""
    d, h, w = feature_size
    if d != 1:
        return None
    ar = np.asarray(anchor_range, np.float64)
    stride = float(ar[3] - ar[0]) / w      # the reference's x-derived stride
    x_step = stride                        # x linspace step
    y_step = float(ar[4] - ar[1]) / h      # y linspace step (offset is still
    x0 = float(ar[0]) + stride / 2         # stride/2 — box_np_ops quirk)
    y0 = float(ar[1]) + stride / 2
    szs = np.reshape(np.asarray(sizes, np.float64), [-1, 3])
    rots = np.asarray(rotations, np.float64)
    hx = hy = 0.0
    for wlh in szs:
        for r in rots:
            swap = abs(limit_period(r, 0.5, np.pi)) > np.pi / 4
            ex, ey = (wlh[1], wlh[0]) if swap else (wlh[0], wlh[1])
            hx, hy = max(hx, ex / 2), max(hy, ey / 2)
    return AnchorLattice(h=h, w=w, per_cell=szs.shape[0] * rots.shape[0],
                         x0=x0, y0=y0, x_step=x_step, y_step=y_step,
                         half_x_max=hx, half_y_max=hy)


def _lattice_candidates(lat: AnchorLattice, b1: np.ndarray, b2: np.ndarray):
    """Exact candidate set (anchors whose near-bbox strictly intersects any
    gt near-bbox) via per-gt index slabs: the slab bounds carry a one-cell
    slack over the analytic range, then the real 4-compare test runs on the
    slab only — identical to the dense [A, M] prefilter by construction."""
    per = lat.per_cell
    found = []
    for j in range(b2.shape[0]):
        bxl, byl, bxh, byh = (float(b2[j, 0]), float(b2[j, 1]),
                              float(b2[j, 2]), float(b2[j, 3]))
        ix_lo = max(int(np.floor((bxl - lat.half_x_max - lat.x0)
                                 / lat.x_step)) - 1, 0)
        ix_hi = min(int(np.ceil((bxh + lat.half_x_max - lat.x0)
                                / lat.x_step)) + 1, lat.w - 1)
        iy_lo = max(int(np.floor((byl - lat.half_y_max - lat.y0)
                                 / lat.y_step)) - 1, 0)
        iy_hi = min(int(np.ceil((byh + lat.half_y_max - lat.y0)
                                / lat.y_step)) + 1, lat.h - 1)
        if ix_lo > ix_hi or iy_lo > iy_hi:
            continue
        cells = (np.arange(iy_lo, iy_hi + 1)[:, None] * lat.w
                 + np.arange(ix_lo, ix_hi + 1)[None, :]).reshape(-1)
        idx = (cells[:, None] * per + np.arange(per)[None, :]).reshape(-1)
        bb = b1[idx]
        keep = ((bb[:, 2] > bxl) & (bb[:, 0] < bxh)
                & (bb[:, 3] > byl) & (bb[:, 1] < byh))
        found.append(idx[keep])
    if not found:
        return np.array([], dtype=np.int64)
    return np.unique(np.concatenate(found))


def create_targets(
    anchors: np.ndarray,  # [A, 7]
    gt_boxes: np.ndarray,  # [M, 7]
    gt_classes: np.ndarray | None = None,  # [M] int, starting at 1
    matched_threshold: float = 0.6,
    unmatched_threshold: float = 0.45,
    box_code_size: int = 7,
    anchors_nearbb: np.ndarray | None = None,  # [A, 4] cached near-bboxes
    lattice: AnchorLattice | None = None,
):
    """Returns dict(labels [A], bbox_targets [A, code], reg_weights [A]).

    All matching runs in CANDIDATE space: the aligned IoU is zero unless
    the near-bboxes intersect, so 4 compares per (anchor, gt) select the
    ~few-hundred candidate anchors out of 70k and every argmax/threshold/
    force-match rule operates on that subset — the dense [A, M] overlap
    matrix (where non-candidate rows are all-zero: label 0, gt -1) is
    never materialized. Semantics are element-identical to the dense
    reference rules (det3d target_ops.py:28-200), oracle-tested.
    """
    num = anchors.shape[0]
    labels = np.zeros((num,), dtype=np.int32)
    gt_ids = np.full((num,), -1, dtype=np.int32)
    if gt_classes is None and len(gt_boxes) > 0:
        gt_classes = np.ones((gt_boxes.shape[0],), dtype=np.int32)

    cand = np.array([], dtype=np.int64)
    if len(gt_boxes) > 0:
        b1 = (anchors_nearbb if anchors_nearbb is not None
              else rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]]))
        b2 = rbbox2d_to_near_bbox(gt_boxes[:, [0, 1, 3, 4, 6]])
        if lattice is not None:
            cand = _lattice_candidates(lattice, b1, b2)
        else:
            hit = ((b1[:, None, 2] > b2[None, :, 0])
                   & (b1[:, None, 0] < b2[None, :, 2])
                   & (b1[:, None, 3] > b2[None, :, 1])
                   & (b1[:, None, 1] < b2[None, :, 3]))  # [A, M]
            cand = np.flatnonzero(hit.any(axis=1))
    if len(cand):
        ov = box_np.iou_2d_aligned_matrix(b1[cand], b2)  # [C, M]
        argmax_c = ov.argmax(axis=1)
        max_c = ov[np.arange(len(cand)), argmax_c]
        gt_to_anchor_max = ov.max(axis=0)
        # gts that match nothing must not force-match anything
        gt_to_anchor_max[gt_to_anchor_max == 0] = -1

        # force match: all anchors tied at each gt's best IoU
        # (target_ops.py:139-146); the forced gt is the ANCHOR's argmax
        force_c = np.unique(np.where(ov == gt_to_anchor_max[None, :])[0])
        pos_c = max_c >= matched_threshold

        # between the thresholds -> don't care; below -> background (the
        # init). Force rows are (re-)applied last, exactly like the dense
        # formulation's trailing labels[awmo] assignment.
        labels[cand[(max_c >= unmatched_threshold) & ~pos_c]] = -1
        labels[cand[pos_c]] = gt_classes[argmax_c[pos_c]]
        labels[cand[force_c]] = gt_classes[argmax_c[force_c]]
        gt_ids[cand[force_c]] = argmax_c[force_c]
        gt_ids[cand[pos_c]] = argmax_c[pos_c]

    fg_inds = np.where(labels > 0)[0]
    bbox_targets = np.zeros((num, box_code_size), dtype=anchors.dtype)
    if len(gt_boxes) > 0 and len(fg_inds) > 0:
        bbox_targets[fg_inds] = box_np.second_box_encode(
            gt_boxes[gt_ids[fg_inds]], anchors[fg_inds]
        )

    reg_weights = np.zeros((num,), dtype=anchors.dtype)
    reg_weights[labels > 0] = 1.0

    return {
        "labels": labels,
        "bbox_targets": bbox_targets,
        "reg_weights": reg_weights,
        "positive_gt_id": gt_ids[fg_inds],
    }


@dataclass
class TargetAssigner:
    """Single-task assigner (target_assigner.py:68-136 / assign_v2)."""

    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45
    box_code_size: int = 7
    lattice: AnchorLattice | None = None  # optional O(M) candidate slabs

    def assign(self, anchors: np.ndarray, gt_boxes: np.ndarray,
               gt_classes: np.ndarray | None = None):
        """anchors [A, 7] flattened; gt boxes already class-filtered.

        With the SE-SSD ``enable_similar_type`` setting, assign_v2 flattens
        all gt classes to 1 before matching (target_assigner.py:90-94);
        callers should pass gt_classes=None to get the same behavior.
        """
        gt_boxes = gt_boxes.copy()
        if len(gt_boxes):
            gt_boxes[:, -1] = limit_period(gt_boxes[:, -1], offset=0.5, period=2 * np.pi)
        # the anchor grid is static per config: cache its near-bboxes
        # (assign runs twice per training sample at ~70k anchors)
        key = (id(anchors), anchors.shape, anchors.dtype)
        cached = getattr(self, "_nearbb_cache", None)
        if cached is None or cached[0] != key:
            nearbb = rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])
            object.__setattr__(self, "_nearbb_cache", (key, nearbb))
        else:
            nearbb = cached[1]
        return create_targets(
            anchors,
            gt_boxes,
            gt_classes=gt_classes,
            matched_threshold=self.matched_threshold,
            unmatched_threshold=self.unmatched_threshold,
            box_code_size=self.box_code_size,
            anchors_nearbb=nearbb,
            lattice=self.lattice,
        )
