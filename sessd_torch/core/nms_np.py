"""Host (numpy) literal port of the reference DI-NMS — the golden oracle for
``core.nms.rotate_weighted_nms``.

This follows ``IOU_weighted_rotate_non_max_suppression_cpu``
(det3d/ops/nms/nms_cpu.h:174-383) plus its torch wrapper
``box_torch_ops.rotate_weighted_nms`` (box_torch_ops.py:552-621) statement by
statement, so the vectorized JAX version can be golden-tested against exact
reference semantics:

- centerness pre-damping (wrapper, enable_centerness & not centerness_c):
  ``scores *= (1 - softmax(dist_xy(box, anchor)))**centerness_pow``.
- boxes are picked in descending (damped) score order; the picked leader is
  suppressed unconditionally.
- cnt = sum over ALL same-label boxes j (suppressed or not) of
  ``overlap(leader, j) * iou_preds[j]`` for overlap > 0.
- cluster members: same-label boxes with overlap > suppressed_thresh (again
  regardless of suppression state); merge weight per member =
  ``exp(-(1-overlap)^2 / sigma) * iou_preds[j]`` where sigma is chosen by the
  leader's distance-to-origin interval (weight 0 beyond the last interval —
  reference behavior, which NaNs there; we keep the leader's own box when the
  total weight vanishes, the one documented deviation).
- ALL 7 box dims are weight-averaged, including the heading.
- suppression (label-agnostic): unsuppressed j with overlap >=
  suppressed_thresh.
- the leader is kept iff cnt > nms_cnt_thresh; its output score is the MAX
  member damped score; if rejected, boxes suppressed this round are recovered.
- the ``iou_threshold`` argument is accepted and UNUSED — exactly as in the
  reference kernel (suppression runs at suppressed_thresh=0.3).
"""
from __future__ import annotations

import numpy as np

from .rotated_iou_np import iou_bev_matrix


def centerness_damp(boxes7: np.ndarray, anchors7: np.ndarray, scores: np.ndarray,
                    centerness_pow: int = 2) -> np.ndarray:
    """Wrapper pre-damping (box_torch_ops.py:582-586)."""
    dist = np.sqrt(((boxes7[:, :2] - anchors7[:, :2]) ** 2).sum(-1))
    e = np.exp(dist - dist.max())
    softmax = e / e.sum()
    return scores * (1.0 - softmax) ** centerness_pow


def rotate_weighted_nms_np(
    boxes7: np.ndarray,
    boxes5: np.ndarray,
    dir_labels: np.ndarray,
    labels: np.ndarray,
    scores: np.ndarray,
    iou_preds: np.ndarray,
    *,
    nms_cnt_thresh: float = 2.6,
    nms_sigma_dist_interval=(0, 20, 40, 60),
    nms_sigma_square=(0.0009, 0.009, 0.1, 1.0),
    suppressed_thresh: float = 0.3,
):
    """Sequential DI-NMS; ``scores`` must already be centerness-damped.

    Returns (merged_boxes [M, 7], dirs [M], labels [M], out_scores [M],
    keep_idx [M]) in pick (descending score) order.
    """
    n = boxes5.shape[0]
    iou = iou_bev_matrix(boxes5, boxes5)
    suppressed = np.zeros(n, dtype=bool)
    # score normalization (nms_cpu.h:246-254) cancels in the output
    # (score_box * score_max4norm); fold it away.
    boxes_ret, scores_ret, labels_ret, dirs_ret, keep = [], [], [], [], []
    intervals = list(nms_sigma_dist_interval)
    while not suppressed.all():
        idx = int(np.argmax(np.where(suppressed, -np.inf, scores)))
        suppressed[idx] = True
        dist = float(np.hypot(boxes7[idx, 0], boxes7[idx, 1]))
        sigma = 0.0
        for k in range(len(intervals) - 1):
            if intervals[k] <= dist < intervals[k + 1]:
                sigma = float(nms_sigma_square[k])
        ov = iou[idx]
        same = labels == labels[idx]
        cnt = float(np.sum(np.where((ov > 0) & same, ov * iou_preds, 0.0)))
        member = (ov > suppressed_thresh) & same
        if sigma > 0:
            w = np.exp(-((1.0 - ov) ** 2) / sigma) * iou_preds
        else:
            w = np.zeros_like(ov)
        w = np.where(member, w, 0.0)
        recover = (~suppressed) & (ov >= suppressed_thresh)
        suppressed |= recover
        if cnt > nms_cnt_thresh:
            wsum = w.sum()
            if wsum != 0:
                merged = (w[:, None] * boxes7).sum(0) / wsum
            else:  # reference NaNs here; keep the leader (documented deviation)
                merged = boxes7[idx].copy()
            boxes_ret.append(merged)
            scores_ret.append(float(scores[member].max()))
            labels_ret.append(int(labels[idx]))
            dirs_ret.append(int(dir_labels[idx]))
            keep.append(idx)
        else:
            suppressed[recover] = False
    if not keep:
        return (np.zeros((0, 7), boxes7.dtype), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32), np.zeros((0,), scores.dtype),
                np.zeros((0,), np.int32))
    return (np.stack(boxes_ret), np.asarray(dirs_ret, np.int32),
            np.asarray(labels_ret, np.int32), np.asarray(scores_ret),
            np.asarray(keep, np.int32))


def rotate_nms_np(boxes5: np.ndarray, scores: np.ndarray,
                  iou_threshold: float, pre_max_size: int = 1000,
                  post_max_size: int = 100) -> np.ndarray:
    """Literal host port of the reference's PLAIN rotated NMS — the golden
    oracle for ``core.nms.rotate_nms``.

    Follows ``rotate_non_max_suppression_cpu`` (det3d/ops/nms/nms_cpu.h:
    72-170) plus its wrappers ``rotate_nms_cc`` (nms_cpu.py:37-48) and
    ``box_torch_ops.rotate_nms`` (:527-548) statement by statement:
    score-descending greedy sweep; pairs are skipped when the standup
    (axis-aligned bbox) IoU is <= 0; otherwise suppress at
    polygon-IoU >= thresh (inclusive — our device kernel uses strict >,
    indistinguishable off ties); keep order truncated to post_max_size.

    Returns indices into the input arrays, in keep (score-descending) order.
    """
    from .rotated_iou_np import overlap_bev_matrix

    n = scores.shape[0]
    pre = min(n, pre_max_size)
    top = np.argsort(-scores, kind="stable")[:pre]  # torch.topk
    b = np.asarray(boxes5[top], np.float64)
    s = scores[top]
    order = np.argsort(-s, kind="stable")

    # standup prefilter (corner_to_standup_nd + iou_jit eps=0: only the
    # sign of the AABB overlap matters)
    half = b[:, 2:4] / 2
    c, si = np.cos(b[:, 4]), np.sin(b[:, 4])
    ex = np.abs(half[:, 0] * c) + np.abs(half[:, 1] * si)
    ey = np.abs(half[:, 0] * si) + np.abs(half[:, 1] * c)
    lo = b[:, :2] - np.stack([ex, ey], 1)
    hi = b[:, :2] + np.stack([ex, ey], 1)
    iw = (np.minimum(hi[:, None, 0], hi[None, :, 0])
          - np.maximum(lo[:, None, 0], lo[None, :, 0]))
    ih = (np.minimum(hi[:, None, 1], hi[None, :, 1])
          - np.maximum(lo[:, None, 1], lo[None, :, 1]))
    standup_pos = (iw > 0) & (ih > 0)

    area = b[:, 2] * b[:, 3]
    suppressed = np.zeros(pre, bool)
    keep = []
    for _i in range(pre):
        i = order[_i]
        if suppressed[i]:
            continue
        keep.append(i)
        for _j in range(_i + 1, pre):
            j = order[_j]
            if suppressed[j] or not standup_pos[i, j]:
                continue
            inter = overlap_bev_matrix(b[i:i + 1], b[j:j + 1])[0, 0]
            union = area[i] + area[j] - inter
            if union > 0 and inter / union >= iou_threshold:
                suppressed[j] = True
    return top[np.asarray(keep[:post_max_size], np.int64)]
