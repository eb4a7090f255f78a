"""Fixed-capacity rotated NMS (port of ``sessd_tpu/core/nms.py:19-83``),
replacing the reference's CPU NMS (det3d/ops/nms/nms_cpu.h:72-170).

Callers pass score-padded arrays (invalid rows carry score = -inf) and get a
fixed-size index buffer plus a validity mask.
"""
from __future__ import annotations

import torch

from .rotated_iou import iou_bev_matrix


def rotate_nms(boxes5: torch.Tensor, scores: torch.Tensor, *,
               pre_max_size: int = 1000, post_max_size: int = 100,
               iou_threshold: float = 0.01):
    """Greedy rotated-BEV NMS.

    boxes5 [N, 5] (x, y, w, l, r), scores [N] -> (indices [min(pre, post)]
    into the inputs, valid mask). Boxes are visited in descending score
    order; a box is kept iff no higher-scoring kept box overlaps it with
    IoU > threshold.
    """
    pre = min(pre_max_size, boxes5.shape[0])
    top_scores, order = torch.topk(scores, pre)
    iou = iou_bev_matrix(boxes5[order], boxes5[order])
    valid_in = top_scores > -torch.inf
    kept = _greedy_keep(iou, valid_in, iou_threshold)
    # compact kept indices (score-descending) into post_max_size; stable as
    # jnp.argsort is
    rank = torch.arange(pre, device=scores.device)
    kept_rank = torch.where(kept, rank, pre + 1)
    sel = torch.argsort(kept_rank, stable=True)[:post_max_size]
    sel_valid = kept[sel]
    return torch.where(sel_valid, order[sel], 0), sel_valid


def _greedy_keep(iou: torch.Tensor, valid_in: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS as a fixpoint: with boxes in descending score order,
    suppressed = F(suppressed), F(s)[i] = exists j<i: !s[j] & overlap[j,i].
    Iterating from F(0) converges in O(suppression-chain depth) passes."""
    pre = iou.shape[0]
    rank = torch.arange(pre, device=iou.device)
    overlap = ((iou > iou_threshold) & (rank[:, None] < rank[None, :])
               & valid_in[:, None])
    s = overlap.any(dim=0)
    prev = torch.zeros_like(s)
    it = 0
    while it < pre and not torch.equal(s, prev):
        s, prev = ((~s)[:, None] & overlap).any(dim=0), s
        it += 1
    return ~s & valid_in
