"""Fixed-capacity rotated NMS (port of ``sessd_tpu/core/nms.py``),
replacing the reference's CPU NMS (det3d/ops/nms/nms_cpu.h:72-170), and
DI-NMS, its IoU-weighted variant (nms_cpu.h:174-383).

Callers pass score-padded arrays (invalid rows carry score = -inf) and get a
fixed-size index buffer plus a validity mask.
"""
from __future__ import annotations

import torch

from .rotated_iou import iou_bev_matrix

# DI-NMS settings (the reference's defaults, box_torch_ops.py:552-621):
# keep a leader iff cnt > _CNT_THRESH; members and suppression at
# _SUPPRESSED_THRESH; sigma by the leader's distance from the sensor,
# (lo, hi, sigma) in m and m^2, 0 past the last edge
_CENTERNESS_POW = 2
_CNT_THRESH = 2.6
_SUPPRESSED_THRESH = 0.3
_SIGMA = ((0, 20, 0.0009), (20, 40, 0.009), (40, 60, 0.1))


def rotate_nms(boxes5: torch.Tensor, scores: torch.Tensor, *,
               pre_max_size: int = 1000, post_max_size: int = 100,
               iou_threshold: float = 0.01):
    """Greedy rotated-BEV NMS.

    boxes5 [N, 5] (x, y, w, l, r), scores [N] -> (indices [min(pre, post)]
    into the inputs, valid mask). Boxes are visited in descending score
    order, the lower index first on ties; a box is kept iff no
    higher-scoring kept box overlaps it with IoU > threshold.
    """
    top_scores, order = score_order(scores, pre_max_size)
    keep, sel_valid = nms_sorted(boxes5[order], top_scores, post_max_size,
                                 iou_threshold)
    return torch.where(sel_valid, order[keep], 0), sel_valid


def score_order(scores: torch.Tensor, pre_max_size: int):
    """The first ``pre_max_size`` scores along the last dimension in
    descending order and their indices, the lower index first on ties (as
    ``jax.lax.top_k``): a stable sort, so a batch [B, N] orders each row as
    the row alone."""
    top, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[..., :pre_max_size], order[..., :pre_max_size]


def nms_sorted(boxes5: torch.Tensor, top_scores: torch.Tensor,
               post_max_size: int, iou_threshold: float):
    """Greedy NMS of boxes already in descending score order: boxes5 [pre,
    5], top_scores [pre] (-inf: padding) -> (keep [min(pre, post)], the
    kept ranks into the rows in order, 0 past the last; valid mask)."""
    pre = boxes5.shape[0]
    iou = iou_bev_matrix(boxes5, boxes5)
    kept = _greedy_keep(iou, top_scores > -torch.inf, iou_threshold)
    # compact kept ranks (score-descending) into post_max_size; stable as
    # jnp.argsort is
    rank = torch.arange(pre, device=boxes5.device)
    kept_rank = torch.where(kept, rank, pre + 1)
    sel = torch.argsort(kept_rank, stable=True)[:post_max_size]
    sel_valid = kept[sel]
    return torch.where(sel_valid, sel, 0), sel_valid


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


def rotate_weighted_nms(boxes: torch.Tensor, boxes5: torch.Tensor,
                        dir_labels: torch.Tensor, labels: torch.Tensor,
                        scores: torch.Tensor, iou_preds: torch.Tensor,
                        anchors: torch.Tensor, *,
                        pre_max_size: int = 1000, post_max_size: int = 100,
                        iou_threshold: float = 0.01):
    """DI-NMS, the distance-interval IoU-weighted NMS of CIA-SSD (port of
    ``sessd_tpu/core/nms.py:96-211``; reference nms_cpu.h:174-383 and its
    wrapper box_torch_ops.py:552-621). The oracle is the literal host port
    ``core.nms_np.rotate_weighted_nms_np``.

    Boxes are taken in descending score order (``score = -inf`` rows are
    padding; the lower index first on ties, as ``jax.lax.top_k``) and
    damped by (1 - softmax of the box-to-anchor BEV distance over the valid
    set)^2. Then leader by leader, in descending damped score among the
    unsuppressed:

    - cnt = sum over same-label j with iou(i, j) > 0 of iou * iou_preds[j];
    - members: same-label j with iou > 0.3; the merged box averages all 7
      dims of the members with weights exp(-(1 - iou)^2 / sigma) *
      iou_preds[j], sigma by the leader's distance interval, 0 past the
      last edge, where the leader's own box is kept;
    - kept iff cnt > 2.6, scored with the members' best damped score, and
      then every unsuppressed box at iou >= 0.3 (any label) is suppressed;
      else only the leader is.

    Each leader is one pass of vectorized [pre] work on the device against
    the precomputed IoU matrix; the host reads one flag per leader (whether
    any box is left), so the loop runs as many times as there are leaders.
    ``iou_threshold`` is accepted and unused, as in the reference. Returns
    (boxes [post, 7], dir_labels, labels, scores, valid), kept leaders first
    in pick order, scores -inf where not valid."""
    n = boxes5.shape[0]
    pre = min(pre_max_size, n)
    top_scores, order = torch.sort(scores, descending=True, stable=True)
    top_scores, order = top_scores[:pre], order[:pre]
    valid_in = top_scores > -torch.inf
    d = (boxes[order, :2] - anchors[order, :2]).pow(2).sum(-1).sqrt()
    d_max = torch.where(valid_in, d, -torch.inf).max()
    e = torch.where(valid_in, torch.exp(d - d_max), 0.0)
    softmax = e / e.sum().clamp_min(1e-20)
    top_scores = torch.where(
        valid_in, top_scores * (1.0 - softmax) ** _CENTERNESS_POW, -torch.inf)
    b7 = boxes[order].float()
    lab = labels[order]
    iop = iou_preds[order].float()
    iou = iou_bev_matrix(boxes5[order], boxes5[order])

    dist = b7[:, :2].pow(2).sum(-1).sqrt()
    sigma = torch.zeros_like(dist)
    for lo, hi, sq in _SIGMA:
        sigma = torch.where((dist >= lo) & (dist < hi), sq, sigma)

    suppressed = ~valid_in
    kept = torch.zeros_like(valid_in)
    out_b = torch.zeros_like(b7)
    out_s = torch.full_like(top_scores, -torch.inf)
    while not bool(suppressed.all()):
        # a [1] index keeps every step on the device (no .item())
        idx = torch.where(suppressed, -torch.inf, top_scores).argmax().view(1)
        ov = iou.index_select(0, idx)[0]
        same = lab == lab.index_select(0, idx)
        cnt = torch.where((ov > 0) & same & valid_in, ov * iop, 0.0).sum()
        member = (ov > _SUPPRESSED_THRESH) & same & valid_in
        sig = sigma.index_select(0, idx)
        w = torch.where(member & (sig > 0),
                        torch.exp(-(1.0 - ov) ** 2 / sig.clamp_min(1e-20))
                        * iop, 0.0)
        wsum = w.sum()
        merged = torch.where(
            wsum != 0,
            (w[:, None] * b7).sum(0) / torch.where(wsum != 0, wsum, 1.0),
            b7.index_select(0, idx)[0])
        keep_it = cnt > _CNT_THRESH
        suppressed = suppressed | (keep_it & (ov >= _SUPPRESSED_THRESH))
        suppressed = suppressed.index_fill(0, idx, True)
        kept = kept.index_put((idx,), keep_it.view(1))
        out_b = out_b.index_put((idx,), torch.where(
            keep_it, merged, out_b.index_select(0, idx)[0])[None])
        out_s = out_s.index_put((idx,), torch.where(
            keep_it, torch.where(member, top_scores, -torch.inf).max(),
            out_s.index_select(0, idx)[0]).view(1))

    # leaders are picked in strictly descending damped score (a recovery
    # only restores boxes below the current leader), so kept leaders sorted
    # by damped score are in pick order
    kept_rank = torch.where(kept, -top_scores, torch.inf)
    sel = torch.argsort(kept_rank, stable=True)[:post_max_size]
    sel_valid = kept[sel]
    return (out_b[sel], dir_labels[order][sel], labels[order][sel],
            torch.where(sel_valid, out_s[sel], -torch.inf), sel_valid)
