"""SE-SSD losses in PyTorch (port of ``sessd_tpu/train/losses.py``): focal
classification, ODIoU regression, direction, IoU prediction and the
teacher/student consistency loss, all fixed-shape.

Semantics of the reference (losses.py:147-202, 365-420, 498-531;
mg_head_sessd.py:525-808) as the JAX package has them: where the reference
boolean-masks dynamic numbers of positives or detections, a fixed top-K is
gathered with validity masks. ``jax.lax.top_k`` puts the lower index first
among equal scores, and these scores tie often (0/1 positives, -1 fills),
so top-K here is a stable descending sort. The per-sample consistency loss
runs batched instead of under ``vmap``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.nn import functional as F

from ..core import box_torch
from ..core.box_torch import clip
from ..core.odiou import odiou_3d
from ..core.rotated_iou import iou_3d, iou_bev

# ---------------------------------------------------------------------------
# elementary losses
# ---------------------------------------------------------------------------


def smooth_l1(diff: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """Elementwise smooth-L1 with the sigma^2 knee (losses.py:184-191)."""
    s2 = sigma ** 2
    ad = torch.abs(diff)
    return torch.where(ad <= 1.0 / s2, 0.5 * s2 * ad * ad, ad - 0.5 / s2)


def weighted_smooth_l1(pred, target, weights=None, sigma: float = 3.0):
    """[..., C] codewise loss, scaled by [...]-shaped weights."""
    loss = smooth_l1(pred - target, sigma)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def sigmoid_focal_loss(logits, onehot_targets, weights=None,
                       alpha: float = 0.25, gamma: float = 2.0):
    """[..., C] focal loss (losses.py:387-419)."""
    per_entry = (torch.maximum(logits, logits.new_zeros(()))
                 - logits * onehot_targets
                 + torch.log1p(torch.exp(-torch.abs(logits))))
    p = torch.sigmoid(logits)
    p_t = onehot_targets * p + (1 - onehot_targets) * (1 - p)
    mod = torch.pow(1.0 - p_t, gamma)
    aw = onehot_targets * alpha + (1 - onehot_targets) * (1 - alpha)
    loss = mod * aw * per_entry
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def softmax_ce_loss(logits, onehot_targets, weights=None):
    """[...]-shaped cross entropy (losses.py:515-531)."""
    ce = -(onehot_targets * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    if weights is not None:
        ce = ce * weights
    return ce


# ---------------------------------------------------------------------------
# target plumbing
# ---------------------------------------------------------------------------


def topk(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, descending, the
    lower index first among equal scores. Returns (values, indices)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, A, C] (or [B, A]) rows at idx [B, K] -> [B, K, C] ([B, K])."""
    if x.dim() == idx.dim():
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def prepare_loss_weights(labels: torch.Tensor):
    """labels [B, A] in {-1, 0, 1..} -> (cls_w, reg_w, cared), all [B, A]:
    NormByNumPositives (mg_head_sessd.py:525-571)."""
    cared = labels >= 0
    positives = (labels > 0).float()
    cls_weights = (labels == 0).float() + positives
    pos_norm = torch.clamp_min(positives.sum(dim=1, keepdim=True), 1.0)
    return cls_weights / pos_norm, positives / pos_norm, cared


def get_direction_target(anchors, reg_targets, dir_offset: float = 0.0):
    """[B, A, 7] -> one-hot [B, A, 2] (mg_head_sessd.py:63-77)."""
    rot_gt = reg_targets[..., -1] + anchors[..., -1]
    d = ((rot_gt - dir_offset) > 0).long()
    return F.one_hot(d, 2).to(anchors.dtype)


def gather_positives(labels: torch.Tensor, k: int):
    """Up to k positive anchor indices per sample: (idx [B, k], mask)."""
    vals, idx = topk((labels > 0).float(), k)
    return idx, vals > 0


# ---------------------------------------------------------------------------
# consistency loss (teacher/student)
# ---------------------------------------------------------------------------


class ConsistencyConfig(NamedTuple):
    score_thresh: float = 0.3
    iou_match_thresh: float = 0.7
    top_k: int = 256
    post_center_range: tuple = (0.0, -40.0, -5.0, 70.4, 40.0, 5.0)


def _decode_bounded(preds, anchors):
    """``second_box_decode`` with the dim logits clamped to +-10 before the
    exp (losses.py:117-136): the box-space clips downstream bound the value
    but would leave a 0 * inf gradient for a logit past ~88.7."""
    preds = torch.cat([preds[..., :3], clip(preds[..., 3:6], -10.0, 10.0),
                       preds[..., 6:]], dim=-1)
    return box_torch.second_box_decode(preds, anchors)


def _bound(b):
    """Box-space bounds of decoded predictions (losses.py:243-252):
    centers within +-200 m, dims in [1e-2, 30] m."""
    return torch.cat([clip(b[..., :3], -200.0, 200.0),
                      clip(b[..., 3:6], 1e-2, 30.0), b[..., 6:]], dim=-1)


def _transform_teacher_boxes(boxes, flipped, noise_rotation, noise_scale):
    """Replay the student's global augmentation on teacher boxes [B, K, 7]
    (mg_head_sessd.py:666-674); the transforms are [B]."""
    flipped = flipped[:, None]
    y = torch.where(flipped, -boxes[..., 1], boxes[..., 1])
    r = torch.where(flipped, -boxes[..., 6] + math.pi, boxes[..., 6])
    b = torch.cat([boxes[..., 0:1], y[..., None], boxes[..., 2:6],
                   r[..., None]], dim=-1)
    rot = noise_rotation[:, None]
    xyz = box_torch.rotation_points_z(b[..., :3], rot)
    b = torch.cat([xyz, b[..., 3:6], (b[..., 6] + rot)[..., None]], dim=-1)
    return torch.cat([b[..., :6] * noise_scale[:, None, None], b[..., 6:7]],
                     dim=-1)


def _consistency_terms(boxes_stu, cls_stu, dir_stu, iou_stu, boxes_tea,
                       cls_tea, dir_tea, iou_tea, transformation,
                       cfg: ConsistencyConfig):
    """Per sample (box, cls, iou, dir) consistency terms, each [B]
    (mg_head_sessd.py:618-703 with fixed top-K subsets)."""
    pcr = torch.tensor(cfg.post_center_range, dtype=boxes_stu.dtype,
                       device=boxes_stu.device)

    def topk_valid(boxes, cls):
        score = torch.sigmoid(cls[..., 0])
        in_range = ((boxes[..., :3] >= pcr[:3]).all(dim=-1)
                    & (boxes[..., :3] <= pcr[3:]).all(dim=-1))
        ok = (score >= cfg.score_thresh) & in_range
        vals, idx = topk(torch.where(ok, score, -1.0), cfg.top_k)
        return idx, vals > 0

    idx_s, m_s = topk_valid(boxes_stu, cls_stu)
    idx_t, m_t = topk_valid(boxes_tea, cls_tea)
    bs = take(boxes_stu, idx_s)
    bt = _transform_teacher_boxes(
        take(boxes_tea, idx_t), transformation["flipped"],
        transformation["noise_rotation"], transformation["noise_scale"])

    iou = iou_bev(bs[:, :, None, :], bt[:, None, :, :])      # [B, K, K]
    iou = torch.where(m_s[:, :, None] & m_t[:, None, :], iou, 0.0)
    mask1 = (iou.amax(dim=2) > cfg.iou_match_thresh) & m_s  # matched stu
    mask2 = (iou.amax(dim=1) > cfg.iou_match_thresh) & m_t  # matched tea
    # restrict to matched columns, then argmax per student row
    iou_r = torch.where(mask1[:, :, None] & mask2[:, None, :], iou, -1.0)
    match_t = iou_r.argmax(dim=2)

    n_pairs = mask1.sum(dim=1)
    has_pairs = (n_pairs > 0) & (mask2.sum(dim=1) > 0)
    denom = torch.clamp_min(n_pairs, 1).float()

    e1, e2 = box_torch.add_sin_difference(bs, take(bt, match_t))
    box_l = smooth_l1(e1 - e2).sum(dim=-1) / 7.0
    box_l = torch.where(mask1, box_l, 0.0).sum(dim=1) / denom

    def tea_take(x):
        return take(take(x, idx_t), match_t)

    ss = torch.sigmoid(take(cls_stu, idx_s)[..., 0])
    st = torch.sigmoid(tea_take(cls_tea)[..., 0])
    cls_l = torch.where(mask1, smooth_l1(ss - st), 0.0).sum(dim=1) / denom

    is_ = (take(iou_stu, idx_s)[..., 0] + 1.0) * 0.5
    it_ = (tea_take(iou_tea)[..., 0] + 1.0) * 0.5
    iou_l = torch.where(mask1, smooth_l1(is_ - it_), 0.0).sum(dim=1) / denom

    # dir term: MSE between softmaxed distributions (logged, not summed)
    ds = torch.softmax(take(dir_stu, idx_s), dim=-1)
    dt = torch.softmax(tea_take(dir_tea), dim=-1)
    dir_l = (torch.where(mask1[..., None], (ds - dt) ** 2, 0.0).sum(
        dim=(1, 2)) / (2.0 * denom))

    return tuple(torch.where(has_pairs, t, 0.0)
                 for t in (box_l, cls_l, iou_l, dir_l))


def consistency_loss(preds_stu, preds_tea, anchors, transformation,
                     cfg: ConsistencyConfig = ConsistencyConfig()):
    """Batched consistency loss (mg_head_sessd.py:618-703). preds_*: task-0
    dicts of [B, A, .]; anchors [B, A, 7]; transformation: [B]-shaped
    flipped / noise_rotation / noise_scale. Returns (total, dir term),
    total = (box + cls + iou) / batch (mg_head_sessd.py:704)."""
    boxes_stu = _bound(_decode_bounded(preds_stu["box_preds"], anchors))
    boxes_tea = _bound(_decode_bounded(preds_tea["box_preds"], anchors))
    box_l, cls_l, iou_l, dir_l = _consistency_terms(
        boxes_stu, preds_stu["cls_preds"], preds_stu["dir_cls_preds"],
        preds_stu["iou_preds"], boxes_tea, preds_tea["cls_preds"],
        preds_tea["dir_cls_preds"], preds_tea["iou_preds"], transformation,
        cfg)
    b = boxes_stu.shape[0]
    return (box_l.sum() + cls_l.sum() + iou_l.sum()) / b, dir_l.sum() / b


# ---------------------------------------------------------------------------
# full head loss
# ---------------------------------------------------------------------------


class LossConfig(NamedTuple):
    cls_loss_weight: float = 1.0
    loc_loss_weight: float = 2.0
    dir_loss_weight: float = 0.2
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_sigma: float = 3.0
    direction_offset: float = 0.0
    max_positive_anchors: int = 256
    # regression term of the total: "odiou" (SE-SSD, mg_head_sessd.py:781)
    # or "smooth_l1" (the CIA-SSD head, mg_head.py:616-627)
    reg_loss: str = "odiou"
    consistency: ConsistencyConfig = ConsistencyConfig()


def detection_loss(preds, batch, cfg: LossConfig = LossConfig(),
                   labels_key="labels", reg_targets_key="reg_targets",
                   include_odiou: bool = True):
    """Supervised SE-SSD loss for one task head (mg_head_sessd.py:706-808):
    total = focal cls + ODIoU reg + dir + IoU prediction; the sin-encoded
    SmoothL1 loc loss is a metric (the total of ``reg_loss="smooth_l1"``).

    preds: dict of [B, A, .] (any float dtype; the loss runs in f32);
    batch: anchors [B, A, 7], labels [B, A], reg_targets [B, A, 7].
    Returns (total, metrics dict of scalars)."""
    preds = {k: v.float() for k, v in preds.items()}
    anchors = batch["anchors"]
    labels = batch[labels_key]
    reg_targets = batch[reg_targets_key]
    b = labels.shape[0]

    cls_w, reg_w, cared = prepare_loss_weights(labels)
    box_preds, cls_preds = preds["box_preds"], preds["cls_preds"]

    # background-as-zeros class targets (mg_head_sessd.py:735-737)
    num_class = cls_preds.shape[-1]
    if num_class == 1:
        cls_targets = (labels * cared).float()[..., None]
    else:
        cls_targets = F.one_hot((labels * cared).long(),
                                num_class + 1).float()[..., 1:]
    cls_loss = sigmoid_focal_loss(cls_preds, cls_targets, cls_w,
                                  cfg.focal_alpha, cfg.focal_gamma)
    cls_loss_reduced = cfg.cls_loss_weight * cls_loss.sum() / b

    ebp, ert = box_torch.add_sin_difference(box_preds, reg_targets)
    loc_loss = weighted_smooth_l1(ebp, ert, reg_w, cfg.smooth_l1_sigma)
    loc_loss_reduced = cfg.loc_loss_weight * loc_loss.sum() / b

    dir_targets = get_direction_target(anchors, reg_targets,
                                       cfg.direction_offset)
    dw = (labels > 0).float()
    dw = dw / torch.clamp_min(dw.sum(dim=-1, keepdim=True), 1.0)
    dir_loss = softmax_ce_loss(preds["dir_cls_preds"], dir_targets, dw)
    dir_loss_reduced = cfg.dir_loss_weight * dir_loss.sum() / b

    # positives gathered to fixed K for the rotated-geometry terms
    pos_idx, pos_mask = gather_positives(labels, cfg.max_positive_anchors)
    pos_anchors = take(anchors, pos_idx)
    pos_w = take(reg_w, pos_idx) * pos_mask
    qboxes = _bound(_decode_bounded(take(box_preds, pos_idx), pos_anchors))
    gboxes = box_torch.second_box_decode(take(reg_targets, pos_idx),
                                         pos_anchors)

    # IoU prediction head: targets 2*iou3d - 1 (no gradient), smooth-L1
    with torch.no_grad():
        iou_t = clip(iou_3d(qboxes, gboxes), 0.0, 1.0)
    iou_targets = (2.0 * iou_t - 1.0)[..., None]
    iou_pred_loss = weighted_smooth_l1(take(preds["iou_preds"], pos_idx),
                                       iou_targets, pos_w).sum() / b

    if include_odiou:
        ious_loss = 2.0 * (odiou_3d(gboxes, qboxes) * pos_w).sum() / b
    else:
        ious_loss = cls_loss_reduced.new_zeros(())

    reg_term = ious_loss if cfg.reg_loss == "odiou" else loc_loss_reduced
    total = cls_loss_reduced + reg_term + dir_loss_reduced + iou_pred_loss

    cls_loss_anchor = cls_loss.sum(dim=-1)
    metrics = {
        "cls_loss_reduced": cls_loss_reduced,
        "loc_loss_reduced": loc_loss_reduced,
        "dir_loss_reduced": dir_loss_reduced,
        "iou_pred_loss": iou_pred_loss,
        "ious_loss": ious_loss,
        "cls_pos_loss": ((labels > 0).float() * cls_loss_anchor).sum() / b,
        "cls_neg_loss": ((labels == 0).float() * cls_loss_anchor).sum() / b,
        "num_pos": (labels > 0).sum() / b,
        "num_neg": (labels == 0).sum() / b,
    }
    return total, metrics
