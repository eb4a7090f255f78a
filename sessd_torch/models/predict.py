"""Inference decode path (port of ``sessd_tpu/models/predict.py``; reference
``MultiGroupHead.predict`` / ``get_task_detections``,
mg_head_sessd.py:893-1057):

    sigmoid score threshold (0.3)
    -> IoU-aware confidence rectification: score *= ((iou_pred+1)/2)^4
    -> rotated NMS (pre 1000 / post 100 / IoU 0.01), or with
       ``nms_type="rotate_weighted_nms"`` DI-NMS on the raw IoU predictions
    -> camera-frustum cull (evaluation; serving passes no frustum)
    -> direction-classifier heading flip by pi
    -> post_center_range mask

Every stage ANDs into a validity mask over a fixed [max_det] buffer.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core import box_torch
from ..core.nms import rotate_nms, rotate_weighted_nms
from ..utils.profiling import count, span


class PredictConfig(NamedTuple):
    score_threshold: float = 0.3
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 100
    # two-level NMS capacity: when every sample in the batch has at most
    # this many above-threshold boxes, the exact small path runs NMS at this
    # capacity instead of nms_pre_max_size. 0 disables.
    nms_pre_small: int = 256
    nms_iou_threshold: float = 0.01
    iou_rectify_pow: float = 4.0
    post_center_range: tuple = (0.0, -40.0, -5.0, 70.4, 40.0, 5.0)
    use_dir_classifier: bool = True
    direction_offset: float = 0.0
    # "rotate_nms" or "rotate_weighted_nms" (the CIA-SSD DI-NMS decode mode
    # kept in SE-SSD, mg_head_sessd.py:999-1022)
    nms_type: str = "rotate_nms"


def points_in_frustum(points: torch.Tensor,
                      surfaces: torch.Tensor) -> torch.Tensor:
    """[N, 3] points vs [S, 4, 3] convex-polyhedron surfaces -> [N] bool
    (sessd_tpu/models/predict.py:47-59; geometry.py:215-278 of the
    reference): inside iff strictly below every surface plane, the normal
    taken from the first three vertices."""
    sv0 = surfaces[:, 0, :] - surfaces[:, 1, :]
    sv1 = surfaces[:, 1, :] - surfaces[:, 2, :]
    normal = torch.linalg.cross(sv0, sv1)  # [S, 3]
    d = (normal * surfaces[:, 0, :]).sum(dim=-1)  # [S]
    sign = points @ normal.T - d[None, :]  # [N, S]
    return ~(sign >= 0).any(dim=-1)


def predict_single(preds: dict, anchors: torch.Tensor, cfg: PredictConfig,
                   frustum_surfaces: Optional[torch.Tensor] = None) -> dict:
    """One sample: preds dict of [A, .] f32 tensors, anchors [A, 7],
    frustum_surfaces [6, 4, 3] or None -> dict(box3d_lidar [D, 7],
    scores [D], label_preds [D], valid [D])."""
    boxes = box_torch.second_box_decode(preds["box_preds"], anchors)
    # per-anchor best class; class-agnostic NMS follows
    scores_all = torch.sigmoid(preds["cls_preds"])
    scores, top_labels = scores_all.max(dim=-1)

    keep = scores >= cfg.score_threshold
    iou_r = ((preds["iou_preds"][..., 0] + 1.0) * 0.5).clamp(0.0, 1.0)
    scores = scores * torch.pow(iou_r, cfg.iou_rectify_pow)
    nms_scores = torch.where(keep, scores, -torch.inf)

    boxes5 = boxes[:, box_torch.BEV5_COLUMNS]
    if cfg.nms_type == "rotate_weighted_nms":
        # the reference's call (mg_head_sessd.py:1001-1018): raw iou_preds,
        # before rectification, and the per-box anchors
        out_boxes, dir_labels, out_labels, out_scores, valid = \
            rotate_weighted_nms(
                boxes, boxes5, preds["dir_cls_preds"].argmax(dim=-1),
                top_labels, nms_scores, preds["iou_preds"][..., 0], anchors,
                pre_max_size=cfg.nms_pre_max_size,
                post_max_size=cfg.nms_post_max_size,
                iou_threshold=cfg.nms_iou_threshold)
    else:
        sel, valid = rotate_nms(boxes5, nms_scores,
                                pre_max_size=cfg.nms_pre_max_size,
                                post_max_size=cfg.nms_post_max_size,
                                iou_threshold=cfg.nms_iou_threshold)
        out_boxes, out_scores, out_labels = boxes[sel], scores[sel], \
            top_labels[sel]
        dir_labels = None
    if frustum_surfaces is not None:
        valid = valid & points_in_frustum(out_boxes[:, :3], frustum_surfaces)

    if cfg.use_dir_classifier:
        # kept exactly as the JAX package has it (predict.py:118-122)
        if dir_labels is None:
            dir_labels = preds["dir_cls_preds"].argmax(dim=-1)[sel]
        opp = ((out_boxes[:, 6] - cfg.direction_offset) > 0) ^ (
            dir_labels == 1)
        out_boxes[:, 6] += torch.where(opp, math.pi, 0.0)  # a gathered copy

    pcr = torch.tensor(cfg.post_center_range, dtype=out_boxes.dtype,
                       device=out_boxes.device)
    in_range = ((out_boxes[:, :3] >= pcr[:3]).all(dim=-1)
                & (out_boxes[:, :3] <= pcr[3:]).all(dim=-1))
    valid = valid & in_range
    return {
        "box3d_lidar": torch.where(valid[:, None], out_boxes, 0.0),
        "scores": torch.where(valid, out_scores, 0.0),
        "label_preds": torch.where(valid, out_labels, 0),
        "valid": valid,
    }


def predict_batch(preds: dict, anchors: torch.Tensor,
                  cfg: PredictConfig = PredictConfig(),
                  frustum_surfaces: Optional[torch.Tensor] = None) -> dict:
    """preds: task-0 dict of [B, A, .] f32 tensors; anchors [A, 7] or
    [B, A, 7]; frustum_surfaces [B, 6, 4, 3] (evaluation) or None
    (serving). Returns the predict_single dict stacked over the batch.

    Two-level NMS (``rotate_nms`` only; DI-NMS always runs at
    ``nms_pre_max_size``): when no sample has more than ``nms_pre_small``
    boxes above the score threshold, top-k at that capacity already holds
    every candidate the full path would consider, so the small path is
    exact.
    """
    b, n_anchors = preds["box_preds"].shape[:2]
    if anchors.dim() == 2:
        anchors = anchors.expand(b, *anchors.shape)
    small = cfg.nms_pre_small
    path = "nms_full"
    if (cfg.nms_type == "rotate_nms" and small
            and small < min(cfg.nms_pre_max_size, n_anchors)):
        counts = (torch.sigmoid(preds["cls_preds"]).amax(dim=-1)
                  >= cfg.score_threshold).sum(dim=-1)
        with span("predict.sync"):
            count("host_sync")
            most = int(counts.max())
        if most <= small:
            cfg = cfg._replace(nms_pre_max_size=small)
            path = "nms_small"
    count(path)
    with span("predict.scenes"):
        outs = [predict_single({k: v[i] for k, v in preds.items()},
                               anchors[i], cfg, None if frustum_surfaces
                               is None else frustum_surfaces[i])
                for i in range(b)]
    with span("predict.stack"):
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
