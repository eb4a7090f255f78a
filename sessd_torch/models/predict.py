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

CenterPoint's center head decodes otherwise (``predict_center_batch``,
center_head.py's ``predict`` / ``post_processing``): score = sigmoid of
the heatmap's best class above the threshold, each BEV position's box from
its offset, height, log size and (sin, cos) heading, the post-center range
applied before NMS, then the same stable sort, rotated NMS pair and finish.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..core import box_torch
from ..core.nms import rotate_nms, rotate_weighted_nms, score_order
from ..ops.cuda.nms import rotated_nms
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
    # a center head's output grid (H, W, x step, y step, x origin, y
    # origin) in m: position (y, x) + its offset, times the step, plus the
    # origin; empty for an anchor head
    center: tuple = ()


def points_in_frustum(points: torch.Tensor,
                      surfaces: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] points vs [..., S, 4, 3] convex-polyhedron surfaces ->
    [..., N] bool
    (sessd_tpu/models/predict.py:47-59; geometry.py:215-278 of the
    reference): inside iff strictly below every surface plane, the normal
    taken from the first three vertices."""
    sv0 = surfaces[..., 0, :] - surfaces[..., 1, :]
    sv1 = surfaces[..., 1, :] - surfaces[..., 2, :]
    normal = torch.linalg.cross(sv0, sv1)  # [..., S, 3]
    d = (normal * surfaces[..., 0, :]).sum(dim=-1)  # [..., S]
    sign = points @ normal.transpose(-1, -2) - d[..., None, :]  # [..., N, S]
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

    ``rotate_nms`` runs once for the whole batch (``_predict_rotate_nms``),
    equal to ``predict_single`` scene by scene; DI-NMS, whose leader loop
    is another algorithm, runs ``predict_single`` per scene. With no
    ``anchors`` the outputs are a center head's (``predict_center_batch``).
    """
    if anchors is None:
        return predict_center_batch(preds, cfg)
    b, n_anchors = preds["box_preds"].shape[:2]
    if anchors.dim() == 2:
        anchors = anchors.expand(b, *anchors.shape)
    cfg = _nms_capacity(
        cfg, n_anchors, cfg.nms_type == "rotate_nms",
        lambda: (torch.sigmoid(preds["cls_preds"]).amax(dim=-1)
                 >= cfg.score_threshold).sum(dim=-1))
    if cfg.nms_type == "rotate_nms":
        return _predict_rotate_nms(preds, anchors, cfg, frustum_surfaces)
    with span("predict.dinms"):
        outs = [predict_single({k: v[i] for k, v in preds.items()},
                               anchors[i], cfg, None if frustum_surfaces
                               is None else frustum_surfaces[i])
                for i in range(b)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _nms_capacity(cfg: PredictConfig, n: int, two_level: bool,
                  counts) -> PredictConfig:
    """The NMS capacity of a batch: ``nms_pre_small`` where ``two_level``
    and no scene has more candidates than that (``counts()``, [B] on the
    device: one host read, ``host_sync``), else ``nms_pre_max_size``;
    counts the path taken (``nms_small`` / ``nms_full``)."""
    small = cfg.nms_pre_small
    path = "nms_full"
    if two_level and small and small < min(cfg.nms_pre_max_size, n):
        most_of = counts()
        with span("predict.sync"):
            count("host_sync")
            most = int(most_of.max())
        if most <= small:
            cfg = cfg._replace(nms_pre_max_size=small)
            path = "nms_small"
    count(path)
    return cfg


@functools.lru_cache(maxsize=8)
def _range_bounds(post_center_range: tuple, dtype, device) -> torch.Tensor:
    """post_center_range as a [6] tensor on the device, made once: a new
    host tensor per batch would copy to the card and wait for it."""
    return torch.tensor(post_center_range, dtype=dtype, device=device)


def _predict_rotate_nms(preds: dict, anchors: torch.Tensor,
                        cfg: PredictConfig,
                        frustum_surfaces: Optional[torch.Tensor]) -> dict:
    """predict_single's ``rotate_nms`` path over [B, A] at once: the same
    elementwise decode and scores, one stable sort, the batched NMS
    (``ops.cuda.nms.rotated_nms``: the kernel pair on the card, the
    per-scene twin on the CPU), and the finish over [B, post]. Only the
    ``pre`` rows the NMS visits are decoded (decoding is per anchor)."""
    with span("predict.decode"):
        scores_all = torch.sigmoid(preds["cls_preds"])
        scores, top_labels = scores_all.max(dim=-1)
        keep = scores >= cfg.score_threshold
        iou_r = ((preds["iou_preds"][..., 0] + 1.0) * 0.5).clamp(0.0, 1.0)
        scores = scores * torch.pow(iou_r, cfg.iou_rectify_pow)
        nms_scores = torch.where(keep, scores, -torch.inf)
        top, order = score_order(nms_scores, cfg.nms_pre_max_size)
        rows = order[..., None].expand(-1, -1, 7)
        boxes = box_torch.second_box_decode(
            preds["box_preds"].gather(1, rows), anchors.gather(1, rows))
    with span("predict.nms"):
        rank, valid = rotated_nms(boxes, top.contiguous(),
                                  cfg.nms_post_max_size,
                                  cfg.nms_iou_threshold)
    with span("predict.finish"):
        sel = order.gather(1, rank)
        out_boxes = boxes.gather(1, rank[..., None].expand(-1, -1, 7))
        out_scores = scores.gather(1, sel)
        out_labels = top_labels.gather(1, sel)
        if frustum_surfaces is not None:
            valid = valid & points_in_frustum(out_boxes[..., :3],
                                              frustum_surfaces)
        if cfg.use_dir_classifier:
            dir_cls = preds["dir_cls_preds"]
            dir_labels = dir_cls.gather(
                1, sel[..., None].expand(-1, -1, dir_cls.shape[-1])).argmax(
                    dim=-1)
            opp = ((out_boxes[..., 6] - cfg.direction_offset) > 0) ^ (
                dir_labels == 1)
            out_boxes[..., 6] += torch.where(opp, math.pi, 0.0)
        pcr = _range_bounds(tuple(cfg.post_center_range), out_boxes.dtype,
                            out_boxes.device)
        centers = out_boxes[..., :3]
        valid = valid & ((centers >= pcr[:3]).all(dim=-1)
                         & (centers <= pcr[3:]).all(dim=-1))
        return {
            "box3d_lidar": torch.where(valid[..., None], out_boxes, 0.0),
            "scores": torch.where(valid, out_scores, 0.0),
            "label_preds": torch.where(valid, out_labels, 0),
            "valid": valid,
        }


@functools.lru_cache(maxsize=8)
def _center_grid(center: tuple, device):
    """(positions [H*W, 2], step [2], origin [2]) of ``cfg.center`` on the
    device, made once: the (x, y) indices of the output grid in (y, x)
    order, and the grid's step and origin in m."""
    h, w, sx, sy, x0, y0 = center
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return (torch.stack([xs, ys], -1).reshape(h * w, 2).float(),
            torch.tensor((sx, sy), device=device),
            torch.tensor((x0, y0), device=device))


def predict_center_batch(preds: dict, cfg: PredictConfig) -> dict:
    """A center head's task-0 outputs [B, H*W, c] (``hm``, ``reg``,
    ``height``, ``dim``, ``rot``; f32) -> the ``predict_batch`` dict.

    As center_head.py decodes: score and label the heatmap's best class
    (sigmoid), kept above ``score_threshold`` (strictly) with the box
    center inside ``post_center_range``; centers (position + ``reg``) x
    step + origin (``cfg.center``), z the ``height``, sizes exp(``dim``),
    heading atan2(``rot``). Boxes come out in CenterPoint's layout (x, y,
    z, dx, dy, dz, heading); the NMS sees them in the port's BEV
    convention, whose angle turns the other way (r = -heading). Classes
    share one NMS. The kept candidates of each scene go through the
    anchor path's stable sort and kernel pair at ``nms_pre_max_size``, with
    no host read: the source has one capacity."""
    dev = preds["hm"].device
    count("nms_full")
    with span("predict.decode"):
        scores, labels = torch.sigmoid(preds["hm"]).max(dim=-1)
        pos, step, origin = _center_grid(tuple(cfg.center), dev)
        xy = (pos + preds["reg"]) * step + origin
        centers = torch.cat([xy, preds["height"]], -1)
        pcr = _range_bounds(tuple(cfg.post_center_range), centers.dtype, dev)
        keep = ((scores > cfg.score_threshold)
                & (centers >= pcr[:3]).all(dim=-1)
                & (centers <= pcr[3:]).all(dim=-1))
        top, order = score_order(torch.where(keep, scores, -torch.inf),
                                 cfg.nms_pre_max_size)

        def rows(key):
            v = preds[key]
            return v.gather(1, order[..., None].expand(-1, -1, v.shape[-1]))

        rot = rows("rot")
        boxes = torch.cat([centers.gather(1, order[..., None].expand(
                               -1, -1, 3)),
                           torch.exp(rows("dim")),
                           torch.atan2(rot[..., :1], rot[..., 1:2])], -1)
        bev = torch.cat([boxes[..., :6], -boxes[..., 6:]], -1)
    with span("predict.nms"):
        rank, valid = rotated_nms(bev, top.contiguous(),
                                  cfg.nms_post_max_size,
                                  cfg.nms_iou_threshold)
    with span("predict.finish"):
        sel = order.gather(1, rank)
        out_boxes = boxes.gather(1, rank[..., None].expand(-1, -1, 7))
        return {
            "box3d_lidar": torch.where(valid[..., None], out_boxes, 0.0),
            "scores": torch.where(valid, scores.gather(1, sel), 0.0),
            "label_preds": torch.where(valid, labels.gather(1, sel), 0),
            "valid": valid,
        }
