"""The plain reference's detections of one scene, written from det3d's
``MultiGroupHead.predict`` (mg_head_sessd.py:893-1057) and its rotated
NMS (det3d/ops/nms): decode every anchor; score = sigmoid of the best
class; keep the anchors scoring at least the threshold; rectify the score
by ((IoU prediction + 1) / 2, within [0, 1]) to the 4th; visit the kept
anchors by rectified score, highest first, at most ``pre`` of them, and
keep each that no kept box overlaps by a BEV IoU over the threshold, at
most ``post``; turn a box by pi where its angle's sign disagrees with the
direction classifier; and mark valid the boxes with centers in the range.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import boxes as bx


def detections(head: dict, anchors: torch.Tensor, cfg: dict) -> dict:
    """head: one scene's [A, .] outputs; anchors [A, 7]. Returns the kept
    boxes in NMS order: ``boxes`` [K, 7], ``scores`` [K], ``valid`` [K]
    (the center in the range)."""
    box = bx.decode(head["box_preds"].float(), anchors)
    score = torch.sigmoid(head["cls_preds"].float()).max(-1).values
    cand = torch.nonzero(score >= cfg["score_threshold"])[:, 0]
    rect = ((head["iou_preds"][cand, 0].float() + 1) / 2).clamp(0.0, 1.0)
    s = score[cand] * rect ** 4
    order = torch.argsort(s, descending=True, stable=True)[:cfg["pre"]]
    cand, s = cand[order], s[order]
    iou = bx.iou_bev_matrix(box[cand], box[cand]).cpu().numpy()
    keep = []
    gone = np.zeros(len(cand), bool)
    for i in range(len(cand)):
        if gone[i]:
            continue
        keep.append(i)
        if len(keep) == cfg["post"]:
            break
        gone |= iou[i] > cfg["iou_threshold"]
    keep = torch.tensor(keep, dtype=torch.long, device=box.device)
    out = box[cand[keep]].clone()
    if cfg["use_dir"]:
        d = head["dir_cls_preds"][cand[keep]].float().argmax(-1)
        flip = ((out[:, 6] - cfg["dir_offset"]) > 0) != (d == 1)
        out[:, 6] = out[:, 6] + flip.float() * math.pi
    pcr = torch.tensor(cfg["post_center_range"], dtype=out.dtype,
                       device=out.device)
    valid = ((out[:, :3] >= pcr[:3]).all(-1)
             & (out[:, :3] <= pcr[3:]).all(-1))
    return {"boxes": out, "scores": s[keep], "valid": valid}
