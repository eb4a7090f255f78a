"""The SE-SSD losses of the plain reference, written from det3d's
definitions (mg_head_sessd.py and losses of Vegeta2020/SE-SSD):

- supervised, per task head: sigmoid focal classification (alpha 0.25,
  gamma 2) over the cared anchors, normalised by the sample's positives;
  the ODIoU regression loss and the IoU-prediction loss (smooth-L1 of the
  prediction against 2 IoU3d - 1) over every positive anchor; the
  direction classifier's cross entropy over the positives; summed with
  their weights and divided by the batch;
- consistency, per sample: the student's and the teacher's decoded boxes
  scoring at least the threshold with centers in the range, at most
  ``top_k`` of each (the highest scores, the lower anchor first among
  equal ones); the teacher's through the student's flip, rotation and
  scale; each student box whose best BEV IoU with a teacher box passes
  0.7 matched to that box; smooth-L1 of the sin-coded boxes (over 7), of
  the scores and of the IoU predictions, averaged over the matches and
  divided by the batch.

Every step is written out per sample with boolean masks, in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from . import boxes as bx


def smooth_l1(x: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    return F.smooth_l1_loss(x, torch.zeros_like(x), reduction="none",
                            beta=1.0 / sigma ** 2)


def bounded_decode(enc: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Decoded predictions with the port's numeric guards, which bind only
    at extreme values: size codes within +-10, centers within +-200 m,
    sizes within [0.01, 30] m."""
    enc = torch.cat([enc[..., :3], enc[..., 3:6].clamp(-10.0, 10.0),
                     enc[..., 6:]], -1)
    b = bx.decode(enc, anchors)
    return torch.cat([b[..., :3].clamp(-200.0, 200.0),
                      b[..., 3:6].clamp(0.01, 30.0), b[..., 6:]], -1)


def detection_loss(preds: dict, labels: torch.Tensor, targets: torch.Tensor,
                   anchors: torch.Tensor, cfg: dict) -> torch.Tensor:
    """preds: [B, A, .] head outputs; labels [B, A] (-1 ignored, 0
    background, 1 car); targets [B, A, 7] codes; anchors [A, 7]."""
    b = labels.shape[0]
    total = anchors.new_zeros(())
    for i in range(b):
        lab, tgt = labels[i], targets[i]
        p = {k: v[i].float() for k, v in preds.items()}
        pos = lab > 0
        npos = max(int(pos.sum()), 1)
        cared = (lab >= 0).float()
        y = pos.float()[:, None]
        x = p["cls_preds"]
        ce = F.binary_cross_entropy_with_logits(x, y, reduction="none")
        prob = torch.sigmoid(x)
        p_t = y * prob + (1 - y) * (1 - prob)
        a_t = y * cfg["alpha"] + (1 - y) * (1 - cfg["alpha"])
        focal = a_t * (1 - p_t) ** cfg["gamma"] * ce * cared[:, None]
        total = total + cfg["cls_weight"] * focal.sum() / npos
        if not bool(pos.any()):
            continue
        anc = anchors[pos]
        gt = bx.decode(tgt[pos], anc)
        q = bounded_decode(p["box_preds"][pos], anc)
        od = bx.odiou(gt, q)
        total = total + cfg["odiou_weight"] * od.sum() / npos
        rot = tgt[pos, 6] + anc[:, 6]
        d = (rot - cfg["dir_offset"] > 0).long()
        ce_dir = F.cross_entropy(p["dir_cls_preds"][pos], d,
                                 reduction="none")
        total = total + cfg["dir_weight"] * ce_dir.sum() / npos
        with torch.no_grad():
            t_iou = 2.0 * bx.iou_3d(q, gt).clamp(0.0, 1.0) - 1.0
        total = total + smooth_l1(p["iou_preds"][pos, 0] - t_iou).sum() \
            / npos
    return total / b


def _selected(boxes, score, pcr, cfg):
    ok = ((score >= cfg["score_thresh"])
          & (boxes[:, :3] >= pcr[:3]).all(-1)
          & (boxes[:, :3] <= pcr[3:]).all(-1))
    idx = torch.nonzero(ok)[:, 0]
    if len(idx) > cfg["top_k"]:
        order = np.lexsort((idx.cpu().numpy(),
                            -score[idx].detach().cpu().double().numpy()))
        idx = idx[torch.from_numpy(order[:cfg["top_k"]]).to(idx.device)]
    return idx


def _teacher_frame(b: torch.Tensor, flipped: bool, rot: float,
                   scale: float) -> torch.Tensor:
    """Teacher boxes [K, 7] through the student's global augmentation:
    the flip about x, the rotation about z, the scale."""
    if flipped:
        b = torch.cat([b[:, :1], -b[:, 1:2], b[:, 2:6],
                       math.pi - b[:, 6:7]], -1)
    c, s = math.cos(rot), math.sin(rot)
    x = b[:, 0] * c + b[:, 1] * s
    y = b[:, 1] * c - b[:, 0] * s
    b = torch.cat([x[:, None], y[:, None], b[:, 2:6], b[:, 6:7] + rot], -1)
    return torch.cat([b[:, :6] * scale, b[:, 6:]], -1)


def consistency_loss(stu: dict, tea: dict, anchors: torch.Tensor,
                     transformation: dict, cfg: dict) -> torch.Tensor:
    """stu, tea: [B, A, .] head outputs; anchors [A, 7]; transformation:
    per sample ``flipped``, ``noise_rotation``, ``noise_scale``."""
    b = stu["cls_preds"].shape[0]
    pcr = torch.tensor(cfg["post_center_range"], dtype=torch.float32,
                       device=anchors.device)
    total = anchors.new_zeros(())
    for i in range(b):
        s = {k: v[i].float() for k, v in stu.items()}
        t = {k: v[i].float() for k, v in tea.items()}
        bs_all = bounded_decode(s["box_preds"], anchors)
        bt_all = bounded_decode(t["box_preds"], anchors)
        ss_all = torch.sigmoid(s["cls_preds"][:, 0])
        st_all = torch.sigmoid(t["cls_preds"][:, 0])
        i_s = _selected(bs_all, ss_all, pcr, cfg)
        i_t = _selected(bt_all, st_all, pcr, cfg)
        if len(i_s) == 0 or len(i_t) == 0:
            continue
        bt = _teacher_frame(bt_all[i_t],
                            bool(transformation["flipped"][i]),
                            float(transformation["noise_rotation"][i]),
                            float(transformation["noise_scale"][i]))
        bs = bs_all[i_s]
        with torch.no_grad():
            best, match = bx.iou_bev_matrix(bs, bt).max(1)
        m = best > cfg["iou_match"]
        if not bool(m.any()):
            continue
        n = int(m.sum())
        jt = i_t[match[m]]
        e1, e2 = bx.sin_pair(bs[m], bt[match[m]])
        box_l = smooth_l1(e1 - e2).sum() / 7.0 / n
        cls_l = smooth_l1(ss_all[i_s][m] - st_all[jt]).sum() / n
        iou_l = smooth_l1((s["iou_preds"][i_s][m, 0] + 1) / 2
                          - (t["iou_preds"][jt, 0] + 1) / 2).sum() / n
        total = total + box_l + cls_l + iou_l
    return total / b
