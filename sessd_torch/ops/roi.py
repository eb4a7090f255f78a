"""RoI operators for two-stage detectors (port of ``sessd_tpu/ops/roi.py``;
the reference's roipool3d, rroi_align and box2d_iou_rotated CUDA
extensions) in plain torch. No SE-SSD path calls them."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..core.rotated_iou import iou_bev_matrix
from .correlation import _bilinear


def box2d_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[N, 5] x [M, 5] (cx, cy, w, h, angle) rotated IoU matrix (the
    detectron2-style ops/box2d_iou_rotated)."""
    return iou_bev_matrix(boxes1, boxes2)


def roipool3d(points: torch.Tensor, point_feats: torch.Tensor,
              boxes: torch.Tensor, num_sampled: int, extra_w: float = 0.0):
    """Rotated 3D RoI pooling (ops/roipool3d): per box up to
    ``num_sampled`` member points (xyz + features), the first points first,
    zero-padded. points [P, 3], point_feats [P, C], boxes [R, 7] gravity
    center -> (pooled [R, num_sampled, 3+C], empty [R] bool)."""
    shifted = points[None, :, :] - boxes[:, None, :3]  # [R, P, 3]
    c, s = torch.cos(boxes[:, 6:7]), torch.sin(boxes[:, 6:7])
    lx = shifted[..., 0] * c + shifted[..., 1] * s
    ly = -shifted[..., 0] * s + shifted[..., 1] * c
    half = boxes[:, 3:6] * 0.5 + extra_w
    inside = ((lx.abs() <= half[:, 0:1]) & (ly.abs() <= half[:, 1:2])
              & (shifted[..., 2].abs() <= half[:, 2:3]))  # [R, P]
    p = points.shape[0]
    k = min(num_sampled, p)
    # members first, in point order: score = inside * (p - index)
    rank = torch.arange(p, 0, -1, device=points.device, dtype=torch.float32)
    _, idx = torch.topk(inside.float() * rank, k, dim=1)
    member = torch.gather(inside, 1, idx)
    pooled = torch.cat([points, point_feats], -1)[idx]  # [R, k, 3+C]
    pooled = torch.where(member[..., None], pooled, 0.0)
    if k < num_sampled:
        pooled = F.pad(pooled, (0, 0, 0, num_sampled - k))
    return pooled, ~inside.any(dim=1)


def rotated_roi_align(feature_map: torch.Tensor, rois: torch.Tensor,
                      out_size=(7, 7), spatial_scale: float = 1.0,
                      samples: int = 2) -> torch.Tensor:
    """Rotated RoIAlign on a BEV map (ops/rroi_align): feature_map [H, W,
    C], rois [R, 5] (cx, cy, w, h, angle) -> [R, oh, ow, C], each bin the
    mean of samples^2 bilinear samples on the rotated grid (zero outside
    the map). Differentiable."""
    h, w, c = feature_map.shape
    oh, ow = out_size
    r = rois.shape[0]
    dev, dt = feature_map.device, feature_map.dtype
    ys = (torch.arange(oh * samples, device=dev, dtype=dt) + 0.5) \
        / (oh * samples) - 0.5
    xs = (torch.arange(ow * samples, device=dev, dtype=dt) + 0.5) \
        / (ow * samples) - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")

    cx, cy = rois[:, 0] * spatial_scale, rois[:, 1] * spatial_scale
    rw, rh = rois[:, 2] * spatial_scale, rois[:, 3] * spatial_scale
    ca, sa = torch.cos(rois[:, 4]), torch.sin(rois[:, 4])
    lx = gx[None] * rw[:, None, None]
    ly = gy[None] * rh[:, None, None]
    px = lx * ca[:, None, None] - ly * sa[:, None, None] + cx[:, None, None]
    py = lx * sa[:, None, None] + ly * ca[:, None, None] + cy[:, None, None]
    v = _bilinear(feature_map, py, px)
    inb = ((px >= -1) & (px <= w) & (py >= -1) & (py <= h))[..., None]
    v = torch.where(inb, v, 0.0)
    return v.reshape(r, oh, samples, ow, samples, c).mean(dim=(2, 4))
