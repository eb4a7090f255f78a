"""Orientation-aware Distance-IoU (ODIoU) in PyTorch (port of
``sessd_tpu/core/odiou.py``; reference det3d/models/losses/odious.py).

The whole loss is forward math and its gradient comes from autograd: the
rotated-BEV intersection of :mod:`.rotated_iou` is differentiable. Final
form (odious.py:845-900):

    odiou = 1 - IoU3d + ||c1-c2||^2 / diag3d^2 + 1.25 * (1 - |cos(dr)|)
    loss  = 2 * sum(odiou * weights) / batch_size

where diag3d^2 = (bounding-rect diag of the 8 BEV corners)^2 + (z-overlap
height)^2 + 1e-7. The geometry is non-smooth (rectangle choice, hull
edges): reductions, bounds and arg-selections follow JAX's tie rules
(``amax``/``amin`` and ``torch.maximum``/``minimum`` split the gradient
between equal values, ``argmin`` takes the first), so the gradient takes
the same branch as the JAX package's.
"""
from __future__ import annotations

import math

import torch

from .box_torch import bev_corners, clip
from .rotated_iou import overlap_bev, overlap_height


def _rect_diag(points: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
               allowed=None) -> torch.Tensor:
    """Diagonal of the min-area one among the bounding rectangles of
    [..., P, 2] points rotated by each candidate angle (cos c, sin s:
    [..., C]); ``allowed`` [..., C] masks candidates."""
    px = points[..., None, :, 0]                 # [..., 1, P]
    py = points[..., None, :, 1]
    rx = px * c[..., :, None] + py * s[..., :, None]
    ry = -px * s[..., :, None] + py * c[..., :, None]
    w = rx.amax(dim=-1) - rx.amin(dim=-1)        # [..., C]
    h = ry.amax(dim=-1) - ry.amin(dim=-1)
    areas = w * h
    if allowed is not None:
        areas = torch.where(allowed, areas, torch.inf)
    best = areas.argmin(dim=-1, keepdim=True)
    bw = w.gather(-1, best)[..., 0]
    bh = h.gather(-1, best)[..., 0]
    return torch.sqrt(bw ** 2 + bh ** 2)


def min_area_rect_diag(points: torch.Tensor) -> torch.Tensor:
    """Diagonal of the minimum-area bounding rectangle of [..., P, 2]
    points: the best of the bounding boxes at every pairwise point-to-point
    direction (one of them is a hull edge, which is optimal)."""
    ii, jj = torch.triu_indices(points.shape[-2], points.shape[-2], 1,
                                device=points.device)
    d = points[..., jj, :] - points[..., ii, :]
    ang = torch.atan2(d[..., 1], d[..., 0])
    return _rect_diag(points, torch.cos(ang), torch.sin(ang))


def ref_mbr_diag(points: torch.Tensor) -> torch.Tensor:
    """The reference's bounding-rect diagonal of [..., P, 2] points
    (odious.py:597-648, as ``sessd_tpu.core.odiou.ref_mbr_diag`` emulates
    it): candidate directions are the convex-hull edges, each angle folded
    to ``abs(fmod(ang, pi/2))``, argmin area wins. All hull edges take part
    (the reference drops one, qhull-order dependent)."""
    p = points.shape[-2]
    ii, jj = (~torch.eye(p, dtype=torch.bool, device=points.device)).nonzero(
        as_tuple=True)                           # all ordered pairs i != j
    a = points[..., ii, :]                       # [..., C, 2]
    e = points[..., jj, :] - a                   # edge vectors
    # hull-edge test: every point left of (or on) the directed edge
    rel = points[..., None, :, :] - a[..., :, None, :]   # [..., C, P, 2]
    cross = e[..., None, 0] * rel[..., 1] - e[..., None, 1] * rel[..., 0]
    center = points.mean(dim=-2, keepdim=True)
    spread = ((points - center) ** 2).sum(dim=-1).amax(dim=-1)
    scale_sq = torch.maximum(spread, spread.new_tensor(1e-12))
    eps = 1e-5 * scale_sq[..., None]
    elen_sq = (e * e).sum(dim=-1)
    zero_e = elen_sq <= 1e-12 * scale_sq[..., None]
    is_edge = (cross >= -eps[..., None]).all(dim=-1) & ~zero_e
    # zero-length edges (duplicate points) are masked above; atan2's
    # gradient at (0, 0) is NaN, so they take a fixed direction
    ex = torch.where(zero_e, 1.0, e[..., 0])
    ey = torch.where(zero_e, 0.0, e[..., 1])
    ang = torch.abs(torch.fmod(torch.atan2(ey, ex), math.pi / 2))
    return _rect_diag(points, torch.cos(ang), torch.sin(ang), is_edge)


def odiou_3d(gboxes: torch.Tensor, qboxes: torch.Tensor) -> torch.Tensor:
    """Elementwise ODIoU distance of aligned [..., 7] box pairs; pairs with
    a non-positive dimension give 0."""
    indicator = ((gboxes[..., 3:6] > 0).all(dim=-1)
                 & (qboxes[..., 3:6] > 0).all(dim=-1))
    g = clip(gboxes, -200.0, 200.0)
    q = clip(qboxes, -200.0, 200.0)

    angle_factor = 1.25 * (1.0 - torch.abs(torch.cos(q[..., 6] - g[..., 6])))
    inter_h = overlap_height(g, q)
    vol_inter = overlap_bev(g, q) * inter_h
    vol_g = g[..., 3] * g[..., 4] * g[..., 5]
    vol_q = q[..., 3] * q[..., 4] * q[..., 5]
    union = vol_g + vol_q - vol_inter
    # clipped to [0, 1]: degenerate sliver boxes can push the clipper's
    # intersection past the union by float error (odiou.py:120-126)
    iou3d = clip(vol_inter / torch.maximum(union, union.new_tensor(1e-7)),
                 0.0, 1.0)

    center_dist_sq = ((g[..., :3] - q[..., :3]) ** 2).sum(dim=-1)
    corners = torch.cat([bev_corners(g), bev_corners(q)], dim=-2)
    # the reference combines the BEV diag with the intersection height, not
    # the union height (odious.py:880-886)
    diag3d_sq = ref_mbr_diag(corners) ** 2 + inter_h ** 2 + 1e-7
    od = 1.0 - iou3d + center_dist_sq / diag3d_sq + angle_factor
    return torch.where(indicator, od, 0.0)


def odiou_3d_loss(gboxes, qboxes, weights, batch_size) -> torch.Tensor:
    """Reduced ODIoU loss as odious.py:896-899: 2*sum(od*w)/batch."""
    return 2.0 * (odiou_3d(gboxes, qboxes) * weights).sum() / batch_size
