"""Rotated BEV overlap / IoU (port of ``sessd_tpu/core/rotated_iou.py``).

The intersection area comes from Green's theorem over clipped edges: the
boundary of A∩B is the union of A-edge parts inside B and B-edge parts
inside A; each part is a parameter interval found by clipping against four
half-planes, and its 0.5*cross(u, v) line-integral contributions sum to the
area. Pure elementwise math with no sort, kept as it is in the JAX package.
Bounds are taken with ``torch.maximum``/``minimum``, which split the gradient
at ties as JAX's do.

Everything broadcasts: ``overlap_bev(a[..., 5], b[..., 5]) -> [...]``.
The 3D functions take full ``[..., 7]`` boxes.
"""
from __future__ import annotations

import torch

from .box_torch import BEV5_COLUMNS, bev_corners, clip

_EPS = 1e-8


def _as_bev5(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> [..., 5] (x, y, w, l, r); [..., 5] passes through."""
    return boxes[..., BEV5_COLUMNS] if boxes.shape[-1] == 7 else boxes


def _clip_edge_contributions(pa: torch.Tensor, qa: torch.Tensor,
                             own_boundary: bool) -> torch.Tensor:
    """Green's-theorem contribution of polygon P's edges clipped by convex
    polygon Q (rotated_iou.py:35-69). pa, qa: [..., 4, 2] CCW corners.

    ``own_boundary``: whether P-edge segments lying exactly ON Q's boundary
    count as inside; exactly one of the two passes claims coincident edges.
    """
    a = pa
    d = torch.roll(pa, -1, dims=-2) - a
    q0 = qa[..., None, :, :]                                   # [..., 1, 4, 2]
    e = torch.roll(qa, -1, dims=-2)[..., None, :, :] - q0      # [..., 1, 4, 2]
    ax = a[..., :, None, :]                                    # [..., 4, 1, 2]
    dx = d[..., :, None, :]
    s0 = (e[..., 0] * (ax[..., 1] - q0[..., 1])
          - e[..., 1] * (ax[..., 0] - q0[..., 0]))
    sd = e[..., 0] * dx[..., 1] - e[..., 1] * dx[..., 0]        # [..., 4, 4]
    t_at0 = -s0 / torch.where(sd.abs() < _EPS, 1.0, sd)
    lo = torch.where(sd > _EPS, t_at0, 0.0)
    hi = torch.where(sd < -_EPS, t_at0, 1.0)
    tol = -1e-6 if own_boundary else 1e-6
    infeasible = (sd.abs() <= _EPS) & (s0 < tol)
    t0 = clip(lo.amax(dim=-1), 0.0, 1.0)                       # [..., 4]
    t1 = clip(hi.amin(dim=-1), 0.0, 1.0)
    ok = (t1 > t0) & ~infeasible.any(dim=-1)
    u = a + t0[..., None] * d
    v = a + t1[..., None] * d
    contrib = 0.5 * (u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0])
    return torch.where(ok, contrib, 0.0).sum(dim=-1)


def overlap_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated BEV boxes; broadcasts over leading dims.
    boxes: [..., 5] (x, y, w, l, r) or [..., 7]."""
    # bev_corners yields clockwise rings; reverse to CCW for positive areas
    c1 = torch.flip(bev_corners(_as_bev5(boxes1)), dims=[-2])
    c2 = torch.flip(bev_corners(_as_bev5(boxes2)), dims=[-2])
    area = (_clip_edge_contributions(c1, c2, own_boundary=True)
            + _clip_edge_contributions(c2, c1, own_boundary=False))
    return torch.maximum(area, area.new_zeros(()))


def iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU; broadcasts."""
    b1, b2 = _as_bev5(boxes1), _as_bev5(boxes2)
    inter = overlap_bev(b1, b2)
    a1 = b1[..., 2] * b1[..., 3]
    a2 = b2[..., 2] * b2[..., 3]
    union = a1 + a2 - inter
    return inter / torch.maximum(union, union.new_tensor(1e-7))


def iou_bev_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[N, .] x [M, .] -> [N, M] rotated BEV IoU."""
    return iou_bev(boxes1[:, None, :], boxes2[None, :, :])


def overlap_height(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """z-extent overlap of gravity-center boxes [..., 7]; broadcasts."""
    zmax1 = boxes1[..., 2] + boxes1[..., 5] * 0.5
    zmin1 = boxes1[..., 2] - boxes1[..., 5] * 0.5
    zmax2 = boxes2[..., 2] + boxes2[..., 5] * 0.5
    zmin2 = boxes2[..., 2] - boxes2[..., 5] * 0.5
    h = torch.minimum(zmax1, zmax2) - torch.maximum(zmin1, zmin2)
    return torch.maximum(h, h.new_zeros(()))


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Rotated 3D IoU of [..., 7] boxes; broadcasts."""
    inter = overlap_bev(boxes1, boxes2) * overlap_height(boxes1, boxes2)
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    union = v1 + v2 - inter
    return inter / torch.maximum(union, union.new_tensor(1e-7))


def iou_3d_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[N, 7] x [M, 7] -> [N, M] rotated 3D IoU."""
    return iou_3d(boxes1[:, None, :], boxes2[None, :, :])
