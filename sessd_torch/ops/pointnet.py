"""PointNet++ point-set operators (port of ``sessd_tpu/ops/pointnet.py``;
the reference's pointnet2 CUDA extension, det3d/ops/pointnet2/src/*):
farthest point sampling, ball query, grouping and 3-NN interpolation, in
plain torch at fixed shapes. No SE-SSD path calls them."""
from __future__ import annotations

from typing import Optional

import torch


def farthest_point_sample(xyz: torch.Tensor, num_samples: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, 3] (+ valid mask) -> [num_samples] int64 indices, greedy FPS
    from index 0 (the first valid point with a mask): each step picks the
    point farthest from the picked set (pointnet2's
    furthest_point_sampling)."""
    d = xyz.new_full((xyz.shape[0],), 1e10)
    if mask is not None:
        d = torch.where(mask, d, -1.0)
    sel = torch.zeros(num_samples, dtype=torch.long, device=xyz.device)
    if mask is not None:
        sel[0] = torch.argmax(mask.int())
    for i in range(1, num_samples):
        dist = ((xyz - xyz[sel[i - 1]]) ** 2).sum(-1)
        if mask is not None:
            dist = torch.where(mask, dist, -1.0)
        d = torch.minimum(d, dist)
        sel[i] = torch.argmax(d)
    return sel


def ball_query(centers: torch.Tensor, xyz: torch.Tensor, radius: float,
               num_neighbors: int, mask: Optional[torch.Tensor] = None):
    """[M, 3] centers vs [N, 3] points -> ([M, K] indices, [M, K] valid):
    up to K hits within ``radius``, lowest indices first; a short row
    repeats its first hit, a center with no hit gets an all-invalid row
    (pointnet2 semantics)."""
    d2 = ((centers[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    ok = d2 <= radius * radius
    if mask is not None:
        ok = ok & mask[None, :]
    n = xyz.shape[0]
    idx = torch.arange(n, device=xyz.device)[None, :]
    order = torch.sort(torch.where(ok, idx, n), dim=-1).values
    order = order[:, :num_neighbors]
    has = order < n
    first = torch.where(has[:, :1], order[:, :1], 0)
    return torch.where(has, order, first), has[:, :1].expand_as(has)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, C] features gathered by [M, K] indices -> [M, K, C]."""
    return features[idx]


def three_nn(query: torch.Tensor, support: torch.Tensor,
             support_mask: Optional[torch.Tensor] = None):
    """[M, 3] vs [N, 3] -> ([M, 3] distances, [M, 3] indices) of the three
    nearest, nearest first."""
    d2 = ((query[:, None, :] - support[None, :, :]) ** 2).sum(-1)
    if support_mask is not None:
        d2 = torch.where(support_mask[None, :], d2, torch.inf)
    neg, idx = torch.topk(-d2, 3, dim=-1)
    return torch.sqrt(torch.clamp(-neg, min=0.0)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dists: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance-weighted interpolation: [N, C] -> [M, C]."""
    w = 1.0 / torch.clamp(dists * dists, min=eps)
    w = w / w.sum(-1, keepdim=True)
    return torch.einsum("mk,mkc->mc", w, features[idx])
