"""Temporal feature correlation and alignment (port of
``sessd_tpu/ops/correlation.py``; the reference's align_aggregation CUDA
extension): a cost volume and an offset-based bilinear warp, in plain
torch. No SE-SSD path calls them."""
from __future__ import annotations

import torch
from torch.nn import functional as F


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4,
                stride: int = 1) -> torch.Tensor:
    """Cost volume of two [H, W, C] maps: out[y, x, k] = <f1[y, x],
    f2[y+dy, x+dx]> / C for the k-th displacement (dy, dx) of the
    (2d+1)^2 window, row-major; zero out of bounds."""
    h, w, c = f1.shape
    d = max_displacement
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    outs = [(f1 * f2p[d + dy:d + dy + h, d + dx:d + dx + w]).sum(-1) / c
            for dy in range(-d, d + 1, stride)
            for dx in range(-d, d + 1, stride)]
    return torch.stack(outs, dim=-1)


def _bilinear(feature: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """Bilinear samples of [H, W, C] at (py, px), edge-clamped corners."""
    h, w, _ = feature.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    dy, dx = py - y0, px - x0

    def at(yy, xx):
        return feature[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]

    return (at(y0, x0) * ((1 - dy) * (1 - dx))[..., None]
            + at(y0, x0 + 1) * ((1 - dy) * dx)[..., None]
            + at(y0 + 1, x0) * (dy * (1 - dx))[..., None]
            + at(y0 + 1, x0 + 1) * (dy * dx)[..., None])


def align_feature(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of an [H, W, C] map by a per-pixel [H, W, 2] (dy, dx)
    flow (the align_feature op); zero where the sample leaves the map.
    Differentiable in both."""
    h, w, _ = feature.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=feature.device),
                            torch.arange(w, device=feature.device),
                            indexing="ij")
    py, px = gy + flow[..., 0], gx + flow[..., 1]
    out = _bilinear(feature, py, px)
    inb = ((py >= 0) & (py <= h - 1) & (px >= 0) & (px <= w - 1))[..., None]
    return torch.where(inb, out, 0.0)
