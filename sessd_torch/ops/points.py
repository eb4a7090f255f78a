"""Point-set utilities (port of ``sessd_tpu/ops/points.py``): the points_op
CPU extension's pts_in_boxes3d, points_to_bev_kernel and
points_bound_kernel as torch on the points' device. No SE-SSD path calls
them."""
from __future__ import annotations

import torch


def points_in_boxes3d(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[P, >=3] x [R, 7] gravity-center boxes -> bool [P, R]
    (points_op.pts_in_boxes3d)."""
    shifted = points[:, None, :3] - boxes[None, :, :3]
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    lx = shifted[..., 0] * c[None] - shifted[..., 1] * s[None]
    ly = shifted[..., 0] * s[None] + shifted[..., 1] * c[None]
    half = boxes[:, 3:6] * 0.5
    return ((lx.abs() <= half[None, :, 0]) & (ly.abs() <= half[None, :, 1])
            & (shifted[..., 2].abs() <= half[None, :, 2]))


def points_to_bev(points: torch.Tensor, pc_range, bev_shape,
                  with_intensity: bool = True) -> torch.Tensor:
    """Rasterize points into a BEV height/intensity map
    (points_op.points_to_bev_kernel). bev_shape (ny, nx) -> [ny, nx, 2]:
    the max height and the max intensity per cell (zeros where empty)."""
    ny, nx = bev_shape
    x0, y0, z0, x1, y1, z1 = pc_range
    xi = torch.floor((points[:, 0] - x0) / (x1 - x0) * nx).long()
    yi = torch.floor((points[:, 1] - y0) / (y1 - y0) * ny).long()
    ok = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
          & (points[:, 2] >= z0) & (points[:, 2] <= z1))
    flat = torch.where(ok, yi * nx + xi, ny * nx)
    hmap = points.new_full((ny * nx + 1,), -torch.inf).scatter_reduce(
        0, flat, torch.where(ok, points[:, 2], -torch.inf), "amax")
    h = hmap[:-1]
    out = [torch.where(torch.isfinite(h), h, 0.0).reshape(ny, nx)]
    if with_intensity and points.shape[1] > 3:
        imap = points.new_zeros(ny * nx + 1).scatter_reduce(
            0, flat, torch.where(ok, points[:, 3], 0.0), "amax")
        out.append(imap[:-1].reshape(ny, nx))
    return torch.stack(out, dim=-1)


def points_bound_filter(points: torch.Tensor, pc_range) -> torch.Tensor:
    """bool [P] mask of points inside the range (points_bound_kernel)."""
    x0, y0, z0, x1, y1, z1 = pc_range
    return ((points[:, 0] >= x0) & (points[:, 0] < x1)
            & (points[:, 1] >= y0) & (points[:, 1] < y1)
            & (points[:, 2] >= z0) & (points[:, 2] < z1))
