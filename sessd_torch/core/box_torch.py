"""Box math in PyTorch (port of ``sessd_tpu/core/box_jax.py``).

Boxes are ``[x, y, z, w, l, h, ry]`` gravity-center lidar boxes; corner and
rotation conventions match the reference (det3d box_np_ops.py:267-446).
Everything is differentiable and broadcasts over leading dims.
"""
from __future__ import annotations

import torch

# [..., 7] box columns of the BEV view (x, y, w, l, r)
BEV5_COLUMNS = [0, 1, 3, 4, 6]

# clockwise corner layout, matching box_np_ops.py:288-289
_CORNERS2D = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


def bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] (or [..., 5] = x,y,w,l,r) boxes -> [..., 4, 2] BEV corners."""
    if boxes.shape[-1] == 7:
        xy, wl, r = boxes[..., :2], boxes[..., 3:5], boxes[..., 6]
    else:
        xy, wl, r = boxes[..., :2], boxes[..., 2:4], boxes[..., 4]
    unit = torch.tensor(_CORNERS2D, dtype=boxes.dtype, device=boxes.device)
    local = wl[..., None, :] * unit  # [..., 4, 2]
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    gx = local[..., 0] * c + local[..., 1] * s
    gy = -local[..., 0] * s + local[..., 1] * c
    return torch.stack([gx, gy], dim=-1) + xy[..., None, :]


def second_box_decode(encodings: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """SECOND anchor-offset decoding (box_torch_ops.py:83-150)."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
    xt, yt, zt, wt, lt, ht, rt = torch.split(encodings, 1, dim=-1)
    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    return torch.cat([
        xt * diagonal + xa,
        yt * diagonal + ya,
        zt * ha + za,
        torch.exp(wt) * wa,
        torch.exp(lt) * la,
        torch.exp(ht) * ha,
        rt + ra,
    ], dim=-1)


def second_box_encode(boxes: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """SECOND anchor-offset encoding (box_torch_ops.py:23-80)."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
    xg, yg, zg, wg, lg, hg, rg = torch.split(boxes, 1, dim=-1)
    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    return torch.cat([
        (xg - xa) / diagonal,
        (yg - ya) / diagonal,
        (zg - za) / ha,
        torch.log(wg / wa),
        torch.log(lg / la),
        torch.log(hg / ha),
        rg - ra,
    ], dim=-1)


def add_sin_difference(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Replace the angle channel with the sin-difference encoding:
    ry1 -> sin(ry1)cos(ry2), ry2 -> cos(ry1)sin(ry2)
    (mg_head_sessd.py:39-44), so SmoothL1(enc1 - enc2) penalises
    sin(ry1 - ry2)."""
    rad1 = torch.sin(boxes1[..., -1:]) * torch.cos(boxes2[..., -1:])
    rad2 = torch.cos(boxes1[..., -1:]) * torch.sin(boxes2[..., -1:])
    return (torch.cat([boxes1[..., :-1], rad1], dim=-1),
            torch.cat([boxes2[..., :-1], rad2], dim=-1))


def rotation_points_z(points: torch.Tensor, angle) -> torch.Tensor:
    """Rotate [..., 3] points about z by ``angle`` (broadcasting against
    points[..., 0]): out = p @ Rz^T, the reference convention
    (box_torch_ops.py:331-336)."""
    angle = torch.as_tensor(angle, dtype=points.dtype, device=points.device)
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[..., 0] * c + points[..., 1] * s
    y = -points[..., 0] * s + points[..., 1] * c
    return torch.stack([x, y, points[..., 2]], dim=-1)


def corner_to_standup_bev(corners: torch.Tensor) -> torch.Tensor:
    """[..., 4, 2] corners -> [..., 4] (x1, y1, x2, y2)."""
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, so a value exactly on a bound
    passes half its gradient, as JAX's balanced max/min do (``clamp``
    passes all of it)."""
    x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    return torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                            device=x.device))
