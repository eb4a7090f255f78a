"""Box math in PyTorch (port of the serving half of
``sessd_tpu/core/box_jax.py``).

Boxes are ``[x, y, z, w, l, h, ry]`` gravity-center lidar boxes; corner and
rotation conventions match the reference (det3d box_np_ops.py:267-446).
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
