"""Anchor-grid generation (numpy, done once at pipeline build time).

Port of the reference's ranged anchor generator
(det3d/core/bbox/box_np_ops.py:780-834 ``create_anchors_3d_range`` via
anchor_generator.py:64-118). For the SE-SSD config: feature map [1, 200, 176],
sizes (w=1.6, l=3.9, h=1.56), rotations {0, pi/2}, z center -1.0 ->
anchors [1, 200, 176, 1, 2, 7], flattened row-major to [70400, 7] in
(z, y, x, size, rot) order, which matches how the head's [H, W, 2*7]
predictions flatten.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def create_anchors_3d_range(
    feature_size,  # [D, H, W] e.g. [1, 200, 176]
    anchor_range,  # [x0, y0, z0, x1, y1, z1]
    sizes=(1.6, 3.9, 1.56),
    rotations=(0.0, np.pi / 2),
    dtype=np.float32,
) -> np.ndarray:
    """Returns [D, H, W, num_sizes, num_rots, 7]."""
    anchor_range = np.asarray(anchor_range, dtype=dtype)
    d, h, w = feature_size
    # NOTE: the reference derives a single stride from the x extent and uses
    # it to center-offset both x and y (box_np_ops.py:801-804); for the KITTI
    # grid both strides are equal (0.4) so this is also the exact y offset.
    stride = (anchor_range[3] - anchor_range[0]) / w
    z_centers = np.linspace(anchor_range[2], anchor_range[5], d, dtype=dtype)
    y_centers = np.linspace(anchor_range[1], anchor_range[4], h, endpoint=False, dtype=dtype) + stride / 2
    x_centers = np.linspace(anchor_range[0], anchor_range[3], w, endpoint=False, dtype=dtype) + stride / 2
    sizes = np.reshape(np.asarray(sizes, dtype=dtype), [-1, 3])
    rotations = np.asarray(rotations, dtype=dtype)
    ns, nr = sizes.shape[0], rotations.shape[0]

    zz, yy, xx, rr = np.meshgrid(z_centers, y_centers, x_centers, rotations, indexing="ij")
    # -> [D, H, W, R]; broadcast against sizes axis
    out = np.zeros((d, h, w, ns, nr, 7), dtype=dtype)
    out[..., 0] = xx[:, :, :, None, :]
    out[..., 1] = yy[:, :, :, None, :]
    out[..., 2] = zz[:, :, :, None, :]
    out[..., 3:6] = sizes[None, None, None, :, None, :]
    out[..., 6] = rr[:, :, :, None, :]
    return out


@dataclass
class AnchorGeneratorRange:
    """One per class (anchor_generator.py:64-118)."""

    anchor_ranges: list
    sizes: tuple = (1.6, 3.9, 1.56)
    rotations: tuple = (0.0, np.pi / 2)
    class_name: str = "Car"
    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45

    def generate(self, feature_map_size) -> np.ndarray:
        return create_anchors_3d_range(
            feature_map_size, self.anchor_ranges, self.sizes, self.rotations
        )

    @property
    def num_anchors_per_localization(self) -> int:
        num_sizes = np.asarray(self.sizes).reshape(-1, 3).shape[0]
        return num_sizes * len(self.rotations)
