"""Voxel feature encoder (port of ``sessd_tpu/models/vfe.py``):
the parameter-free per-voxel point mean (readers/voxel_encoder.py:197-210).

In serving the host computes this mean already and the model receives
``voxels = feats[:, None, :]`` with one point each, so the module passes the
features through unchanged.
"""
from __future__ import annotations

import torch
from torch import nn


class VoxelFeatureExtractorV3(nn.Module):
    """voxels [V, P, F], num_points [V] -> [V, num_input_features]."""

    def __init__(self, num_input_features: int = 4):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        s = voxels[:, :, :self.num_input_features].sum(dim=1)
        return s / num_points.clamp_min(1).to(voxels.dtype)[:, None]
