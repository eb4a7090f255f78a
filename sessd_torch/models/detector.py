"""VoxelNet detector assembly (port of ``sessd_tpu/models/detector.py``;
reference detectors/voxelnet_sessd.py:5-43), serving form.

reader (mean VFE) -> all-sparse SpMiddleFHD -> SSFA neck -> multi-group head.
Submodules carry det3d's names (``reader``, ``backbone``, ``neck``,
``bbox_head``). Parameters are kept in float32; ``dtype`` is the compute
dtype: the backbone folds and casts its weights per call, and the neck and
head hold theirs in ``dtype``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
from torch import nn

from ..ops.cuda.sparse_conv import fused_sparse_conv
from .backbone import SpMiddleFHD
from .head import MultiGroupHead
from .layers import BatchNorm, uniform_
from .ssfa import SSFA
from .vfe import VoxelFeatureExtractorV3


class VoxelNet(nn.Module):
    def __init__(self, num_input_features: int = 4,
                 sparse_shape: Tuple[int, int, int] = (41, 1600, 1408),
                 tasks: Sequence[dict] = (dict(num_class=1,
                                               class_names=("Car",)),),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.dtype = dtype
        self.reader = VoxelFeatureExtractorV3(num_input_features)
        self.backbone = SpMiddleFHD(num_input_features)
        self.neck = SSFA(128)
        self.bbox_head = MultiGroupHead(tasks, in_channels=128)
        self.neck.to(dtype)
        self.bbox_head.to(dtype)

    def reset_parameters(self, generator: torch.Generator):
        """Seeded random init with the JAX package's distributions: He-uniform
        sparse kernels and head convs, Xavier-uniform neck convs, zero
        biases, BatchNorm at identity. Draws on the CPU ``generator``, so
        the weights do not depend on the device."""
        self.backbone.reset_parameters(generator)
        for m in self.neck.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                s0, s1 = m.weight.shape[:2]
                fan_sum = m.weight.numel() // (s0 * s1) * (s0 + s1)
                uniform_(m.weight, math.sqrt(6.0 / fan_sum), generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
        for m in self.bbox_head.modules():
            if isinstance(m, nn.Conv2d):
                uniform_(m.weight, math.sqrt(6.0 / m.in_channels), generator)
                with torch.no_grad():
                    m.bias.zero_()

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                rulebooks: dict, batch_size: int,
                conv: Callable = fused_sparse_conv) -> list:
        """voxels [B*cap0, P, F], num_points [B*cap0], host rulebook chain
        as device tensors -> list of per-task dicts of [B, A, c] tensors in
        the compute dtype."""
        feats = self.reader(voxels, num_points)
        bev = self.backbone(feats, rulebooks, batch_size, self.sparse_shape,
                            self.dtype, conv=conv)
        return self.bbox_head(self.neck(bev))
