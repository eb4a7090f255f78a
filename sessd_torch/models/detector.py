"""VoxelNet detector assembly (port of ``sessd_tpu/models/detector.py``;
reference detectors/voxelnet_sessd.py:5-43).

reader (mean VFE) -> SpMiddleFHD -> SSFA neck -> multi-group head, or
the modules given (``builder.build_detector`` takes them from the config:
CenterPoint's SpMiddleResNetFHD -> RPN -> CenterHead), through the same
``forward``, spans and serving entry. Submodules carry det3d's names
(``reader``, ``backbone``, ``neck``, ``bbox_head``). Parameters are kept
in float32; ``dtype`` is the compute dtype, to which every layer casts its
weights per call. The parameter tree does not depend on the execution
plan (``dense_from_stage``), so a student and its teacher share one
state-dict layout.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..data.rulebooks import make_chain_inputs_transform
from ..ops.sparse import build_device_chain
from ..utils.profiling import span
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
                 dtype: torch.dtype = torch.float32,
                 dense_from_stage: int = 3,
                 stage_capacity: Sequence[int] = (20000, 22000, 18000, 12000,
                                                  8000),
                 backbone: Optional[nn.Module] = None,
                 neck: Optional[nn.Module] = None,
                 bbox_head: Optional[nn.Module] = None):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        # per-sample row capacity of each sparse stage (detector.py:29)
        self.stage_capacity = tuple(int(c) for c in stage_capacity)
        self.dtype = dtype
        # training plan: stages from here on run as masked dense conv3d
        self.dense_from_stage = dense_from_stage
        self.reader = VoxelFeatureExtractorV3(num_input_features)
        self.backbone = (SpMiddleFHD(num_input_features) if backbone is None
                         else backbone)
        self.neck = SSFA(128) if neck is None else neck
        self.bbox_head = (MultiGroupHead(tasks, in_channels=128)
                          if bbox_head is None else bbox_head)

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
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
        if hasattr(self.bbox_head, "reset_hm_bias"):
            self.bbox_head.reset_hm_bias()

    def host_transform(self, stage_capacity: Sequence[int],
                       suffixes: Sequence[str] = ("",)) -> Callable:
        """The batch transform that builds ``forward``'s third argument on
        the host: per suffix, the rulebook chain at ``stage_capacity``
        under ``inputs<sfx>``, its full stages under ``saturated<sfx>``
        (``data.rulebooks.make_chain_inputs_transform``)."""
        return make_chain_inputs_transform(self.sparse_shape, stage_capacity,
                                           suffixes)

    def device_inputs(self, coords: torch.Tensor, valid: torch.Tensor,
                      batch_size: int,
                      stage_capacity: Optional[Sequence[int]] = None):
        """``host_transform``'s device twin: the rulebook chain of coords
        [B, V, 3] zyx with valid [B, V], built on their device
        (``ops.sparse.build_device_chain``) at ``stage_capacity`` (default
        the model's) scaled by the batch, as backbone.py:274 scales it.
        Returns (chain, saturated [5] bool on the device)."""
        caps = self.stage_capacity if stage_capacity is None \
            else stage_capacity
        b, v = coords.shape[:2]
        bidx = torch.arange(b, dtype=coords.dtype, device=coords.device)
        bzyx = torch.cat([bidx[:, None, None].expand(b, v, 1), coords], -1)
        return build_device_chain(
            bzyx.reshape(b * v, 4), valid.reshape(b * v),
            (batch_size,) + self.sparse_shape,
            [int(c) * batch_size for c in caps])

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                rulebooks: dict, batch_size: int,
                conv: Optional[Callable] = None,
                train: bool = False,
                dense_from_stage: Optional[int] = None) -> list:
        """voxels [B*V, P, F], num_points [B*V], the rulebook chain as
        device tensors (``host_transform``'s or ``device_inputs``', int16
        or int32) -> list of per-task dicts of [B, A, c] tensors in the
        compute dtype. ``train`` takes the training plan
        (``SpMiddleFHD.forward_train`` at ``dense_from_stage``, the
        model's unless given); BatchNorm uses batch statistics when the
        module is in training mode, its running ones in eval mode (the
        hybrid eval plan of device chains)."""
        with span("model.backbone"):
            feats = self.reader(voxels, num_points)
            if train:
                bev = self.backbone.forward_train(
                    feats, rulebooks, batch_size, self.sparse_shape,
                    self.dtype, self.dense_from_stage
                    if dense_from_stage is None else dense_from_stage)
            else:
                bev = self.backbone(feats, rulebooks, batch_size,
                                    self.sparse_shape, self.dtype, conv=conv)
        with span("model.neck"):
            x = self.neck(bev)
        with span("model.head"):
            return self.bbox_head(x)
