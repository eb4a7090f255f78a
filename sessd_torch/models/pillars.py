"""PointPillars (port of ``sessd_tpu/models/pillars.py``; reference
readers/pillar_encoder.py:17-230, necks/rpn_v1.py:24-116,
detectors/point_pillars.py:5-54).

    PillarFeatureNet: decorate each pillar's points with offsets from the
        points' mean and from the pillar center, linear + masked BatchNorm
        + ReLU, max over the points
    pillar_scatter:   the pillars into a dense [B, C, ny, nx] BEV canvas
    RPN:              three strided conv stages, each upsampled (k == s
                      transposed convs) to half the grid and concatenated
    MultiGroupHead:   the shared head (``head.py``), 384 channels in

All dense: no sparse conv kernel, cuDNN for the convs. Submodules carry
det3d's names (``reader.pfn_layers.0.{linear,norm}``,
``neck.blocks.i.j``, ``neck.deblocks.i.j``, ``bbox_head``), so a reference
state dict loads as it is.

By default the decoration is the standard one (point minus pillar center)
and the max is over the real points only. ``ref_compat=True`` reproduces
the reference's two quirks: its ``f_center`` drops the point coordinates
(pillar_encoder.py:129-136 zeroes them, leaving the negated pillar
center), and its max runs over the padded rows too, which carry
relu(BN(0)) after the linear layer (pillar_encoder.py:147-151).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .head import MultiGroupHead
from .layers import (BatchNorm, ConvTranspose2d, Sequential, _cast,
                     conv_bn_relu, uniform_)


class PFNLayer(nn.Module):
    """Linear (no bias) + BatchNorm over the valid points + ReLU + max."""

    def __init__(self, in_channels: int, units: int, last: bool = True,
                 ref_compat: bool = False):
        super().__init__()
        self.last = last
        self.ref_compat = ref_compat
        units = units if last else units // 2
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = BatchNorm(units)

    def forward(self, x: torch.Tensor, point_mask: torch.Tensor,
                pillar_mask: torch.Tensor) -> torch.Tensor:
        """x [V, P, C] -> [V, units] (last) or [V, P, 2 * units]."""
        v, p, _ = x.shape
        x = F.linear(x, _cast(self.linear, x.dtype)[0])
        units = x.shape[-1]
        flat_mask = (point_mask & pillar_mask[:, None]).reshape(v * p, 1)
        x = self.norm(x.reshape(v * p, units), flat_mask).reshape(v, p, units)
        x = torch.relu(x)
        if self.ref_compat:
            x_max = x.amax(dim=1, keepdim=True)
        else:
            x_max = torch.where(point_mask[..., None], x, -torch.inf).amax(
                dim=1, keepdim=True)
            x_max = torch.where(torch.isfinite(x_max), x_max, 0.0)
        if self.last:
            return x_max[:, 0, :]
        x = torch.where(point_mask[..., None], x, 0.0)
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarFeatureNet(nn.Module):
    def __init__(self, num_input_features: int = 4,
                 num_filters: Sequence[int] = (64,),
                 voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Sequence[float] = (0.0, -40.0, -3.0, 70.4, 40.0,
                                              1.0),
                 dtype: torch.dtype = torch.float32,
                 ref_compat: bool = False):
        super().__init__()
        self.num_input_features = num_input_features
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.dtype = dtype
        self.ref_compat = ref_compat
        cin = num_input_features + 5  # + f_cluster (3) + f_center (2)
        layers = []
        for i, f in enumerate(num_filters):
            last = i == len(num_filters) - 1
            layers.append(PFNLayer(cin, f, last=last, ref_compat=ref_compat))
            cin = f
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords_bzyx: torch.Tensor,
                pillar_mask: torch.Tensor) -> torch.Tensor:
        """voxels [V, P, F] (f32), num_points [V], coords [V, 4] (b, z, y,
        x), pillar_mask [V] -> [V, C] in the compute dtype, 0 where the
        pillar is padding."""
        v, p, _ = voxels.shape
        point_mask = (torch.arange(p, device=voxels.device)[None, :]
                      < num_points[:, None])
        pm = point_mask[..., None].to(voxels.dtype)

        cnt = num_points.clamp_min(1).to(voxels.dtype)[:, None, None]
        mean = (voxels[:, :, :3] * pm).sum(dim=1, keepdim=True) / cnt
        f_cluster = voxels[:, :, :3] - mean

        vx, vy = self.voxel_size
        px = coords_bzyx[:, 3].to(voxels.dtype) * vx + (
            vx / 2 + self.pc_range[0])
        py = coords_bzyx[:, 2].to(voxels.dtype) * vy + (
            vy / 2 + self.pc_range[1])
        if self.ref_compat:
            zero = torch.zeros_like(voxels[:, :, 0])
            f_center = torch.stack([zero - px[:, None], zero - py[:, None]],
                                   dim=-1)
        else:
            f_center = torch.stack([voxels[:, :, 0] - px[:, None],
                                    voxels[:, :, 1] - py[:, None]], dim=-1)

        x = torch.cat([voxels[:, :, :self.num_input_features], f_cluster,
                       f_center], dim=-1) * pm
        x = x.to(self.dtype)
        for layer in self.pfn_layers:
            x = layer(x, point_mask, pillar_mask)
        return torch.where(pillar_mask[:, None], x, 0.0)


def pillar_scatter(features: torch.Tensor, coords_bzyx: torch.Tensor,
                   pillar_mask: torch.Tensor, batch_size: int, ny: int,
                   nx: int) -> torch.Tensor:
    """[V, C] pillar features -> the [B, C, ny, nx] canvas
    (PointPillarsScatter). Padding pillars write zeros to a trash row at
    index B * ny * nx, as sessd_tpu/models/pillars.py:106-114 does. The
    canvas is laid out channels-last (a permuted [B, ny, nx, C]), which
    cuDNN takes as it is."""
    c = features.shape[-1]
    total = batch_size * ny * nx
    flat = (coords_bzyx[:, 0] * (ny * nx) + coords_bzyx[:, 2] * nx
            + coords_bzyx[:, 3]).long()
    flat = torch.where(pillar_mask, flat, total)
    canvas = features.new_zeros(total + 1, c).index_copy(
        0, flat, torch.where(pillar_mask[:, None], features, 0.0))
    return canvas[:total].view(batch_size, ny, nx, c).permute(0, 3, 1, 2)


class RPN(nn.Module):
    """The multi-scale conv / deconv neck (necks/rpn_v1.py:24-116).

    ``blocks[i]``: a 3x3 conv at stride ``ds_strides[i]`` (the reference's
    ZeroPad2d(1) at index 0, folded into the conv's padding), then
    ``layer_nums[i]`` 3x3 convs, each with BatchNorm and ReLU.
    ``deblocks[i]``: a transposed conv with kernel = stride =
    ``us_strides[i]`` and no padding (1x1 at stride 1), BatchNorm, ReLU.
    """

    def __init__(self, in_channels: int = 64,
                 layer_nums: Sequence[int] = (3, 5, 5),
                 ds_strides: Sequence[int] = (2, 2, 2),
                 ds_filters: Sequence[int] = (64, 128, 256),
                 us_strides: Sequence[int] = (1, 2, 4),
                 us_filters: Sequence[int] = (128, 128, 128)):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        cin = in_channels
        for i, n in enumerate(layer_nums):
            f = ds_filters[i]
            layers = [nn.Identity()] + conv_bn_relu(cin, f, 3,
                                                    stride=ds_strides[i])
            for _ in range(n):
                layers += conv_bn_relu(f, f, 3)
            self.blocks.append(Sequential(*layers))
            s = us_strides[i]
            self.deblocks.append(Sequential(
                ConvTranspose2d(f, us_filters[i], s, stride=s, bias=False),
                BatchNorm(us_filters[i]), nn.ReLU()))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        return torch.cat(ups, dim=1)


class PointPillars(nn.Module):
    """reader (PillarFeatureNet) -> scatter -> neck (RPN) -> bbox_head.

    ``forward`` takes the arguments of ``VoxelNet.forward`` in the same
    slots, so the train step, ``Trainer.validate`` and serving call either
    model alike; the third, where VoxelNet takes its rulebook chain, is the
    pillars' placement: ``{"coords": [B*V, 4] (b, z, y, x), "valid":
    [B*V] bool}`` (``pillar_inputs``)."""

    def __init__(self, num_input_features: int = 4,
                 grid_size: Tuple[int, int] = (496, 432),
                 voxel_size: Tuple[float, float] = (0.16, 0.16),
                 pc_range: Sequence[float] = (0.0, -39.68, -3.0, 69.12,
                                              39.68, 1.0),
                 tasks: Sequence[dict] = (dict(num_class=1,
                                               class_names=("Car",)),),
                 dtype: torch.dtype = torch.float32,
                 ref_compat: bool = False):
        super().__init__()
        self.grid_size = tuple(grid_size)  # (ny, nx)
        self.dtype = dtype
        self.reader = PillarFeatureNet(num_input_features, (64,),
                                       voxel_size, pc_range, dtype,
                                       ref_compat)
        self.neck = RPN()
        self.bbox_head = MultiGroupHead(tasks, in_channels=384)

    def reset_parameters(self, generator: torch.Generator):
        """Seeded random init with the JAX package's scales: the PFN's
        linear at variance 1/fan_in (flax Dense), Xavier-uniform RPN convs,
        He-uniform head convs, zero biases, BatchNorm at identity. Draws on
        the CPU ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                uniform_(m.weight, math.sqrt(3.0 / m.in_features), generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
        for m in self.neck.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                s0, s1 = m.weight.shape[:2]
                fan_sum = m.weight.numel() // (s0 * s1) * (s0 + s1)
                uniform_(m.weight, math.sqrt(6.0 / fan_sum), generator)
        for m in self.bbox_head.modules():
            if isinstance(m, nn.Conv2d):
                uniform_(m.weight, math.sqrt(6.0 / m.in_channels), generator)
                with torch.no_grad():
                    m.bias.zero_()

    def host_transform(self, stage_capacity: Sequence[int],
                       suffixes: Sequence[str] = ("",)) -> Callable:
        """``VoxelNet.host_transform``'s counterpart: per suffix, the
        pillars' placement (``pillar_inputs``) under ``inputs<sfx>``; it
        has no capacity stages, so ``saturated<sfx>`` is empty and
        ``stage_capacity`` is unused."""
        def transform(batch: dict) -> dict:
            out = dict(batch)
            for sfx in suffixes:
                out["inputs" + sfx] = pillar_inputs(batch["coords" + sfx],
                                                    batch["voxel_mask" + sfx])
                out["saturated" + sfx] = []
            return out

        return transform

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                pillars: dict, batch_size: int, train: bool = False) -> list:
        """voxels [B*V, P, F], num_points [B*V], ``pillars`` as above ->
        list of per-task dicts of [B, A, c] tensors in the compute dtype.
        BatchNorm takes batch statistics when the module is in training
        mode (``train`` is VoxelNet's plan switch; pillars have one plan)."""
        coords, valid = pillars["coords"], pillars["valid"]
        feats = self.reader(voxels, num_points, coords, valid)
        ny, nx = self.grid_size
        bev = pillar_scatter(feats, coords, valid, batch_size, ny, nx)
        return self.bbox_head(self.neck(bev))


def pillar_inputs(coords_zyx: np.ndarray, mask: np.ndarray) -> dict:
    """The loader's per-sample coords [B, V, 3] (z, y, x) and voxel mask
    [B, V] -> ``PointPillars``'s placement argument (numpy): coords [B*V,
    4] with the sample index in front, and the mask flattened."""
    b, v = mask.shape
    bi = np.repeat(np.arange(b, dtype=np.int32), v)[:, None]
    return {"coords": np.concatenate(
                [bi, np.asarray(coords_zyx, np.int32).reshape(b * v, 3)], 1),
            "valid": np.asarray(mask, bool).reshape(b * v)}
