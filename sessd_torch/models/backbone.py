"""Sparse 3D middle backbone (port of ``sessd_tpu/models/backbone.py``):
the all-sparse serving plan (``:277-284, 334-383``) and the training plans
(``:385-425``).

Stage plan (channels / resolution, input sparse shape (41, 1600, 1408)):
    2 x subm(4->16, 16->16)                       @ (41, 1600, 1408)
    spconv s2 p1 (16->32), 2 x subm(32)           @ (21,  800,  704)
    spconv s2 p1 (32->64), 3 x subm(64)           @ (11,  400,  352)
    spconv s2 p(0,1,1) (64->64), 3 x subm(64)     @ ( 5,  200,  176)
    spconv k(3,1,1) s(2,1,1) (64->64)             @ ( 2,  200,  176)
    -> dense [B, 2, 200, 176, 64] -> BEV [B, 64*2, 200, 176]

Serving: every block is one call of a fused sparse conv kernel
(``ops/cuda/sparse_conv.py``) on row-major ``[cap_stage, C]`` features, with
the BatchNorm scale folded into the weights before the cast to the compute
dtype. A conv takes the streaming kernel exactly where the JAX package
streams it (``sparse_conv.streams``, the same byte rule: at TRAIN_CAPS in
f32 at batch 4 the 11 convs of stages 1-3, at SERVING_CAPS in bf16 at batch
8 the 7 of stages 1-2), else the resident one. Training
(``forward_train``): each sparse block is ``SparseConvFunction`` (the K4
forward and K5 backward kernels) + masked batch-statistics BatchNorm +
ReLU; from ``dense_from_stage`` on the grid is densified and the blocks run
as masked dense ``conv3d`` (submanifold conv == dense conv x occupancy;
strided sparse conv == dense strided conv x covered mask), re-masked after
the BatchNorm. The rulebook chain is the host-built one
(``utils.native.build_rulebooks``); the TPU's transposed ``[C, cols]``
layout, windows and patch lists have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import sparse as sp
from ..ops.cuda.sparse_conv import (fused_sparse_conv,
                                    fused_sparse_conv_stream, streams)
from ..utils.profiling import count
from .layers import BatchNorm, derived, uniform_

# (channels, n_subm, down_kernel, down_stride, down_pad) per stage
PLAN = [
    (16, 2, None, None, None),                     # stage 0
    (32, 2, (3, 3, 3), (2, 2, 2), (1, 1, 1)),      # stage 1
    (64, 3, (3, 3, 3), (2, 2, 2), (1, 1, 1)),      # stage 2
    (64, 3, (3, 3, 3), (2, 2, 2), (0, 1, 1)),      # stage 3
    (64, 0, (3, 1, 1), (2, 1, 1), (0, 0, 0)),      # stage 4
]


class SparseConv3d(nn.Module):
    """Weight holder of one sparse conv, in spconv's [kd, kh, kw, Cin, Cout]
    layout (and its bias where ``bias``); the backbone runs it through the
    fused kernel."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int],
                 bias: bool = False):
        super().__init__()
        self.kernel = tuple(kernel)
        self.weight = nn.Parameter(torch.zeros(*kernel, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class SpMiddleFHD(nn.Module):
    """Sparse middle extractor: (features, rulebooks) -> BEV [B, C*D, H, W]
    (channels-last from ``forward``, the serving plan: ``bev_nhwc``).

    ``middle_conv`` lists (conv, BN, ReLU) per block as the reference's
    Sequential does (scn.py:105-151), so parameters carry det3d's names
    ``middle_conv.{3b}.weight`` / ``middle_conv.{3b+1}.*``.
    """

    def __init__(self, num_input_features: int = 4):
        super().__init__()
        layers: List[nn.Module] = []
        cin = num_input_features
        for feats, n_subm, dk, _, _ in PLAN:
            kernels = ([dk] if dk else []) + [(3, 3, 3)] * n_subm
            for k in kernels:
                layers += [SparseConv3d(cin, feats, k), BatchNorm(feats),
                           nn.ReLU()]
                cin = feats
        self.middle_conv = nn.ModuleList(layers)

    def blocks(self):
        """(conv, bn) pairs in call order."""
        return [(self.middle_conv[i], self.middle_conv[i + 1])
                for i in range(0, len(self.middle_conv), 3)]

    def reset_parameters(self, generator: torch.Generator):
        """He-uniform kernels over fan_in = K*Cin (the JAX init's
        variance_scaling(2, fan_in, uniform)); BN at identity."""
        for conv, bn in self.blocks():
            k, cin = math.prod(conv.kernel), conv.weight.shape[-2]
            uniform_(conv.weight, math.sqrt(6.0 / (k * cin)), generator)
            bn.reset_parameters()

    def folded(self, dtype: torch.dtype):
        """Per block (w2 [K, Cin, Cout] in ``dtype``, bias [Cout] f32) with
        the BN scale folded in, w2 = W * s (backbone.py:99-100); made once
        and kept outside autograd (``layers.derived``)."""
        def fold():
            out = []
            for conv, bn in self.blocks():
                s, b = bn.fold()
                w = conv.weight.float()
                w = w.reshape(-1, w.shape[-2], w.shape[-1])
                out.append(((w * s).to(dtype).contiguous(), b.contiguous()))
            return out

        sources = [t for conv, bn in self.blocks()
                   for t in (conv.weight, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var)]
        return derived(self, ("folded", dtype), sources, fold)

    def forward(self, voxel_features: torch.Tensor, rulebooks: dict,
                batch_size: int, sparse_shape, dtype: torch.dtype,
                conv: Optional[Callable] = None) -> torch.Tensor:
        """voxel_features [B*cap0, F]; rulebooks {"perm" [B*cap0],
        "ids" [5 x cap_i], "subm" [4 x (cap_i, 27)], "down" [4 x (cap_i, K)]}
        as tensors on the features' device (int16 or int32). ``conv`` runs
        every block when given (tests and the smoke check pass the kernels'
        plain twin); by default each block takes ``pick_conv``'s kernel."""
        ids = rulebooks["ids"]
        shape = (batch_size,) + tuple(sparse_shape)
        x = voxel_features[rulebooks["perm"].long()]
        x = torch.where((ids[0] < sp.SENTINEL)[:, None], x, 0.0).to(dtype)
        params = iter(self.folded(dtype))

        def block(x, rb):
            fn = conv or pick_conv(x.shape[1], x.shape[0], dtype)
            return fn(x, rb, *next(params), n_in=x.shape[0])

        for stage, (_, n_subm, dk, ds, dp) in enumerate(PLAN):
            if stage > 0:
                x = block(x, rulebooks["down"][stage - 1])
                shape = sp.downsample_out_shape(shape, dk, ds, dp)
            for _ in range(n_subm):
                x = block(x, rulebooks["subm"][stage])
        return bev_nhwc(sp.to_dense(x, ids[4], shape))

    def forward_train(self, voxel_features: torch.Tensor, rulebooks: dict,
                      batch_size: int, sparse_shape, dtype: torch.dtype,
                      dense_from_stage: int = 3) -> torch.Tensor:
        """The training forward (BatchNorm in batch-statistics mode when the
        module is in training mode). Same inputs and output as ``forward``.
        Stages below ``dense_from_stage`` (and the strided conv into it) run
        sparse; the rest dense. With autograd on, each rulebook's inverse is
        built once and shared by the convs that use it."""
        ids = rulebooks["ids"]
        valid = [i < sp.SENTINEL for i in ids]
        shape = (batch_size,) + tuple(sparse_shape)
        dfs = min(max(dense_from_stage, 1), 5)
        x = voxel_features[rulebooks["perm"].long()]
        x = torch.where(valid[0][:, None], x, 0.0).to(dtype)
        blocks = iter(self.blocks())
        grad = torch.is_grad_enabled()

        def sparse_block(x, rb, mask, inv):
            conv, bn = next(blocks)
            w = conv.weight.reshape(-1, *conv.weight.shape[-2:]).to(dtype)
            y = sp.SparseConvFunction.apply(x, w, rb, mask, inv)
            return torch.relu(bn(y, mask[:, None]))

        def dense_block(x, occ, stride, padding):
            conv, bn = next(blocks)
            # [kd, kh, kw, Cin, Cout] -> [Cout, Cin, kd, kh, kw]
            w = conv.weight.permute(4, 3, 0, 1, 2).to(dtype)
            y = F.conv3d(x, w, stride=stride, padding=padding) * occ
            # re-mask: the BN shift makes empty sites nonzero, and the next
            # conv would read them as neighbours (backbone.py:188-192)
            return torch.relu(bn(y, occ > 0) * occ)

        dense = occ = None
        for stage, (_, n_subm, dk, ds, dp) in enumerate(PLAN):
            if stage > 0 and stage <= dfs:
                rb = rulebooks["down"][stage - 1]
                inv = sp.inverse_rulebook(rb, x.shape[0]) if grad else None
                x = sparse_block(x, rb, valid[stage], inv)
                shape = sp.downsample_out_shape(shape, dk, ds, dp)
            elif stage > 0:
                occ = _cover_mask(occ, dk, ds, dp)
                dense = dense_block(dense, occ, ds, dp)
            if stage >= dfs and dense is None:
                dense = sp.to_dense(x, ids[stage], shape).permute(
                    0, 4, 1, 2, 3).contiguous()
                occ = (sp.to_dense(torch.ones_like(x[:, :1]), ids[stage],
                                   shape) > 0).to(dtype).permute(0, 4, 1, 2, 3)
            if n_subm and stage < dfs:
                rb = rulebooks["subm"][stage]
                inv = sp.inverse_rulebook(rb, x.shape[0]) if grad else None
                for _ in range(n_subm):
                    x = sparse_block(x, rb, valid[stage], inv)
            else:
                for _ in range(n_subm):
                    dense = dense_block(dense, occ, 1, 1)
        if dense is None:
            dense = sp.to_dense(x, ids[4], shape).permute(0, 4, 1, 2, 3)
        b, c, d, h, w = dense.shape
        return dense.reshape(b, c * d, h, w)


def bev_nhwc(dense: torch.Tensor) -> torch.Tensor:
    """The serving BEV map of the dense grid [B, D, H, W, C]: [B, C*D, H,
    W] in channel order c*D + d, the reference's [N, C, D, H, W] -> [N,
    C*D, H, W] view (scn.py:186-188), written channels-last in one copy,
    the layout the neck's cuDNN convs compute in."""
    b, d, h, w, c = dense.shape
    return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d).permute(
        0, 3, 1, 2)


def pick_conv(cin: int, n_in: int, dtype: torch.dtype) -> Callable:
    """The serving kernel of a conv over ``n_in`` rows of ``cin`` channels:
    the streaming one where the JAX package streams
    (sessd_tpu/ops/pallas/wconv.py:433-435), else the resident one."""
    return (fused_sparse_conv_stream if streams(cin, n_in, dtype)
            else fused_sparse_conv)


def _cover_mask(occ: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """Occupancy [B, 1, D, H, W] -> the covered-output mask of a strided
    conv: a site exists iff its window sees a voxel (backbone.py:212-219)."""
    ones = occ.new_ones((1, 1) + tuple(kernel), dtype=torch.float32)
    c = F.conv3d(occ.float(), ones, stride=stride, padding=padding)
    return (c > 0).to(occ.dtype)


# SpMiddleResNetFHD (CenterPoint, det3d/models/backbones/scn.py:195-366 of
# the reference tree): (channels, residual blocks, down kernel, down
# stride, down padding) per stage, the strided convs SpMiddleFHD's, so one
# rulebook chain (``data.rulebooks.DOWNS``) serves both
RES_PLAN = [
    (16, 2, None, None, None),                     # subm 5->16, 2 blocks
    (32, 2, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (64, 2, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (128, 2, (3, 3, 3), (2, 2, 2), (0, 1, 1)),
    (128, 0, (3, 1, 1), (2, 1, 1), (0, 0, 0)),     # extra_conv
]
# the first conv's input is zero-padded to this width, the narrowest the
# tensor-core tile takes: its weight rows past the 5 published ones are 0,
# so the padded conv is the published one exactly
PAD_INPUT_CHANNELS = 16


class SparseBasicBlock(nn.Module):
    """subm conv (bias) -> BN -> ReLU -> subm conv (bias) -> BN, plus the
    block's input, then ReLU (scn.py's ``SparseBasicBlock``, its names)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = SparseConv3d(planes, planes, (3, 3, 3), bias=True)
        self.bn1 = BatchNorm(planes)
        self.conv2 = SparseConv3d(planes, planes, (3, 3, 3), bias=True)
        self.bn2 = BatchNorm(planes)


class SpMiddleResNetFHD(nn.Module):
    """CenterPoint's residual sparse middle extractor: (features,
    rulebooks) -> BEV [B, 128*D, H, W], 21 sparse convs (``RES_PLAN``).

    Parameters carry the reference's names: ``conv_input.{0,1}``,
    ``conv1.{0,1}`` (blocks), ``conv{2,3,4}.{0,1}`` (the strided conv and
    its BN) and ``.{3,4}`` (blocks), ``extra_conv.{0,1}``. Serving runs
    every conv through the fused kernels with BN folded, as ``SpMiddleFHD``
    does; a block's second conv adds the block's input in its store,
    before the ReLU (the kernels' ``residual``: no pass of its own over
    the rows; counted as ``sparse_residual`` on the span recorder). Only
    the serving plan is ported: ``forward_train`` raises.
    """

    def __init__(self, num_input_features: int = 5):
        super().__init__()
        if num_input_features > PAD_INPUT_CHANNELS:
            raise ValueError(f"{num_input_features} input features: at most "
                             f"{PAD_INPUT_CHANNELS}")
        cin = num_input_features
        for stage, (feats, n_blocks, dk, _, _) in enumerate(RES_PLAN):
            head = [SparseConv3d(cin, feats, dk or (3, 3, 3)),
                    BatchNorm(feats), nn.ReLU()]
            blocks = [SparseBasicBlock(feats) for _ in range(n_blocks)]
            if stage == 0:
                self.conv_input = nn.ModuleList(head)
                self.conv1 = nn.ModuleList(blocks)
            elif stage < 4:
                setattr(self, f"conv{stage + 1}", nn.ModuleList(head + blocks))
            else:
                self.extra_conv = nn.ModuleList(head)
            cin = feats

    def stages(self):
        """Per stage: (its first conv's (conv, BN), its blocks)."""
        out = []
        for stage in range(len(RES_PLAN)):
            if stage == 0:
                head, blocks = self.conv_input, list(self.conv1)
            elif stage < 4:
                m = getattr(self, f"conv{stage + 1}")
                head, blocks = m, list(m)[3:]
            else:
                head, blocks = self.extra_conv, []
            out.append(((head[0], head[1]), blocks))
        return out

    def convs(self):
        """(conv, BN) of every sparse conv in call order."""
        return [pair for head, blocks in self.stages()
                for pair in [head] + [p for b in blocks
                                      for p in ((b.conv1, b.bn1),
                                                (b.conv2, b.bn2))]]

    def reset_parameters(self, generator: torch.Generator):
        """He-uniform kernels over fan_in = K*Cin (as ``SpMiddleFHD``),
        zero conv biases, BN at identity."""
        for conv, bn in self.convs():
            k, cin = math.prod(conv.kernel), conv.weight.shape[-2]
            uniform_(conv.weight, math.sqrt(6.0 / (k * cin)), generator)
            if conv.bias is not None:
                with torch.no_grad():
                    conv.bias.zero_()
            bn.reset_parameters()

    def folded(self, dtype: torch.dtype):
        """Per conv in call order (w2 [K, Cin, Cout] in ``dtype``, bias
        [Cout] f32): w2 = W * s and bias = conv bias * s + b for the BN's
        (s, b); the first conv's Cin zero-padded to
        ``PAD_INPUT_CHANNELS``."""
        def fold():
            out = []
            for i, (conv, bn) in enumerate(self.convs()):
                s, b = bn.fold()
                w = conv.weight.float()
                w = w.reshape(-1, w.shape[-2], w.shape[-1]) * s
                if i == 0:
                    w = F.pad(w, (0, 0, 0, PAD_INPUT_CHANNELS - w.shape[1]))
                if conv.bias is not None:
                    b = b + conv.bias.float() * s
                out.append((w.to(dtype).contiguous(), b.contiguous()))
            return out

        sources = [t for conv, bn in self.convs()
                   for t in (conv.weight, conv.bias, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var)
                   if t is not None]
        return derived(self, ("folded", dtype), sources, fold)

    def forward(self, voxel_features: torch.Tensor, rulebooks: dict,
                batch_size: int, sparse_shape, dtype: torch.dtype,
                conv: Optional[Callable] = None) -> torch.Tensor:
        """``SpMiddleFHD.forward``'s inputs and output, over ``RES_PLAN``."""
        ids = rulebooks["ids"]
        shape = (batch_size,) + tuple(sparse_shape)
        x = voxel_features[rulebooks["perm"].long()]
        x = torch.where((ids[0] < sp.SENTINEL)[:, None], x, 0.0)
        x = F.pad(x, (0, PAD_INPUT_CHANNELS - x.shape[1])).to(dtype)
        params = iter(self.folded(dtype))

        def block(x, rb, residual=None):
            fn = conv or pick_conv(x.shape[1], x.shape[0], dtype)
            if residual is None:
                return fn(x, rb, *next(params), n_in=x.shape[0])
            return fn(x, rb, *next(params), n_in=x.shape[0],
                      residual=residual)

        for stage, (_, n_blocks, dk, ds, dp) in enumerate(RES_PLAN):
            if stage == 0:
                x = block(x, rulebooks["subm"][0])
            else:
                x = block(x, rulebooks["down"][stage - 1])
                shape = sp.downsample_out_shape(shape, dk, ds, dp)
            for _ in range(n_blocks):
                rb = rulebooks["subm"][stage]
                count("sparse_residual")
                x = block(block(x, rb), rb, residual=x)
        return bev_nhwc(sp.to_dense(x, ids[4], shape))

    def forward_train(self, *args, **kwargs):
        raise NotImplementedError("SpMiddleResNetFHD serves only: its "
                                  "training plan is not ported")
