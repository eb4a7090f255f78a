"""SSFA neck (port of ``sessd_tpu/models/ssfa.py``; reference
rpn_v1.py:119-235), as cuDNN convs: in serving on channels-last maps with
each conv's BatchNorm folded in (``layers.Sequential``).

Two branches from the 128-ch BEV map: a spatial branch at full resolution
and a stride-2 semantic branch at 256 ch; 1x1 transforms; the semantic
branch is deconvolved back and fused twice; a per-pixel 2-way softmax
attention mixes the two outputs. Submodule names and Sequential indices are
the reference's, so det3d checkpoints load as they are.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import Sequential, conv_bn_relu


class SSFA(nn.Module):
    def __init__(self, num_input_features: int = 128):
        super().__init__()
        c = num_input_features
        # index 0 is the reference's explicit ZeroPad2d(1)
        self.bottom_up_block_0 = Sequential(
            nn.ZeroPad2d(1), *conv_bn_relu(c, 128, 3, padding=0),
            *conv_bn_relu(128, 128, 3), *conv_bn_relu(128, 128, 3))
        self.bottom_up_block_1 = Sequential(
            *conv_bn_relu(128, 256, 3, stride=2),
            *conv_bn_relu(256, 256, 3), *conv_bn_relu(256, 256, 3))
        self.trans_0 = Sequential(*conv_bn_relu(128, 128, 1))
        self.trans_1 = Sequential(*conv_bn_relu(256, 256, 1))
        self.deconv_block_0 = Sequential(
            *conv_bn_relu(256, 128, 3, stride=2, transpose=True))
        self.deconv_block_1 = Sequential(
            *conv_bn_relu(256, 128, 3, stride=2, transpose=True))
        self.conv_0 = Sequential(*conv_bn_relu(128, 128, 3))
        self.w_0 = Sequential(*conv_bn_relu(128, 1, 1, relu=False))
        self.conv_1 = Sequential(*conv_bn_relu(128, 128, 3))
        self.w_1 = Sequential(*conv_bn_relu(128, 1, 1, relu=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.bottom_up_block_0(x)
        x1 = self.bottom_up_block_1(x0)
        t0 = self.trans_0(x0)
        t1 = self.trans_1(x1)
        # crop the deconvs to the skip size (odd BEV extents; a no-op for
        # the 200x176 KITTI map), ssfa.py:44-48
        h, w = x0.shape[-2:]
        m0 = self.deconv_block_0(t1)[:, :, :h, :w] + t0
        m1 = self.deconv_block_1(t1)[:, :, :h, :w]
        o0 = self.conv_0(m0)
        o1 = self.conv_1(m1)
        att = torch.softmax(torch.cat([self.w_0(o0), self.w_1(o1)], dim=1),
                            dim=1)
        return o0 * att[:, 0:1] + o1 * att[:, 1:2]
