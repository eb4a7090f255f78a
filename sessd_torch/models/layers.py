"""Shared building blocks (port of ``sessd_tpu/models/layers.py``, serving
half): the inference BatchNorm with its affine fold, and the reference's
conv + BN + ReLU triples for the dense BEV stages.

Norm semantics follow the reference: BatchNorm eps 1e-3 (scn.py:103,
rpn_v1.py:131). Training-mode statistics come with the training port.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Inference BatchNorm over channel dim 1, with the reference's parameter
    and buffer names (``weight``, ``bias``, ``running_mean``,
    ``running_var``) so det3d state dicts load as they are."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def fold(self):
        """(s, b) in f32 with BN(x) == x*s + b (MaskedBatchNorm affine_only,
        sessd_tpu/models/layers.py:43-46)."""
        s = (torch.rsqrt(self.running_var.float() + self.eps)
             * self.weight.float())
        return s, self.bias.float() - self.running_mean.float() * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, b = self.fold()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * s.view(shape).to(x.dtype) + b.view(shape).to(x.dtype)


@torch.no_grad()
def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill ``param`` from U(-bound, bound) drawn in f32 on the CPU
    ``generator`` (same values whatever the param's device and dtype)."""
    param.copy_(torch.empty(param.shape).uniform_(-bound, bound,
                                                  generator=generator))


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: Optional[int] = None, transpose: bool = False,
                 relu: bool = True) -> List[nn.Module]:
    """[conv, BN(, ReLU)] as the reference's Sequentials list them.

    Plain convs pad symmetrically by k//2 (torch style). Transposed convs
    take padding k//2 and output_padding s-1, so the output is exactly s x
    the input: the crop ``ConvBnRelu(transpose=True)`` applies by hand in
    sessd_tpu/models/layers.py:102-116 (odd kernels, as SSFA uses).
    """
    if transpose:
        conv = nn.ConvTranspose2d(cin, cout, kernel, stride=stride,
                                  padding=kernel // 2,
                                  output_padding=stride - 1, bias=False)
    else:
        conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding,
                         bias=False)
    layers = [conv, BatchNorm(cout)]
    if relu:
        layers.append(nn.ReLU())
    return layers
