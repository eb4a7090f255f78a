"""Shared building blocks (port of ``sessd_tpu/models/layers.py``): the
BatchNorm of the sparse, dense-3D and BEV stages in both modes, its affine
fold for serving, and the reference's conv + BN + ReLU triples.

Norm semantics follow the reference: BatchNorm eps 1e-3 and momentum 0.01
(scn.py:103, rpn_v1.py:131), i.e. flax momentum 0.99. Parameters stay
float32; convs cast their weights to the dtype of their input, which is the
compute dtype (flax's ``nn.Conv(dtype=...)``). Outside autograd (serving,
the teacher) those casts and the BatchNorm fold are made once and kept
(``derived``), so a request launches no per-call weight casts.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from ..parallel.mesh import all_reduce_sum


def derived(module: nn.Module, key, sources: Sequence[torch.Tensor],
            make: Callable):
    """``make()``, a value computed from the tensors ``sources`` alone.

    With autograd on it is made at every call, so gradients flow through
    it. Without (``no_grad``, ``inference_mode``) it is kept on ``module``
    under ``key`` and made again only when a source changed: another tensor
    or storage (``module.to``, ``load_state_dict(assign=True)``) or an
    in-place update (optimizer step, EMA, ``copy_``), which bumps the
    tensor's version counter.
    """
    if torch.is_grad_enabled():
        return make()
    stamp = tuple((id(t), t.data_ptr(), t._version) for t in sources)
    store = module.__dict__.setdefault("_derived", {})
    hit = store.get(key)
    if hit is None or hit[0] != stamp:
        hit = store[key] = (stamp, make())
    return hit[1]


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1, with the reference's parameter and
    buffer names (``weight``, ``bias``, ``running_mean``, ``running_var``)
    so det3d state dicts load as they are.

    In training mode it normalizes with batch statistics taken in f32 and
    moves the running statistics by ``momentum`` towards them, the variance
    biased in both places (flax, unlike ``F.batch_norm``, never applies
    Bessel's correction):

    - with ``mask`` (the sparse backbone's padded rows, the dense stages'
      occupancy): ``MaskedBatchNorm`` (sessd_tpu/models/layers.py:48-62),
      moments over the rows where the mask holds, var = E[(x - mean)^2];
    - without: flax ``nn.BatchNorm`` (``batch_norm_2d``), var = E[x^2] -
      E[x]^2 clipped at 0.

    With a ``process_group`` (``sync_batch_norm``) the batch statistics are
    those of every rank's rows together, through one ``AllReduceSum`` per
    forward, whose backward carries the other ranks' gradient terms (the
    ``axis_name`` psum of sessd_tpu/models/layers.py:54-59 and flax's
    ``pmean``): masked, each rank's [count, sum, squared deviations from
    its mean] gathered and combined pairwise (the same moments as JAX's
    sums of [count, mean * count, (var + mean^2) * count], without their
    cancellation, so that a group of one trains as no group does);
    unmasked, the mean over ranks of [E[x], E[x^2]].
    """

    def __init__(self, channels: int, eps: float = 1e-3,
                 momentum: float = 0.01, process_group=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.process_group = process_group
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

    def _batch_stats(self, xf: torch.Tensor, mask: Optional[torch.Tensor]):
        """(mean, var) [C] of the batch, over every rank's rows where a
        process group is set."""
        dims = [d for d in range(xf.dim()) if d != 1]
        group = self.process_group
        if mask is None:
            mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
            if group is not None:
                mean, mean2 = (all_reduce_sum(torch.stack([mean, mean2]),
                                              group)
                               / dist.get_world_size(group))
            return mean, (mean2 - mean * mean).clamp_min(0.0)
        m = mask.to(xf.dtype)
        cnt = torch.clamp_min(m.expand_as(xf[:, :1]).sum(), 1.0)
        shape = (1, -1) + (1,) * (xf.dim() - 2)
        total = (xf * m).sum(dims)
        mean = total / cnt
        sq = (((xf - mean.view(shape)) ** 2) * m).sum(dims)
        if group is None:
            return mean, sq / cnt
        # every rank's (count, sum, squared deviations from its own mean)
        # in a row of its own, gathered by one all-reduce, then combined as
        # Chan et al.'s parallel variance does: no E[x^2] - E[x]^2
        # cancellation, and in a group of one the local moments bit for bit
        c = mean.numel()
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        row = torch.cat([cnt.reshape(1), total, sq])[None]
        rows = all_reduce_sum(F.pad(row, (0, 0, rank, world - rank - 1)),
                              group)
        n, s, q = rows[:, :1], rows[:, 1:1 + c], rows[:, 1 + c:]
        big_n = n.sum(0)
        gmean = s.sum(0) / big_n
        return gmean, (q.sum(0) + (n * (s / n - gmean) ** 2).sum(0)) / big_n

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N, C, ...]; ``mask`` (training only) broadcasts against x with
        size 1 on the channel dim. Returns x's dtype."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            s, b = derived(self, ("fold", x.dtype, x.dim()),
                           (self.weight, self.bias, self.running_mean,
                            self.running_var),
                           lambda: tuple(t.view(shape).to(x.dtype)
                                         for t in self.fold()))
            return x * s + b
        xf = x.float()
        mean, var = self._batch_stats(xf, mask)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return out.to(x.dtype)


def sync_batch_norm(module: nn.Module, process_group) -> nn.Module:
    """Set ``process_group`` on every ``BatchNorm`` of ``module`` (None
    turns the sync off), in the idiom of
    ``nn.SyncBatchNorm.convert_sync_batchnorm``; returns ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.process_group = process_group
    return module


def _cast(module: nn.Module, dtype: torch.dtype):
    """(weight, bias or None) of a conv in ``dtype``."""
    params = [p for p in (module.weight, module.bias) if p is not None]
    cast = derived(module, dtype, params,
                   lambda: [p.to(dtype) for p in params])
    return cast[0], (cast[1] if module.bias is not None else None)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype (f32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, *_cast(self, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = _cast(self, x.dtype)
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


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
        conv = ConvTranspose2d(cin, cout, kernel, stride=stride,
                               padding=kernel // 2,
                               output_padding=stride - 1, bias=False)
    else:
        conv = Conv2d(cin, cout, kernel, stride=stride,
                      padding=kernel // 2 if padding is None else padding,
                      bias=False)
    layers = [conv, BatchNorm(cout)]
    if relu:
        layers.append(nn.ReLU())
    return layers
