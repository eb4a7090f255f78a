"""Shared building blocks (port of ``sessd_tpu/models/layers.py``): the
BatchNorm of the sparse, dense-3D and BEV stages in both modes, its affine
fold for serving, and the reference's conv + BN + ReLU triples.

Norm semantics follow the reference: BatchNorm eps 1e-3 and momentum 0.01
(scn.py:103, rpn_v1.py:131), i.e. flax momentum 0.99. Parameters stay
float32; convs cast their weights to the dtype of their input, which is the
compute dtype (flax's ``nn.Conv(dtype=...)``). Outside autograd (serving,
the teacher) those casts and the BatchNorm fold are made once and kept
(``derived``), so a request launches no per-call weight casts.

In eval mode outside autograd (serving, validation), ``Sequential`` runs
each dense conv that an eval BatchNorm follows as one conv on the pair's
folded parameters (``fold_conv_bn``), the ReLU after it fused into cuDNN's
call on the card, with channels-last weights, as an eval conv on a
channels-last input keeps its own: the BEV maps stay NHWC, the layout
cuDNN computes in, so no BatchNorm pass and no layout transpose runs
around a conv. Training mode and autograd take the plain path.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from ..parallel.mesh import all_reduce_sum
from ..utils.profiling import count


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


def _eval_layout(module: nn.Module) -> bool:
    """Whether ``module``'s call takes the eval path (eval mode, outside
    autograd), on which 4-D weights may be kept channels-last."""
    return not module.training and not torch.is_grad_enabled()


def _cast(module: nn.Module, dtype: torch.dtype,
          like: Optional[torch.Tensor] = None):
    """(weight, bias or None) of a conv in ``dtype``; on the eval path a
    4-D weight channels-last where ``like``, the conv's input, is: the
    layout cuDNN's NHWC kernels read, so neither is transposed."""
    params = [p for p in (module.weight, module.bias) if p is not None]
    cl = (like is not None and module.weight.dim() == 4
          and _eval_layout(module)
          and like.is_contiguous(memory_format=torch.channels_last))

    def make():
        out = [p.to(dtype) for p in params]
        if cl:
            out[0] = out[0].contiguous(memory_format=torch.channels_last)
        return out

    cast = derived(module, (dtype, cl), params, make)
    return cast[0], (cast[1] if module.bias is not None else None)


def _pointwise(conv: nn.ConvTranspose2d) -> bool:
    """A 1x1 stride-1 transposed conv: the plain 1x1 conv of its weight
    with dims 0 and 1 swapped."""
    return (conv.kernel_size == (1, 1) and conv.stride == (1, 1)
            and conv.padding == (0, 0) and conv.output_padding == (0, 0)
            and conv.dilation == (1, 1) and conv.groups == 1)


def fold_conv_bn(conv: nn.Module, bn: "BatchNorm", dtype: torch.dtype):
    """(weight, bias) in ``dtype`` of the one conv that equals ``conv``
    followed by ``bn`` in eval mode: W * s over the output channels (dim 1
    of a transposed conv's weight) and b + conv bias * s, for the BN's
    (s, b) in f32, the weight channels-last; a 1x1 stride-1 transposed
    conv's weight as the plain conv's (``_pointwise``). Made once and kept
    (``derived``): a new conv or BN parameter or running statistic folds
    again."""
    transposed = isinstance(conv, nn.ConvTranspose2d)

    def make():
        s, b = bn.fold()
        w = conv.weight.float() * s.view((1, -1, 1, 1) if transposed
                                         else (-1, 1, 1, 1))
        if transposed and _pointwise(conv):
            w = w.transpose(0, 1)
        if conv.bias is not None:
            b = b + conv.bias.float() * s
        return (w.to(dtype).contiguous(memory_format=torch.channels_last),
                b.to(dtype))

    sources = [t for t in (conv.weight, conv.bias, bn.weight, bn.bias,
                           bn.running_mean, bn.running_var) if t is not None]
    return derived(conv, ("fold", dtype), sources, make)


def _conv_relu(x: torch.Tensor, weight, bias, stride, padding, dilation,
               groups, relu: bool) -> torch.Tensor:
    """conv2d(x) + bias, then ReLU where ``relu``: on the card one cuDNN
    call with the bias and ReLU in its epilogue."""
    if relu and x.is_cuda:
        return torch.cudnn_convolution_relu(x, weight, bias, stride, padding,
                                            dilation, groups)
    y = F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    return y.relu_() if relu else y


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype (f32 parameters).
    Given ``bn``, the eval BatchNorm that follows it (``Sequential``), it
    runs the pair, and a ReLU where ``relu``, as one conv on the folded
    parameters (``fold_conv_bn``)."""

    def forward(self, x: torch.Tensor, bn: Optional["BatchNorm"] = None,
                relu: bool = False) -> torch.Tensor:
        if bn is None:
            return self._conv_forward(x, *_cast(self, x.dtype, x))
        return _conv_relu(x, *fold_conv_bn(self, bn, x.dtype), self.stride,
                          self.padding, self.dilation, self.groups, relu)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in its input's dtype. With
    ``bn``, as ``Conv2d``: a 1x1 stride-1 one runs as the plain conv it
    equals; any other adds the bias and the ReLU in passes of their own
    (cuDNN fuses neither into a transposed conv)."""

    def forward(self, x: torch.Tensor, bn: Optional["BatchNorm"] = None,
                relu: bool = False) -> torch.Tensor:
        if bn is None:
            weight, bias = _cast(self, x.dtype, x)
        else:
            weight, bias = fold_conv_bn(self, bn, x.dtype)
            if _pointwise(self):
                return _conv_relu(x, weight, bias, (1, 1), (0, 0), (1, 1), 1,
                                  relu)
        y = F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return y.relu_() if relu else y


class Sequential(nn.Sequential):
    """``nn.Sequential`` (the same children, so the same state-dict keys)
    that, outside autograd, runs each ``Conv2d`` or ``ConvTranspose2d``
    followed by an eval ``BatchNorm`` (and a ReLU) as one call of the conv
    with the BatchNorm folded in, counted as ``conv_bn_folded``; anything
    else as ``nn.Sequential`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            return super().forward(x)
        mods = list(self)
        i = 0
        while i < len(mods):
            m, bn = mods[i], mods[i + 1] if i + 1 < len(mods) else None
            if (isinstance(m, (Conv2d, ConvTranspose2d))
                    and isinstance(bn, BatchNorm) and not bn.training):
                relu = i + 2 < len(mods) and isinstance(mods[i + 2], nn.ReLU)
                x = m(x, bn=bn, relu=relu)
                count("conv_bn_folded")
                i += 3 if relu else 2
            else:
                x = m(x)
                i += 1
        return x


@torch.no_grad()
def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill ``param`` from U(-bound, bound) drawn in f32 on the CPU
    ``generator`` (same values whatever the param's device and dtype)."""
    param.copy_(torch.empty(param.shape).uniform_(-bound, bound,
                                                  generator=generator))


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: Optional[int] = None, transpose: bool = False,
                 relu: bool = True) -> List[nn.Module]:
    """[conv, BN(, ReLU)] as the reference's Sequentials list them (the
    port puts them in a ``Sequential``, which folds the pair in eval).

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
