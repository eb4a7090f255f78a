"""The plain reference of the SE-SSD Car detector: VoxelNet = mean VFE ->
SpMiddleFHD (14 sparse conv blocks) -> SSFA neck -> multi-group head, in
float32 PyTorch with no kernel, no capacity and no padding.

It imports nothing of the program. Its parameters carry the program's
state-dict names, so one set of weights, made by ``weights.py`` from the
seed, loads into both. Where the program has two execution plans (the
student's dense stages 3-4, the teacher's all-sparse plan, the serving
plan with BatchNorm folded), the reference has one: every sparse stage is
sparse, which is the same arithmetic (a submanifold conv is a dense conv
times the occupancy; a strided sparse conv is a dense strided conv times
the covered-site mask).

The rulebooks are this module's own: from the voxels' (b, z, y, x) coords,
each stage's active sites are sorted keys, and each tap of a conv is the
list of (output row, input row) pairs it joins, found by binary search.
A sparse conv then multiplies only the rows a tap hits, so its arithmetic
is 2 x hits x Cin x Cout, which is also what ``FlopCounterMode`` counts.

``quant`` puts the reference in a lower precision's place: every tensor
the program keeps in its compute type rounded to ``fp8`` (the control of a
bfloat16 configuration) or ``bf16`` (a witness of what bfloat16 alone does
to the compared numbers), forward and backward.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

# (channels, subm convs, down kernel, down stride, down padding) per stage
PLAN = [
    (16, 2, None, None, None),
    (32, 2, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (64, 3, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (64, 3, (3, 3, 3), (2, 2, 2), (0, 1, 1)),
    (64, 0, (3, 1, 1), (2, 1, 1), (0, 0, 0)),
]
BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    amax = x.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax  # per tensor, the largest value at e4m3's max
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Round(torch.autograd.Function):
    """A tensor rounded to a lower precision on the way forward, and its
    gradient rounded the same way on the way back: where the program keeps
    a tensor in its compute type, the reference put in its place keeps it
    in ``fmt`` ("bf16", or "fp8": float8 e4m3 at a per-tensor scale)."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt), None


def rounder(fmt):
    """``fmt`` None: the identity (the float32 reference); else the
    rounding of every tensor the program keeps in its compute type: each
    conv's input, weight and output, each BatchNorm's output, the neck's
    attention and mix, the head's outputs."""
    if fmt is None:
        return lambda x: x
    return lambda x: Round.apply(x, fmt)


# ----------------------------------------------------------------------------
# rulebooks
# ----------------------------------------------------------------------------

def _keys(c: torch.Tensor, shape) -> torch.Tensor:
    _, d, h, w = shape
    return ((c[:, 0] * d + c[:, 1]) * h + c[:, 2]) * w + c[:, 3]


def _offsets(kernel, device) -> torch.Tensor:
    """[K, 3] (dz, dy, dx), row-major over the kernel."""
    return torch.tensor(list(itertools.product(*(range(k) for k in kernel))),
                        device=device)


def _find(sorted_keys, order, keys, ok):
    """Rows of ``keys`` among the sorted ones: (hit mask, input row)."""
    n = sorted_keys.shape[0]
    pos = torch.searchsorted(sorted_keys, keys).clamp_(max=n - 1)
    hit = ok & (sorted_keys[pos] == keys)
    return hit, order[pos]


def subm_taps(coords: torch.Tensor, shape) -> List[Tuple]:
    """A 3x3x3 submanifold conv over active sites ``coords`` [N, 4]
    (b, z, y, x): per tap k, (output rows, input rows); output n reads the
    site at coords[n] + offset_k - 1."""
    _, d, h, w = shape
    keys = _keys(coords, shape)
    sk, order = torch.sort(keys)
    lim = torch.tensor([d, h, w], device=coords.device)
    taps = []
    for off in _offsets((3, 3, 3), coords.device):
        nb = coords.clone()
        nb[:, 1:] += off - 1
        ok = ((nb[:, 1:] >= 0) & (nb[:, 1:] < lim)).all(1)
        hit, rows = _find(sk, order, _keys(nb, shape), ok)
        out = torch.nonzero(hit).squeeze(1)
        taps.append((out, rows[out]))
    return taps


def down_taps(coords: torch.Tensor, shape, kernel, stride, padding):
    """A strided sparse conv (spconv semantics): output o reads input
    i = o * s - p + k per axis, and exists where it reads an active input.
    Returns (output coords [M, 4] in key order, output grid shape, taps)."""
    b, d, h, w = shape
    dims = torch.tensor([d, h, w], device=coords.device)
    s = torch.tensor(stride, device=coords.device)
    p = torch.tensor(padding, device=coords.device)
    k = torch.tensor(kernel, device=coords.device)
    odims = (dims + 2 * p - k) // s + 1
    out_shape = (b,) + tuple(int(v) for v in odims)
    offs = _offsets(kernel, coords.device)
    num = coords[:, None, 1:] + p - offs[None]          # [N, K, 3]
    o = torch.div(num, s, rounding_mode="floor")
    ok = ((num % s == 0) & (o >= 0) & (o < odims)).all(-1)
    cand = torch.cat([coords[:, None, :1].expand(-1, offs.shape[0], 1), o],
                     -1)
    ckeys = _keys(cand.reshape(-1, 4), out_shape).reshape(ok.shape)
    out_keys = torch.unique(ckeys[ok])                 # sorted
    _, od, oh, ow = out_shape
    out = torch.stack([out_keys // (od * oh * ow), (out_keys // (oh * ow)) % od,
                       (out_keys // ow) % oh, out_keys % ow], 1)
    taps = []
    for t in range(offs.shape[0]):
        rows_in = torch.nonzero(ok[:, t]).squeeze(1)
        rows_out = torch.searchsorted(out_keys, ckeys[rows_in, t])
        taps.append((rows_out, rows_in))
    return out, out_shape, taps


def build_chain(coords: torch.Tensor, shape) -> dict:
    """Every stage's active coords and every conv's taps, from the voxels'
    (b, z, y, x) coords [N, 4] (int64, unique) on the grid (B, D, H, W)."""
    chain = {"coords": [coords], "shapes": [tuple(shape)], "subm": [],
             "down": []}
    for stage, (_, n_subm, dk, ds, dp) in enumerate(PLAN):
        if stage > 0:
            coords, shape, taps = down_taps(coords, shape, dk, ds, dp)
            chain["down"].append(taps)
            chain["coords"].append(coords)
            chain["shapes"].append(shape)
        chain["subm"].append(subm_taps(coords, shape) if n_subm else None)
    return chain


def conv_hits(taps) -> int:
    return sum(int(o.numel()) for o, _ in taps)


# ----------------------------------------------------------------------------
# modules (the program's state-dict names)
# ----------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """Training mode: batch statistics in float32, the variance biased (no
    Bessel correction, in the normalization and in the running statistics
    alike), the running statistics moved by ``momentum``; over the rows
    given (the sparse stages' active sites) two-pass, over a dense map
    E[x^2] - E[x]^2 clipped at 0. Eval mode: the running statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.momentum = BN_MOMENTUM

    def forward(self, x: torch.Tensor, rows: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            s = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return x * s.view(shape) + (self.bias - self.running_mean * s
                                        ).view(shape)
        dims = [i for i in range(x.dim()) if i != 1]
        mean = x.mean(dims)
        if rows:
            var = ((x - mean.view(shape)) ** 2).mean(dims)
        else:
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(
                self.momentum * var)
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


class SparseWeight(nn.Module):
    def __init__(self, cin, cout, kernel):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*kernel, cin, cout))


class Backbone(nn.Module):
    def __init__(self, cin: int = 4):
        super().__init__()
        layers = []
        for feats, n_subm, dk, _, _ in PLAN:
            for k in ([dk] if dk else []) + [(3, 3, 3)] * n_subm:
                layers += [SparseWeight(cin, feats, k), BatchNorm(feats),
                           nn.ReLU()]
                cin = feats
        self.middle_conv = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, chain: dict, quant: Callable):
        blocks = iter(range(0, len(self.middle_conv), 3))

        def block(x, taps, n_out):
            i = next(blocks)
            w = quant(self.middle_conv[i].weight)
            w = w.reshape(-1, *w.shape[-2:])
            xq = quant(x)
            y = x.new_zeros(n_out, w.shape[-1])
            for k, (rows_out, rows_in) in enumerate(taps):
                if rows_out.numel():
                    y = y.index_add(0, rows_out, xq[rows_in] @ w[k])
            return torch.relu(quant(self.middle_conv[i + 1](quant(y),
                                                           rows=True)))

        for stage, (_, n_subm, _, _, _) in enumerate(PLAN):
            n = chain["coords"][stage].shape[0]
            if stage > 0:
                x = block(x, chain["down"][stage - 1], n)
            for _ in range(n_subm):
                x = block(x, chain["subm"][stage], n)
        c = chain["coords"][4]
        b, d, h, w = chain["shapes"][4]
        dense = x.new_zeros(b, d, h, w, x.shape[1])
        dense[c[:, 0], c[:, 1], c[:, 2], c[:, 3]] = x
        # channel order c*D + d (scn.py:186-188)
        return dense.permute(0, 4, 1, 2, 3).reshape(b, -1, h, w)


class ConvBlock(nn.Sequential):
    """conv (no bias), BatchNorm, optional ReLU; a leading ZeroPad2d where
    ``pad_first`` (the SSFA's first block), as the reference indexes them."""

    def __init__(self, spec: Sequence[tuple], pad_first: bool = False):
        layers: List[nn.Module] = [nn.ZeroPad2d(1)] if pad_first else []
        for cin, cout, k, stride, padding, transpose, relu in spec:
            if transpose:
                conv = nn.ConvTranspose2d(cin, cout, k, stride, k // 2,
                                          output_padding=stride - 1,
                                          bias=False)
            else:
                conv = nn.Conv2d(cin, cout, k, stride,
                                 k // 2 if padding is None else padding,
                                 bias=False)
            layers += [conv, BatchNorm(cout)] + ([nn.ReLU()] if relu else [])
        super().__init__(*layers)

    def run(self, x, quant):
        for m in self:
            if isinstance(m, nn.ConvTranspose2d):
                x = quant(F.conv_transpose2d(quant(x), quant(m.weight), None,
                                             m.stride, m.padding,
                                             m.output_padding))
            elif isinstance(m, nn.Conv2d):
                x = quant(F.conv2d(quant(x), quant(m.weight), None, m.stride,
                                   m.padding))
            elif isinstance(m, BatchNorm):
                x = quant(m(x))
            else:
                x = m(x)
        return x


def _c(cin, cout, k=3, stride=1, padding=None, transpose=False, relu=True):
    return (cin, cout, k, stride, padding, transpose, relu)


class SSFA(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.bottom_up_block_0 = ConvBlock(
            [_c(c, 128, padding=0), _c(128, 128), _c(128, 128)], True)
        self.bottom_up_block_1 = ConvBlock(
            [_c(128, 256, stride=2), _c(256, 256), _c(256, 256)])
        self.trans_0 = ConvBlock([_c(128, 128, 1)])
        self.trans_1 = ConvBlock([_c(256, 256, 1)])
        self.deconv_block_0 = ConvBlock([_c(256, 128, 3, 2, transpose=True)])
        self.deconv_block_1 = ConvBlock([_c(256, 128, 3, 2, transpose=True)])
        self.conv_0 = ConvBlock([_c(128, 128)])
        self.w_0 = ConvBlock([_c(128, 1, 1, relu=False)])
        self.conv_1 = ConvBlock([_c(128, 128)])
        self.w_1 = ConvBlock([_c(128, 1, 1, relu=False)])

    def forward(self, x, quant):
        x0 = self.bottom_up_block_0.run(x, quant)
        x1 = self.bottom_up_block_1.run(x0, quant)
        t0 = self.trans_0.run(x0, quant)
        t1 = self.trans_1.run(x1, quant)
        h, w = x0.shape[-2:]
        m0 = quant(self.deconv_block_0.run(t1, quant)[:, :, :h, :w] + t0)
        m1 = self.deconv_block_1.run(t1, quant)[:, :, :h, :w]
        o0 = self.conv_0.run(m0, quant)
        o1 = self.conv_1.run(m1, quant)
        att = quant(torch.softmax(torch.cat([self.w_0.run(o0, quant),
                                             self.w_1.run(o1, quant)], 1), 1))
        return quant(quant(o0 * att[:, 0:1]) + quant(o1 * att[:, 1:2]))


class TaskHead(nn.Module):
    def __init__(self, c: int = 128, na: int = 2, num_class: int = 1):
        super().__init__()
        self.na = na
        self.conv_box = nn.Conv2d(c, na * 7, 1)
        self.conv_cls = nn.Conv2d(c, na * num_class, 1)
        self.conv_iou = nn.Conv2d(c, na, 1)
        self.conv_dir = nn.Conv2d(c, na * 2, 1)
        self.heads = [("box_preds", "conv_box", 7),
                      ("cls_preds", "conv_cls", num_class),
                      ("iou_preds", "conv_iou", 1),
                      ("dir_cls_preds", "conv_dir", 2)]

    def forward(self, x, quant):
        b, _, h, w = x.shape
        out = {}
        for name, attr, c in self.heads:
            conv = getattr(self, attr)
            y = quant(F.conv2d(quant(x), quant(conv.weight),
                               quant(conv.bias)))
            out[name] = y.permute(0, 2, 3, 1).reshape(b, h * w * self.na, c)
        return out


class Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.tasks = nn.ModuleList([TaskHead()])


class VoxelNet(nn.Module):
    """forward(voxels [V, P, 4], num_points [V], coords [V, 4] (b, z, y, x),
    batch size) -> the task-0 head dict of [B, A, c] float32 tensors.
    ``sparse_shape`` is the (D, H, W) voxel grid."""

    def __init__(self, sparse_shape=(41, 1600, 1408), quant=None):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.quant = rounder(quant)
        self.backbone = Backbone(4)
        self.neck = SSFA(128)
        self.bbox_head = Head()

    def chain(self, coords: torch.Tensor, batch_size: int) -> dict:
        return build_chain(coords.long(), (batch_size,) + self.sparse_shape)

    def forward(self, voxels, num_points, chain: dict) -> dict:
        feats = (voxels[:, :, :4].sum(1)
                 / num_points.clamp_min(1).to(voxels.dtype)[:, None])
        bev = self.backbone(feats, chain, self.quant)
        return self.bbox_head.tasks[0](self.neck(bev, self.quant), self.quant)


def sparse_conv_shapes(model: VoxelNet, chain: dict):
    """(cin, cout, hits, n_in, n_out, taps) of each sparse conv of a
    forward over ``chain``, in call order: the counts a roofline bound is
    made of."""
    out = []
    convs = iter(range(0, len(model.backbone.middle_conv), 3))
    for stage, (_, n_subm, _, _, _) in enumerate(PLAN):
        n = chain["coords"][stage].shape[0]
        calls = ([(chain["down"][stage - 1], chain["coords"][stage - 1]
                   .shape[0])] if stage > 0 else [])
        calls += [(chain["subm"][stage], n)] * n_subm
        for taps, n_in in calls:
            w = model.backbone.middle_conv[next(convs)].weight
            out.append((w.shape[-2], w.shape[-1], conv_hits(taps), n_in, n,
                        len(taps)))
    return out


@torch.no_grad()
def calibrate_bn(model: VoxelNet, voxels, num_points, chain) -> dict:
    """The state dict of ``model`` with every BatchNorm's running statistics
    set to the batch statistics of one forward over these inputs (a
    trained detector's statistics stand in for a random one's, which would
    shrink the activations stage by stage). ``model`` is left as it was."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    model.train()
    for m in bns:
        m.momentum = 1.0
    try:
        model(voxels, num_points, chain)
        out = {k: v.clone() for k, v in model.state_dict().items()}
    finally:
        for m in bns:
            m.momentum = BN_MOMENTUM
        model.load_state_dict(saved)
    return out

