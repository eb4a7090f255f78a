"""The plain reference of CenterPoint-Voxel (Waymo): mean VFE ->
SpMiddleResNetFHD (21 sparse convs, 8 residual blocks) -> RPN ->
CenterHead -> center decode -> greedy rotated NMS, in float32 PyTorch with
no kernel, no capacity and no padding.

Written from tianweiy/CenterPoint (det3d/models/backbones/scn.py,
necks/rpn.py, bbox_heads/center_head.py, core/bbox/box_torch_ops.py) and
its config configs/waymo/voxelnet/waymo_centerpoint_voxelnet_3x.py. It
imports nothing of the program and no JAX; its parameters carry the
program's state-dict names, so one set of weights loads into both.

- Rulebooks are its own: each stage's active sites are sorted integer keys
  of their (b, z, y, x) coords, and a conv's tap k is the list of (output
  row, input row) pairs it joins, found by binary search of those keys: a
  submanifold conv reads the site at the output's coords + offset - 1; a
  strided conv follows spconv's output rule (output o reads input
  o * s - p + k per axis and exists where it reads an active site).
- A sparse conv runs tap by tap: the hit input rows times the tap's
  weights, added into the hit output rows. Only the hit rows are
  multiplied, so its arithmetic is 2 x hits x Cin x Cout, which is also
  what ``FlopCounterMode`` counts; on the card this keeps a Waymo-size
  batch within memory.
- Residual blocks as scn.py's ``SparseBasicBlock``: subm conv (bias), BN,
  ReLU, subm conv (bias), BN, plus the block's input, ReLU. BatchNorm runs
  in eval mode on its running statistics (``calibrate_bn`` sets them from
  one batch), eps 1e-3 in the backbone and the RPN; the head's
  BatchNorms (the shared conv's and the separate heads', each an
  ``nn.BatchNorm2d`` in center_head.py) keep torch's 1e-5.
- The RPN (rpn.py): per level a 3x3 conv at the level's stride (the
  source's ZeroPad2d(1) as the conv's padding) and ``layer_nums`` 3x3
  convs, each with BN and ReLU; each level upsampled by a transposed conv
  with kernel = stride (at stride 1 the source's 1x1 conv: the same
  function), BN, ReLU; the levels concatenated.
- The decode (center_head.py ``predict``): score = sigmoid of the best
  class, kept above the threshold and with the box center inside the
  post-center range; center (index + offset) x out_size_factor x voxel
  size + range minimum; z the height head; sizes exp(dim); heading
  atan2(sin, cos). Boxes in CenterPoint's layout (x, y, z, dx, dy, dz,
  heading), heading counter-clockwise from x.
- NMS (box_torch_ops.rotate_nms_pcdet): the kept boxes by score, highest
  first (ties: the lower position first), at most ``pre``; each is kept
  unless a kept box overlaps it by a BEV IoU over the threshold; at most
  ``post``. The IoU is the area of the clipped polygon: the corners of
  each rectangle inside the other and the crossings of their edges,
  ordered by angle about their mean, summed by the shoelace formula.

Departures from the source: the heads' outputs are flattened to [B, H*W,
c] in (y, x) order as the program's are (the source keeps [B, H, W, c]);
the rotated NMS is this greedy loop, where the source calls the iou3d_nms
CUDA extension; classes share one NMS (the Waymo config's
``use_multi_class_nms=False``); the voxelizer and the points are the
caller's (the benchmark's scans are synthetic).
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# (channels, residual blocks, down kernel, down stride, down padding) per
# stage: conv_input + conv1, conv2, conv3, conv4, extra_conv (scn.py)
PLAN = [
    (16, 2, None, None, None),
    (32, 2, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (64, 2, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (128, 2, (3, 3, 3), (2, 2, 2), (0, 1, 1)),
    (128, 0, (3, 1, 1), (2, 1, 1), (0, 0, 0)),
]
BN_EPS, HEAD_BN_EPS = 1e-3, 1e-5


def exact_matmuls():
    """float32 matmuls and convs on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def subm_taps(coords: torch.Tensor, shape) -> List[Tuple]:
    """A 3x3x3 submanifold conv over active sites ``coords`` [N, 4]
    (b, z, y, x), sorted by key: per tap k, (output rows, input rows);
    output n reads the site at coords[n] + offset_k - 1."""
    _, d, h, w = shape
    keys = _keys(coords, shape)
    n = keys.shape[0]
    lim = torch.tensor([d, h, w], device=coords.device)
    taps = []
    for off in _offsets((3, 3, 3), coords.device):
        nb = coords.clone()
        nb[:, 1:] += off - 1
        ok = ((nb[:, 1:] >= 0) & (nb[:, 1:] < lim)).all(1)
        k = _keys(nb, shape)
        pos = torch.searchsorted(keys, k).clamp_(max=n - 1)
        out = torch.nonzero(ok & (keys[pos] == k)).squeeze(1)
        taps.append((out, pos[out]))
    return taps


def down_taps(coords: torch.Tensor, shape, kernel, stride, padding):
    """A strided sparse conv (spconv's output rule): output o reads input
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
    out = torch.stack([out_keys // (od * oh * ow),
                       (out_keys // (oh * ow)) % od,
                       (out_keys // ow) % oh, out_keys % ow], 1)
    taps = []
    for t in range(offs.shape[0]):
        rows_in = torch.nonzero(ok[:, t]).squeeze(1)
        rows_out = torch.searchsorted(out_keys, ckeys[rows_in, t])
        taps.append((rows_out, rows_in))
    return out, out_shape, taps


def build_chain(coords: torch.Tensor, shape) -> dict:
    """Every stage's active coords and every conv's taps, from the voxels'
    unique (b, z, y, x) coords [N, 4] (int64, sorted by key) on the grid
    (B, D, H, W)."""
    chain = {"coords": [coords], "shapes": [tuple(shape)], "subm": [],
             "down": []}
    for stage, (_, n_blocks, dk, ds, dp) in enumerate(PLAN):
        if stage > 0:
            coords, shape, taps = down_taps(coords, shape, dk, ds, dp)
            chain["down"].append(taps)
            chain["coords"].append(coords)
            chain["shapes"].append(shape)
        chain["subm"].append(subm_taps(coords, shape)
                             if stage < 4 else None)
    return chain


def sort_voxels(voxels, num_points, coords, shape):
    """The voxels in key order (the chain's row order)."""
    order = torch.argsort(_keys(coords, shape))
    return voxels[order], num_points[order], coords[order]


def conv_hits(taps) -> int:
    return sum(int(o.numel()) for o, _ in taps)


# ----------------------------------------------------------------------------
# modules (the program's state-dict names)
# ----------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """Eval mode: the running statistics. Training mode (``calibrate_bn``
    only): the batch's, biased, over every row (a sparse stage's active
    sites) or every position of a dense map."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [i for i in range(x.dim()) if i != 1]
            mean = x.mean(dims)
            var = ((x - mean.view(shape)) ** 2).mean(dims)
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        s = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * s.view(shape) + (self.bias - self.running_mean * s
                                    ).view(shape)


class SparseWeight(nn.Module):
    def __init__(self, cin, cout, kernel, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*kernel, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, taps, n_out: int) -> torch.Tensor:
        w = self.weight.reshape(-1, *self.weight.shape[-2:])
        y = x.new_zeros(n_out, w.shape[-1])
        for k, (rows_out, rows_in) in enumerate(taps):
            if rows_out.numel():
                y = y.index_add(0, rows_out, x[rows_in] @ w[k])
        return y if self.bias is None else y + self.bias


class Block(nn.Module):
    """scn.py's ``SparseBasicBlock``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = SparseWeight(c, c, (3, 3, 3), bias=True)
        self.bn1 = BatchNorm(c)
        self.conv2 = SparseWeight(c, c, (3, 3, 3), bias=True)
        self.bn2 = BatchNorm(c)

    def forward(self, x, taps):
        n = x.shape[0]
        y = torch.relu(self.bn1(self.conv1(x, taps, n)))
        return torch.relu(self.bn2(self.conv2(y, taps, n)) + x)


class Backbone(nn.Module):
    """SpMiddleResNetFHD: (features [N, 5] in key order, chain) -> BEV
    [B, 128 * D, H, W]."""

    def __init__(self, cin: int = 5):
        super().__init__()
        for stage, (c, n_blocks, dk, _, _) in enumerate(PLAN):
            head = [SparseWeight(cin, c, dk or (3, 3, 3)), BatchNorm(c),
                    nn.ReLU()]
            blocks = [Block(c) for _ in range(n_blocks)]
            if stage == 0:
                self.conv_input = nn.ModuleList(head)
                self.conv1 = nn.ModuleList(blocks)
            elif stage < 4:
                setattr(self, f"conv{stage + 1}", nn.ModuleList(head + blocks))
            else:
                self.extra_conv = nn.ModuleList(head)
            cin = c

    def stages(self):
        out = []
        for stage in range(len(PLAN)):
            if stage == 0:
                out.append((self.conv_input, list(self.conv1)))
            elif stage < 4:
                m = getattr(self, f"conv{stage + 1}")
                out.append((m, list(m)[3:]))
            else:
                out.append((self.extra_conv, []))
        return out

    def forward(self, x: torch.Tensor, chain: dict) -> torch.Tensor:
        for stage, (head, blocks) in enumerate(self.stages()):
            n = chain["coords"][stage].shape[0]
            taps = (chain["subm"][0] if stage == 0
                    else chain["down"][stage - 1])
            x = torch.relu(head[1](head[0](x, taps, n)))
            for blk in blocks:
                x = blk(x, chain["subm"][stage])
        c = chain["coords"][4]
        b, d, h, w = chain["shapes"][4]
        dense = x.new_zeros(b, d, h, w, x.shape[1])
        dense[c[:, 0], c[:, 1], c[:, 2], c[:, 3]] = x
        # channel order c*D + d (scn.py's view of [N, C, D, H, W])
        return dense.permute(0, 4, 1, 2, 3).reshape(b, -1, h, w)

    def convs(self):
        """(conv, its input rows' stage, its taps' key) in call order."""
        out = []
        for stage, (head, blocks) in enumerate(self.stages()):
            out.append((head[0], stage - 1 if stage else 0,
                        ("subm", 0) if stage == 0 else ("down", stage - 1)))
            for blk in blocks:
                for conv in (blk.conv1, blk.conv2):
                    out.append((conv, stage, ("subm", stage)))
        return out


def _conv_bn_relu(cin, cout, stride=1, eps=BN_EPS, bias=False):
    return [nn.Conv2d(cin, cout, 3, stride, 1, bias=bias),
            BatchNorm(cout, eps), nn.ReLU()]


class RPN(nn.Module):
    def __init__(self, cin=256, layer_nums=(5, 5), ds_strides=(1, 2),
                 ds_filters=(128, 256), us_strides=(1, 2),
                 us_filters=(256, 256)):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        for i, n in enumerate(layer_nums):
            f = ds_filters[i]
            layers = [nn.Identity()] + _conv_bn_relu(cin, f, ds_strides[i])
            for _ in range(n):
                layers += _conv_bn_relu(f, f)
            self.blocks.append(nn.Sequential(*layers))
            s = us_strides[i]
            self.deblocks.append(nn.Sequential(
                nn.ConvTranspose2d(f, us_filters[i], s, stride=s, bias=False),
                BatchNorm(us_filters[i]), nn.ReLU()))
            cin = f

    def forward(self, x):
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        return torch.cat(ups, 1)


HEADS = (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("hm", 3))


class SepHead(nn.Module):
    def __init__(self, cin=64, head_conv=64, heads=HEADS):
        super().__init__()
        self.names = [n for n, _ in heads]
        for name, c in heads:
            setattr(self, name, nn.Sequential(
                nn.Conv2d(cin, head_conv, 3, 1, 1, bias=True),
                BatchNorm(head_conv, HEAD_BN_EPS), nn.ReLU(),
                nn.Conv2d(head_conv, c, 3, 1, 1, bias=True)))

    def forward(self, x):
        b, _, h, w = x.shape
        out = {}
        for name in self.names:
            y = getattr(self, name)(x)
            out[name] = y.permute(0, 2, 3, 1).reshape(b, h * w, y.shape[1])
        return out


class CenterHead(nn.Module):
    def __init__(self, cin=512, share=64):
        super().__init__()
        self.shared_conv = nn.Sequential(*_conv_bn_relu(
            cin, share, eps=HEAD_BN_EPS, bias=True))
        self.tasks = nn.ModuleList([SepHead(share)])

    def forward(self, x):
        return self.tasks[0](self.shared_conv(x))


class CenterPoint(nn.Module):
    """forward(voxels [V, P, 5], num_points [V], chain) -> the head dict
    of [B, H*W, c] float32 tensors. The voxels are in the chain's row
    order (``sort_voxels``); ``chain`` is ``self.chain(coords, B)``."""

    def __init__(self, sparse_shape=(41, 1504, 1504), num_features=5):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.num_features = num_features
        self.backbone = Backbone(num_features)
        self.neck = RPN()
        self.bbox_head = CenterHead()

    def chain(self, coords: torch.Tensor, batch_size: int) -> dict:
        return build_chain(coords.long(), (batch_size,) + self.sparse_shape)

    def forward(self, voxels, num_points, chain: dict) -> dict:
        feats = (voxels[:, :, :self.num_features].sum(1)
                 / num_points.clamp_min(1).to(voxels.dtype)[:, None])
        return self.bbox_head(self.neck(self.backbone(feats, chain)))


def sparse_conv_shapes(model: CenterPoint, chain: dict):
    """(cin, cout, hits, n_in, n_out, taps) of each of the 21 sparse convs
    of a forward over ``chain``, in call order."""
    out = []
    for conv, stage_in, (kind, i) in model.backbone.convs():
        taps = chain[kind][i]
        n_out = chain["coords"][i + 1 if kind == "down" else i].shape[0]
        w = conv.weight
        out.append((w.shape[-2], w.shape[-1], conv_hits(taps),
                    chain["coords"][stage_in].shape[0], n_out, len(taps)))
    return out


@torch.no_grad()
def calibrate_bn(model: CenterPoint, voxels, num_points, chain) -> dict:
    """The state dict of ``model`` with every BatchNorm's running
    statistics set to the batch statistics of one forward over these
    inputs; ``model`` is left as it was."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    try:
        model(voxels, num_points, chain)
        out = {k: v.clone() for k, v in model.state_dict().items()}
    finally:
        model.load_state_dict(saved)
        model.eval()
    return out


# ----------------------------------------------------------------------------
# decode and NMS
# ----------------------------------------------------------------------------

def decode(head: dict, grid: Sequence[float]) -> dict:
    """One scene's head outputs [H*W, c] -> ``boxes`` [H*W, 7] (x, y, z,
    dx, dy, dz, heading), ``scores`` and ``labels`` [H*W]. ``grid`` is
    (H, W, x step, y step, x origin, y origin)."""
    h, w, sx, sy, x0, y0 = grid
    dev = head["hm"].device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    x = (xs.reshape(-1).float() + head["reg"][:, 0]) * sx + x0
    y = (ys.reshape(-1).float() + head["reg"][:, 1]) * sy + y0
    rot = torch.atan2(head["rot"][:, 0], head["rot"][:, 1])
    boxes = torch.cat([x[:, None], y[:, None], head["height"],
                       torch.exp(head["dim"]), rot[:, None]], 1)
    scores, labels = torch.sigmoid(head["hm"]).max(1)
    return {"boxes": boxes, "scores": scores, "labels": labels}


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> [..., 4, 2] BEV corners, counter-clockwise."""
    unit = torch.tensor(((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)),
                        dtype=boxes.dtype, device=boxes.device)
    local = unit * boxes[..., None, 3:5]
    c = torch.cos(boxes[..., 6])[..., None]
    s = torch.sin(boxes[..., 6])[..., None]
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return torch.stack([x, y], -1) + boxes[..., None, :2]


def _cross(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _inside(p, poly, tol):
    """[..., P, 2] points in the counter-clockwise [..., 4, 2] polygon,
    its boundary within ``tol`` included -> [..., P]."""
    e = torch.roll(poly, -1, -2) - poly
    rel = p[..., :, None, :] - poly[..., None, :, :]
    return (_cross(e[..., None, :, :], rel) >= -tol).all(-1)


def bev_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The area of the intersection of the BEV rectangles of [..., 7]
    boxes: the clipped polygon."""
    a, b = torch.broadcast_tensors(a, b)
    pa, pb = corners(a), corners(b)

    def tol(box):
        size = box[..., 3:5].amax(-1)
        return (1e-6 * size * size)[..., None, None]

    in_a = _inside(pa, pb, tol(b))
    in_b = _inside(pb, pa, tol(a))
    da = torch.roll(pa, -1, -2) - pa
    db = torch.roll(pb, -1, -2) - pb
    ai, dai = pa[..., :, None, :], da[..., :, None, :]
    bj, dbj = pb[..., None, :, :], db[..., None, :, :]
    den = _cross(dai, dbj)
    par = den.abs() < 1e-12
    safe = torch.where(par, torch.ones_like(den), den)
    t = _cross(bj - ai, dbj) / safe
    u = _cross(bj - ai, dai) / safe
    hit = ~par & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    xs = (ai + t[..., None] * dai).flatten(-3, -2)
    verts = torch.cat([pa, pb, xs], -2)
    ok = torch.cat([in_a, in_b, hit.flatten(-2)], -1)
    n = ok.sum(-1)
    wts = ok.to(verts.dtype)
    mean = ((verts * wts[..., None]).sum(-2)
            / n.clamp_min(1)[..., None].to(verts.dtype))
    rel = verts - mean[..., None, :]
    ang = torch.where(ok, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 10.0))
    order = ang.argsort(-1)
    v = verts.gather(-2, order[..., None].expand_as(verts))
    oks = ok.gather(-1, order)
    v = torch.where(oks[..., None], v, v[..., :1, :])
    area = 0.5 * _cross(v, torch.roll(v, -1, -2)).sum(-1)
    return torch.where(n >= 3, area, torch.zeros_like(area)).clamp_min(0.0)


def iou_bev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    inter = bev_overlap(a, b)
    union = a[..., 3] * a[..., 4] + b[..., 3] * b[..., 4] - inter
    return inter / union.clamp_min(1e-7)


def iou_bev_matrix(a: torch.Tensor, b: torch.Tensor,
                   rows: int = 128) -> torch.Tensor:
    """[N, 7] x [M, 7] -> [N, M] BEV IoU, ``rows`` rows at a time."""
    return torch.cat([iou_bev(a[i:i + rows, None], b[None])
                      for i in range(0, len(a), rows)] or
                     [a.new_zeros(0, len(b))])


def greedy_nms(boxes: torch.Tensor, iou_threshold: float,
               post: int) -> List[int]:
    """Boxes in visiting order -> the indices kept, in order."""
    iou = iou_bev_matrix(boxes, boxes).cpu().numpy()
    keep: List[int] = []
    gone = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        if gone[i]:
            continue
        keep.append(i)
        if len(keep) == post:
            break
        gone |= iou[i] > iou_threshold
    return keep


def detections(head: dict, cfg: dict) -> dict:
    """One scene's head outputs [H*W, c] and the decode settings (``grid``,
    ``score_threshold``, ``post_center_range``, ``pre``, ``post``,
    ``iou_threshold``) -> the kept ``boxes`` [K, 7], ``scores`` [K] and
    ``labels`` [K], in NMS order."""
    d = decode({k: v.float() for k, v in head.items()}, cfg["grid"])
    pcr = torch.tensor(cfg["post_center_range"], dtype=torch.float32,
                       device=d["boxes"].device)
    ctr = d["boxes"][:, :3]
    ok = ((d["scores"] > cfg["score_threshold"])
          & (ctr >= pcr[:3]).all(1) & (ctr <= pcr[3:]).all(1))
    cand = torch.nonzero(ok)[:, 0]
    order = torch.argsort(d["scores"][cand], descending=True,
                          stable=True)[:cfg["pre"]]
    cand = cand[order]
    keep = greedy_nms(d["boxes"][cand], cfg["iou_threshold"], cfg["post"])
    sel = cand[torch.tensor(keep, dtype=torch.long, device=cand.device)]
    return {"boxes": d["boxes"][sel], "scores": d["scores"][sel],
            "labels": d["labels"][sel]}


def model_flops(model: CenterPoint, voxels, num_points, chain) -> float:
    """The operations one forward asks for, as ``FlopCounterMode`` counts
    them: 2 x hits x Cin x Cout for the sparse convs, the dense layers as
    they are."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(voxels, num_points, chain)
    return float(counter.get_total_flops())


def sizes(model: CenterPoint) -> dict:
    """The published widths of the reference as built (for the tests)."""
    convs = model.backbone.convs()
    return {"sparse_convs": len(convs),
            "channels": sorted({int(c.weight.shape[-1]) for c, _, _ in convs}),
            "rpn_out": sum(d[0].out_channels for d in model.neck.deblocks),
            "params": sum(p.numel() for p in model.parameters())}


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    amax = x.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax  # per tensor, the largest value at e4m3's max
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def quantized(model: CenterPoint, fmt: str) -> CenterPoint:
    """A copy of ``model`` in a lower precision's place: every weight, and
    every conv's input and output and every BatchNorm's output, rounded to
    ``fmt`` ("bf16", or "fp8": float8 e4m3 at a per-tensor scale), where a
    program computing in that type keeps them."""
    import copy

    q = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in q.named_parameters():
            if p.dim() > 1:
                p.copy_(_round(p, fmt))

    def pre(_m, args):
        return (_round(args[0], fmt),) + tuple(args[1:])

    def post(_m, _args, out):
        return _round(out, fmt)

    for m in q.modules():
        if isinstance(m, (SparseWeight, nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)
        elif isinstance(m, BatchNorm):
            m.register_forward_hook(post)
    return q
