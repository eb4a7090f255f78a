"""Pillar-column execution plan of the sparse backbone's convs (port of
``sessd_tpu/ops/pillar.py``).

The voxel-row plan (``ops/sparse.py`` and the K1/K3/K4 kernels) gathers
one row of C values per (output voxel, tap). This plan re-lays the sparse
tensor as

    columns [P, D, C]   dense in z over the occupied BEV pillars,
    occ     [P, D]      the exact voxel occupancy inside each column,
    PillarSet ids [P]   sorted linearized (b, y, x) pillar ids,

so a 3x3x3 sparse conv becomes one gather of 9 neighbouring columns (P*9
rows of D*C contiguous values) and one dense conv over the (neighbour, z)
axes. Unoccupied sites hold zeros, so the dense sum is exactly the
submanifold sum over occupied neighbours; outputs are masked by
occupancy. A strided conv downsamples z inside the dense conv (its stride
on the z axis) and xy by a new pillar set, with spconv's covered-output
rule as a mask that a ones channel carries through the same gather.

The dense conv is ``F.conv2d`` (JAX's ``lax.conv``, which is XLA, not
Pallas, sessd_tpu/ops/pillar.py:223-227) and the column gather a plain
indexed gather. The JAX package parked the plan for a TPU measurement
(XLA's per-element gather, pillar.py:22-28), which says nothing of this
card; ``chip_smoke.py`` times it against K4 on an H100. It is not the
default anywhere: the backbone runs the voxel-row kernels.

It is an execution plan, not another model: the weights are the
backbone's [K, Cin, Cout] with row-major (dz, dy, dx) kernel offsets.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from .sparse import SENTINEL


class SparseGrid(NamedTuple):
    """The fields of the JAX package's ``SparseGrid`` (sparse.py:36-52)
    that ``pillars_from_grid`` reads: ids [N] int32, sorted ascending,
    SENTINEL-padded, linearized z-minor; shape (B, D, H, W)."""

    ids: torch.Tensor
    shape: Tuple[int, int, int, int]

    @property
    def mask(self) -> torch.Tensor:
        return self.ids < SENTINEL

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]


class PillarSet(NamedTuple):
    """Sorted BEV pillar index set of a fixed capacity.

    ids: [P] int32, sorted ascending, SENTINEL-padded; id = (b*H + y)*W + x.
    shape: (B, H, W); depth: the z extent D of the columns.
    """

    ids: torch.Tensor
    shape: Tuple[int, int, int]
    depth: int

    @property
    def mask(self) -> torch.Tensor:
        return self.ids < SENTINEL

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]


def pillars_from_grid(grid: SparseGrid, features: torch.Tensor,
                      capacity: int):
    """Re-lay a sorted z-minor grid as pillar columns. grid.ids are
    ((b*H + y)*W + x)*D + z, so the pillar ids ids // D are already sorted.
    Returns (pillars, cols [P, D, C], occ [P, D] in features' dtype)."""
    b, d, h, w = grid.shape
    mask = grid.mask
    ids = grid.ids.long()
    pid = torch.where(mask, ids // d, SENTINEL)
    z = ids % d
    is_new = torch.cat([mask[:1], pid[1:] != pid[:-1]]) & mask
    prow = torch.cumsum(is_new, 0) - 1  # [N] pillar row per voxel
    ok = mask & (prow < capacity)

    out = torch.full((capacity + 1,), SENTINEL, dtype=torch.int32,
                     device=ids.device)
    out[torch.where(is_new & ok, prow, capacity)] = pid.int()
    c = features.shape[-1]
    dest = torch.where(ok, prow * d + z, capacity * d)
    cols = features.new_zeros(capacity * d + 1, c)
    cols[dest] = torch.where(ok[:, None], features, 0.0).to(features.dtype)
    occ = features.new_zeros(capacity * d + 1)
    occ[dest] = ok.to(features.dtype)
    return (PillarSet(ids=out[:capacity], shape=(b, h, w), depth=d),
            cols[:-1].reshape(capacity, d, c), occ[:-1].reshape(capacity, d))


def _bev_lut(pillars: PillarSet) -> torch.Tensor:
    """Dense BEV id -> pillar row LUT (capacity = miss); int16 below 32767
    rows, else int32."""
    b, h, w = pillars.shape
    total = b * h * w
    cap = pillars.capacity
    dt = torch.int16 if cap < 2 ** 15 - 1 else torch.int32
    dev = pillars.ids.device
    lut = torch.full((total + 1,), cap, dtype=dt, device=dev)
    sid = torch.where(pillars.mask, pillars.ids.long(), total)
    lut[sid] = torch.arange(cap, dtype=dt, device=dev)
    return lut[:total]


def _kernel_offsets_2d(kernel: Tuple[int, int], device=None) -> torch.Tensor:
    """[kh*kw, 2] int32 (dy, dx) offsets in 0..k-1, row-major."""
    kh, kw = kernel
    yy, xx = torch.meshgrid(torch.arange(kh, device=device),
                            torch.arange(kw, device=device), indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], 1).int()


def bev_rulebook(in_pillars: PillarSet,
                 out_pillars: Optional[PillarSet] = None, kernel=(3, 3),
                 stride=(1, 1), padding=(1, 1)) -> torch.Tensor:
    """[P_out, kh*kw] int32 rows into the input pillars (capacity = miss).

    For a submanifold conv (``out_pillars`` None) the offsets are centred;
    for a strided one, output site o reads input i = o*s - p + k per axis,
    ``ops.sparse.downsample_rulebook``'s rule."""
    b, h, w = in_pillars.shape
    offs = _kernel_offsets_2d(kernel, in_pillars.ids.device)
    if out_pillars is None:
        out_pillars = in_pillars
        offs = offs - (torch.tensor(kernel, dtype=torch.int32,
                                    device=offs.device) - 1) // 2
        sy = sx = 1
        py = px = 0
        oh, ow = h, w
    else:
        sy, sx = stride
        py, px = padding
        _, oh, ow = out_pillars.shape

    oid = out_pillars.ids.long()
    ox = oid % ow
    oy = (oid // ow) % oh
    ob = oid // (ow * oh)
    iy = oy[:, None] * sy - py + offs[None, :, 0]
    ix = ox[:, None] * sx - px + offs[None, :, 1]
    inb = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
           & out_pillars.mask[:, None])
    qid = (ob[:, None] * h + iy) * w + ix
    lut = _bev_lut(in_pillars)
    safe = torch.where(inb, qid, 0)
    return torch.where(inb, lut[safe].int(), in_pillars.capacity).int()


def downsample_pillars(pillars: PillarSet, kernel=(3, 3), stride=(2, 2),
                       padding=(1, 1), out_capacity: Optional[int] = None,
                       out_depth: Optional[int] = None) -> PillarSet:
    """The output pillar set of a strided conv (xy only; z is downsampled
    inside ``pillar_conv``). A BEV output site exists iff its window covers
    at least one input pillar and it lies inside the strided output
    extent."""
    b, h, w = pillars.shape
    kh, kw = kernel
    sy, sx = stride
    py, px = padding
    oh = (h + 2 * py - kh) // sy + 1
    ow = (w + 2 * px - kw) // sx + 1
    out_capacity = out_capacity or pillars.capacity
    offs = _kernel_offsets_2d(kernel, pillars.ids.device)

    ids = pillars.ids.long()
    x = ids % w
    y = (ids // w) % h
    bb = ids // (w * h)

    def axis_out(inp, k_off, s, p, odim):
        num = inp + p - k_off
        ok = (num % s == 0) & (num >= 0)
        o = num // s
        return o, ok & (o >= 0) & (o < odim)

    oy, oky = axis_out(y[:, None], offs[None, :, 0], sy, py, oh)
    ox, okx = axis_out(x[:, None], offs[None, :, 1], sx, px, ow)
    ok = oky & okx & pillars.mask[:, None]
    cand = torch.where(ok, (bb[:, None] * oh + oy) * ow + ox,
                       SENTINEL).reshape(-1)

    cs = torch.sort(cand).values
    first = torch.ones(1, dtype=torch.bool, device=cs.device)
    is_new = torch.cat([first, cs[1:] != cs[:-1]]) & (cs < SENTINEL)
    pos = torch.cumsum(is_new, 0) - 1
    dest = torch.where(is_new & (pos < out_capacity), pos, out_capacity)
    out_ids = torch.full((out_capacity + 1,), SENTINEL, dtype=torch.int32,
                         device=cs.device)
    out_ids[dest] = cs.int()
    return PillarSet(ids=out_ids[:out_capacity], shape=(b, oh, ow),
                     depth=out_depth if out_depth is not None
                     else pillars.depth)


def reorder_kernel(weights: torch.Tensor,
                   kernel_shape: Tuple[int, int, int]) -> torch.Tensor:
    """[kd*kh*kw, Cin, Cout] row-major (dz, dy, dx) -> [kh*kw, kd, Cin,
    Cout]: the gathered neighbour axis (dy, dx) leads, the z taps follow."""
    kd, kh, kw = kernel_shape
    cin, cout = weights.shape[1], weights.shape[2]
    w5 = weights.reshape(kd, kh, kw, cin, cout)
    return w5.permute(1, 2, 0, 3, 4).reshape(kh * kw, kd, cin, cout)


def pillar_conv(cols: torch.Tensor, rulebook: torch.Tensor,
                weights: torch.Tensor,
                kernel_shape: Tuple[int, int, int] = (3, 3, 3),
                z_stride: int = 1, z_pad: int = 1,
                occ: Optional[torch.Tensor] = None):
    """Sparse 3D conv over pillar columns.

    cols: [P_in, D, Cin] (zeros at unoccupied sites, the submanifold
    invariant); rulebook: [P_out, kh*kw] rows into cols (P_in = miss);
    weights: [kd*kh*kw, Cin, Cout], the backbone's layout, in cols' dtype.
    With ``occ`` ([P_in, D]) the occupancy rides the gather as one more
    channel, and the covered-output mask [P_out, D_out] (spconv's rule for
    a strided conv's outputs) is returned beside the output.

    Returns out [P_out, D_out, Cout] (unmasked), or (out, cover) with occ.
    One gather of [P_out, kh*kw, D, Cin(+1)] and one ``F.conv2d`` over
    (neighbour, z): a kernel of (kh*kw, kd) with stride (1, z_stride), so
    the neighbour axis collapses to 1.
    """
    kd, kh, kw = kernel_shape
    cin = cols.shape[-1]
    cout = weights.shape[-1]
    w = reorder_kernel(weights, kernel_shape)  # [KhKw, kd, Cin, Cout]

    src = cols
    if occ is not None:
        src = torch.cat([cols, occ[..., None].to(cols.dtype)], -1)
    padded = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    g = padded[rulebook.long()]  # [P_out, KhKw, D, Cin(+1)]
    if z_pad:
        g = F.pad(g, (0, 0, z_pad, z_pad))

    if occ is not None:
        # the occupancy channel feeds no real output; the cover output
        # reads only it
        w_ext = torch.cat([w, w.new_zeros(kh * kw, kd, 1, cout)], 2)
        cover_col = torch.cat([w.new_zeros(kh * kw, kd, cin, 1),
                               w.new_ones(kh * kw, kd, 1, 1)], 2)
        w = torch.cat([w_ext, cover_col], -1)  # [.., Cin+1, Cout+1]

    # NHWC / HWIO -> NCHW / OIHW
    out = F.conv2d(g.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=(1, z_stride))
    out = out[:, :, 0].permute(0, 2, 1)  # [P_out, D_out, Cout(+1)]
    if occ is not None:
        return (out[..., :cout].contiguous(),
                (out[..., cout] > 0.5).to(cols.dtype))
    return out.contiguous()


def pillar_to_dense(cols: torch.Tensor, pillars: PillarSet) -> torch.Tensor:
    """Scatter pillar columns into a dense [B, D, H, W, C] grid."""
    b, h, w = pillars.shape
    p, d, c = cols.shape
    total = b * h * w
    idx = torch.where(pillars.mask, pillars.ids.long(), total)
    dense = cols.new_zeros(total + 1, d * c)
    dense[idx] = torch.where(pillars.mask[:, None], cols.reshape(p, d * c),
                             0.0).to(cols.dtype)
    return dense[:total].reshape(b, h, w, d, c).permute(0, 3, 1, 2, 4)
