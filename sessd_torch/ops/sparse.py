"""Sparse-tensor helpers (port of the parts of ``sessd_tpu/ops/sparse.py``
that serving and training reach) and the trainable sparse conv,
``SparseConvFunction`` (port of ``windowed_conv`` and its custom VJP,
``sessd_tpu/ops/pallas/wconv.py:100-187, 526-579``).

A sparse tensor is features ``[N, C]`` (row-major) plus int32 voxel ids
``[N]``, linearized z-minor as ``((b*H + y)*W + x)*D + z``, sorted ascending,
with ``SENTINEL`` marking padding rows. Rulebooks are ``[N_out, K]`` row
indices into the input features; the input capacity ``N_in`` marks a miss.
The rulebook chain comes from the host C++ builder (``utils.native``) or
from ``build_device_chain`` on the features' device (port of
``sessd_tpu/ops/sparse.py:55-158, 273-334``): the same arrays either way.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..data.rulebooks import DOWNS

SENTINEL = torch.iinfo(torch.int32).max


def delinearize(ids: torch.Tensor, shape):
    """linear ids -> (b, z, y, x); garbage for SENTINEL rows (mask them)."""
    b, d, h, w = shape
    z = ids % d
    x = (ids // d) % w
    y = (ids // (d * w)) % h
    bb = ids // (d * w * h)
    return bb, z, y, x


def _conv_out_dim(in_dim: int, k: int, s: int, p: int) -> int:
    return (in_dim + 2 * p - k) // s + 1


def downsample_out_shape(shape, kernel: Sequence[int], stride: Sequence[int],
                         padding: Sequence[int]) -> Tuple[int, int, int, int]:
    """Output grid shape (B, D, H, W) of a strided sparse conv."""
    b, d, h, w = shape
    return (b,
            _conv_out_dim(d, kernel[0], stride[0], padding[0]),
            _conv_out_dim(h, kernel[1], stride[1], padding[1]),
            _conv_out_dim(w, kernel[2], stride[2], padding[2]))


# dense occupancy-LUT lookups where the LUT fits this budget, else a binary
# search of the sorted ids (sparse.py:103-105); the plan never changes a
# result
LUT_BUDGET_BYTES = 2 * 1024 ** 3


def linearize(coords_bzyx: torch.Tensor, shape) -> torch.Tensor:
    """[N, 4] (b, z, y, x) int coords -> z-minor linear ids
    ``((b*H + y)*W + x)*D + z``, in the coords' dtype."""
    b, d, h, w = shape
    c = coords_bzyx
    return ((c[..., 0] * h + c[..., 2]) * w + c[..., 3]) * d + c[..., 1]


def grid_from_coords(coords_bzyx: torch.Tensor, valid: torch.Tensor, shape,
                     capacity: Optional[int] = None):
    """The sorted voxel ids of a (b, z, y, x) coord set and the row
    permutation into that order -> (ids [capacity] int32, SENTINEL-padded;
    perm [capacity] int64: features_sorted = features[perm], padding rows
    gather row 0 and must be masked by ``ids < SENTINEL``). A stable sort,
    so rows with equal ids keep their order (sparse.py:77-98)."""
    n = coords_bzyx.shape[0]
    capacity = capacity or n
    assert math.prod(shape) < 2 ** 31, "int32 id space overflow"
    ids = torch.where(valid, linearize(coords_bzyx.long(), shape),
                      SENTINEL).int()
    order = torch.argsort(ids, stable=True)[:capacity]
    ids = ids[order]
    if n < capacity:  # pad up to the capacity
        ids = torch.cat([ids, ids.new_full((capacity - n,), SENTINEL)])
        order = torch.cat([order, order.new_zeros(capacity - n)])
    return ids, order


def _kernel_offsets(kernel: Sequence[int], device):
    """(dz, dy, dx) [K] each, row-major over the kernel, in 0..k-1; made on
    ``device`` (no host copy)."""
    axes = [torch.arange(k, device=device) for k in kernel]
    return [a.reshape(-1) for a in torch.meshgrid(*axes, indexing="ij")]


def occupancy_lut(ids: torch.Tensor, shape) -> Optional[torch.Tensor]:
    """The dense LUT voxel id -> row of a grid (the capacity marks a miss),
    int16 when the rows fit, where it fits ``LUT_BUDGET_BYTES``; else None,
    and lookups take the binary search (sparse.py:108-121). One LUT serves
    the grid's subm map and the downsample map out of it."""
    total = math.prod(shape)
    cap = ids.shape[0]
    dt = torch.int16 if cap < 2 ** 15 - 1 else torch.int32
    if total * dt.itemsize > LUT_BUDGET_BYTES:
        return None
    lut = torch.full((total + 1,), cap, dtype=dt, device=ids.device)
    sid = torch.where(ids < SENTINEL, ids.long(), total)
    lut.scatter_(0, sid, torch.arange(cap, dtype=dt, device=ids.device))
    return lut[:total]


def _lookup(ids: torch.Tensor, nid: torch.Tensor, inb: torch.Tensor,
            lut: Optional[torch.Tensor]) -> torch.Tensor:
    """Neighbour ids [N, K] -> input rows, int32 (the capacity = miss)."""
    cap = ids.shape[0]
    if lut is not None:
        return torch.where(inb, lut[torch.where(inb, nid, 0)].int(), cap)
    q = torch.where(inb, nid, SENTINEL).int()
    pos = torch.searchsorted(ids, q.reshape(-1)).reshape(q.shape)
    pos = pos.clamp_(0, cap - 1)
    return torch.where((ids[pos] == q) & inb, pos.int(), cap)


def subm_rulebook(ids: torch.Tensor, shape, kernel=(3, 3, 3),
                  lut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Submanifold rulebook [N, K] int32 (the capacity = missing): output
    sites are the input sites, neighbour k of voxel n the voxel at ``coord
    + offset_k - kernel//2`` (sparse.py:124-145). ``lut``: the grid's
    ``occupancy_lut`` where the caller has it."""
    b, d, h, w = shape
    dz, dy, dx = _kernel_offsets(kernel, ids.device)
    cz, cy, cx = ((k - 1) // 2 for k in kernel)
    bb, z, y, x = delinearize(ids.long(), shape)
    nz = z[:, None] + (dz - cz)
    ny = y[:, None] + (dy - cy)
    nx = x[:, None] + (dx - cx)
    inb = ((nz >= 0) & (nz < d) & (ny >= 0) & (ny < h) & (nx >= 0)
           & (nx < w) & (ids < SENTINEL)[:, None])
    nid = ((bb[:, None] * h + ny) * w + nx) * d + nz
    return _lookup(ids, nid, inb,
                   occupancy_lut(ids, shape) if lut is None else lut)


def downsample_rulebook(ids: torch.Tensor, shape, kernel=(3, 3, 3),
                        stride=(2, 2, 2), padding=(1, 1, 1),
                        out_capacity: Optional[int] = None,
                        lut: Optional[torch.Tensor] = None):
    """A strided sparse conv's output sites and rulebook (spconv semantics,
    sparse.py:273-334): output o (per axis) reads input i = o*s - p + k, and
    exists iff a covered input is active and it lies in the output grid.
    The candidates are sorted and compacted to ``out_capacity`` rows, the
    lowest ids kept. Returns (out_ids [out_capacity] int32, out_shape,
    rulebook [out_capacity, K] int32 into the input rows)."""
    b, d, h, w = shape
    (sd, sh, sw), (pd, ph, pw) = stride, padding
    out_shape = downsample_out_shape(shape, kernel, stride, padding)
    _, od, oh, ow = out_shape
    out_capacity = out_capacity or ids.shape[0]
    kz, ky, kx = _kernel_offsets(kernel, ids.device)
    bb, z, y, x = delinearize(ids.long(), shape)

    def axis_out(inp, k_off, s, p, odim):
        num = inp[:, None] + p - k_off
        o = num // s
        return o, (num % s == 0) & (num >= 0) & (o >= 0) & (o < odim)

    oz, okz = axis_out(z, kz, sd, pd, od)
    oy, oky = axis_out(y, ky, sh, ph, oh)
    ox, okx = axis_out(x, kx, sw, pw, ow)
    ok = okz & oky & okx & (ids < SENTINEL)[:, None]
    cand = ((bb[:, None] * oh + oy) * ow + ox) * od + oz
    cs = torch.sort(torch.where(ok, cand, SENTINEL).int().reshape(-1)).values

    # unique + compaction to the capacity, sorted order kept
    is_new = torch.cat([cs.new_ones(1, dtype=torch.bool), cs[1:] != cs[:-1]])
    is_new &= cs < SENTINEL
    pos = torch.cumsum(is_new, 0) - 1
    dest = torch.where(is_new & (pos < out_capacity), pos, out_capacity)
    out_ids = torch.full((out_capacity + 1,), SENTINEL, dtype=torch.int32,
                         device=ids.device)
    out_ids = out_ids.scatter_(0, dest, cs)[:out_capacity]

    # the input row feeding output o through offset k (an empty output
    # grid has only SENTINEL rows, masked below: no division by zero)
    obb, ozz, oyy, oxx = delinearize(out_ids.long(),
                                     [max(n, 1) for n in out_shape])
    iz = ozz[:, None] * sd - pd + kz
    iy = oyy[:, None] * sh - ph + ky
    ix = oxx[:, None] * sw - pw + kx
    inb = ((iz >= 0) & (iz < d) & (iy >= 0) & (iy < h) & (ix >= 0)
           & (ix < w) & (out_ids < SENTINEL)[:, None])
    iid = ((obb[:, None] * h + iy) * w + ix) * d + iz
    rulebook = _lookup(ids, iid, inb,
                       occupancy_lut(ids, shape) if lut is None else lut)
    return out_ids, out_shape, rulebook


def build_device_chain(coords_bzyx: torch.Tensor, valid: torch.Tensor, shape,
                       caps: Sequence[int]):
    """The backbone's rulebook chain built on the coords' device, the
    counterpart of the host builder (``utils.native.build_rulebooks``):
    coords [N, 4] (b, z, y, x), valid [N], the batched grid (B, D, H, W)
    and the batched stage capacities. Returns (chain, saturated): chain
    {"perm" [caps[0]], "ids" [5 x caps[i]] int32, "subm" [4 x (caps[i],
    27)], "down" [4 x (caps[i+1], K)]} with the host builder's values and
    its dtype rule (int16 where max(caps) < 2^15, else int32); saturated
    [5] bool, the stages whose id table is full (the last id is not
    SENTINEL: truncated or exactly filled). Nothing is read back to the
    host. The perm equals the host's where coords has caps[0] rows, as the
    loader and the voxelizers lay them out; with fewer, its padding rows
    gather row 0 (JAX's rule) where the host's count on."""
    dt = torch.int16 if max(caps) < 2 ** 15 else torch.int32
    ids, perm = grid_from_coords(coords_bzyx, valid, shape, caps[0])
    chain = {"perm": perm.to(dt), "ids": [ids], "subm": [], "down": []}
    for i, (dk, ds, dp) in enumerate(DOWNS):
        lut = occupancy_lut(ids, shape)
        chain["subm"].append(subm_rulebook(ids, shape, lut=lut).to(dt))
        ids, shape, rbd = downsample_rulebook(ids, shape, dk, ds, dp,
                                              caps[i + 1], lut=lut)
        chain["ids"].append(ids)
        chain["down"].append(rbd.to(dt))
    del lut
    saturated = torch.stack([i[-1] < SENTINEL for i in chain["ids"]])
    return chain, saturated


def gather_gemm(features: torch.Tensor, rulebook: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """The implicit GEMM: gather K rows per output (row N_in = a zero row),
    then one matmul with weights [K, Cin, Cout] in f32 (f64 for f64 inputs).
    Returns [N_out, Cout] in that type.
    """
    n_in, cin = features.shape
    n_out, k = rulebook.shape
    cout = weights.shape[-1]
    acc = torch.promote_types(features.dtype, torch.float32)
    padded = torch.cat([features, features.new_zeros(1, cin)])
    g = padded.index_select(0, rulebook.reshape(-1).long())
    return torch.matmul(g.reshape(n_out, k * cin).to(acc),
                        weights.reshape(k * cin, cout).to(acc))


def sparse_conv_apply(features: torch.Tensor, rulebook: torch.Tensor,
                      weights: torch.Tensor,
                      out_mask: torch.Tensor) -> torch.Tensor:
    """Plain gather-GEMM sparse conv: features [N_in, Cin], rulebook
    [N_out, K] (N_in = miss), weights [K, Cin, Cout] -> [N_out, Cout] in the
    features' dtype, zero where ``out_mask`` is False."""
    out = gather_gemm(features, rulebook, weights)
    return torch.where(out_mask[:, None], out, 0.0).to(features.dtype)


def tile_tap_hits(rulebook: torch.Tensor, miss: int, rows: int = 64):
    """Which taps each tile of ``rows`` output rows gathers, as the
    tensor-core tile (``csrc/gather_mma.cuh``) decides it: tap k of a tile
    is skipped when no row of the tile reads an input row in [0, miss).
    The last tile may be ragged; its missing rows count as misses.

    Returns (hits [tiles, K] bool, the share of (tile, tap) pairs skipped)."""
    n_out, k = rulebook.shape
    tiles = -(-n_out // rows)
    hit = (rulebook >= 0) & (rulebook < miss)
    pad = hit.new_zeros((tiles * rows - n_out, k))
    hits = torch.cat([hit, pad]).reshape(tiles, rows, k).any(dim=1)
    return hits, 1.0 - float(hits.double().mean()) if tiles else 0.0


def inverse_rulebook(rulebook: torch.Tensor, n_in: int) -> torch.Tensor:
    """inv [n_in, K] with inv[rulebook[n, k], k] = n, and N_out where no
    output reads input row i through tap k; in the rulebook's dtype.

    Each tap's map is injective (distinct outputs of a subm or strided conv
    read distinct inputs through one offset), so the scatter has no
    collisions and the input gradient becomes a gather over ``inv``. Index
    bookkeeping only, built once per rulebook and step and shared by the
    convs that use the rulebook."""
    n_out, k = rulebook.shape
    rb = rulebook.long()
    hit = rb < n_in
    flat = torch.where(hit, rb * k + torch.arange(k, device=rb.device),
                       n_in * k)
    rows = torch.arange(n_out, device=rb.device)[:, None].expand(n_out, k)
    inv = torch.full((n_in * k + 1,), n_out, dtype=torch.long,
                     device=rb.device)
    inv.scatter_(0, flat.reshape(-1), rows.reshape(-1))
    return inv[:n_in * k].reshape(n_in, k).to(rulebook.dtype)


class SparseConvFunction(torch.autograd.Function):
    """out = sparse_conv_apply(feats, rulebook, w2, out_mask) with a
    backward of its own: forward through the K4 kernel
    (``ops.cuda.sparse_conv_train.sparse_conv_fwd``), input gradient as a
    gather-GEMM over the inverse rulebook (``sparse_conv_dfeat``) and weight
    gradient as a split-K reduction (``sparse_conv_dw``). Saves the
    features, rulebooks and weights, not the gathered rows. On CPU tensors
    every step runs the kernels' plain twins.

    apply(feats [N_in, Cin], w2 [K, Cin, Cout] in feats' dtype, rulebook
    [N_out, K], out_mask [N_out] bool, inv [N_in, K] or None) -> [N_out,
    Cout] in feats' dtype."""

    @staticmethod
    def forward(ctx, feats, w2, rulebook, out_mask, inv):
        from .cuda.sparse_conv_train import sparse_conv_fwd

        ctx.save_for_backward(feats, w2, rulebook, out_mask, inv)
        return sparse_conv_fwd(feats, rulebook, w2, out_mask)

    @staticmethod
    def backward(ctx, dout):
        from .cuda.sparse_conv_train import (sparse_conv_dfeat,
                                             sparse_conv_dw)

        feats, w2, rulebook, out_mask, inv = ctx.saved_tensors
        # rows outside out_mask were zeroed after the GEMM: no gradient
        dout = torch.where(out_mask[:, None], dout, 0.0).to(
            feats.dtype).contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            if inv is None:
                inv = inverse_rulebook(rulebook, feats.shape[0])
            dfeat = sparse_conv_dfeat(dout, inv, w2)
        if ctx.needs_input_grad[1]:
            dw = sparse_conv_dw(feats, rulebook, dout)
        return dfeat, dw, None, None, None


def to_dense(features: torch.Tensor, ids: torch.Tensor, shape) -> torch.Tensor:
    """Scatter [N, C] features with z-minor ids into a dense z-major
    [B, D, H, W, C] grid (zeros where no voxel)."""
    b, d, h, w = shape
    c = features.shape[-1]
    total = b * d * h * w
    ids = ids.long()
    mask = ids < SENTINEL
    bb, z, y, x = delinearize(ids, shape)
    flat = torch.where(mask, ((bb * d + z) * h + y) * w + x, total)
    dense = features.new_zeros(total + 1, c)
    dense[flat] = torch.where(mask[:, None], features, 0.0).to(features.dtype)
    return dense[:total].reshape(b, d, h, w, c)
