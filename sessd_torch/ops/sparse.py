"""Sparse-tensor helpers (port of the parts of ``sessd_tpu/ops/sparse.py``
that serving and training reach) and the trainable sparse conv,
``SparseConvFunction`` (port of ``windowed_conv`` and its custom VJP,
``sessd_tpu/ops/pallas/wconv.py:100-187, 526-579``).

A sparse tensor is features ``[N, C]`` (row-major) plus int32 voxel ids
``[N]``, linearized z-minor as ``((b*H + y)*W + x)*D + z``, sorted ascending,
with ``SENTINEL`` marking padding rows. Rulebooks are ``[N_out, K]`` row
indices into the input features; the input capacity ``N_in`` marks a miss.
The rulebooks come from the host C++ builder (``sessd_tpu.utils.native``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

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
