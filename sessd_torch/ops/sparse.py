"""Sparse-tensor helpers of the serving path (port of the parts of
``sessd_tpu/ops/sparse.py`` that serving reaches).

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
    then one f32 matmul with weights [K, Cin, Cout]. Returns f32 [N_out, Cout].
    """
    n_in, cin = features.shape
    n_out, k = rulebook.shape
    cout = weights.shape[-1]
    padded = torch.cat([features, features.new_zeros(1, cin)])
    g = padded.index_select(0, rulebook.reshape(-1).long())
    return torch.matmul(g.reshape(n_out, k * cin).float(),
                        weights.reshape(k * cin, cout).float())


def sparse_conv_apply(features: torch.Tensor, rulebook: torch.Tensor,
                      weights: torch.Tensor,
                      out_mask: torch.Tensor) -> torch.Tensor:
    """Plain gather-GEMM sparse conv: features [N_in, Cin], rulebook
    [N_out, K] (N_in = miss), weights [K, Cin, Cout] -> [N_out, Cout] in the
    features' dtype, zero where ``out_mask`` is False."""
    out = gather_gemm(features, rulebook, weights)
    return torch.where(out_mask[:, None], out, 0.0).to(features.dtype)


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
