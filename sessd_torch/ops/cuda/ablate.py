"""Micro-benchmark kernels: the gather-GEMM tile with one cost removed at a
time, and an empty launch, with their plain PyTorch versions.

``sparse_conv_ablate`` replaces the ablated Pallas ``_fwd_kernel`` copies of
``scripts/bench_wconv_ablate.py`` (``full_kernel``) and ``empty_launch``
the empty Pallas kernel of ``scripts/bench_wconv_ablate2.py``
(``bench_empty``). The source is ``sessd_torch/csrc/sparse_conv_ablate.cu``,
built with the other kernels by ``ops.cuda.sparse_conv.build`` at the first
CUDA call. On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches its kernel, counted in ``<wrapper>.launches``, or raises.
Neither kernel runs in serving or training:
``sessd_torch.scripts.bench_sparse_conv_ablate`` and
``sessd_torch.scripts.bench_launch_overhead`` drive them.
"""
from __future__ import annotations

import torch

from ..sparse import gather_gemm
from . import sparse_conv_train as kt
from .sparse_conv import _DTYPE_CODES, _INDEX_BYTES, build, raise_on_error

# mode -> the kernel's MODE (csrc/sparse_conv_ablate.cu). "k9" is not a mode
# of its own: it is "full" on a 9-tap rulebook.
MODES = {"full": 0, "linear": 1, "no_gather": 2, "fma_only": 3}
NO_GATHER_VALUE = 1.0  # the staged value of a hit in "no_gather"
CHANNELS = 16


def linear_rulebook(n_in: int, n_out: int, taps: int,
                    device=None) -> torch.Tensor:
    """The rulebook ``linear`` stands for: row n of every tap reads row n,
    rows from ``n_in`` on miss."""
    rows = torch.arange(n_out, dtype=torch.int32, device=device)
    rows = torch.where(rows < n_in, rows, n_in)
    return rows[:, None].expand(n_out, taps).contiguous()


def sparse_conv_ablate_ref(feats: torch.Tensor, rb: torch.Tensor,
                           w2: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of each mode, summed in f32, in the features' dtype:
    - full: sum_k feats[rb[n, k]] @ w2[k] (miss = n_in reads 0);
    - linear: the same over ``linear_rulebook``;
    - no_gather: sum_k [rb[n, k] hits] * NO_GATHER_VALUE * sum_c w2[k, c];
    - fma_only: taps * (feats[n] @ w2[0]) (0 for n >= n_in)."""
    n_in = feats.shape[0]
    n_out, taps = rb.shape
    if mode == "full":
        out = gather_gemm(feats, rb, w2)
    elif mode == "linear":
        out = gather_gemm(feats, linear_rulebook(n_in, n_out, taps,
                                                 feats.device), w2)
    elif mode == "no_gather":
        hit = ((rb >= 0) & (rb < n_in)).float() * NO_GATHER_VALUE
        out = hit @ w2.float().sum(dim=1)
    elif mode == "fma_only":
        lin = linear_rulebook(n_in, n_out, 1, feats.device)
        out = gather_gemm(feats, lin, w2[:1]) * taps
    else:
        raise ValueError(f"mode {mode!r}: want one of {sorted(MODES)}")
    return out.to(feats.dtype)


def _check(feats, rb, w2, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: want one of {sorted(MODES)}")
    for t in (rb, w2):
        if t.device != feats.device:
            raise ValueError(f"tensor on {t.device}, features on "
                             f"{feats.device}")
    for t in (feats, rb, w2):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    taps = rb.shape[1] if rb.dim() == 2 else -1
    if (feats.dtype, rb.dtype, w2.dtype) != (torch.bfloat16, torch.int32,
                                             torch.bfloat16) \
            or feats.dim() != 2 or feats.shape[1] != CHANNELS \
            or tuple(w2.shape) != (taps, CHANNELS, CHANNELS) \
            or feats.shape[0] == 0 or rb.shape[0] == 0:
        raise ValueError(
            f"the ablation kernel takes bf16 features [n, 16], an int32 "
            f"rulebook [n_out, K] and bf16 weights [K, 16, 16]; got "
            f"{tuple(feats.shape)} {feats.dtype}, {tuple(rb.shape)} "
            f"{rb.dtype}, {tuple(w2.shape)} {w2.dtype}")


def sparse_conv_ablate(feats: torch.Tensor, rb: torch.Tensor,
                       w2: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """The scalar gather-GEMM tile (``csrc/gather_gemm.cuh``) with one cost
    removed (``mode``, see ``sparse_conv_ablate_ref``). feats [n_in, 16]
    bf16; rb [n_out, K] int32 (n_in = miss); w2 [K, 16, 16] bf16. Returns
    [n_out, 16] bf16. "full" equals ``fused_sparse_conv`` with zero bias
    and ``relu=False`` bit for bit."""
    if feats.device.type == "cpu":
        return sparse_conv_ablate_ref(feats, rb, w2, mode)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    _check(feats, rb, w2, mode)
    lib = build()
    out = torch.empty((rb.shape[0], CHANNELS), dtype=feats.dtype,
                      device=feats.device)
    with torch.cuda.device(feats.device):
        rc = lib.sessd_sparse_conv_ablate(
            feats.data_ptr(), rb.data_ptr(), w2.data_ptr(), out.data_ptr(),
            feats.shape[0], rb.shape[0], rb.shape[1], MODES[mode],
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"sparse_conv_ablate ({mode}, K={rb.shape[1]})")
    sparse_conv_ablate.launches += 1
    return out


sparse_conv_ablate.launches = 0


def empty_launch_ref(out: torch.Tensor) -> torch.Tensor:
    """Plain version of the empty kernel: a tensor of zeros like ``out``."""
    return torch.zeros_like(out)


def _check_empty(out, block_rows, reps=1):
    if out.device.type != "cuda":
        raise ValueError(f"no kernel for device {out.device}")
    row_bytes = out.shape[-1] * out.element_size() if out.dim() else 0
    nbytes = out.numel() * out.element_size()
    if (not out.is_contiguous() or out.dim() != 2 or nbytes % 16
            or out.data_ptr() % 16 or block_rows <= 0
            or (block_rows * row_bytes) % 16 or reps <= 0):
        raise ValueError(f"empty_launch: want a contiguous, 16-byte aligned "
                         f"[rows, cols] output of whole 16-byte blocks and "
                         f"reps > 0; got {tuple(out.shape)} {out.dtype}, "
                         f"block_rows {block_rows}, reps {reps}")
    return nbytes, block_rows * row_bytes


def empty_launch(out: torch.Tensor, block_rows: int = 256) -> torch.Tensor:
    """Write zeros over ``out`` [rows, cols] in place, ``block_rows`` rows
    per block; returns ``out``. A CPU tensor is zeroed by its plain
    version."""
    if out.device.type == "cpu":
        return out.copy_(empty_launch_ref(out))
    nbytes, block_bytes = _check_empty(out, block_rows)
    lib = build()
    with torch.cuda.device(out.device):
        rc = lib.sessd_empty_launch(out.data_ptr(), nbytes, block_bytes,
                                    torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"empty_launch (block_rows={block_rows})")
    empty_launch.launches += 1
    return out


empty_launch.launches = 0


def empty_launch_repeat(out: torch.Tensor, block_rows: int,
                        reps: int) -> torch.Tensor:
    """``reps`` launches of the empty kernel issued from one C call, with no
    Python between them; counted in ``empty_launch.launches``. A CPU
    tensor is zeroed by the plain version."""
    if out.device.type == "cpu":
        return out.copy_(empty_launch_ref(out))
    nbytes, block_bytes = _check_empty(out, block_rows, reps)
    lib = build()
    with torch.cuda.device(out.device):
        rc = lib.sessd_empty_launch_repeat(
            out.data_ptr(), nbytes, block_bytes, reps,
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"empty_launch x{reps}")
    empty_launch.launches += reps
    return out


def sparse_conv_fwd_repeat(feats: torch.Tensor, rb: torch.Tensor,
                           w2: torch.Tensor, out: torch.Tensor,
                           reps: int) -> torch.Tensor:
    """``reps`` launches of the training forward's kernel (no mask) into
    ``out``, issued from one C call through its C entry: the bare launch
    cost of ``sparse_conv_fwd``, without the wrapper's checks and
    allocation. Counted in ``sparse_conv_fwd.launches``. CPU tensors take
    the forward's plain version."""
    if feats.device.type == "cpu":
        return out.copy_(kt.sparse_conv_fwd_ref(feats, rb, w2))
    kt._check(feats, rb, w2, out)
    kt._check_gather(feats, rb, w2, "sparse_conv_fwd_repeat")
    taps, cin, cout = w2.shape
    if out.shape != (rb.shape[0], cout) or out.dtype != feats.dtype \
            or feats.device.type != "cuda" or reps <= 0:
        raise ValueError(f"sparse_conv_fwd_repeat: out {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}, reps {reps}")
    lib = build()
    with torch.cuda.device(feats.device):
        rc = lib.sessd_sparse_conv_fwd_repeat(
            feats.data_ptr(), rb.data_ptr(), w2.data_ptr(), out.data_ptr(),
            feats.shape[0], rb.shape[0], cin, cout, taps,
            _DTYPE_CODES[feats.dtype], _INDEX_BYTES[rb.dtype], reps,
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"sparse_conv_fwd x{reps}")
    kt.sparse_conv_fwd.launches += reps
    return out
