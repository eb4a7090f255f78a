"""Micro-benchmark kernels: the gather-GEMM tiles with one cost removed at a
time, and an empty launch, with their plain PyTorch versions.

``sparse_conv_ablate_mma`` (the tensor-core tile of ``csrc/gather_mma.cuh``,
the one every bf16 conv at 16-64 channels runs) and ``sparse_conv_ablate``
(a copy of the scalar tile the convs ran before) replace the ablated Pallas
``_fwd_kernel`` copies of ``scripts/bench_wconv_ablate.py``
(``full_kernel``); ``empty_launch`` the empty Pallas kernel of
``scripts/bench_wconv_ablate2.py`` (``bench_empty``). The source is
``sessd_torch/csrc/sparse_conv_ablate.cu``, built with the other kernels by
``ops.cuda.sparse_conv.build`` at the first CUDA call. On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel,
counted in ``<wrapper>.launches``, or raises. None of these kernels runs in
serving or training: ``sessd_torch.scripts.bench_sparse_conv_ablate`` and
``sessd_torch.scripts.bench_launch_overhead`` drive them.
"""
from __future__ import annotations

import torch

from ..sparse import gather_gemm, tile_tap_hits
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


def scalar_tile_sum(feats: torch.Tensor, rb: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """The scalar tile's ``full`` sum in its own order, in plain torch: per
    row, the taps in order, within a tap the input channels in order, each
    product added into one f32 sum (a miss, any index outside [0, n_in), a
    zero row); cast to the features' dtype. A product of two bf16 values
    is exact in f32, so on bf16 inputs each step is the kernel's fmaf and
    the result its bits."""
    n_in, cin = feats.shape
    padded = torch.cat([feats.float(), feats.new_zeros(1, cin).float()])
    idx = torch.where((rb >= 0) & (rb < n_in), rb.long(), n_in)
    acc = torch.zeros(rb.shape[0], w2.shape[2], device=feats.device)
    for k in range(rb.shape[1]):
        g = padded[idx[:, k]]
        for c in range(cin):
            acc = acc + g[:, c:c + 1] * w2[k, c].float()
    return (acc + 0.0).to(feats.dtype)  # the kernel's store: -0 as +0


def _check(feats, rb, w2, mode, modes=MODES, channels=(CHANNELS,)):
    if mode not in modes:
        raise ValueError(f"mode {mode!r}: want one of {sorted(modes)}")
    for t in (rb, w2):
        if t.device != feats.device:
            raise ValueError(f"tensor on {t.device}, features on "
                             f"{feats.device}")
    for t in (feats, rb, w2):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    c = feats.shape[1] if feats.dim() == 2 else -1
    taps = rb.shape[1] if rb.dim() == 2 else -1
    if (feats.dtype, rb.dtype, w2.dtype) != (torch.bfloat16, torch.int32,
                                             torch.bfloat16) \
            or c not in channels or tuple(w2.shape) != (taps, c, c) \
            or feats.shape[0] == 0 or rb.shape[0] == 0:
        raise ValueError(
            f"the ablation kernel takes bf16 features [n, C] with C in "
            f"{channels}, an int32 rulebook [n_out, K] and bf16 weights "
            f"[K, C, C]; got {tuple(feats.shape)} {feats.dtype}, "
            f"{tuple(rb.shape)} {rb.dtype}, {tuple(w2.shape)} {w2.dtype}")


def sparse_conv_ablate(feats: torch.Tensor, rb: torch.Tensor,
                       w2: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """The scalar gather-GEMM tile (``csrc/sparse_conv_ablate.cu``) with
    one cost removed (``mode``, see ``sparse_conv_ablate_ref``). feats
    [n_in, 16] bf16; rb [n_out, K] int32 (n_in = miss); w2 [K, 16, 16]
    bf16. Returns [n_out, 16] bf16. "full" is the gather-GEMM with no bias
    and no ReLU, in the order of ``scalar_tile_sum``."""
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

# mode -> the tensor-core tile's TileMode (csrc/gather_mma.cuh)
MMA_MODES = {"full": 0, "linear": 1, "no_gather": 2, "mma_only": 3,
             "copy_only": 4, "fixed": 5}
MMA_CHANNELS = (16, 64)  # the instances of sparse_conv_ablate_mma_kernel


def sparse_conv_ablate_mma_ref(feats: torch.Tensor, rb: torch.Tensor,
                               w2: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of each mode of the tensor-core tile, summed in f32, in
    the features' dtype (miss = any index outside [0, n_in)):
    - full: sum_k feats[rb[n, k]] @ w2[k];
    - linear: the same over ``linear_rulebook``;
    - no_gather: sum over the taps row n hits of feats[0] @ w2[k];
    - mma_only: (the taps some row of n's 64-row tile hits) x
      (feats[rb[n, 0]] @ w2[0]);
    - copy_only, fixed: zeros."""
    n_in = feats.shape[0]
    n_out, taps = rb.shape
    if mode == "full":
        out = gather_gemm(feats, rb, w2)
    elif mode == "linear":
        out = gather_gemm(feats, linear_rulebook(n_in, n_out, taps,
                                                 feats.device), w2)
    elif mode == "no_gather":
        hit = ((rb >= 0) & (rb < n_in)).float()
        out = hit @ torch.einsum("c,kcd->kd", feats[0].float(), w2.float())
    elif mode == "mma_only":
        hits, _ = tile_tap_hits(rb, n_in)
        per_row = hits.sum(1).repeat_interleave(64)[:n_out].float()
        out = gather_gemm(feats, rb[:, :1].contiguous(), w2[:1]) \
            * per_row[:, None]
    elif mode in ("copy_only", "fixed"):
        out = feats.new_zeros((n_out, w2.shape[2]), dtype=torch.float32)
    else:
        raise ValueError(f"mode {mode!r}: want one of {sorted(MMA_MODES)}")
    return out.to(feats.dtype)


def sparse_conv_ablate_mma(feats: torch.Tensor, rb: torch.Tensor,
                           w2: torch.Tensor,
                           mode: str = "full") -> torch.Tensor:
    """The tensor-core gather tile (``csrc/gather_mma.cuh``) with one cost
    removed (``mode``, see ``sparse_conv_ablate_mma_ref``). feats [n_in, C]
    bf16 with C 16 or 64; rb [n_out, K] int32 (n_in = miss); w2 [K, C, C]
    bf16; feats and w2 16-byte aligned. Returns [n_out, C] bf16. "full"
    equals ``sparse_conv_fwd`` (bf16, no mask) bit for bit."""
    if feats.device.type == "cpu":
        return sparse_conv_ablate_mma_ref(feats, rb, w2, mode)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    _check(feats, rb, w2, mode, MMA_MODES, MMA_CHANNELS)
    if feats.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("feats and w2 must be 16-byte aligned")
    lib = build()
    c = feats.shape[1]
    out = torch.empty((rb.shape[0], c), dtype=feats.dtype,
                      device=feats.device)
    with torch.cuda.device(feats.device):
        rc = lib.sessd_sparse_conv_ablate_mma(
            feats.data_ptr(), rb.data_ptr(), w2.data_ptr(), out.data_ptr(),
            feats.shape[0], rb.shape[0], c, rb.shape[1], MMA_MODES[mode],
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"sparse_conv_ablate_mma ({mode}, C={c}, "
                            f"K={rb.shape[1]})")
    sparse_conv_ablate_mma.launches += 1
    return out


sparse_conv_ablate_mma.launches = 0


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
