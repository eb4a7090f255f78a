"""The sparse conv of a training step: forward (K4), input gradient and
weight gradient (K5) as CUDA kernels, with their plain PyTorch twins.

``sparse_conv_fwd`` replaces the Pallas ``_fwd_kernel`` and
``sparse_conv_dfeat`` / ``sparse_conv_dw`` the Pallas ``_bwd_kernel`` of
``sessd_tpu/ops/pallas/wconv.py`` (the custom VJP of ``windowed_conv``).
The sources are ``sessd_torch/csrc/sparse_conv_train.cu``,
``gather_gemm.cuh`` (the scalar tile) and ``gather_mma.cuh`` (the
tensor-core tile of the bf16 forward), built with the serving kernel by
``ops.cuda.sparse_conv.build`` at the first CUDA call. On a CPU tensor each
wrapper runs its twin; on a CUDA tensor it launches its kernel, counted in
``<wrapper>.launches``, or raises.

Layouts are row-major: features [N, C], rulebooks [N_out, K] int16/int32
with ``N_in`` as the miss, weights [K, Cin, Cout] in the features' dtype.
All sums are taken in f32; outputs are cast to the features' dtype.
"""
from __future__ import annotations

import torch

from ..sparse import gather_gemm
from .sparse_conv import (_DTYPE_CODES, _INDEX_BYTES, FWD_PAIRS, build,
                          conv_instance, raise_on_error)

# rows of one dW split-K chunk: ~43 chunks x 27 taps of blocks at the
# largest training stage (88,000 rows at batch 4)
DW_CHUNK_ROWS = 2048


def sparse_conv_fwd_ref(feats, rb, w2, out_mask=None):
    """Twin of the forward: gather_gemm, rows outside ``out_mask`` zero."""
    out = gather_gemm(feats, rb, w2)
    if out_mask is not None:
        out = torch.where(out_mask[:, None], out, 0.0)
    return out.to(feats.dtype)


def sparse_conv_dfeat_ref(dout, inv, w2):
    """Twin of the input gradient: gather_gemm of ``dout`` over the inverse
    rulebook with the transposed weights."""
    return gather_gemm(dout, inv, w2.transpose(1, 2)).to(dout.dtype)


def sparse_conv_dw_ref(feats, rb, dout):
    """Twin of the weight gradient: index_select + einsum in f32 (f64 for
    f64 inputs)."""
    n_in, cin = feats.shape
    n_out, k = rb.shape
    acc = torch.promote_types(feats.dtype, torch.float32)
    padded = torch.cat([feats, feats.new_zeros(1, cin)])
    g = padded.index_select(0, rb.reshape(-1).long()).reshape(n_out, k, cin)
    return torch.einsum("nkc,nd->kcd", g.to(acc), dout.to(acc)).to(
        feats.dtype)


def _check(x, rb, *others):
    dev = x.device
    for t in (rb, *others):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, features on {dev}")
    for t in (x, rb, *others):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype}: want float32/bfloat16")
    if rb.dtype not in _INDEX_BYTES:
        raise ValueError(f"rulebook dtype {rb.dtype}: want int16/int32")
    if x.dim() != 2 or rb.dim() != 2 or x.shape[0] == 0 or rb.shape[0] == 0:
        raise ValueError(f"want non-empty [n, C] features and [n_out, K] "
                         f"rulebook, got {tuple(x.shape)}, {tuple(rb.shape)}")
    if rb.dtype == torch.int16 and x.shape[0] > torch.iinfo(torch.int16).max:
        raise ValueError(f"{x.shape[0]} rows do not fit an int16 rulebook")


def _device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type == "cuda"


def _check_gather(x, rb, w2, what):
    taps, cin, cout = w2.shape
    if w2.dtype != x.dtype or (x.shape[1], rb.shape[1]) != (cin, taps):
        raise ValueError(f"{what}: features {tuple(x.shape)} {x.dtype}, "
                         f"rulebook {tuple(rb.shape)}, weights "
                         f"{tuple(w2.shape)} {w2.dtype}")


def sparse_conv_fwd(feats, rb, w2, out_mask=None):
    """out[n] = sum_k feats[rb[n, k]] @ w2[k] where ``out_mask[n]`` (bool
    [N_out], or None for every row), else 0. feats [N_in, Cin]; rb
    [N_out, K] with N_in = miss. Returns [N_out, Cout] in feats' dtype.
    bf16 with Cin in {16, 32, 64} runs the tensor-core tile, which copies
    16-byte chunks and wants feats and w2 16-byte aligned; the rest runs
    the scalar tile (``conv_instance``)."""
    if not _device(feats):
        return sparse_conv_fwd_ref(feats, rb, w2, out_mask)
    if out_mask is not None and (out_mask.dtype != torch.bool
                                 or out_mask.shape != rb.shape[:1]):
        raise ValueError("out_mask must be bool [N_out]")
    _check(feats, rb, w2, *(() if out_mask is None else (out_mask,)))
    _check_gather(feats, rb, w2, "sparse_conv_fwd")
    taps, cin, cout = w2.shape
    if (cin, cout) in FWD_PAIRS \
            and conv_instance("sparse_conv_fwd", feats.dtype, cin,
                              cout) == "mma" \
            and (feats.data_ptr() % 16 or w2.data_ptr() % 16):
        raise ValueError("feats and w2 must be 16-byte aligned")
    lib = build()
    out = torch.empty((rb.shape[0], cout), dtype=feats.dtype,
                      device=feats.device)
    mask = None if out_mask is None else out_mask.view(torch.uint8)
    with torch.cuda.device(feats.device):
        rc = lib.sessd_sparse_conv_fwd(
            feats.data_ptr(), rb.data_ptr(), w2.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            feats.shape[0], rb.shape[0], cin, cout, taps,
            _DTYPE_CODES[feats.dtype], _INDEX_BYTES[rb.dtype],
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"sparse_conv_fwd (Cin={cin}, Cout={cout}, "
                            f"K={taps})")
    sparse_conv_fwd.launches += 1
    return out


def sparse_conv_dfeat(dout, inv, w2):
    """dfeat[i] = sum_k dout[inv[i, k]] @ w2[k]^T. dout [N_out, Cout]
    (zero on masked rows); inv [N_in, K] the inverse rulebook
    (``ops.sparse.inverse_rulebook``, miss N_out); w2 [K, Cin, Cout].
    Returns [N_in, Cin] in dout's dtype."""
    if not _device(dout):
        return sparse_conv_dfeat_ref(dout, inv, w2)
    wt = w2.transpose(1, 2).contiguous()
    _check(dout, inv, wt)
    _check_gather(dout, inv, wt, "sparse_conv_dfeat")
    taps, cin, cout = w2.shape
    lib = build()
    dfeat = torch.empty((inv.shape[0], cin), dtype=dout.dtype,
                        device=dout.device)
    with torch.cuda.device(dout.device):
        rc = lib.sessd_sparse_conv_dfeat(
            dout.data_ptr(), inv.data_ptr(), wt.data_ptr(), dfeat.data_ptr(),
            dout.shape[0], inv.shape[0], cin, cout, taps,
            _DTYPE_CODES[dout.dtype], _INDEX_BYTES[inv.dtype],
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"sparse_conv_dfeat (Cin={cin}, Cout={cout}, "
                            f"K={taps})")
    sparse_conv_dfeat.launches += 1
    return dfeat


def sparse_conv_dw(feats, rb, dout):
    """dw[k] = sum_n feats[rb[n, k]]^T dout[n] ([K, Cin, Cout] in feats'
    dtype, summed in f32 in a fixed order: split-K partials, then one
    ordered reduce). dout [N_out, Cout] must be zero on masked rows."""
    if not _device(feats):
        return sparse_conv_dw_ref(feats, rb, dout)
    _check(feats, rb, dout)
    n_out, taps = rb.shape
    cin, cout = feats.shape[1], dout.shape[1]
    if dout.dtype != feats.dtype or dout.shape[0] != n_out:
        raise ValueError(f"sparse_conv_dw: dout {tuple(dout.shape)} "
                         f"{dout.dtype} for rulebook {tuple(rb.shape)}, "
                         f"features {feats.dtype}")
    lib = build()
    chunks = -(-n_out // DW_CHUNK_ROWS)
    partial = torch.empty((chunks, taps, cin, cout), dtype=torch.float32,
                          device=feats.device)
    dw = torch.empty((taps, cin, cout), dtype=feats.dtype,
                     device=feats.device)
    with torch.cuda.device(feats.device):
        rc = lib.sessd_sparse_conv_dw(
            feats.data_ptr(), rb.data_ptr(), dout.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), feats.shape[0], n_out, cin,
            cout, taps, DW_CHUNK_ROWS, _DTYPE_CODES[feats.dtype],
            _INDEX_BYTES[rb.dtype], torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc, f"sparse_conv_dw (Cin={cin}, Cout={cout}, "
                            f"K={taps})")
    sparse_conv_dw.launches += 1
    return dw


sparse_conv_fwd.launches = 0
sparse_conv_dfeat.launches = 0
sparse_conv_dw.launches = 0
