"""The sparse conv of a training step: forward (K4), input gradient and
weight gradient (K5) as CUDA kernels, with their plain PyTorch twins.

``sparse_conv_fwd`` replaces the Pallas ``_fwd_kernel`` and
``sparse_conv_dfeat`` / ``sparse_conv_dw`` the Pallas ``_bwd_kernel`` of
``sessd_tpu/ops/pallas/wconv.py`` (the custom VJP of ``windowed_conv``).
The sources are ``sessd_torch/csrc/sparse_conv_train.cu``,
``gather_common.cuh`` (what the bodies share), ``gather_mma.cuh`` (the
tensor-core tile of the forward and input gradient, in bf16 and in f32
through 3xTF32) and ``gather_direct.cuh`` (the first conv's 4-channel
side), built with the serving kernel by ``ops.cuda.sparse_conv.build`` at
the first CUDA call; dW's bodies (mma.sync, bf16 and f32 through 3xTF32,
and the first conv's direct one) are in the ``.cu`` itself. On
a CPU tensor each wrapper runs its twin; on a CUDA tensor it launches its
kernel, counted in ``<wrapper>.launches``, or raises.

Layouts are row-major: features [N, C], rulebooks [N_out, K] int16/int32
with ``N_in`` as the miss, weights [K, Cin, Cout] in the features' dtype.
All sums are taken in f32; outputs are cast to the features' dtype.
"""
from __future__ import annotations

import torch

from ..sparse import gather_gemm
from .sparse_conv import (_DTYPE_CODES, _INDEX_BYTES, DFEAT_PAIRS, DW_PAIRS,
                          FWD_PAIRS, TILE_ROWS, build, conv_instance,
                          raise_on_error)

# rows of one dW split-K chunk (a multiple of 64, at most DW_MAX_CHUNK_ROWS
# for the tensor-core partial kernel): 59 chunks x 27 taps of blocks at the
# largest training stage (120,000 rows at batch 4 and the acceptance caps)
DW_CHUNK_ROWS = 2048
DW_MAX_CHUNK_ROWS = 8192  # csrc/sparse_conv_train.cu: kDwMaxChunkRows
# a grid's blocks on x (2^31 - 1): dW's chunks x taps at most
GRID_X_MAX = 2 ** 31 - 1  # csrc/sparse_conv_train.cu: kGridXMax


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


TF32_DEPTH = 8  # the reduction depth of one TF32 mma: wgmma m64nNk8, mma.sync m16n8k8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does (finite inputs): half a TF32
    unit added to the magnitude's bits, the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo with hi = tf32(x), lo = tf32(x - hi): the 3xTF32 tile's
    split of each operand (x - hi is exact in f32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def gather_gemm_tf32(feats, rb, w2, passes: int = 3) -> torch.Tensor:
    """The f32 tensor-core tile's arithmetic in plain torch: the gather-GEMM
    of ``ops.sparse.gather_gemm`` with both operands split by
    ``split_tf32`` and, per tap in order, a partial sum from zero of, per 8
    input channels, lo_a hi_b, then hi_a lo_b, then hi_a hi_b (``passes``
    3; with ``passes`` 1 the single TF32 product hi_a hi_b), added into the
    f32 running sum. The model of the kernel's numerics that the tests
    hold against JAX; no path of the port calls it."""
    if passes not in (1, 3):
        raise ValueError(f"passes {passes}: 1 or 3")
    n_in, cin = feats.shape
    n_out, taps = rb.shape
    padded = torch.cat([feats.float(), feats.new_zeros(1, cin).float()])
    idx = torch.where((rb >= 0) & (rb < n_in), rb.long(), n_in)
    a_hi, a_lo = split_tf32(padded[idx])  # [n_out, taps, cin]
    b_hi, b_lo = split_tf32(w2)
    acc = torch.zeros(n_out, w2.shape[2], dtype=torch.float32,
                      device=feats.device)
    for k in range(taps):
        part = torch.zeros_like(acc)
        for c in range(0, cin, TF32_DEPTH):
            s = slice(c, c + TF32_DEPTH)
            if passes == 3:
                part += a_lo[:, k, s] @ b_hi[k, s]
                part += a_hi[:, k, s] @ b_lo[k, s]
            part += a_hi[:, k, s] @ b_hi[k, s]
        acc += part
    return acc


DW_TF32_WARPS = 8  # csrc/sparse_conv_train.cu: DwMma::kWarps in f32


def dw_warp_split(cin: int, cout: int) -> int:
    """How many groups of warps split each 64-row step's eight k8 slices in
    dW's f32 tensor-core body (``csrc/sparse_conv_train.cu``:
    ``DwMma::kWk``): the block's 8 warps split Cin and Cout in up to 2
    each, the rest the slices (16 -> 16: 8, 16 -> 32: 4, from 32 -> 32 on:
    2)."""
    wm, wn = min(cin // 16, 2), min(cout // 16, 2)
    return DW_TF32_WARPS // (wm * wn)


def dw_tf32(feats, rb, dout, chunk_rows: int = DW_CHUNK_ROWS,
            passes: int = 3) -> torch.Tensor:
    """The f32 tensor-core dW's arithmetic in plain torch: per (chunk, tap)
    the chunk's rows that hit the tap, in order, in steps of 64 (zero rows
    after the last hit, as the kernel's compacted list runs); both operands
    split by ``split_tf32``; per group of warps (``dw_warp_split``), for
    each step in order, a partial from zero of, per 8-row k-slice of the
    group in order, lo_a hi_b, then hi_a lo_b, then hi_a hi_b (``passes``
    3; with ``passes`` 1 the single TF32 product hi_a hi_b), added into the
    group's f32 sum; the groups added in order, then the chunks in order
    (the reduce kernel). Steps of zero rows add zero partials, as the
    kernel runs no such step. The model of the kernel's numerics that the
    tests hold against JAX; no path of the port calls it. Returns [K, Cin,
    Cout] f32."""
    if passes not in (1, 3):
        raise ValueError(f"passes {passes}: 1 or 3")
    n_in, cin = feats.shape
    n_out, taps = rb.shape
    cout = dout.shape[1]
    groups = dw_warp_split(cin, cout)
    chunks = -(-n_out // chunk_rows)
    steps, slices = chunk_rows // TILE_ROWS, TILE_ROWS // TF32_DEPTH
    pad = chunks * chunk_rows - n_out
    padded = torch.cat([feats.float(), feats.new_zeros(1, cin).float()])
    hit = (rb >= 0) & (rb < n_in)
    idx = torch.cat([torch.where(hit, rb.long(), n_in),
                     rb.new_full((pad, taps), n_in, dtype=torch.long)])
    hit = torch.cat([hit, hit.new_zeros(pad, taps)]).reshape(
        chunks, chunk_rows, taps)
    # per (chunk, tap) its hit rows in order, then its misses
    order = torch.sort((~hit).to(torch.uint8), dim=1, stable=True).indices
    rows = (order + torch.arange(chunks, device=rb.device)[:, None, None]
            * chunk_rows).reshape(-1, taps)
    keep = hit.gather(1, order).reshape(-1, taps, 1)
    g = padded[idx.gather(0, rows)]  # [chunks * chunk_rows, taps, cin]
    d = torch.where(keep, torch.cat([dout.float(), dout.new_zeros(
        pad, cout).float()])[rows], 0.0)
    # [chunk, step, slice, row, tap, ...]
    a_hi, a_lo = split_tf32(g.reshape(chunks, steps, slices, TF32_DEPTH,
                                      taps, cin))
    b_hi, b_lo = split_tf32(d.reshape(chunks, steps, slices, TF32_DEPTH,
                                      taps, cout))
    prods = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if passes == 3 \
        else ((a_hi, b_hi),)
    total = None
    for group in range(groups):
        acc = torch.zeros(chunks, taps, cin, cout, device=feats.device)
        for s in range(steps):
            part = torch.zeros_like(acc)
            for kk in range(group, slices, groups):
                for a, b in prods:
                    part += torch.einsum("crti,crtj->ctij", a[:, s, kk],
                                         b[:, s, kk])
            acc += part
        total = acc if total is None else total + acc
    dw = total[0].clone()
    for c in range(1, chunks):
        dw += total[c]
    return dw


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
    Cin in {16, 32, 64} runs the tensor-core tile (bf16, and f32 through
    3xTF32, whose arithmetic ``gather_gemm_tf32`` models), which copies
    16-byte chunks; the first conv's Cin = 4 runs the direct body
    (``conv_instance``), which sums each row's taps in order by fmaf on the
    CUDA cores. Both want feats and w2 16-byte aligned."""
    if not _device(feats):
        return sparse_conv_fwd_ref(feats, rb, w2, out_mask)
    _check_fwd(feats, rb, w2, out_mask)
    out = _launch_fwd(feats, rb, w2, out_mask)
    sparse_conv_fwd.launches += 1
    return out


def _check_fwd(feats, rb, w2, out_mask):
    if out_mask is not None and (out_mask.dtype != torch.bool
                                 or out_mask.shape != rb.shape[:1]):
        raise ValueError("out_mask must be bool [N_out]")
    _check(feats, rb, w2, *(() if out_mask is None else (out_mask,)))
    _check_gather(feats, rb, w2, "sparse_conv_fwd")
    taps, cin, cout = w2.shape
    # every body loads 16-byte chunks (the direct one a gathered row whole)
    if (cin, cout) in FWD_PAIRS \
            and (feats.data_ptr() % 16 or w2.data_ptr() % 16):
        raise ValueError("feats and w2 must be 16-byte aligned")


def _launch_fwd(feats, rb, w2, out_mask):
    taps, cin, cout = w2.shape
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
    raise_on_error(lib, rc,
                   f"sparse_conv_fwd (Cin={cin}, Cout={cout}, K={taps})")
    return out


def _check_dfeat(dout, inv, w2):
    _check(dout, inv, w2)
    taps, cin, cout = w2.shape
    if w2.dtype != dout.dtype or (dout.shape[1], inv.shape[1]) != (cout,
                                                                   taps):
        raise ValueError(f"sparse_conv_dfeat: dout {tuple(dout.shape)} "
                         f"{dout.dtype}, inverse rulebook "
                         f"{tuple(inv.shape)}, weights {tuple(w2.shape)} "
                         f"{w2.dtype}")
    return taps, cin, cout


def _launch_dfeat(dout, inv, w2, cin, cout, taps):
    lib = build()
    dfeat = torch.empty((inv.shape[0], cin), dtype=dout.dtype,
                        device=dout.device)
    with torch.cuda.device(dout.device):
        rc = lib.sessd_sparse_conv_dfeat(
            dout.data_ptr(), inv.data_ptr(), w2.data_ptr(), dfeat.data_ptr(),
            dout.shape[0], inv.shape[0], cin, cout, taps,
            _DTYPE_CODES[dout.dtype], _INDEX_BYTES[inv.dtype],
            torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc,
                   f"sparse_conv_dfeat (Cin={cin}, Cout={cout}, K={taps})")
    return dfeat


def sparse_conv_dfeat(dout, inv, w2):
    """dfeat[i] = sum_k dout[inv[i, k]] @ w2[k]^T. dout [N_out, Cout]
    (zero on masked rows); inv [N_in, K] the inverse rulebook
    (``ops.sparse.inverse_rulebook``, miss N_out); w2 [K, Cin, Cout], read
    as it lies (no transposed copy). Returns [N_in, Cin] in dout's dtype.
    Cin, Cout in {16, 32, 64} run the tensor-core tile with a K-major B
    (bf16, and f32 through 3xTF32), which reads 16-byte chunks; the first
    conv's Cin = 4 (the voxel features' gradient) runs the direct body in
    both types (``conv_instance("sparse_conv_dfeat", dtype, Cout, Cin)``),
    which sums each row's taps in order by fmaf. Both want dout and w2
    16-byte aligned."""
    if not _device(dout):
        return sparse_conv_dfeat_ref(dout, inv, w2)
    taps, cin, cout = _check_dfeat(dout, inv, w2)
    if (cout, cin) in DFEAT_PAIRS \
            and (dout.data_ptr() % 16 or w2.data_ptr() % 16):
        raise ValueError("dout and w2 must be 16-byte aligned")
    dfeat = _launch_dfeat(dout, inv, w2, cin, cout, taps)
    sparse_conv_dfeat.launches += 1
    return dfeat


def _check_dw(feats, rb, dout, chunk_rows):
    _check(feats, rb, dout)
    n_out = rb.shape[0]
    if dout.dtype != feats.dtype or dout.shape[0] != n_out:
        raise ValueError(f"sparse_conv_dw: dout {tuple(dout.shape)} "
                         f"{dout.dtype} for rulebook {tuple(rb.shape)}, "
                         f"features {feats.dtype}")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows {chunk_rows}: want at least one row")
    chunks, taps = -(-n_out // chunk_rows), rb.shape[1]
    if chunks * taps > GRID_X_MAX:
        raise ValueError(f"sparse_conv_dw: {chunks} chunks x {taps} taps of "
                         f"blocks pass a grid's {GRID_X_MAX} (chunk_rows "
                         f"{chunk_rows})")
    cin, cout = feats.shape[1], dout.shape[1]
    if (cin, cout) not in DW_PAIRS:
        return
    if conv_instance("sparse_conv_dw", feats.dtype, cin, cout) != "direct" \
            and (chunk_rows % TILE_ROWS
                 or not 0 < chunk_rows <= DW_MAX_CHUNK_ROWS):
        raise ValueError(f"chunk_rows {chunk_rows}: the tensor-core dW "
                         f"takes multiples of {TILE_ROWS} up to "
                         f"{DW_MAX_CHUNK_ROWS}")
    if feats.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("feats and dout must be 16-byte aligned")


def _launch_dw(feats, rb, dout, chunk_rows):
    n_out, taps = rb.shape
    cin, cout = feats.shape[1], dout.shape[1]
    lib = build()
    chunks = -(-n_out // chunk_rows)
    partial = torch.empty((chunks, taps, cin, cout), dtype=torch.float32,
                          device=feats.device)
    dw = torch.empty((taps, cin, cout), dtype=feats.dtype,
                     device=feats.device)
    with torch.cuda.device(feats.device):
        rc = lib.sessd_sparse_conv_dw(
            feats.data_ptr(), rb.data_ptr(), dout.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), feats.shape[0], n_out, cin,
            cout, taps, chunk_rows, _DTYPE_CODES[feats.dtype],
            _INDEX_BYTES[rb.dtype], torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, rc,
                   f"sparse_conv_dw (Cin={cin}, Cout={cout}, K={taps})")
    return dw


def sparse_conv_dw(feats, rb, dout, chunk_rows=DW_CHUNK_ROWS):
    """dw[k] = sum_n feats[rb[n, k]]^T dout[n] ([K, Cin, Cout] in feats'
    dtype, summed in f32 in a fixed order: split-K partials over chunks of
    ``chunk_rows`` rows, then one ordered reduce). dout [N_out, Cout] must
    be zero on masked rows. Cin, Cout in {16, 32, 64} run the tensor-core
    partial kernel (bf16 on mma.sync m16n8k16, f32 through 3xTF32 on
    m16n8k8, whose arithmetic ``dw_tf32`` models), which takes chunk_rows
    a multiple of 64 up to DW_MAX_CHUNK_ROWS; the first conv's Cin = 4
    runs the direct one (``conv_instance``), which takes any chunk_rows and
    sums each chunk's rows in order by fmaf. Both want feats and dout
    16-byte aligned."""
    if not _device(feats):
        return sparse_conv_dw_ref(feats, rb, dout)
    _check_dw(feats, rb, dout, chunk_rows)
    dw = _launch_dw(feats, rb, dout, chunk_rows)
    sparse_conv_dw.launches += 1
    return dw


BLOCKS_ENTRIES = ("sparse_conv_fwd", "sparse_conv_dfeat", "sparse_conv_dw")


def blocks_per_sm(entry: str, dtype: torch.dtype, cin: int, cout: int,
                  chunk_rows: int = DW_CHUNK_ROWS) -> int:
    """Blocks of the int32-rulebook instance of ``entry`` (one of
    BLOCKS_ENTRIES; the input gradient by its gather's pair, dW's partial
    kernel at the shared memory of ``chunk_rows``-row chunks) for these
    types and channels that fit one SM of the current card at once (the
    occupancy API), 0 where there is none; needs a CUDA device."""
    lib = build()
    if entry == "sparse_conv_dw":
        return lib.sessd_sparse_conv_dw_blocks_per_sm(
            cin, cout, _DTYPE_CODES[dtype], chunk_rows)
    return lib.sessd_sparse_conv_train_blocks_per_sm(
        BLOCKS_ENTRIES.index(entry), cin, cout, _DTYPE_CODES[dtype])


sparse_conv_fwd.launches = 0
sparse_conv_dfeat.launches = 0
sparse_conv_dw.launches = 0
