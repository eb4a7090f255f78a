"""Fused sparse conv + folded BN + ReLU + occupancy mask: the CUDA kernels'
wrappers, their plain PyTorch twin, and the kernels' build.

``fused_sparse_conv`` replaces the Pallas ``_fused_kernel`` of
``sessd_tpu/ops/pallas/wconv.py`` (and, having no window, its over-span
``_patch_kernel``); ``fused_sparse_conv_stream`` replaces its streaming
twins ``_fused_stream_kernel`` and ``_patch_stream_kernel``, which the JAX
package takes where a conv's feature buffer is large (``streams``). On a
CPU tensor each runs the twin ``fused_sparse_conv_ref``; on a CUDA tensor
it launches its kernel (``sessd_torch/csrc/sparse_conv.cu``,
``sparse_conv_stream.cu``; ``conv_instance`` names the body a call takes,
``cluster_split`` the cluster size of a bf16 ``fused_sparse_conv``) or
raises. ``fused_sparse_conv_at_split`` (K1's kernel at a given cluster
size) exists for same-call comparisons only; nothing on the serving path
calls it. The kernels are compiled with nvcc into ``build/sessd_torch/``
at the first CUDA call (cached by a hash of the sources and flags) and
loaded with ctypes; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from typing import Optional

from ..sparse import gather_gemm

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sessd_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_BYTES = {torch.int16: 2, torch.int32: 4}

# sessd_tpu/ops/pallas/wconv.py:190-193, 394-399, 433-435: a conv streams its
# features when the TPU's resident [Cin, cols_for(n_in)] buffer would pass
# this many bytes; the port takes the stream kernel on the same convs
STREAM_FEATS_BYTES = 8 * 2 ** 20


def cols_for(n_rows: int, block: int = 256) -> int:
    """Lane-padded column count of the TPU's transposed feature buffer:
    >= n_rows + 1, a multiple of ``block``."""
    return (n_rows + 1 + block - 1) // block * block


def streams(cin: int, n_in: int, dtype: torch.dtype) -> bool:
    """True where the JAX package runs a conv over ``n_in`` input rows of
    ``cin`` channels through its stream kernels."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return cin * cols_for(n_in) * itemsize > STREAM_FEATS_BYTES


# the (Cin, Cout) pairs each C entry has instances of
# (csrc/sparse_conv_train.cu: SESSD_FWD_PAIRS, SESSD_DFEAT_PAIRS,
# SESSD_DW_PAIRS; csrc/sparse_conv_stream.cu: SESSD_STREAM_PAIRS;
# csrc/sparse_conv.cu: SESSD_FUSED_PAIRS). The input gradient's pairs are
# its gather's: (the conv's Cout, its Cin) of every conv, the first's
# (16, 4) included.
FWD_PAIRS = ((4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64))
STREAM_PAIRS = FWD_PAIRS[1:]
FUSED_PAIRS = DW_PAIRS = FWD_PAIRS
DFEAT_PAIRS = ((16, 4), (16, 16), (32, 16), (32, 32), (64, 32), (64, 64))
MMA_CHANNELS = (16, 32, 64)  # csrc/gather_mma.cuh: kMmaTile, kTf32Tile
# the bf16-only pairs of the two serving entries (csrc/sparse_conv.cu:
# SESSD_FUSED_WIDE_PAIRS, csrc/sparse_conv_stream.cu:
# SESSD_STREAM_WIDE_PAIRS; csrc/gather_mma.cuh: kWideTile): the 128-channel
# stages of SpMiddleResNetFHD (CenterPoint); f32 has no instance of them
WIDE_PAIRS = ((64, 128), (128, 128))
WIDE_ENTRIES = ("fused_sparse_conv_stream", "fused_sparse_conv")
# csrc/sparse_conv_train.cu: tile_code, what the C instance entries answer
INSTANCE_CODES = {"tf32": 3, "mma": 2, "direct": 1}
_PAIRS = {"sparse_conv_fwd": FWD_PAIRS,
          "fused_sparse_conv_stream": STREAM_PAIRS,
          "fused_sparse_conv": FUSED_PAIRS,
          "sparse_conv_dfeat": DFEAT_PAIRS,
          "sparse_conv_dw": DW_PAIRS}
MAX_SPLIT = 4  # csrc/gather_mma.cuh: kMaxSplit
TILE_ROWS = 64  # csrc/gather_common.cuh: kRows


def conv_instance(entry: str, dtype: torch.dtype, cin: int,
                  cout: int) -> str:
    """The body the C entry ``entry`` ("sparse_conv_fwd",
    "fused_sparse_conv_stream", "fused_sparse_conv", "sparse_conv_dfeat"
    or "sparse_conv_dw") launches for these types and channels, fixed at
    compile time: "mma" (bf16 with Cin and Cout in {16, 32, 64}: the
    tensor-core tile of ``csrc/gather_mma.cuh`` for the convs and the input
    gradient, the mma.sync partial kernel of ``sparse_conv_train.cu`` for
    dW; also bf16 at ``WIDE_PAIRS`` in the two serving entries), "tf32"
    (f32 at those channels: the same bodies through 3xTF32, dW's on
    mma.sync m16n8k8) or "direct" (the 4-channel side of the first
    conv, in both types: ``csrc/gather_direct.cuh``'s body on the CUDA
    cores for the convs and the input gradient's 16 -> 4, dW's
    ``dw_direct_partial``). For "sparse_conv_dfeat", (cin, cout) is its
    gather's pair: the conv's (Cout, Cin). Raises ValueError where the
    entry has no instance."""
    if (entry in WIDE_ENTRIES and (cin, cout) in WIDE_PAIRS
            and dtype == torch.bfloat16):
        return "mma"
    if (cin, cout) not in _PAIRS[entry] or dtype not in _DTYPE_CODES:
        raise ValueError(f"{entry} has no instance for {dtype}, Cin={cin}, "
                         f"Cout={cout}")
    if cin not in MMA_CHANNELS or cout not in MMA_CHANNELS:
        return "direct"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def cluster_split(tiles: int, wave: int) -> int:
    """The cluster size S of a tensor-core ``fused_sparse_conv`` launch of
    ``tiles`` 64-row tiles, where ``wave`` blocks of the instance fit on the
    card at once (blocks per SM x SMs): 1 where the tiles fill a wave, else
    4 where four CTAs per tile still fit one wave, else 2
    (``csrc/gather_mma.cuh:cluster_split``)."""
    if tiles >= wave:
        return 1
    return MAX_SPLIT if tiles * MAX_SPLIT <= wave else 2


_build_lock = threading.Lock()
_library = None  # the loaded ctypes library, once built
build_info: dict = {}  # path, seconds and compiler log of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _compile(srcs, lib_path: pathlib.Path) -> str:
    """One nvcc per source, all started together, then one link; the
    library appears on ``lib_path`` through a single rename."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    log += res.stdout + res.stderr
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders agree
    return log


def build() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` (once per source/flag hash) and load it."""
    global _library
    with _build_lock:
        if _library is not None:
            return _library
        srcs = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        for src in sorted(CSRC.glob("*.cu*")):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        lib_path = BUILD_DIR / f"libsessd_torch_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        log = "" if lib_path.exists() else _compile(srcs, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # feats, rb, w2, bias, out; n_in, n_out, cin, cout, taps, dtype,
        # idx_bytes, relu; stream
        lib.sessd_fused_sparse_conv.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        lib.sessd_fused_sparse_conv_stream.argtypes = \
            lib.sessd_fused_sparse_conv.argtypes
        # feats, rb, w2, bias, residual, out; the rest as above
        lib.sessd_fused_sparse_conv_residual.argtypes = \
            [ptr] * 6 + [i32] * 8 + [ptr]
        lib.sessd_fused_sparse_conv_stream_residual.argtypes = \
            lib.sessd_fused_sparse_conv_residual.argtypes
        # ... relu, split; stream
        lib.sessd_fused_sparse_conv_at_split.argtypes = \
            [ptr] * 5 + [i32] * 9 + [ptr]
        # feats, rb, w2, row_mask, out; n_in, n_out, cin, cout, taps,
        # dtype, idx_bytes; stream
        lib.sessd_sparse_conv_fwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        # dout, inv, w2, dfeat; n_out, n_in, cin, cout, taps, dtype,
        # idx_bytes; stream
        lib.sessd_sparse_conv_dfeat.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        # feats, rb, dout, partial, dw; n_in, n_out, cin, cout, taps,
        # chunk_rows, dtype, idx_bytes; stream
        lib.sessd_sparse_conv_dw.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        # the micro-benchmark kernels (ops/cuda/ablate.py)
        # feats, rb, w2, out; n_in, n_out, taps, mode; stream
        lib.sessd_sparse_conv_ablate.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        # feats, rb, w2, out; n_in, n_out, channels, taps, mode; stream
        lib.sessd_sparse_conv_ablate_mma.argtypes = \
            [ptr] * 4 + [i32] * 5 + [ptr]
        # out; n_bytes, block_bytes(, reps); stream
        i64 = ctypes.c_longlong
        lib.sessd_empty_launch.argtypes = [ptr, i64, i32, ptr]
        lib.sessd_empty_launch_repeat.argtypes = [ptr, i64, i32, i32, ptr]
        # feats, rb, w2, out; n_in, n_out, cin, cout, taps, dtype,
        # idx_bytes, reps; stream
        lib.sessd_sparse_conv_fwd_repeat.argtypes = \
            [ptr] * 4 + [i32] * 8 + [ptr]
        # boxes, scores, mask, keep, valid; batch, pre, slots; threshold;
        # stream (the rotated NMS, ops/cuda/nms.py)
        lib.sessd_rotated_nms.argtypes = \
            [ptr] * 5 + [i32] * 3 + [ctypes.c_float, ptr]
        # cin, cout, dtype -> INSTANCE_CODES of the body, 0 none
        instances = (lib.sessd_sparse_conv_fwd_instance,
                     lib.sessd_fused_sparse_conv_stream_instance,
                     lib.sessd_fused_sparse_conv_instance,
                     lib.sessd_sparse_conv_dfeat_instance,
                     lib.sessd_sparse_conv_dw_instance)
        for fn in instances:
            fn.argtypes = [i32] * 3
        # cin, cout -> the tensor-core K1 instance's wave (0: none);
        # n_out, cin, cout, dtype -> the cluster size K1 launches with
        lib.sessd_fused_sparse_conv_wave.argtypes = [i32] * 2
        lib.sessd_fused_sparse_conv_split.argtypes = [i32] * 4
        # entry (0 fwd, 1 dfeat), cin, cout, dtype -> blocks per SM of a
        # training instance; dW's at (cin, cout, dtype, chunk_rows),
        # the stream kernel's at (cin, cout, dtype)
        lib.sessd_sparse_conv_train_blocks_per_sm.argtypes = [i32] * 4
        lib.sessd_sparse_conv_dw_blocks_per_sm.argtypes = [i32] * 4
        lib.sessd_fused_sparse_conv_stream_blocks_per_sm.argtypes = [i32] * 3
        for fn in (lib.sessd_fused_sparse_conv,
                   lib.sessd_fused_sparse_conv_stream,
                   lib.sessd_fused_sparse_conv_residual,
                   lib.sessd_fused_sparse_conv_stream_residual,
                   lib.sessd_fused_sparse_conv_at_split,
                   lib.sessd_sparse_conv_fwd,
                   lib.sessd_sparse_conv_dfeat,
                   lib.sessd_sparse_conv_dw,
                   lib.sessd_sparse_conv_ablate,
                   lib.sessd_sparse_conv_ablate_mma, lib.sessd_empty_launch,
                   lib.sessd_empty_launch_repeat,
                   lib.sessd_sparse_conv_fwd_repeat,
                   lib.sessd_fused_sparse_conv_wave,
                   lib.sessd_fused_sparse_conv_split,
                   lib.sessd_sparse_conv_train_blocks_per_sm,
                   lib.sessd_sparse_conv_dw_blocks_per_sm,
                   lib.sessd_fused_sparse_conv_stream_blocks_per_sm,
                   lib.sessd_rotated_nms,
                   *instances):
            fn.restype = i32
        lib.sessd_cuda_error_string.restype = ctypes.c_char_p
        lib.sessd_cuda_error_string.argtypes = [i32]
        build_info.update(path=str(lib_path), log=log,
                          seconds=time.perf_counter() - t0)
        _library = lib
        return lib


def raise_on_error(lib, rc: int, what: str):
    """Raise for a nonzero return of a C entry point; the entry points also
    answer cudaErrorInvalidValue for a shape or type they have no instance
    of."""
    if rc != 0:
        msg = lib.sessd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {rc} ({msg})")


def fused_sparse_conv_ref(feats: torch.Tensor, rb: torch.Tensor,
                          w2: torch.Tensor, bias: torch.Tensor, n_in: int,
                          relu: bool = True,
                          residual: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (any device): zero-row pad,
    index_select, one f32 matmul, bias (and ``residual``, a residual
    block's identity [n_out, Cout]), ReLU, hit mask; output in the
    features' dtype."""
    out = gather_gemm(feats[:n_in], rb, w2) + bias.float()
    if residual is not None:
        out = out + residual.float()
    if relu:
        out = out.clamp_min(0.0)
    hit = (rb != n_in).any(dim=1, keepdim=True)
    return torch.where(hit, out, 0.0).to(feats.dtype)


def _check(feats, rb, w2, bias, n_in):
    dev = feats.device
    for name, t in (("rb", rb), ("w2", w2), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not feats.is_contiguous():
        raise ValueError("feats must be contiguous")
    if feats.dtype not in _DTYPE_CODES:
        raise ValueError(f"feats dtype {feats.dtype}: want float32/bfloat16")
    if rb.dtype not in _INDEX_BYTES:
        raise ValueError(f"rb dtype {rb.dtype}: want int16/int32")
    if w2.dtype != feats.dtype or bias.dtype != torch.float32:
        raise ValueError(f"w2 must be {feats.dtype} (is {w2.dtype}), "
                         f"bias float32 (is {bias.dtype})")
    if feats.dim() != 2 or rb.dim() != 2 or w2.dim() != 3:
        raise ValueError("want feats [n, Cin], rb [n_out, K], "
                         "w2 [K, Cin, Cout]")
    taps, cin, cout = w2.shape
    if (feats.shape[1], rb.shape[1]) != (cin, taps) or bias.shape != (cout,):
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, rb "
                         f"{tuple(rb.shape)}, w2 {tuple(w2.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if not 0 < n_in <= feats.shape[0] or rb.shape[0] == 0:
        raise ValueError(f"n_in={n_in} outside (0, {feats.shape[0]}] or "
                         "empty rulebook")
    if rb.dtype == torch.int16 and n_in > torch.iinfo(torch.int16).max:
        raise ValueError(f"n_in={n_in} does not fit an int16 rulebook")


def _launch(entry: str, feats, rb, w2, bias, n_in, relu,
            *extra, residual=None) -> torch.Tensor:
    lib = build()
    taps, cin, cout = w2.shape
    out = torch.empty((rb.shape[0], cout), dtype=feats.dtype,
                      device=feats.device)
    res = () if residual is None else (residual.data_ptr(),)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "sessd_" + entry + ("_residual" if res else ""))(
            feats.data_ptr(), rb.data_ptr(), w2.data_ptr(), bias.data_ptr(),
            *res, out.data_ptr(), n_in, rb.shape[0], cin, cout, taps,
            _DTYPE_CODES[feats.dtype], _INDEX_BYTES[rb.dtype], int(relu),
            *extra, stream)
    raise_on_error(lib, rc, f"{entry} (Cin={cin}, Cout={cout}, K={taps})")
    return out


def _check_residual(feats, rb, w2, residual):
    """A residual joins the bf16 tensor-core instances with Cin == Cout:
    the output's shape, type and device, contiguous and 16-byte aligned."""
    taps, cin, cout = w2.shape
    if cin != cout or feats.dtype != torch.bfloat16:
        raise ValueError(f"a residual needs bf16 and Cin == Cout (got "
                         f"{feats.dtype}, {cin}, {cout})")
    if (residual.shape != (rb.shape[0], cout) or residual.dtype != feats.dtype
            or residual.device != feats.device
            or not residual.is_contiguous() or residual.data_ptr() % 16):
        raise ValueError(f"want a contiguous, 16-byte aligned {feats.dtype} "
                         f"residual {(rb.shape[0], cout)} on {feats.device}")


def _check_aligned(feats, w2):
    """The tensor-core tile copies 16-byte chunks; the direct body loads
    each gathered row whole and stores 4 channels at once."""
    if feats.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("feats and w2 must be 16-byte aligned")


def _on_device(feats, rb, w2, bias, n_in) -> bool:
    """False for CPU tensors (the twin's), True for CUDA tensors that pass
    the kernels' checks; raises for any other device."""
    if feats.device.type == "cpu":
        return False
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    _check(feats, rb, w2, bias, n_in)
    return True


def _body(feats, w2) -> str:
    """``conv_instance`` of ``fused_sparse_conv`` for these inputs ("" for
    a pair it has no instance of: the C entry refuses it)."""
    taps, cin, cout = w2.shape
    try:
        return conv_instance("fused_sparse_conv", feats.dtype, cin, cout)
    except ValueError:
        return ""


def fused_sparse_conv(feats: torch.Tensor, rb: torch.Tensor, w2: torch.Tensor,
                      bias: torch.Tensor, n_in: int, relu: bool = True,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """out[n] = relu(sum_k feats[rb[n, k]] @ w2[k] + bias) where any tap of
    row n hits, else 0.

    feats [n_in, Cin] f32/bf16; rb [n_out, K] int16/int32 with entries in
    [0, n_in] (n_in = miss); w2 [K, Cin, Cout] in the feats dtype (BN scale
    folded in); bias [Cout] f32. Returns [n_out, Cout] in the feats dtype.
    bf16 with Cin, Cout in {16, 32, 64}, or at ``WIDE_PAIRS``, runs the
    tensor-core tile (feats and w2 16-byte aligned), in clusters of
    ``cluster_split`` CTAs per tile where the launch fills less than a
    wave; f32 at those channels runs the
    same tile through 3xTF32 at one CTA per tile (the f32 stream kernel's
    instance: bit-equal to ``fused_sparse_conv_stream``); the Cin = 4 first
    conv runs the direct body (``conv_instance``), which sums each row's
    taps in order by fmaf on the CUDA cores. Every body wants feats and w2
    16-byte aligned. ``residual`` [n_out, Cout] (a residual block's identity; bf16
    tensor-core instances with Cin == Cout) is added before the ReLU, in
    f32. CPU tensors take the twin; CUDA tensors launch the kernel on the
    current stream, counted in ``fused_sparse_conv.launches``.
    """
    if not _on_device(feats, rb, w2, bias, n_in):
        return fused_sparse_conv_ref(feats, rb, w2, bias, n_in, relu,
                                     residual)
    if _body(feats, w2):
        _check_aligned(feats, w2)
    if residual is not None:
        _check_residual(feats, rb, w2, residual)
    out = _launch("fused_sparse_conv", feats, rb, w2, bias, n_in, relu,
                  residual=residual)
    fused_sparse_conv.launches += 1
    return out


fused_sparse_conv.launches = 0


def fused_sparse_conv_at_split(feats, rb, w2, bias, n_in, split: int,
                               relu=True):
    """``fused_sparse_conv``'s kernel launched in clusters of ``split`` (1,
    2 or 4) CTAs per tile instead of the rule's: for same-call comparisons
    only. Tensor-core instances only; CPU tensors take the twin. Counted in
    ``fused_sparse_conv_at_split.launches``."""
    if not _on_device(feats, rb, w2, bias, n_in):
        return fused_sparse_conv_ref(feats, rb, w2, bias, n_in, relu)
    if _body(feats, w2) != "mma" or split not in (1, 2, MAX_SPLIT):
        raise ValueError(f"split {split} of a {feats.dtype} "
                         f"{tuple(w2.shape[1:])} conv: the bf16 tensor-core "
                         "instances take 1, 2 or 4")
    _check_aligned(feats, w2)
    out = _launch("fused_sparse_conv_at_split", feats, rb, w2, bias, n_in,
                  relu, split)
    fused_sparse_conv_at_split.launches += 1
    return out


fused_sparse_conv_at_split.launches = 0


def launch_split(n_out: int, cin: int, cout: int, dtype) -> int:
    """The cluster size the C entry of ``fused_sparse_conv`` launches with
    for ``n_out`` output rows on this card (1 on the direct body and in
    f32); reads the card, so CUDA only."""
    lib = build()
    split = lib.sessd_fused_sparse_conv_split(n_out, cin, cout,
                                              _DTYPE_CODES[dtype])
    if split <= 0:
        raise ValueError(f"fused_sparse_conv has no instance for {dtype}, "
                         f"Cin={cin}, Cout={cout}")
    return split


def launch_wave(cin: int, cout: int) -> int:
    """The wave ``cluster_split`` compares the tiles of a bf16
    ``fused_sparse_conv`` launch with, on this card; CUDA only."""
    wave = build().sessd_fused_sparse_conv_wave(cin, cout)
    if wave <= 0:
        raise ValueError(f"no tensor-core instance for Cin={cin}, "
                         f"Cout={cout}")
    return wave


def fused_sparse_conv_stream(feats: torch.Tensor, rb: torch.Tensor,
                             w2: torch.Tensor, bias: torch.Tensor, n_in: int,
                             relu: bool = True,
                             residual: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``fused_sparse_conv``'s function and contract, through the streaming
    kernel (``csrc/sparse_conv_stream.cu``): the tensor-core tile of
    ``gather_mma.cuh`` (a 4-stage cp.async ring, taps no row of a tile hits
    skipped), in bf16 bit-equal to K1 where K1 runs one CTA per tile, in f32
    through 3xTF32, bit-equal to f32 K1 and to ``sparse_conv_fwd`` plus
    bias, ReLU and the any-hit mask (``conv_instance``).
    Takes Cin in {16, 32, 64}, and bf16 at ``WIDE_PAIRS``: the 4-channel
    first conv never streams. ``residual`` as ``fused_sparse_conv``'s. CPU
    tensors take the twin; CUDA tensors launch the kernel, counted in
    ``fused_sparse_conv_stream.launches``.
    """
    if not _on_device(feats, rb, w2, bias, n_in):
        return fused_sparse_conv_ref(feats, rb, w2, bias, n_in, relu,
                                     residual)
    if w2.shape[1] not in MMA_CHANNELS and not (
            tuple(w2.shape[1:]) in WIDE_PAIRS and w2.dtype == torch.bfloat16):
        raise ValueError(f"Cin={w2.shape[1]}: the stream kernel takes 16, 32 "
                         "or 64 input channels, or bf16 (64, 128) and "
                         "(128, 128)")
    _check_aligned(feats, w2)
    if residual is not None:
        _check_residual(feats, rb, w2, residual)
    out = _launch("fused_sparse_conv_stream", feats, rb, w2, bias, n_in, relu,
                  residual=residual)
    fused_sparse_conv_stream.launches += 1
    return out


fused_sparse_conv_stream.launches = 0


def stream_blocks_per_sm(cin: int, cout: int, dtype) -> int:
    """Blocks of the int32-rulebook instance of ``fused_sparse_conv_stream``
    for these channels and type that fit one SM of the current card (the
    occupancy API), 0 where there is none; needs a CUDA device."""
    return build().sessd_fused_sparse_conv_stream_blocks_per_sm(
        cin, cout, _DTYPE_CODES[dtype])
