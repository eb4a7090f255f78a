"""Fused sparse conv + folded BN + ReLU + occupancy mask: the CUDA kernels'
wrappers, their plain PyTorch twin, and the kernels' build.

``fused_sparse_conv`` replaces the Pallas ``_fused_kernel`` of
``sessd_tpu/ops/pallas/wconv.py`` (and, having no window, its over-span
``_patch_kernel``); ``fused_sparse_conv_stream`` replaces its streaming
twins ``_fused_stream_kernel`` and ``_patch_stream_kernel``, which the JAX
package takes where a conv's feature buffer is large (``streams``). On a
CPU tensor each runs the twin ``fused_sparse_conv_ref``; on a CUDA tensor
it launches its kernel (``sessd_torch/csrc/sparse_conv.cu``,
``sparse_conv_stream.cu``; ``conv_instance`` names the body a call takes)
or raises. The kernels are compiled with nvcc
into ``build/sessd_torch/`` at the first CUDA call (cached by a hash of the
sources and flags) and loaded with ctypes; importing this module builds
nothing.
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
# (csrc/sparse_conv_train.cu: SESSD_FWD_PAIRS, csrc/sparse_conv_stream.cu:
# SESSD_STREAM_PAIRS)
FWD_PAIRS = ((4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64))
STREAM_PAIRS = FWD_PAIRS[1:]
MMA_CHANNELS = (16, 32, 64)  # csrc/gather_mma.cuh: kMmaTile
_PAIRS = {"sparse_conv_fwd": FWD_PAIRS,
          "fused_sparse_conv_stream": STREAM_PAIRS}


def conv_instance(entry: str, dtype: torch.dtype, cin: int,
                  cout: int) -> str:
    """The body the C entry ``entry`` ("sparse_conv_fwd" or
    "fused_sparse_conv_stream") launches for these types and channels,
    fixed at compile time: "mma" (the tensor-core tile of
    ``csrc/gather_mma.cuh``: bf16 with Cin and Cout in {16, 32, 64}) or
    "scalar" (``gather_gemm.cuh``'s tile, or the stream kernel's f32 ring).
    Raises ValueError where the entry has no instance."""
    if (cin, cout) not in _PAIRS[entry] or dtype not in _DTYPE_CODES:
        raise ValueError(f"{entry} has no instance for {dtype}, Cin={cin}, "
                         f"Cout={cout}")
    mma = (dtype == torch.bfloat16 and cin in MMA_CHANNELS
           and cout in MMA_CHANNELS)
    return "mma" if mma else "scalar"


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
        # feats, rb, w2, row_mask, out; n_in, n_out, cin, cout, taps,
        # dtype, idx_bytes; stream
        lib.sessd_sparse_conv_fwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        # dout, inv, wt, dfeat; n_out, n_in, cin, cout, taps, dtype,
        # idx_bytes; stream
        lib.sessd_sparse_conv_dfeat.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        # feats, rb, dout, partial, dw; n_in, n_out, cin, cout, taps,
        # chunk_rows, dtype, idx_bytes; stream
        lib.sessd_sparse_conv_dw.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        # the micro-benchmark kernels (ops/cuda/ablate.py)
        # feats, rb, w2, out; n_in, n_out, taps, mode; stream
        lib.sessd_sparse_conv_ablate.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        # out; n_bytes, block_bytes(, reps); stream
        i64 = ctypes.c_longlong
        lib.sessd_empty_launch.argtypes = [ptr, i64, i32, ptr]
        lib.sessd_empty_launch_repeat.argtypes = [ptr, i64, i32, i32, ptr]
        # feats, rb, w2, out; n_in, n_out, cin, cout, taps, dtype,
        # idx_bytes, reps; stream
        lib.sessd_sparse_conv_fwd_repeat.argtypes = \
            [ptr] * 4 + [i32] * 8 + [ptr]
        # cin, cout, dtype -> 2 tensor-core tile, 1 scalar tile, 0 none
        lib.sessd_sparse_conv_fwd_instance.argtypes = [i32] * 3
        lib.sessd_fused_sparse_conv_stream_instance.argtypes = [i32] * 3
        for fn in (lib.sessd_fused_sparse_conv,
                   lib.sessd_fused_sparse_conv_stream,
                   lib.sessd_sparse_conv_fwd,
                   lib.sessd_sparse_conv_dfeat, lib.sessd_sparse_conv_dw,
                   lib.sessd_sparse_conv_ablate, lib.sessd_empty_launch,
                   lib.sessd_empty_launch_repeat,
                   lib.sessd_sparse_conv_fwd_repeat,
                   lib.sessd_sparse_conv_fwd_instance,
                   lib.sessd_fused_sparse_conv_stream_instance):
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
                          relu: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (any device): zero-row pad,
    index_select, one f32 matmul, bias, ReLU, hit mask; output in the
    features' dtype."""
    out = gather_gemm(feats[:n_in], rb, w2) + bias.float()
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


def _launch(entry: str, feats, rb, w2, bias, n_in, relu) -> torch.Tensor:
    lib = build()
    taps, cin, cout = w2.shape
    out = torch.empty((rb.shape[0], cout), dtype=feats.dtype,
                      device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "sessd_" + entry)(
            feats.data_ptr(), rb.data_ptr(), w2.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n_in, rb.shape[0], cin, cout, taps,
            _DTYPE_CODES[feats.dtype], _INDEX_BYTES[rb.dtype], int(relu),
            stream)
    raise_on_error(lib, rc, f"{entry} (Cin={cin}, Cout={cout}, K={taps})")
    return out


def fused_sparse_conv(feats: torch.Tensor, rb: torch.Tensor, w2: torch.Tensor,
                      bias: torch.Tensor, n_in: int,
                      relu: bool = True) -> torch.Tensor:
    """out[n] = relu(sum_k feats[rb[n, k]] @ w2[k] + bias) where any tap of
    row n hits, else 0.

    feats [n_in, Cin] f32/bf16; rb [n_out, K] int16/int32 with entries in
    [0, n_in] (n_in = miss); w2 [K, Cin, Cout] in the feats dtype (BN scale
    folded in); bias [Cout] f32. Returns [n_out, Cout] in the feats dtype.
    CPU tensors take the twin; CUDA tensors launch the kernel on the current
    stream, counted in ``fused_sparse_conv.launches``.
    """
    if feats.device.type == "cpu":
        return fused_sparse_conv_ref(feats, rb, w2, bias, n_in, relu)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    _check(feats, rb, w2, bias, n_in)
    out = _launch("fused_sparse_conv", feats, rb, w2, bias, n_in, relu)
    fused_sparse_conv.launches += 1
    return out


fused_sparse_conv.launches = 0


def fused_sparse_conv_stream(feats: torch.Tensor, rb: torch.Tensor,
                             w2: torch.Tensor, bias: torch.Tensor, n_in: int,
                             relu: bool = True) -> torch.Tensor:
    """``fused_sparse_conv``'s function and contract, through the streaming
    kernel (``csrc/sparse_conv_stream.cu``): in bf16 the tensor-core tile
    of ``gather_mma.cuh`` (a 4-stage cp.async ring, taps no row of a tile
    hits skipped), which sums in another order than K1; in f32 a two-slot
    ring with K1's summation order, bit-equal to K1 (``conv_instance``).
    Takes Cin in {16, 32, 64}: the 4-channel first conv never streams. CPU
    tensors take the twin; CUDA tensors launch the kernel, counted in
    ``fused_sparse_conv_stream.launches``.
    """
    if feats.device.type == "cpu":
        return fused_sparse_conv_ref(feats, rb, w2, bias, n_in, relu)
    if feats.device.type != "cuda":
        raise ValueError(f"no kernel for device {feats.device}")
    _check(feats, rb, w2, bias, n_in)
    if w2.shape[1] not in (16, 32, 64):
        raise ValueError(f"Cin={w2.shape[1]}: the stream kernel takes 16, 32 "
                         "or 64 input channels")
    if feats.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("feats and w2 must be 16-byte aligned")
    out = _launch("fused_sparse_conv_stream", feats, rb, w2, bias, n_in, relu)
    fused_sparse_conv_stream.launches += 1
    return out


fused_sparse_conv_stream.launches = 0
