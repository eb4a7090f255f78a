"""The host C++ library (``native/*.cpp``): its race-free build and its
ctypes binding (the port's copy of ``sessd_tpu/utils/native.py``).

The sources sit at the repo root and are built as they are, with the
reference's g++ command, into the port's own file under
``build/sessd_torch/``, named by a hash of the sources and flags, so the two
packages never write the same library. The build runs under an
``fcntl.flock`` shared by all processes, into a temporary file beside the
library that one ``os.replace`` puts on the final path: test workers, loader
threads and a fresh checkout that start together compile it once, and no
process can load a half-written file. A failed compile raises with the
compiler's log; there is no fallback.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = REPO / "native"
BUILD_DIR = REPO / "build" / "sessd_torch"
# sessd_tpu/utils/native.py:33-34, the output path aside
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_handles: dict = {}
build_log: dict = {}  # lib path -> compiler output of this process's builds


class _Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        v = lib.voxelize
        v.restype = ctypes.c_int64
        v.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # points
            ctypes.c_int64, ctypes.c_int64,   # num_points, num_features
            ctypes.POINTER(ctypes.c_float),   # pc_range
            ctypes.POINTER(ctypes.c_float),   # voxel_size
            ctypes.c_int64, ctypes.c_int64,   # max_points, max_voxels
            ctypes.POINTER(ctypes.c_float),   # out_voxels
            ctypes.POINTER(ctypes.c_int32),   # out_coords
            ctypes.POINTER(ctypes.c_int32),   # out_num_points
        ]
        rb = lib.build_rulebooks
        rb.restype = ctypes.c_int64
        rb.argtypes = [
            ctypes.POINTER(ctypes.c_int32),   # coords_bzyx
            ctypes.c_int64,                   # n valid
            ctypes.POINTER(ctypes.c_int64),   # shape_bdhw
            ctypes.POINTER(ctypes.c_int64),   # caps [5]
            ctypes.POINTER(ctypes.c_int32),   # down kernels [4*3]
            ctypes.POINTER(ctypes.c_int32),   # down strides [4*3]
            ctypes.POINTER(ctypes.c_int32),   # down pads [4*3]
            ctypes.POINTER(ctypes.c_int32),   # out_perm
            ctypes.POINTER(ctypes.c_int32),   # out_ids
            ctypes.POINTER(ctypes.c_int32),   # out_subm
            ctypes.POINTER(ctypes.c_int32),   # out_down
        ]
        rb16 = lib.build_rulebooks_i16
        rb16.restype = ctypes.c_int64
        rb16.argtypes = rb.argtypes[:7] + [
            ctypes.POINTER(ctypes.c_int16),   # out_perm
            ctypes.POINTER(ctypes.c_int32),   # out_ids
            ctypes.POINTER(ctypes.c_int16),   # out_subm
            ctypes.POINTER(ctypes.c_int16),   # out_down
        ]

    def voxelize(self, points, pc_range, voxel_size, max_points, max_voxels):
        """FCFS voxelization; returns (voxels, coords zyx, num_points),
        trimmed to the actual voxel count like voxelize_np."""
        points = np.ascontiguousarray(points, dtype=np.float32)
        p, f = points.shape
        pc_range = np.asarray(pc_range, dtype=np.float32)
        voxel_size = np.asarray(voxel_size, dtype=np.float32)
        out_voxels = np.zeros((max_voxels, max_points, f), dtype=np.float32)
        out_coords = np.zeros((max_voxels, 3), dtype=np.int32)
        out_np = np.zeros((max_voxels,), dtype=np.int32)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        nv = self._lib.voxelize(
            ptr(points, ctypes.c_float), p, f,
            ptr(pc_range, ctypes.c_float), ptr(voxel_size, ctypes.c_float),
            max_points, max_voxels,
            ptr(out_voxels, ctypes.c_float), ptr(out_coords, ctypes.c_int32),
            ptr(out_np, ctypes.c_int32),
        )
        return out_voxels[:nv], out_coords[:nv], out_np[:nv]

    def rulebook_scratch(self, caps, downs, out_dtype=np.int32):
        """Allocate one reusable output-buffer set for build_rulebooks.

        Serving/loaders should hold a small ring of these (one per batch
        in flight) and pass them via ``scratch=``: steady-state host prep
        then performs no large allocations at all.
        """
        caps = np.asarray(caps, np.int64)
        kvols = [int(np.prod(k)) for k, _, _ in downs]
        out_dtype = np.dtype(out_dtype)
        return {
            "perm": np.empty(int(caps[0]), out_dtype),
            "ids": np.empty(int(caps.sum()), np.int32),
            "subm": np.empty(int(sum(caps[i] * 27 for i in range(4))),
                             out_dtype),
            "down": np.empty(int(sum(caps[i + 1] * kvols[i]
                                     for i in range(4))), out_dtype),
        }

    def build_rulebooks(self, coords_bzyx, valid, shape_bdhw, caps, downs,
                        out_dtype=np.int32, scratch=None):
        """Host twin of the device SpMiddleFHD rulebook chain (ops/sparse.py).

        coords_bzyx [cap0, 4] int32 (+ valid [cap0] bool, any layout);
        shape_bdhw: stage-0 (B, D, H, W); caps: 5 per-stage row capacities;
        downs: 4 (kernel, stride, pad) int-triple tuples.
        Returns dict(perm [cap0], ids (5 arrays), subm (4 arrays [cap, 27]),
        down (4 arrays [cap, K])) matching the device arrays exactly.

        out_dtype=np.int16 writes perm/subm/down as int16 directly (all
        capacities must fit; ids stay int32) — half the PCIe bytes for
        serving with no cast pass.
        """
        coords_bzyx = np.ascontiguousarray(coords_bzyx, np.int32)
        valid = np.asarray(valid, bool)
        caps = np.asarray(caps, np.int64)
        assert coords_bzyx.shape[0] <= caps[0]
        if coords_bzyx.shape[0] < caps[0]:  # pad like the device capacity
            pad = int(caps[0]) - coords_bzyx.shape[0]
            coords_bzyx = np.concatenate(
                [coords_bzyx, np.zeros((pad, 4), np.int32)])
            valid = np.concatenate([valid, np.zeros((pad,), bool)])
        vrows = np.flatnonzero(valid)
        ivrows = np.flatnonzero(~valid)
        comp = np.ascontiguousarray(coords_bzyx[vrows])
        n = comp.shape[0]
        shape = np.asarray(shape_bdhw, np.int64)
        dk = np.ascontiguousarray([k for k, _, _ in downs], np.int32)
        ds = np.ascontiguousarray([s for _, s, _ in downs], np.int32)
        dp = np.ascontiguousarray([p for _, _, p in downs], np.int32)
        kvols = [int(np.prod(k)) for k, _, _ in downs]
        out_dtype = np.dtype(out_dtype)
        ct = dict([(np.dtype(np.int32), ctypes.c_int32),
                   (np.dtype(np.int16), ctypes.c_int16)])[out_dtype]
        fn = (self._lib.build_rulebooks if out_dtype == np.int32
              else self._lib.build_rulebooks_i16)
        # np.empty: the C++ fills every output element (misses included).
        # `scratch` (see rulebook_scratch) reuses preallocated buffers —
        # fresh ~50-80 MB mmaps per call stall for SECONDS under THP/
        # khugepaged once the process heap is churned (measured 1.4-1.9 s
        # per batch-4 call when results stay alive; 80 ms with reuse)
        if scratch is None:
            scratch = self.rulebook_scratch(caps, downs, out_dtype)
        perm = scratch["perm"]
        ids = scratch["ids"]
        subm = scratch["subm"]
        down = scratch["down"]

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        rc = fn(
            ptr(comp, ctypes.c_int32), n, ptr(shape, ctypes.c_int64),
            ptr(caps, ctypes.c_int64), ptr(dk, ctypes.c_int32),
            ptr(ds, ctypes.c_int32), ptr(dp, ctypes.c_int32),
            ptr(perm, ct), ptr(ids, ctypes.c_int32),
            ptr(subm, ct), ptr(down, ct))
        if rc != 0:
            raise ValueError(f"build_rulebooks failed: rc={rc}")
        # un-compact the permutation: C++ permutes valid rows; the device
        # perm sorts the full padded array (stable, SENTINEL ids last)
        full_perm = np.concatenate(
            [vrows[perm[:n]], ivrows]).astype(out_dtype)
        out = {"perm": full_perm, "ids": [], "subm": [], "down": []}
        o = 0
        for c in caps:
            out["ids"].append(ids[o:o + int(c)])
            o += int(c)
        o = 0
        for i in range(4):
            out["subm"].append(subm[o:o + int(caps[i]) * 27]
                               .reshape(int(caps[i]), 27))
            o += int(caps[i]) * 27
        o = 0
        for i in range(4):
            out["down"].append(down[o:o + int(caps[i + 1]) * kvols[i]]
                               .reshape(int(caps[i + 1]), kvols[i]))
            o += int(caps[i + 1]) * kvols[i]
        return out


def library_path(src_dir=SRC_DIR, lib_dir=BUILD_DIR) -> pathlib.Path:
    """``lib_dir/libsessd_native_<hash>.so``, the hash over the g++ flags
    and every ``src_dir/*.cpp`` (name and bytes): a changed source gets a
    new file, and an unchanged one is never rebuilt."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in sorted(pathlib.Path(src_dir).glob("*.cpp")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    name = f"libsessd_native_{digest.hexdigest()[:16]}.so"
    return pathlib.Path(lib_dir) / name


def _compile(srcs, lib: pathlib.Path) -> str:
    """g++ into a temporary file beside ``lib``, then one rename onto it."""
    fd, tmp = tempfile.mkstemp(prefix=f".{lib.name}.", suffix=".tmp",
                               dir=lib.parent)
    os.close(fd)
    try:
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) building "
                               f"{lib}:\n{log}")
        os.replace(tmp, lib)
        return log
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_library(src_dir, lib: pathlib.Path,
                  lock_dir=BUILD_DIR) -> pathlib.Path:
    """Compile ``src_dir/*.cpp`` onto ``lib`` unless a library that loads
    and is newer than the sources is already there, under the lock file of
    ``lock_dir``; returns ``lib``. Safe to call from any number of processes
    at once: exactly one compiles, the others wait on the lock and find the
    finished file. A file on ``lib`` that does not load (a partial write by
    a process that held no lock) is rebuilt."""
    srcs = sorted(pathlib.Path(src_dir).glob("*.cpp"))
    if not srcs:
        raise FileNotFoundError(f"no C++ sources in {src_dir}")
    lib = pathlib.Path(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(lock_dir).mkdir(parents=True, exist_ok=True)
    with open(pathlib.Path(lock_dir) / "native.lock", "a") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if not lib.exists() or lib.stat().st_mtime < max(
                    s.stat().st_mtime for s in srcs):
                build_log[str(lib)] = _compile(srcs, lib)
            try:
                ctypes.CDLL(str(lib))
            except OSError:
                build_log[str(lib)] = _compile(srcs, lib)
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return lib


def ensure_native(src_dir=SRC_DIR, lib_dir=BUILD_DIR) -> _Native:
    """The binding over ``library_path(src_dir, lib_dir)``, built first if
    it is missing; one per library and process."""
    lib = library_path(src_dir, lib_dir)
    key = str(lib.resolve())
    with _lock:
        if key not in _handles:
            _handles[key] = _Native(ctypes.CDLL(str(build_library(src_dir,
                                                                  lib))))
        return _handles[key]


def get_native() -> _Native:
    """The repo's host library, built on first use (``ensure_native``);
    raises where it cannot be built."""
    return ensure_native()
