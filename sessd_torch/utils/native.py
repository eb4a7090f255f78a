"""Race-free build and load of the host C++ library (``native/*.cpp``).

``sessd_tpu.utils.native.get_native`` compiles ``native/libsessd_native.so``
with g++ straight onto its final path, guarded only by a lock inside one
process. Several processes that start together (test workers, loader
processes, a fresh checkout on a new machine) can then load a half-written
file; ``get_native`` caches ``None`` for the rest of that process and every
host-native caller fails.

``ensure_native`` builds the same library from the same sources with the
same g++ command, but under an ``fcntl.flock`` shared by all processes,
into a temporary file beside the sources that ``os.replace`` puts on the
final path in one step, so no process can observe a partial library. It
returns the reference package's own ``_Native`` wrapper over it, never
``None``: a failed compile raises with the compiler's log.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
import tempfile
import threading

from sessd_tpu.utils import native as _ref

REPO = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = REPO / "native"
LIB_NAME = "libsessd_native.so"
LOCK_DIR = REPO / "build" / "sessd_torch"
# sessd_tpu/utils/native.py:33-34, the output path aside
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_handles: dict = {}
build_log: dict = {}  # lib path -> compiler output of this process's builds


def _stale(lib: pathlib.Path, srcs) -> bool:
    if not lib.exists():
        return True
    return lib.stat().st_mtime < max(s.stat().st_mtime for s in srcs)


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


def ensure_native(src_dir=SRC_DIR, lib_path=None, lock_dir=LOCK_DIR):
    """Build ``lib_path`` (default ``src_dir/libsessd_native.so``) if it is
    missing or older than ``src_dir/*.cpp``, and load it.

    Returns ``sessd_tpu.utils.native._Native`` over the library. Safe to
    call from any number of processes and threads at once: exactly one
    compiles, the others wait on the lock and load the finished file. A
    library on the final path that does not load (written in place by
    another builder that held no lock) is rebuilt.
    """
    src_dir = pathlib.Path(src_dir)
    lib = pathlib.Path(lib_path) if lib_path else src_dir / LIB_NAME
    key = str(lib.resolve())
    with _lock:
        native = _handles.get(key) or _load(src_dir, lib,
                                            pathlib.Path(lock_dir))
        _handles[key] = native
    if key == str(_ref._LIB_PATH.resolve()):
        # the reference loader may have cached None after meeting a
        # half-written file; hand its callers in this process the library
        # that is now whole
        with _ref._lock:
            if _ref._native is None:
                _ref._native, _ref._tried = native, True
    return native


def _load(src_dir: pathlib.Path, lib: pathlib.Path, lock_dir: pathlib.Path):
    srcs = sorted(src_dir.glob("*.cpp"))
    if not srcs:
        raise FileNotFoundError(f"no C++ sources in {src_dir}")
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / "native.lock", "a") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if _stale(lib, srcs):
                build_log[str(lib)] = _compile(srcs, lib)
            try:
                handle = ctypes.CDLL(str(lib))
            except OSError:
                build_log[str(lib)] = _compile(srcs, lib)
                handle = ctypes.CDLL(str(lib))
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return _ref._Native(handle)
