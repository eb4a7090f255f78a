"""Race-free build of the host C++ library (sessd_torch/utils/native.py):
many processes that start together compile it once and all load it, the
final path only ever holds a whole library, and the port builds its own
file, apart from the JAX package's, so it works in a process where the
reference loader cached None."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from sessd_tpu.utils import native as ref_native
from sessd_torch.ops.voxelize import KITTI_VOXELIZER
from sessd_torch.utils import native as tn
from tests.test_torch_common import guard_reference_native
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 4

WORKER = textwrap.dedent("""
    import json, sys, numpy as np
    from sessd_torch.utils.native import build_log, ensure_native
    src, out = sys.argv[1], sys.argv[2]
    lib = ensure_native(src, out)
    pts = np.array([[1.0, 0.0, 0.0, 0.5], [1.01, 0.0, 0.0, 0.3]], np.float32)
    _, coords, num = lib.voxelize(pts, (0, -40, -3, 70.4, 40, 1),
                                  (0.05, 0.05, 0.1), 5, 10)
    print(json.dumps({"compiled": bool(build_log), "voxels": len(coords),
                      "points": int(num.sum())}))
""")


def _copy_sources(tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    for f in os.listdir(os.path.join(REPO, "native")):
        if f.endswith(".cpp"):
            shutil.copy(os.path.join(REPO, "native", f), src / f)
    return src


def test_concurrent_processes_compile_once_and_all_load(tmp_path):
    src = _copy_sources(tmp_path)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(src), str(tmp_path / "out")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(N_PROCS)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert sum(r["compiled"] for r in results) == 1, results
    assert all(r["voxels"] == 1 and r["points"] == 2 for r in results)
    out = tmp_path / "out"
    assert [f.name for f in out.iterdir() if f.suffix == ".tmp"] == []
    assert [f.name for f in out.iterdir() if f.suffix == ".so"] == [
        tn.library_path(src, out).name]


def test_final_path_appears_only_through_replace(tmp_path, monkeypatch):
    """g++ writes a temporary file beside the library; the final path does
    not exist until one os.replace puts the finished library there."""
    src = _copy_sources(tmp_path)
    lib = tn.library_path(src, tmp_path / "out")
    outputs, replaced = [], []
    real_run, real_replace = subprocess.run, os.replace

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        outputs.append(out)
        assert not lib.exists(), "final path present during the compile"
        return real_run(cmd, **kw)

    def replace(a, b):
        replaced.append((str(a), str(b)))
        return real_replace(a, b)

    monkeypatch.setattr(tn.subprocess, "run", run)
    monkeypatch.setattr(tn.os, "replace", replace)
    tn.ensure_native(src, tmp_path / "out")
    assert len(outputs) == 1 and outputs[0] != str(lib)
    assert os.path.dirname(outputs[0]) == str(lib.parent)
    assert replaced == [(outputs[0], str(lib))]
    assert lib.exists() and not os.path.exists(outputs[0])


def test_partial_library_on_final_path_is_rebuilt(tmp_path):
    """A file newer than the sources that does not load (the half-written
    output of a compile that held no lock) is compiled again, not
    trusted."""
    src = _copy_sources(tmp_path)
    lib = tn.library_path(src, tmp_path / "out")
    lib.parent.mkdir()
    lib.write_bytes(b"\x7fELF" + b"\0" * 60)  # truncated, and newer
    native = tn.ensure_native(src, tmp_path / "out")
    assert str(lib) in tn.build_log
    assert lib.stat().st_size > 10_000
    pts = np.array([[1.0, 0.0, 0.0, 0.5]], np.float32)
    _, coords, _ = native.voxelize(pts,
                                   (0, -40, -3, 70.4, 40, 1),
                                   (0.05, 0.05, 0.1), 5, 10)
    assert len(coords) == 1


def test_port_preprocessor_after_reference_cached_none(monkeypatch):
    """The reference constructor refuses once get_native() has cached None;
    the port's preprocessor takes its own library (another file than the
    reference's) and preps a scene, and the tests' collection guard hands
    the reference loader its whole library back."""
    from sessd_tpu.serve import HostPreprocessor as RefPreprocessor
    from sessd_torch.serve import (SERVING_CAPS, HostPreprocessor,
                                   make_scene)

    monkeypatch.setattr(ref_native, "_native", None)
    monkeypatch.setattr(ref_native, "_tried", True)
    with pytest.raises(RuntimeError, match="native toolchain unavailable"):
        RefPreprocessor(KITTI_VOXELIZER, SERVING_CAPS)
    prep = HostPreprocessor(KITTI_VOXELIZER, SERVING_CAPS)
    out = prep(make_scene(seed=0)[0])
    rb = out["rulebooks"]
    assert out["feats"].shape == (SERVING_CAPS[0], 4)
    assert [a.shape[0] for a in rb["subm"]] == list(SERVING_CAPS[:4])
    assert rb["subm"][0].dtype == np.int16

    assert prep.native is tn.get_native()
    assert tn.library_path() != ref_native._LIB_PATH
    assert tn.library_path().parent == tn.BUILD_DIR
    guard_reference_native()
    assert ref_native.get_native() is not None
    assert ref_native.get_native() is not prep.native
