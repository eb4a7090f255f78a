"""The port runs where JAX is absent and stands apart from the JAX package:
importing every sessd_torch module (serving, training, evaluation, tools)
loads no module of jax, flax or ``sessd_tpu`` (not even one that imports no
JAX: the port keeps its own copy of the host layer), no file of the port
names ``sessd_tpu`` in an import, its configs are its own, and neither
importing nor running the CPU path, the trainable sparse conv's backward
included, tries to build the CUDA kernels (there is no nvcc on a CPU
machine).
``chip_smoke.py`` reaches the port alone: it names no module of the JAX
package, and without a CUDA device it exits non-zero with no result."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import sessd_torch, sessd_torch.serve, sessd_torch.builder
    for m in pkgutil.walk_packages(sessd_torch.__path__, "sessd_torch."):
        importlib.import_module(m.name)
    from sessd_torch.ops.cuda import sparse_conv as sc
    assert sc._library is None and not sc.build_info, "built at import"

    import torch
    feats = torch.randn(6, 4)
    rb = torch.tensor([[0, 6, 6], [6, 6, 6]], dtype=torch.int16)
    w2 = torch.randn(3, 4, 16)
    out = sc.fused_sparse_conv(feats, rb, w2, torch.zeros(16), 6)
    assert out.shape == (2, 16) and not out[1].any()
    assert sc._library is None and sc.fused_sparse_conv.launches == 0
    x16 = torch.randn(6, 16)
    out = sc.fused_sparse_conv_stream(x16, rb, torch.randn(3, 16, 16),
                                      torch.zeros(16), 6)
    assert out.shape == (2, 16) and sc.fused_sparse_conv_stream.launches == 0
    from sessd_torch.ops import sparse as sp
    from sessd_torch.ops.cuda import sparse_conv_train as kt
    x = feats.requires_grad_(True)
    w = torch.randn(3, 4, 16, requires_grad=True)
    rb32 = rb.int()
    sp.SparseConvFunction.apply(x, w, rb32, torch.ones(2, dtype=torch.bool),
                                None).sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert sc._library is None
    assert (kt.sparse_conv_fwd.launches, kt.sparse_conv_dfeat.launches,
            kt.sparse_conv_dw.launches) == (0, 0, 0)

    def foreign():
        return sorted(m for m in sys.modules if m.split(".")[0] in
                      ("jax", "flax", "jaxlib", "sessd_tpu"))

    assert not foreign(), foreign()
    print("ok")
""")


SMOKE_PROBE = textwrap.dedent("""
    import chip_smoke
    assert not foreign(), foreign()
    print("imported chip_smoke")
    chip_smoke.main()
""")


@pytest.fixture(scope="module")
def probe():
    """One interpreter, no CUDA device visible: the package probe, then
    chip_smoke's imports and its run (which must stop)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", PROBE + SMOKE_PROBE],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)


def test_port_imports_no_jax_and_builds_nothing(probe):
    assert probe.stdout.splitlines()[:1] == ["ok"], probe.stderr


def test_chip_smoke_imports_only_the_port(probe):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert "sessd_torch" in roots
    assert not roots & {"sessd_tpu", "jax", "flax", "jaxlib"}, roots

    assert probe.stdout.splitlines() == ["ok", "imported chip_smoke"], \
        probe.stderr
    assert probe.returncode != 0 and "no CUDA device" in probe.stderr


def _import_roots(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    return roots | {n.module.split(".")[0] for n in ast.walk(tree)
                    if isinstance(n, ast.ImportFrom) and n.level == 0}


def test_no_file_of_the_port_imports_sessd_tpu():
    files = sorted(pathlib.Path(REPO, "sessd_torch").rglob("*.py"))
    assert len(files) > 40
    bad = {str(f): r for f in files + [pathlib.Path(REPO, "chip_smoke.py")]
           if (r := _import_roots(f) & {"sessd_tpu", "jax", "flax"})}
    assert not bad, bad


def test_config_dir_is_the_ports():
    from sessd_torch import builder

    pkg = pathlib.Path(REPO, "sessd_torch").resolve()
    assert builder.CONFIG_DIR.resolve().is_relative_to(pkg)
    assert (builder.CONFIG_DIR / "se_ssd_kitti_car.py").exists()
