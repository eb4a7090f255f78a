"""The port runs where JAX is absent: importing every sessd_torch module
(serving, training, tools) pulls in neither jax nor flax, and neither
importing nor running the CPU path, the trainable sparse conv's backward
included, tries to build the CUDA kernels (there is no nvcc on a CPU
machine).
``chip_smoke.py`` reaches the port alone: it names no module of the JAX
package, and without a CUDA device it exits non-zero with no result."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

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

    bad = [m for m in ("jax", "flax", "jaxlib") if m in sys.modules]
    assert not bad, bad
    print("ok")
""")


SMOKE_PROBE = textwrap.dedent("""
    import chip_smoke
    bad = [m for m in ("jax", "flax", "jaxlib") if m in sys.modules]
    assert not bad, bad
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
