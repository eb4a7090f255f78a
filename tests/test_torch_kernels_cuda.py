"""The CUDA kernels of sessd_torch against their plain PyTorch twins, on the
card. Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device the ``cuda`` tests skip. Tolerances, relative to the
twin's largest output: 1e-4 in f32 (TF32 off in the twin's matmul; sums in
another order) and 2e-2 in bf16 (both accumulate in f32; outputs round to
bf16). Random rulebooks with no locality, ragged row counts and all-miss
rows exercise what the serving chain may not.
"""
import numpy as np
import pytest
import torch

from sessd_torch.ops.cuda import sparse_conv as sc

# (Cin, Cout, K) of the backbone plan
PLAN = [(4, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27),
        (64, 64, 27), (64, 64, 3)]
N_IN, N_OUT = 3000, 2500  # 2500 = 39 tiles of 64 rows + 4


def _inputs(cin, cout, k, seed=0):
    rng = np.random.RandomState(seed)
    rb = rng.randint(0, N_IN, (N_OUT, k))
    rb[rng.rand(N_OUT, k) < 0.4] = N_IN           # misses
    rb[rng.choice(N_OUT, 50, replace=False)] = N_IN  # all-miss rows
    feats = rng.randn(N_IN, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.randn(cout) * 0.3).astype(np.float32)
    return feats, rb, w2, bias


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("cin,cout,k", PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in PLAN])
def test_kernel_matches_twin(cuda, cin, cout, k, relu, idx_dtype, dtype,
                             tol):
    feats, rb, w2, bias = _inputs(cin, cout, k)
    args = (torch.from_numpy(feats).to(cuda, dtype),
            torch.from_numpy(rb).to(cuda, idx_dtype),
            torch.from_numpy(w2).to(cuda, dtype),
            torch.from_numpy(bias).to(cuda), N_IN)
    before = sc.fused_sparse_conv.launches
    got = sc.fused_sparse_conv(*args, relu=relu)
    torch.cuda.synchronize()
    assert sc.fused_sparse_conv.launches == before + 1
    assert got.dtype == dtype and got.shape == (N_OUT, cout)
    want = sc.fused_sparse_conv_ref(*args, relu=relu)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= tol
    miss = torch.from_numpy((rb == N_IN).all(1)).to(cuda)
    assert not got[miss].any()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    feats, rb, w2, bias = _inputs(16, 32, 27)
    f = torch.from_numpy(feats).to(cuda)
    r = torch.from_numpy(rb).to(cuda, torch.int32)
    w = torch.from_numpy(w2).to(cuda)
    b = torch.from_numpy(bias).to(cuda)
    with pytest.raises(ValueError):      # non-contiguous features
        sc.fused_sparse_conv(f.t().contiguous().t(), r, w, b, N_IN)
    with pytest.raises(ValueError):      # int64 rulebook
        sc.fused_sparse_conv(f, r.long(), w, b, N_IN)
    with pytest.raises(ValueError):      # weights in another dtype
        sc.fused_sparse_conv(f, r, w.bfloat16(), b, N_IN)
    before = sc.fused_sparse_conv.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        # no kernel instance for these channels
        sc.fused_sparse_conv(f[:, :8].contiguous(), r, w[:, :8].contiguous(),
                             b, N_IN)
    assert sc.fused_sparse_conv.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    """Only CPU tensors take the twin; any other device raises."""
    feats, rb, w2, bias = (torch.from_numpy(a).to("meta")
                           for a in _inputs(16, 32, 27))
    before = sc.fused_sparse_conv.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        sc.fused_sparse_conv(feats, rb, w2, bias, N_IN)
    assert sc.fused_sparse_conv.launches == before
