"""The CUDA kernels of sessd_torch against their plain PyTorch twins, on the
card: the serving convs (K1, and K3, the streaming one, also against K1:
bit for bit in f32, within 2e-2 in bf16, where it runs the tensor-core
tile), the training conv's forward (K4), input gradient and weight
gradient (K5), the tensor-core tile of bf16 K4 and K3 on tiles that skip
taps, and the micro-benchmark kernels (S1: the ablated conv tile, whose
``full`` mode equals K1 with zero bias and no ReLU bit for bit; S2: the
empty launch). Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device the ``cuda`` tests skip. Tolerances, relative to the
twin's largest output: 1e-4 in f32 (TF32 off in the twin's matmul; sums in
another order), 1e-3 for the weight gradient (a reduction over all rows),
and 2e-2 in bf16 (both accumulate in f32; outputs round to bf16). Random
rulebooks with no locality, ragged row counts and all-miss rows exercise
what the host chains may not.
"""
import numpy as np
import pytest
import torch

from sessd_torch.ops import sparse as sp
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt

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


STREAM_PLAN = [p for p in PLAN if p[0] != 4]  # Cin = 4 never streams


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", STREAM_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in STREAM_PLAN])
def test_stream_kernel_matches_twin_and_k1(cuda, cin, cout, k, idx_dtype,
                                           dtype, tol):
    """K3 within the bound of the twin. In f32 it equals K1 bit for bit (the
    two sum every output in the same order); in bf16 it runs the
    tensor-core tile, which sums in another order, and stays within the
    bf16 bound of K1."""
    feats, rb, w2, bias = _inputs(cin, cout, k)
    args = (torch.from_numpy(feats).to(cuda, dtype),
            torch.from_numpy(rb).to(cuda, idx_dtype),
            torch.from_numpy(w2).to(cuda, dtype),
            torch.from_numpy(bias).to(cuda), N_IN)
    before = sc.fused_sparse_conv_stream.launches
    got = sc.fused_sparse_conv_stream(*args)
    torch.cuda.synchronize()
    assert sc.fused_sparse_conv_stream.launches == before + 1
    assert got.dtype == dtype and got.shape == (N_OUT, cout)
    want = sc.fused_sparse_conv_ref(*args)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= tol
    k1 = sc.fused_sparse_conv(*args)
    if dtype == torch.float32:
        assert torch.equal(got, k1)
    else:
        assert _err(got, k1) <= tol
    miss = torch.from_numpy((rb == N_IN).all(1)).to(cuda)
    assert not got[miss].any()


def _tile_inputs(cin, cout, k, seed=0):
    """Rows in tiles of 64 with a ragged last tile (N_OUT = 39 * 64 + 4),
    tile 1 all miss, tile 2 hit by one tap in one row, tile 3 by every tap
    in one row, the rest at a 40% hit rate; injective taps are not needed
    by the forward."""
    rng = np.random.RandomState(seed)
    rb = rng.randint(0, N_IN, (N_OUT, k))
    rb[rng.rand(N_OUT, k) < 0.6] = N_IN
    rb[64:256] = N_IN
    rb[128 + 17, k // 2] = 11
    rb[192 + 63, :] = rng.randint(0, N_IN, k)
    feats = rng.randn(N_IN, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.randn(cout) * 0.3).astype(np.float32)
    mask = rng.rand(N_OUT) > 0.1
    return feats, rb, w2, bias, mask


MMA_PLAN = [p for p in PLAN if p[0] != 4]  # bf16 Cin in {16, 32, 64}


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_mma_tile_k4_and_k3_match_twins(cuda, cin, cout, k, idx_dtype):
    """bf16 K4 and K3 (the tensor-core tile) within 2e-2 of their twins on
    tiles that skip every tap, all but one, or none; K4 zeroes masked rows,
    K3 rows with no hit, and the rows of the all-miss tile come out 0."""
    feats, rb, w2, bias, mask = _tile_inputs(cin, cout, k)
    assert sc.conv_instance("sparse_conv_fwd", torch.bfloat16, cin,
                            cout) == "mma"
    f = torch.from_numpy(feats).to(cuda, torch.bfloat16)
    r = torch.from_numpy(rb).to(cuda, idx_dtype)
    w = torch.from_numpy(w2).to(cuda, torch.bfloat16)
    b = torch.from_numpy(bias).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    y4 = kt.sparse_conv_fwd(f, r, w, m)
    y3 = sc.fused_sparse_conv_stream(f, r, w, b, N_IN)
    torch.cuda.synchronize()
    want4 = kt.sparse_conv_fwd_ref(f, r, w, m)
    want3 = sc.fused_sparse_conv_ref(f, r, w, b, N_IN)
    assert _err(y4, want4) <= 2e-2 and _err(y3, want3) <= 2e-2
    assert not y4[~m].any() and not y4[64:128].any()
    assert not y3[torch.from_numpy((rb == N_IN).all(1)).to(cuda)].any()
    # the lone hits: one tap of one row, every tap of one row
    for row in (128 + 17, 192 + 63):
        assert _err(y3[row:row + 1], want3[row:row + 1]) <= 2e-2
        if mask[row]:
            assert _err(y4[row:row + 1], want4[row:row + 1]) <= 2e-2


@pytest.mark.cuda
def test_conv_instance_equals_the_c_entries(cuda):
    """The Python rule names the body each C entry launches."""
    lib = sc.build()
    entries = {"sparse_conv_fwd": lib.sessd_sparse_conv_fwd_instance,
               "fused_sparse_conv_stream":
                   lib.sessd_fused_sparse_conv_stream_instance}
    pairs = {"sparse_conv_fwd": sc.FWD_PAIRS,
             "fused_sparse_conv_stream": sc.STREAM_PAIRS}
    for entry, fn in entries.items():
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for cin in (4, 8, 16, 32, 64):
                for cout in (16, 32, 64):
                    got = fn(cin, cout, code)
                    if (cin, cout) in pairs[entry]:
                        want = sc.conv_instance(entry, dtype, cin, cout)
                        assert got == {"mma": 2, "scalar": 1}[want]
                    else:
                        assert got == 0


@pytest.mark.cuda
def test_mma_forward_rejects_misaligned_inputs(cuda):
    f = torch.zeros(N_IN * 16 + 4, dtype=torch.bfloat16,
                    device=cuda)[4:].view(N_IN, 16)  # 8 bytes off
    r = torch.full((N_OUT, 27), N_IN, dtype=torch.int32, device=cuda)
    w = torch.zeros(27, 16, 16, dtype=torch.bfloat16, device=cuda)
    before = kt.sparse_conv_fwd.launches
    with pytest.raises(ValueError, match="aligned"):
        kt.sparse_conv_fwd(f, r, w)
    assert kt.sparse_conv_fwd.launches == before


@pytest.mark.cuda
def test_stream_kernel_rejects_what_it_does_not_take(cuda):
    feats, rb, w2, bias = (torch.from_numpy(a).to(cuda)
                           for a in _inputs(4, 16, 27))
    before = sc.fused_sparse_conv_stream.launches
    with pytest.raises(ValueError, match="16, 32 or 64"):
        sc.fused_sparse_conv_stream(feats, rb.int(), w2, bias, N_IN)
    f, r, w, b = (torch.from_numpy(a).to(cuda) for a in _inputs(16, 32, 27))
    with pytest.raises(ValueError, match="aligned"):
        sc.fused_sparse_conv_stream(f.view(-1)[1:1 + (N_IN - 1) * 16].view(
            N_IN - 1, 16), r.int(), w, b, N_IN - 1)
    assert sc.fused_sparse_conv_stream.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    """Only CPU tensors take the twin; any other device raises."""
    feats, rb, w2, bias = (torch.from_numpy(a).to("meta")
                           for a in _inputs(16, 32, 27))
    for fn in (sc.fused_sparse_conv, sc.fused_sparse_conv_stream):
        before = fn.launches
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(feats, rb, w2, bias, N_IN)
        assert fn.launches == before


TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def _train_inputs(cin, cout, k, seed=0):
    """Injective taps (each tap maps distinct outputs to distinct inputs,
    as a conv's rulebook does), misses, and a random output mask."""
    rng = np.random.RandomState(seed)
    rb = np.full((N_OUT, k), N_IN)
    for t in range(k):
        rows = rng.choice(N_OUT, int(N_OUT * 0.6), replace=False)
        rb[rows, t] = rng.choice(N_IN, len(rows), replace=False)
    feats = rng.randn(N_IN, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    dout = rng.randn(N_OUT, cout).astype(np.float32)
    mask = rng.rand(N_OUT) > 0.1
    return feats, rb, w2, dout, mask


def _err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _on(cuda, dtype, idx_dtype, feats, rb, w2, dout, mask):
    dev = lambda a, t: torch.from_numpy(a).to(cuda, t)  # noqa: E731
    return (dev(feats, dtype), dev(rb, idx_dtype), dev(w2, dtype),
            dev(dout, dtype), torch.from_numpy(mask).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in PLAN])
def test_train_fwd_kernel_matches_twin(cuda, cin, cout, k, idx_dtype, dtype,
                                       tol):
    f, rb, w, _, m = _on(cuda, dtype, idx_dtype,
                         *_train_inputs(cin, cout, k))
    before = kt.sparse_conv_fwd.launches
    got = kt.sparse_conv_fwd(f, rb, w, m)
    torch.cuda.synchronize()
    assert kt.sparse_conv_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == (N_OUT, cout)
    assert _err(got, kt.sparse_conv_fwd_ref(f, rb, w, m)) <= tol
    assert not got[~m].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", PLAN[1:],
                         ids=[f"{a}x{b}x{c}" for a, b, c in PLAN[1:]])
def test_train_dfeat_kernel_matches_twin(cuda, cin, cout, k, idx_dtype,
                                         dtype, tol):
    f, rb, w, d, _ = _on(cuda, dtype, idx_dtype,
                         *_train_inputs(cin, cout, k))
    inv = sp.inverse_rulebook(rb, N_IN)
    before = kt.sparse_conv_dfeat.launches
    got = kt.sparse_conv_dfeat(d, inv, w)
    torch.cuda.synchronize()
    assert kt.sparse_conv_dfeat.launches == before + 1
    assert got.dtype == dtype and got.shape == (N_IN, cin)
    assert _err(got, kt.sparse_conv_dfeat_ref(d, inv, w)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in PLAN])
def test_train_dw_kernel_matches_twin(cuda, cin, cout, k, idx_dtype, dtype,
                                      tol):
    f, rb, w, d, _ = _on(cuda, dtype, idx_dtype,
                         *_train_inputs(cin, cout, k))
    before = kt.sparse_conv_dw.launches
    got = kt.sparse_conv_dw(f, rb, d)
    again = kt.sparse_conv_dw(f, rb, d)
    torch.cuda.synchronize()
    assert kt.sparse_conv_dw.launches == before + 2
    assert got.dtype == dtype and got.shape == (k, cin, cout)
    assert _err(got, kt.sparse_conv_dw_ref(f, rb, d)) <= tol
    assert torch.equal(got, again)  # no atomics: the same bits every run


@pytest.mark.cuda
def test_sparse_conv_function_on_card_matches_cpu(cuda):
    """Forward and both gradients of SparseConvFunction through the kernels
    against the same function on CPU tensors (the twins), f32."""
    feats, rb, w2, dout, mask = _train_inputs(32, 64, 27, seed=1)
    outs = []
    for dev in ("cpu", cuda):
        x = torch.from_numpy(feats).to(dev).requires_grad_(True)
        w = torch.from_numpy(w2).to(dev).requires_grad_(True)
        r = torch.from_numpy(rb).to(dev, torch.int32)
        m = torch.from_numpy(mask).to(dev)
        y = sp.SparseConvFunction.apply(x, w, r, m,
                                        sp.inverse_rulebook(r, N_IN))
        (y * torch.from_numpy(dout).to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, x.grad, w.grad)])
    for got, want, tol in zip(outs[1], outs[0], (1e-4, 1e-4, 1e-3)):
        assert _err(got, want) <= tol


@pytest.mark.cuda
def test_kernels_profile_under_their_own_names(cuda):
    """Each wrapper's launch shows in a device profile under a kernel name
    of its own, the names the step and request profilers
    (``sessd_torch/scripts/profile_*.py``) sum by."""
    feats, rb, w2, bias = (torch.from_numpy(a).to(cuda)
                           for a in _inputs(16, 32, 27))
    f, r, w, d, m = _on(cuda, torch.float32, torch.int32,
                        *_train_inputs(16, 32, 27))
    inv = sp.inverse_rulebook(r, N_IN)
    calls = {"fused_sparse_conv_kernel": lambda: sc.fused_sparse_conv(
                 feats, rb.int(), w2, bias, N_IN),
             "fused_sparse_conv_stream_kernel":
                 lambda: sc.fused_sparse_conv_stream(feats, rb.int(), w2,
                                                     bias, N_IN),
             "sparse_conv_fwd_kernel": lambda: kt.sparse_conv_fwd(f, r, w, m),
             "sparse_conv_dfeat_kernel": lambda: kt.sparse_conv_dfeat(
                 d, inv, w),
             "sparse_conv_dw_partial_kernel": lambda: kt.sparse_conv_dw(
                 f, r, d)}
    for name, call in calls.items():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = {e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "sparse_conv" in e.name}
        assert any(name in k for k in kernels), (name, kernels)
        assert all(name in k or "sparse_conv_dw_reduce_kernel" in k
                   for k in kernels), (name, kernels)


def test_train_wrappers_raise_off_cpu_and_cuda():
    feats, rb, w2, dout, mask = (torch.from_numpy(a).to("meta") for a in
                                 _train_inputs(16, 32, 27))
    for fn, args in ((kt.sparse_conv_fwd, (feats, rb, w2)),
                     (kt.sparse_conv_dfeat, (dout, rb, w2)),
                     (kt.sparse_conv_dw, (feats, rb, dout))):
        before = fn.launches
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(*args)
        assert fn.launches == before


def _ablate_inputs(cuda):
    """The ablation's shape and seed (``bench_sparse_conv_ablate``)."""
    from sessd_torch.scripts import bench_sparse_conv_ablate as bench
    return bench, bench.make_inputs(cuda)


@pytest.mark.cuda
def test_ablate_full_equals_k1_without_bias_or_relu(cuda):
    """S1's ``full`` mode is a copy of the scalar tile: the same bits as K1
    with zero bias and no ReLU on the same inputs (both store acc + 0, and
    a row with no hit sums to 0)."""
    from sessd_torch.ops.cuda import ablate
    _, x = _ablate_inputs(cuda)
    before = ablate.sparse_conv_ablate.launches
    got = ablate.sparse_conv_ablate(x["feats"], x["rb"], x["w2"], "full")
    zero = torch.zeros(16, dtype=torch.float32, device=cuda)
    want = sc.fused_sparse_conv(x["feats"], x["rb"], x["w2"], zero,
                                x["feats"].shape[0], relu=False)
    torch.cuda.synchronize()
    assert ablate.sparse_conv_ablate.launches == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "k9", "linear", "no_gather",
                                     "fma_only"])
def test_ablate_mode_matches_plain(cuda, variant):
    """Each S1 mode against its plain version, within 2e-2 of max|plain|
    (bf16 inputs and output, f32 sums)."""
    from sessd_torch.ops.cuda import ablate
    bench, x = _ablate_inputs(cuda)
    feats, rb, w2, mode = bench.variant_args(x, variant)
    got = ablate.sparse_conv_ablate(feats, rb, w2, mode)
    torch.cuda.synchronize()
    assert got.shape == (bench.NPAD, 16) and got.dtype == torch.bfloat16
    assert _err(got, ablate.sparse_conv_ablate_ref(feats, rb, w2,
                                                   mode)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", [256, 512, 1024])
def test_empty_launch_writes_zeros(cuda, block_rows):
    from sessd_torch.ops.cuda import ablate
    out = torch.ones((20224, 16), dtype=torch.bfloat16, device=cuda)
    before = ablate.empty_launch.launches
    assert ablate.empty_launch(out, block_rows) is out
    torch.cuda.synchronize()
    assert not out.any()
    out.fill_(1)
    ablate.empty_launch_repeat(out, block_rows, 3)
    torch.cuda.synchronize()
    assert not out.any()
    assert ablate.empty_launch.launches == before + 4


@pytest.mark.cuda
def test_ablate_rejects_what_it_does_not_take(cuda):
    from sessd_torch.ops.cuda import ablate
    _, x = _ablate_inputs(cuda)
    before = ablate.sparse_conv_ablate.launches
    with pytest.raises(ValueError):      # f32 features
        ablate.sparse_conv_ablate(x["feats"].float(), x["rb"], x["w2"])
    with pytest.raises(ValueError):      # no such mode
        ablate.sparse_conv_ablate(x["feats"], x["rb"], x["w2"], "k9")
    with pytest.raises(ValueError):      # not 16-byte aligned
        ablate.empty_launch(torch.zeros(13 * 16, dtype=torch.bfloat16,
                                        device=cuda)[1:1 + 12 * 16].view(
                                            12, 16), 4)
    assert ablate.sparse_conv_ablate.launches == before


def test_ablate_wrappers_raise_off_cpu_and_cuda():
    from sessd_torch.ops.cuda import ablate
    feats = torch.zeros((8, 16), dtype=torch.bfloat16, device="meta")
    rb = torch.zeros((8, 27), dtype=torch.int32, device="meta")
    w2 = torch.zeros((27, 16, 16), dtype=torch.bfloat16, device="meta")
    before = (ablate.sparse_conv_ablate.launches,
              ablate.empty_launch.launches)
    with pytest.raises(ValueError, match="no kernel for device"):
        ablate.sparse_conv_ablate(feats, rb, w2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ablate.empty_launch(feats)
    assert (ablate.sparse_conv_ablate.launches,
            ablate.empty_launch.launches) == before
