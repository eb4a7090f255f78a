"""The CUDA kernels of sessd_torch against their plain PyTorch twins, on the
card: the serving convs (K1, and K3, the streaming one, also against K1:
in bf16 bit for bit where K1 runs one CTA per tile; in f32, where both run
3xTF32 at one CTA per tile, bit for bit, and both bit for bit equal to the
f32 forward with bias, ReLU and the any-hit mask), the training conv's
forward (K4), input gradient and weight gradient (K5), the tensor-core
tile of bf16 K1, K3, K4 and dFeat (K-major B, one launch per call) on
tiles that skip taps, the same tile through 3xTF32 in f32 K1, K3, K4 and
dFeat (against the twins and the plain model of its
arithmetic, ``kt.gather_gemm_tf32``, on every pair of those entries), K1's
tap split over a cluster against one CTA per tile and against itself, dW's
tensor-core partial kernel (bf16, and f32 through 3xTF32 against its model
``kt.dw_tf32``) on chunks and steps that skip, the direct bodies of the
first conv's 4-channel side (K1, K4, dFeat 16 -> 4 and dW, both types,
against the twins and the same bits on two runs, on ragged row counts),
and the micro-benchmark kernels (S1: the ablated scalar tile, whose
``full`` mode equals its in-order f32 sum bit for bit, and
the ablated tensor-core tile, whose ``full`` mode equals bf16 K4 bit for
bit; S2: the empty launch). Imports no JAX, so it runs on a GPU machine
without it:

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
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

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
    """K3 within the bound of the twin and of K1. In f32 K3 and K1 run the
    3xTF32 tile at one CTA per tile, so they agree bit for bit, and both
    equal the f32 forward (the same tile, taps and order, without the
    epilogue) with bias, ReLU and the any-hit mask added; in bf16 both run
    the tensor-core tile, and K1 splits these 40 tiles' taps over clusters
    (at one CTA per tile they agree bit for bit:
    test_bf16_k1_at_one_cta_per_tile_equals_k3)."""
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
    assert _err(got, k1) <= tol
    miss = torch.from_numpy((rb == N_IN).all(1)).to(cuda)
    assert not got[miss].any()
    if dtype == torch.float32:
        f, r, w, b, _ = args
        for relu in (True, False):
            y = sc.fused_sparse_conv_stream(*args, relu=relu)
            assert torch.equal(y, _tf32_with_epilogue(f, r, w, b, relu))
            assert torch.equal(y, sc.fused_sparse_conv(*args, relu=relu))


def _tf32_with_epilogue(f, r, w, b, relu=True):
    """The f32 forward (the 3xTF32 tile) with K3's epilogue added in torch:
    bias, ReLU, and zero where no tap of the row hits."""
    y = kt.sparse_conv_fwd(f, r, w) + b
    if relu:
        y = torch.relu(y)
    return torch.where((r != N_IN).any(1, keepdim=True), y, 0.0)


# f32 1e-4 (TF32 off in the twins' matmuls; the 3xTF32 tile keeps ~21
# mantissa bits of each product), bf16 2e-2
TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
# the f32 tile against the plain model of its arithmetic (the same split,
# the same three products per k8 step in the same order, per-tap partials):
# only the order of the f32 additions inside one wgmma differs
TF32_MODEL_BOUND = 1e-5


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


MMA_PLAN = [p for p in PLAN if p[0] != 4]  # Cin in {16, 32, 64}
# the body K1, K3, K4 and dFeat take on MMA_PLAN: the tensor-core tile in
# bf16, the tile through 3xTF32 in f32
K4_BODY = DFEAT_BODY = {torch.bfloat16: "mma", torch.float32: "tf32"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_mma_tile_k4_and_k3_match_twins(cuda, cin, cout, k, idx_dtype,
                                        dtype, tol):
    """K4 and K3 (the tensor-core tile in bf16, through 3xTF32 in f32)
    within the type's bound of their twins on tiles that skip every tap,
    all but one, or none; K4 zeroes masked rows, K3 rows with no hit, and
    the rows of the all-miss tile come out 0; in f32 both within 1e-5 of
    the model of their arithmetic (``kt.gather_gemm_tf32``, K3's with the
    epilogue, K4's masked)."""
    feats, rb, w2, bias, mask = _tile_inputs(cin, cout, k)
    assert sc.conv_instance("sparse_conv_fwd", dtype, cin,
                            cout) == K4_BODY[dtype]
    f = torch.from_numpy(feats).to(cuda, dtype)
    r = torch.from_numpy(rb).to(cuda, idx_dtype)
    w = torch.from_numpy(w2).to(cuda, dtype)
    b = torch.from_numpy(bias).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    y4 = kt.sparse_conv_fwd(f, r, w, m)
    y3 = sc.fused_sparse_conv_stream(f, r, w, b, N_IN)
    torch.cuda.synchronize()
    want4 = kt.sparse_conv_fwd_ref(f, r, w, m)
    want3 = sc.fused_sparse_conv_ref(f, r, w, b, N_IN)
    assert _err(y4, want4) <= tol and _err(y3, want3) <= tol
    assert not y4[~m].any() and not y4[64:128].any()
    assert not y3[torch.from_numpy((rb == N_IN).all(1)).to(cuda)].any()
    # the lone hits: one tap of one row, every tap of one row
    for row in (128 + 17, 192 + 63):
        assert _err(y3[row:row + 1], want3[row:row + 1]) <= tol
        if mask[row]:
            assert _err(y4[row:row + 1], want4[row:row + 1]) <= tol
    if dtype == torch.float32:
        hit = (r != N_IN).any(1, keepdim=True)
        model = kt.gather_gemm_tf32(f, r, w)
        assert _err(y3, torch.where(hit, torch.relu(model + b), 0.0)) \
            <= TF32_MODEL_BOUND
        assert _err(y4, torch.where(m[:, None], model, 0.0)) \
            <= TF32_MODEL_BOUND


@pytest.mark.cuda
def test_conv_instance_equals_the_c_entries(cuda):
    """The Python rule names the body each C entry launches."""
    lib = sc.build()
    entries = {"sparse_conv_fwd": lib.sessd_sparse_conv_fwd_instance,
               "fused_sparse_conv_stream":
                   lib.sessd_fused_sparse_conv_stream_instance,
               "fused_sparse_conv": lib.sessd_fused_sparse_conv_instance,
               "sparse_conv_dfeat": lib.sessd_sparse_conv_dfeat_instance,
               "sparse_conv_dw": lib.sessd_sparse_conv_dw_instance}
    pairs = {"sparse_conv_fwd": sc.FWD_PAIRS,
             "fused_sparse_conv_stream": sc.STREAM_PAIRS,
             "fused_sparse_conv": sc.FUSED_PAIRS,
             "sparse_conv_dfeat": sc.DFEAT_PAIRS,
             "sparse_conv_dw": sc.DW_PAIRS}
    for entry, fn in entries.items():
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for cin in (4, 8, 16, 32, 64):
                for cout in (4, 16, 32, 64):
                    got = fn(cin, cout, code)
                    if (cin, cout) in pairs[entry]:
                        want = sc.conv_instance(entry, dtype, cin, cout)
                        assert got == sc.INSTANCE_CODES[want]
                        # the 4-channel side of the first conv: the direct
                        # body in both types, in every entry that has it
                        assert (want == "direct") == (4 in (cin, cout))
                    else:
                        assert got == 0
    # the 128-channel pairs: bf16 K1 and K3 alone
    for entry, fn in entries.items():
        for cin, cout in sc.WIDE_PAIRS + ((128, 64), (32, 128)):
            wide = (cin, cout) in sc.WIDE_PAIRS and entry in sc.WIDE_ENTRIES
            assert fn(cin, cout, 1) == (sc.INSTANCE_CODES["mma"] if wide
                                        else 0)
            assert fn(cin, cout, 0) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mma_forward_rejects_misaligned_inputs(cuda, dtype):
    """The tensor-core forward (bf16 K4, and f32 K4 through 3xTF32) copies
    16-byte chunks: a misaligned call raises, it does not fall back to
    another body."""
    f = torch.zeros(N_IN * 16 + 2, dtype=dtype,
                    device=cuda)[2:].view(N_IN, 16)  # 4 or 8 bytes off
    r = torch.full((N_OUT, 27), N_IN, dtype=torch.int32, device=cuda)
    w = torch.zeros(27, 16, 16, dtype=dtype, device=cuda)
    w_off = torch.zeros(27 * 256 + 2, dtype=dtype,
                        device=cuda)[2:].view(27, 16, 16)
    fn = kt.sparse_conv_fwd
    before = fn.launches
    with pytest.raises(ValueError, match="aligned"):
        fn(f, r, w)
    with pytest.raises(ValueError, match="aligned"):
        fn(f.clone(), r, w_off)
    assert fn.launches == before


# (Cin, Cout, K) of SpMiddleResNetFHD's 128-channel convs: the strided
# 64 -> 128, the blocks' 128 -> 128, the extra conv's 3 taps
WIDE_PLAN = [(64, 128, 27), (128, 128, 27), (128, 128, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", WIDE_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in WIDE_PLAN])
def test_wide_instances_match_twin(cuda, cin, cout, k, idx_dtype):
    """bf16 K1 and K3 at 128 output channels (``WIDE_PAIRS``) within 2e-2
    of the twin on tiles that skip every tap, all but one, or none; K1 at
    S = 1, 2 and 4, each equal to itself on a second run, and at S = 1
    bit-equal to K3; rows with no hit 0; f32 has no instance."""
    feats, rb, w2, bias, _ = _tile_inputs(cin, cout, k)
    args = (torch.from_numpy(feats).to(cuda, torch.bfloat16),
            torch.from_numpy(rb).to(cuda, idx_dtype),
            torch.from_numpy(w2).to(cuda, torch.bfloat16),
            torch.from_numpy(bias).to(cuda), N_IN)
    want = sc.fused_sparse_conv_ref(*args)
    miss = torch.from_numpy((rb == N_IN).all(1)).to(cuda)
    before = (sc.fused_sparse_conv.launches,
              sc.fused_sparse_conv_stream.launches)
    got = sc.fused_sparse_conv(*args)
    k3 = sc.fused_sparse_conv_stream(*args)
    lin = sc.fused_sparse_conv_stream(*args, relu=False)
    torch.cuda.synchronize()
    assert (sc.fused_sparse_conv.launches,
            sc.fused_sparse_conv_stream.launches) == (before[0] + 1,
                                                      before[1] + 2)
    for y in (got, k3):
        assert y.shape == (N_OUT, cout) and y.dtype == torch.bfloat16
        assert _err(y, want) <= 2e-2 and not y[miss].any()
    assert _err(lin, sc.fused_sparse_conv_ref(*args, relu=False)) <= 2e-2
    assert (lin < 0).any()
    one = sc.fused_sparse_conv_at_split(*args, split=1)
    assert torch.equal(one, k3)
    for split in (2, 4):
        y = sc.fused_sparse_conv_at_split(*args, split=split)
        assert torch.equal(y, sc.fused_sparse_conv_at_split(*args,
                                                            split=split))
        assert _err(y, want) <= 2e-2 and not y[miss].any()
    f32 = tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16
                else a for a in args)
    for fn in (sc.fused_sparse_conv, sc.fused_sparse_conv_stream):
        with pytest.raises((RuntimeError, ValueError)):
            fn(*f32)
    assert sc.stream_blocks_per_sm(cin, cout, torch.bfloat16) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_residual_store_matches_twin(cuda, c, idx_dtype):
    """bf16 K1 and K3 with a residual block's identity added in the store
    (``residual``), before the ReLU: within 2e-2 of the twin, rows with no
    hit 0, K1 at one CTA per tile bit-equal to K3; a residual of another
    shape or type, f32 and a pair with Cin != Cout are refused."""
    dtype, tol = torch.bfloat16, 2e-2
    feats, rb, w2, bias, _ = _tile_inputs(c, c, 27)
    args = (torch.from_numpy(feats).to(cuda, dtype),
            torch.from_numpy(rb).to(cuda, idx_dtype),
            torch.from_numpy(w2).to(cuda, dtype),
            torch.from_numpy(bias).to(cuda), N_IN)
    res = torch.randn(N_OUT, c, generator=torch.Generator().manual_seed(c)
                      ).to(cuda, dtype)
    want = sc.fused_sparse_conv_ref(*args, residual=res)
    miss = torch.from_numpy((rb == N_IN).all(1)).to(cuda)
    k1 = sc.fused_sparse_conv(*args, residual=res)
    k3 = sc.fused_sparse_conv_stream(*args, residual=res)
    for y in (k1, k3):
        assert _err(y, want) <= tol and not y[miss].any()
    assert _err(k1, sc.fused_sparse_conv_ref(*args)) > 10 * tol
    assert torch.equal(sc.fused_sparse_conv_at_split(*args, split=1),
                       sc.fused_sparse_conv_stream(*args))
    for bad in (res[:-1], res.float()):
        with pytest.raises(ValueError, match="residual"):
            sc.fused_sparse_conv_stream(*args, residual=bad)
    f32 = tuple(a.float() if torch.is_tensor(a) and a.dtype == dtype else a
                for a in args)
    if c < 128:
        with pytest.raises(ValueError, match="residual"):
            sc.fused_sparse_conv(*f32, residual=res.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_padded_first_conv_is_the_five_channel_conv(cuda, dtype, tol):
    """CenterPoint's first conv (5 -> 16) on the card: its input and
    weights zero-padded to 16 channels (``SpMiddleResNetFHD``) through K1
    and K3's 16 -> 16 instance, against the twin of the published 5-channel
    conv."""
    feats, rb, w2, bias = _inputs(5, 16, 27)
    pf = np.pad(feats, ((0, 0), (0, 11)))
    pw = np.pad(w2, ((0, 0), (0, 11), (0, 0)))
    r = torch.from_numpy(rb).to(cuda, torch.int32)
    b = torch.from_numpy(bias).to(cuda)
    want = sc.fused_sparse_conv_ref(torch.from_numpy(feats).to(cuda, dtype),
                                    r, torch.from_numpy(w2).to(cuda, dtype),
                                    b, N_IN)
    args = (torch.from_numpy(pf).to(cuda, dtype), r,
            torch.from_numpy(pw).to(cuda, dtype), b, N_IN)
    for fn in (sc.fused_sparse_conv, sc.fused_sparse_conv_stream):
        assert _err(fn(*args), want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_mma_tile_k1_matches_twin_at_every_split(cuda, cin, cout, k,
                                                 idx_dtype):
    """bf16 K1 on the tensor-core tile, as the rule launches it and at
    S = 1, 2 and 4 CTAs per tile, within 2e-2 of its twin on tiles that
    skip every tap, all but one, or none; each S > 1 within 2e-2 of S = 1
    (relative to S = 1's max) and equal to itself on a second run; rows
    with no hit come out 0."""
    feats, rb, w2, bias, _ = _tile_inputs(cin, cout, k)
    assert sc.conv_instance("fused_sparse_conv", torch.bfloat16, cin,
                            cout) == "mma"
    args = (torch.from_numpy(feats).to(cuda, torch.bfloat16),
            torch.from_numpy(rb).to(cuda, idx_dtype),
            torch.from_numpy(w2).to(cuda, torch.bfloat16),
            torch.from_numpy(bias).to(cuda), N_IN)
    want = sc.fused_sparse_conv_ref(*args)
    miss = torch.from_numpy((rb == N_IN).all(1)).to(cuda)
    before = sc.fused_sparse_conv.launches
    got = sc.fused_sparse_conv(*args)
    torch.cuda.synchronize()
    assert sc.fused_sparse_conv.launches == before + 1
    assert _err(got, want) <= 2e-2 and not got[miss].any()
    one = sc.fused_sparse_conv_at_split(*args, split=1)
    for split in (2, 4):
        y = sc.fused_sparse_conv_at_split(*args, split=split)
        again = sc.fused_sparse_conv_at_split(*args, split=split)
        torch.cuda.synchronize()
        assert _err(y, want) <= 2e-2 and _err(y, one) <= 2e-2
        assert torch.equal(y, again)  # partials added in rank order
        assert not y[miss].any()
        for row in (128 + 17, 192 + 63):  # one tap of a row; every tap
            assert _err(y[row:row + 1], want[row:row + 1]) <= 2e-2
    rule = sc.launch_split(N_OUT, cin, cout, torch.bfloat16)
    assert torch.equal(got, sc.fused_sparse_conv_at_split(*args,
                                                          split=rule))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_mma_tile_k1_rows_do_not_depend_on_their_tile(cuda, cin, cout, k,
                                                     split):
    """bf16 K1 split over a cluster gives each row the same bits wherever
    the rows before it put it in a tile (another scan batched ahead of
    it): every rank sums the row's own taps of its residue class. Rows hit
    half the taps and a few rare ones, so the taps a tile hits, and a
    deal by position in that list, change with the rows it holds."""
    feats, _, w2, bias, _ = _tile_inputs(cin, cout, k)
    rng = np.random.RandomState(cin + cout + k)
    n_out = 16384
    rate = np.where(np.arange(k) % 4 == 1, 0.02, 0.5)
    rb = np.where(rng.rand(n_out, k) < rate,
                  rng.randint(0, N_IN, (n_out, k)), N_IN)
    args = (torch.from_numpy(feats).to(cuda, torch.bfloat16),
            torch.from_numpy(w2).to(cuda, torch.bfloat16),
            torch.from_numpy(bias).to(cuda))
    want = sc.fused_sparse_conv_at_split(
        args[0], torch.from_numpy(rb).to(cuda, torch.int32), *args[1:], N_IN,
        split=split)
    for shift in (1, 23, 40):
        moved = np.concatenate([np.full((shift, k), N_IN), rb])
        got = sc.fused_sparse_conv_at_split(
            args[0], torch.from_numpy(moved).to(cuda, torch.int32),
            *args[1:], N_IN, split=split)
        torch.cuda.synchronize()
        assert torch.equal(got[shift:], want), shift


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_bf16_k1_at_one_cta_per_tile_equals_k3(cuda, cin, cout, k,
                                               idx_dtype):
    """K1 and K3 run the same tensor-core body; at S = 1 the bits agree."""
    feats, rb, w2, bias = _inputs(cin, cout, k)
    args = (torch.from_numpy(feats).to(cuda, torch.bfloat16),
            torch.from_numpy(rb).to(cuda, idx_dtype),
            torch.from_numpy(w2).to(cuda, torch.bfloat16),
            torch.from_numpy(bias).to(cuda), N_IN)
    for relu in (True, False):
        k1 = sc.fused_sparse_conv_at_split(*args, split=1, relu=relu)
        k3 = sc.fused_sparse_conv_stream(*args, relu=relu)
        torch.cuda.synchronize()
        assert torch.equal(k1, k3)


@pytest.mark.cuda
def test_cluster_split_equals_the_c_entry(cuda):
    """The Python mirror of the rule picks the S the C entry launches with,
    on this card's wave, across a wave's worth of row counts."""
    for cin, cout in sc.FUSED_PAIRS:
        if sc.conv_instance("fused_sparse_conv", torch.bfloat16, cin,
                            cout) != "mma":
            assert sc.launch_split(1000, cin, cout, torch.bfloat16) == 1
            continue
        wave = sc.launch_wave(cin, cout)
        assert wave >= 132  # at least one block per SM
        for tiles in sorted({1, wave // 4, wave // 4 + 1, wave // 2,
                             wave - 1, wave, wave + 1, 3 * wave}):
            n_out = max(1, tiles * 64 - 5)
            got = sc.launch_split(n_out, cin, cout, torch.bfloat16)
            assert got == sc.cluster_split(tiles, wave), (cin, cout, tiles)
        assert sc.launch_split(1000, cin, cout, torch.float32) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mma_k1_rejects_misaligned_inputs(cuda, dtype):
    """K1 on the tensor-core tile (bf16, and f32 through 3xTF32) copies
    16-byte chunks: a misaligned call raises. Its comparison entry at a
    forced cluster size takes 1, 2 or 4 in bf16 and no f32 call."""
    f = torch.zeros(N_IN * 16 + 2, dtype=dtype,
                    device=cuda)[2:].view(N_IN, 16)  # 4 or 8 bytes off
    r = torch.full((N_OUT, 27), N_IN, dtype=torch.int32, device=cuda)
    w = torch.zeros(27, 16, 16, dtype=dtype, device=cuda)
    b = torch.zeros(16, device=cuda)
    before = sc.fused_sparse_conv.launches
    with pytest.raises(ValueError, match="aligned"):
        sc.fused_sparse_conv(f, r, w, b, N_IN)
    assert sc.fused_sparse_conv.launches == before
    # the forced cluster size: 1, 2 or 4, on the bf16 tensor-core tile only
    args = (torch.zeros(N_IN, 16, dtype=dtype, device=cuda), r, w, b, N_IN)
    for split in ((3,) if dtype == torch.bfloat16 else (1,)):
        with pytest.raises(ValueError, match="1, 2 or 4"):
            sc.fused_sparse_conv_at_split(*args, split=split)


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
@pytest.mark.parametrize("cin,cout,k", PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in PLAN])
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


LONE_ROW = 5993  # the one row that hits the last tap in _dw_skip_inputs


def _dw_skip_inputs(cin, cout, k, n_out=6000, seed=0):
    """Injective taps over ``n_out`` rows in which rows 0-2047 hit only
    tap 0 (a chunk whose other taps skip), rows 2048-2111 and 4096-4159 hit
    nothing (steps that skip), the last tap is hit by LONE_ROW alone (input
    row 5), and the rest hit at 50%."""
    rng = np.random.RandomState(seed)
    n_in = n_out + 100
    rb = np.full((n_out, k), n_in)
    for t in range(k):
        rows = np.flatnonzero(rng.rand(n_out) < 0.5)
        rb[rows, t] = rng.choice(n_in, len(rows), replace=False)
    rb[:2048, 1:] = n_in
    rb[2048:2112] = n_in
    rb[4096:4160] = n_in
    rb[:, k - 1] = n_in
    rb[LONE_ROW, k - 1] = 5
    feats = rng.randn(n_in, cin).astype(np.float32)
    dout = rng.randn(n_out, cout).astype(np.float32)
    return feats, rb, dout


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_dw_mma_kernel_skips_and_matches_twin(cuda, cin, cout, k, idx_dtype):
    """bf16 dW on tensor cores, at several chunk sizes, over chunks and
    steps that no row hits: within 2e-2 of its twin, the same bits on a
    second run, and a tap that one row hits carries exactly that row's
    product."""
    assert sc.conv_instance("sparse_conv_dw", torch.bfloat16, cin,
                            cout) == "mma"
    feats, rb, dout = _dw_skip_inputs(cin, cout, k)
    f = torch.from_numpy(feats).to(cuda, torch.bfloat16)
    r = torch.from_numpy(rb).to(cuda, idx_dtype)
    d = torch.from_numpy(dout).to(cuda, torch.bfloat16)
    want = kt.sparse_conv_dw_ref(f, r, d)
    lone = torch.outer(f[5].float(), d[LONE_ROW].float())
    for chunk in (64, 2048, kt.DW_MAX_CHUNK_ROWS):
        before = kt.sparse_conv_dw.launches
        got = kt.sparse_conv_dw(f, r, d, chunk_rows=chunk)
        again = kt.sparse_conv_dw(f, r, d, chunk_rows=chunk)
        torch.cuda.synchronize()
        assert kt.sparse_conv_dw.launches == before + 2
        assert got.dtype == torch.bfloat16 and got.shape == (k, cin, cout)
        assert _err(got, want) <= 2e-2
        assert _err(got[k - 1], lone) <= 2e-2
        assert torch.equal(got, again)
    with pytest.raises(ValueError, match="chunk_rows"):
        kt.sparse_conv_dw(f, r, d, chunk_rows=100)


@pytest.mark.cuda
def test_dw_mma_rejects_misaligned_inputs(cuda):
    """bf16 and, since its 3xTF32 body, f32: a misaligned call or a chunk
    the tensor-core body does not take raises before any launch."""
    r = torch.full((N_OUT, 27), N_IN, dtype=torch.int32, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        f = torch.zeros(N_IN * 16 + 2, dtype=dtype,
                        device=cuda)[2:].view(N_IN, 16)  # 4 or 8 bytes off
        d = torch.zeros(N_OUT, 16, dtype=dtype, device=cuda)
        before = kt.sparse_conv_dw.launches
        with pytest.raises(ValueError, match="aligned"):
            kt.sparse_conv_dw(f, r, d)
        with pytest.raises(ValueError, match="chunk_rows"):
            kt.sparse_conv_dw(f.clone(), r, d, chunk_rows=100)
        assert kt.sparse_conv_dw.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_dw_tf32_kernel_skips_and_matches_twin_and_model(cuda, cin, cout, k,
                                                         idx_dtype):
    """f32 dW through 3xTF32 (mma.sync m16n8k8), at several chunk sizes,
    over chunks and steps that no row hits: within the f32 dW bound (1e-3)
    of its twin, within 1e-5 of the model of its arithmetic (``kt.dw_tf32``), the same bits on a second
    run, and a tap that one row hits carries that row's product."""
    assert sc.conv_instance("sparse_conv_dw", torch.float32, cin,
                            cout) == "tf32"
    feats, rb, dout = _dw_skip_inputs(cin, cout, k)
    f = torch.from_numpy(feats).to(cuda)
    r = torch.from_numpy(rb).to(cuda, idx_dtype)
    d = torch.from_numpy(dout).to(cuda)
    want = kt.sparse_conv_dw_ref(f, r, d)
    lone = torch.outer(f[5], d[LONE_ROW])
    for chunk in (64, 2048, kt.DW_MAX_CHUNK_ROWS):
        before = kt.sparse_conv_dw.launches
        got = kt.sparse_conv_dw(f, r, d, chunk_rows=chunk)
        again = kt.sparse_conv_dw(f, r, d, chunk_rows=chunk)
        torch.cuda.synchronize()
        assert kt.sparse_conv_dw.launches == before + 2
        assert got.dtype == torch.float32 and got.shape == (k, cin, cout)
        assert _err(got, want) <= 1e-3
        model = kt.dw_tf32(f, r, d, chunk_rows=chunk)
        assert _err(got, model) <= TF32_MODEL_BOUND
        assert _err(got[k - 1], lone) <= 1e-4
        assert torch.equal(got, again)


# (conv Cin, conv Cout) of the input gradient's five tensor-core gather
# pairs (the first conv's 16 -> 4 takes the direct body)
DFEAT_CONVS = [(b, a) for a, b in sc.DFEAT_PAIRS if b != 4]
DFEAT_CASES = [(cin, cout, k) for cin, cout in DFEAT_CONVS for k in (3, 27)]
DEAD = slice(64, 192)  # input rows no output reads: two all-miss tiles
LONE_IN = 200          # an input row read through one tap by one output


def _dfeat_inputs(cin, cout, k, seed=0):
    """A conv's injective rulebook over N_IN inputs in which input rows
    64-191 are read by no output (their inverse tiles miss every tap),
    input row LONE_IN by one output through tap k // 2 alone, and the rest
    at a 60% rate; its weights and a cotangent."""
    rng = np.random.RandomState(seed)
    rows_in = np.setdiff1d(np.arange(N_IN), np.r_[64:192, LONE_IN])
    rb = np.full((N_OUT, k), N_IN)
    for t in range(k):
        outs = rng.choice(N_OUT, int(N_OUT * 0.6), replace=False)
        rb[outs, t] = rng.choice(rows_in, len(outs), replace=False)
    free = np.flatnonzero(rb[:, k // 2] == N_IN)[0]
    rb[free, k // 2] = LONE_IN
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    dout = rng.randn(N_OUT, cout).astype(np.float32)
    return rb, w2, dout


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", DFEAT_CASES,
                         ids=[f"{a}x{b}x{c}" for a, b, c in DFEAT_CASES])
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f32", "bf16"])
def test_dfeat_mma_matches_twin(cuda, cin, cout, k, idx_dtype, dtype, tol):
    """dFeat on the tensor-core tile (W read K-major as it lies; bf16, and
    f32 through 3xTF32) within the type's bound of its twin, over the
    inverse rulebook of a conv whose inverse tiles
    skip every tap (all-miss rows come out 0) or all but one; in f32 also
    within 1e-5 of the model of its arithmetic (``kt.gather_gemm_tf32``
    over the inverse rulebook with W^T)."""
    assert sc.conv_instance("sparse_conv_dfeat", dtype, cout,
                            cin) == DFEAT_BODY[dtype]
    rb, w2, dout = _dfeat_inputs(cin, cout, k, seed=cin + cout + k)
    r = torch.from_numpy(rb).to(cuda, idx_dtype)
    w = torch.from_numpy(w2).to(cuda, dtype)
    d = torch.from_numpy(dout).to(cuda, dtype)
    inv = sp.inverse_rulebook(r, N_IN)
    before = kt.sparse_conv_dfeat.launches
    got = kt.sparse_conv_dfeat(d, inv, w)
    torch.cuda.synchronize()
    assert kt.sparse_conv_dfeat.launches == before + 1
    assert got.dtype == dtype and got.shape == (N_IN, cin)
    want = kt.sparse_conv_dfeat_ref(d, inv, w)
    assert _err(got, want) <= tol
    assert not got[DEAD].any()
    assert _err(got[LONE_IN:LONE_IN + 1], want[LONE_IN:LONE_IN + 1]) <= tol
    if dtype == torch.float32:
        model = kt.gather_gemm_tf32(d, inv, w.transpose(1, 2))
        assert _err(got, model) <= TF32_MODEL_BOUND


def _allocs():
    return torch.cuda.memory_stats()["allocation.all.allocated"]


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("cin,cout,k", MMA_PLAN,
                         ids=[f"{a}x{b}x{c}" for a, b, c in MMA_PLAN])
def test_tf32_forward_matches_model_and_twin(cuda, cin, cout, k,
                                             idx_dtype):
    """The f32 forward (K4 through 3xTF32) on every pair of
    SESSD_FWD_PAIRS it takes: within 1e-5 of the model
    ``kt.gather_gemm_tf32`` (masked) and 1e-4 of its twin, over tiles that skip every
    tap, all but one, or none, and a ragged last tile; one call is one
    launch and one allocation (its output: the weights are transposed and
    split inside the kernel)."""
    feats, rb, w2, _, mask = _tile_inputs(cin, cout, k)
    f = torch.from_numpy(feats).to(cuda)
    r = torch.from_numpy(rb).to(cuda, idx_dtype)
    w = torch.from_numpy(w2).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    torch.cuda.synchronize()
    counts = (_allocs(), kt.sparse_conv_fwd.launches)
    got = kt.sparse_conv_fwd(f, r, w, m)
    assert (_allocs(), kt.sparse_conv_fwd.launches) == (counts[0] + 1,
                                                        counts[1] + 1)
    model = torch.where(m[:, None], kt.gather_gemm_tf32(f, r, w), 0.0)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (N_OUT, cout)
    assert _err(got, model) <= TF32_MODEL_BOUND
    assert _err(got, kt.sparse_conv_fwd_ref(f, r, w, m)) <= 1e-4
    assert not got[~m].any() and not got[64:128].any()


@pytest.mark.cuda
def test_training_tiles_fit_the_sm(cuda):
    """Every instance of the forward, input gradient and dW partial kernel
    (at DW_CHUNK_ROWS) fits at least one block per SM, and each 3xTF32 one
    (the forward's, dFeat's, dW's) two (their ring stages are chosen so),
    to overlap one block's gathers with another's tensor-core work. So do
    the stream
    kernel's 3xTF32 instances. The direct bodies of the forward and the
    input gradient are counted at the 128-thread block they launch with
    (sessd::kDirectThreads), and fit at least four."""
    for cin, cout in sc.STREAM_PAIRS:
        for dtype in (torch.float32, torch.bfloat16):
            body = sc.conv_instance("fused_sparse_conv_stream", dtype, cin,
                                    cout)
            assert sc.stream_blocks_per_sm(cin, cout, dtype) >= (
                2 if body == "tf32" else 1), (cin, cout, dtype)
    for entry, pairs in (("sparse_conv_fwd", sc.FWD_PAIRS),
                         ("sparse_conv_dfeat", sc.DFEAT_PAIRS),
                         ("sparse_conv_dw", sc.DW_PAIRS)):
        for cin, cout in pairs:
            for dtype in (torch.float32, torch.bfloat16):
                blocks = kt.blocks_per_sm(entry, dtype, cin, cout)
                body = sc.conv_instance(entry, dtype, cin, cout)
                least = {"tf32": 2, "direct": 4}.get(body, 1)
                if entry == "sparse_conv_dw" and body == "direct":
                    least = 1
                assert blocks >= least, (entry, dtype, cin, cout, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dfeat_allocates_only_its_output(cuda, dtype):
    """A ``sparse_conv_dfeat`` call makes one device allocation, its output:
    the weights are read as they lie, with no transposed copy (the kernel
    count per call is held in ``test_kernels_profile_under_their_own_names``)."""
    rb, w2, dout = _dfeat_inputs(64, 64, 27)
    r = torch.from_numpy(rb).to(cuda, torch.int32)
    w = torch.from_numpy(w2).to(cuda, dtype)
    d = torch.from_numpy(dout).to(cuda, dtype)
    inv = sp.inverse_rulebook(r, N_IN)
    torch.cuda.synchronize()
    allocs = lambda: torch.cuda.memory_stats()[  # noqa: E731
        "allocation.all.allocated"]
    before = allocs()
    kt.sparse_conv_dfeat(d, inv, w)
    assert allocs() == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dfeat_mma_rejects_misaligned_inputs(cuda, dtype):
    d = torch.zeros(N_OUT * 16 + 2, dtype=dtype,
                    device=cuda)[2:].view(N_OUT, 16)  # 4 or 8 bytes off
    inv = torch.full((N_IN, 27), N_OUT, dtype=torch.int32, device=cuda)
    w = torch.zeros(27, 16, 16, dtype=dtype, device=cuda)
    w_off = torch.zeros(27 * 256 + 2, dtype=dtype,
                        device=cuda)[2:].view(27, 16, 16)
    before = kt.sparse_conv_dfeat.launches
    with pytest.raises(ValueError, match="aligned"):
        kt.sparse_conv_dfeat(d, inv, w)
    with pytest.raises(ValueError, match="aligned"):
        kt.sparse_conv_dfeat(d.clone(), inv, w_off)
    assert kt.sparse_conv_dfeat.launches == before


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
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f32", "bf16"])
def test_first_conv_input_gradient_on_card(cuda, dtype, tol):
    """``autograd.grad`` with respect to the 4-channel input of the first
    conv (4 -> 16) launches the dFeat kernel once, on the direct body, and
    matches the same gradient through the plain twins."""
    assert sc.conv_instance("sparse_conv_dfeat", dtype, 16, 4) == "direct"
    feats, rb, w2, dout, mask = _train_inputs(4, 16, 27, seed=2)
    r = torch.from_numpy(rb).to(cuda, torch.int32)
    m = torch.from_numpy(mask).to(cuda)
    w = torch.from_numpy(w2).to(cuda, dtype)
    d = torch.from_numpy(dout).to(cuda, dtype)
    x = torch.from_numpy(feats).to(cuda, dtype).requires_grad_(True)
    before = kt.sparse_conv_dfeat.launches
    y = sp.SparseConvFunction.apply(x, w, r, m, None)
    (got,) = torch.autograd.grad(y, x, d)
    torch.cuda.synchronize()
    assert kt.sparse_conv_dfeat.launches == before + 1
    assert got.dtype == dtype and got.shape == (N_IN, 4)
    inv = sp.inverse_rulebook(r, N_IN)
    dm = torch.where(m[:, None], d, 0.0)
    assert _err(got, kt.sparse_conv_dfeat_ref(dm, inv, w)) <= tol


# (n_in, n_out) of the direct bodies' cases: ragged against the forward's
# 64-row blocks, dFeat's 256-row blocks and dW's chunks and 64-row steps
DIRECT_ROWS = [(3000, 2500), (20011, 20003)]
# chunk rows of dW's cases: the default, one that is no multiple of 64, and
# one small enough that every SM has chunks (the largest tap group)
DIRECT_DW_CHUNKS = (kt.DW_CHUNK_ROWS, 1000, 64)


def _direct_inputs(n_in, n_out, seed=0):
    """The first conv's shapes (4 -> 16, 27 taps): injective taps at a 40%
    hit rate, 50 all-miss rows, a row mask with zeros and dout zero on the
    masked rows."""
    rng = np.random.RandomState(seed)
    rb = np.full((n_out, 27), n_in)
    for t in range(27):
        rows = rng.choice(n_out, int(min(n_in, n_out) * 0.4), replace=False)
        rb[rows, t] = rng.choice(n_in, len(rows), replace=False)
    dead = rng.choice(n_out, 50, replace=False)
    rb[dead] = n_in
    feats = rng.randn(n_in, 4).astype(np.float32)
    w2 = (rng.randn(27, 4, 16) / np.sqrt(27 * 4)).astype(np.float32)
    bias = (rng.randn(16) * 0.3).astype(np.float32)
    mask = rng.rand(n_out) > 0.1
    dout = np.where(mask[:, None], rng.randn(n_out, 16), 0.0).astype(
        np.float32)
    return feats, rb, w2, bias, dout, mask, dead


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS, ids=["f32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("n_in,n_out", DIRECT_ROWS,
                         ids=[f"{a}to{b}" for a, b in DIRECT_ROWS])
def test_direct_bodies_match_twins_and_repeat_their_bits(cuda, n_in, n_out,
                                                         idx_dtype, dtype,
                                                         tol):
    """The first conv's 4-channel side on the direct bodies: K1 (with and
    without ReLU), K4 (row mask), dFeat 16 -> 4 and dW (at each chunk size
    of DIRECT_DW_CHUNKS) within the type's bound of their twins (dW 1e-3
    in f32), one launch each on the main counters, and the same bits on a
    second run (each sums in a fixed order); rows with no hit and masked
    rows come out 0."""
    for entry in ("fused_sparse_conv", "sparse_conv_fwd", "sparse_conv_dw"):
        assert sc.conv_instance(entry, dtype, 4, 16) == "direct"
    assert sc.conv_instance("sparse_conv_dfeat", dtype, 16, 4) == "direct"
    feats, rb, w2, bias, dout, mask, dead = _direct_inputs(n_in, n_out)
    f, r, w, d, m = _on(cuda, dtype, idx_dtype, feats, rb, w2, dout, mask)
    b = torch.from_numpy(bias).to(cuda)
    for relu in (True, False):
        before = sc.fused_sparse_conv.launches
        y = sc.fused_sparse_conv(f, r, w, b, n_in, relu=relu)
        torch.cuda.synchronize()
        assert sc.fused_sparse_conv.launches == before + 1
        assert y.dtype == dtype and y.shape == (n_out, 16)
        assert _err(y, sc.fused_sparse_conv_ref(f, r, w, b, n_in,
                                                relu=relu)) <= tol
        assert torch.equal(y, sc.fused_sparse_conv(f, r, w, b, n_in,
                                                   relu=relu))
        assert not y[torch.from_numpy(dead).to(cuda)].any()
    before = kt.sparse_conv_fwd.launches
    y4 = kt.sparse_conv_fwd(f, r, w, m)
    torch.cuda.synchronize()
    assert kt.sparse_conv_fwd.launches == before + 1
    assert _err(y4, kt.sparse_conv_fwd_ref(f, r, w, m)) <= tol
    assert torch.equal(y4, kt.sparse_conv_fwd(f, r, w, m))
    assert not y4[~m].any()
    inv = sp.inverse_rulebook(r, n_in)
    before = kt.sparse_conv_dfeat.launches
    g = kt.sparse_conv_dfeat(d, inv, w)
    torch.cuda.synchronize()
    assert kt.sparse_conv_dfeat.launches == before + 1
    assert g.dtype == dtype and g.shape == (n_in, 4)
    assert _err(g, kt.sparse_conv_dfeat_ref(d, inv, w)) <= tol
    assert torch.equal(g, kt.sparse_conv_dfeat(d, inv, w))
    dw_tol = 1e-3 if dtype == torch.float32 else tol
    for chunk in DIRECT_DW_CHUNKS:
        before = kt.sparse_conv_dw.launches
        dw = kt.sparse_conv_dw(f, r, d, chunk)
        torch.cuda.synchronize()
        assert kt.sparse_conv_dw.launches == before + 1
        assert dw.dtype == dtype and dw.shape == (27, 4, 16)
        assert _err(dw, kt.sparse_conv_dw_ref(f, r, d)) <= dw_tol, chunk
        assert torch.equal(dw, kt.sparse_conv_dw(f, r, d, chunk)), chunk


@pytest.mark.cuda
def test_direct_dw_takes_any_chunk_count(cuda):
    """The direct dW launches one block per (chunk, tap group) on a grid of
    one dimension, so any positive chunk_rows runs: at one row a chunk,
    66000 chunks (above 65535, a grid's limit in y) give the same bits on
    two runs and the twin within 1e-3."""
    n = 66000
    feats, rb, w2, _, dout, mask, _ = _direct_inputs(n, n)
    f, r, _, d, _ = _on(cuda, torch.float32, torch.int32, feats, rb, w2,
                        dout, mask)
    dw = kt.sparse_conv_dw(f, r, d, 1)
    torch.cuda.synchronize()
    assert torch.equal(dw, kt.sparse_conv_dw(f, r, d, 1))
    assert _err(dw, kt.sparse_conv_dw_ref(f, r, d)) <= 1e-3


MANY_CHUNKS = 65_600  # of 64 rows: past 65535, a grid's limit in y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_dw_mma_takes_any_chunk_count(cuda, dtype, tol):
    """The tensor-core dW launches taps x chunks blocks on a grid of one
    dimension, tap-fastest, so 65,600 chunks of 64 rows (4.2 M rows at
    16 -> 16, 27 taps; 1.8 GB of partials) run: one launch within the dW
    bound of its twin (1e-3 in f32, 2e-2 in bf16)."""
    n_out, n_in = MANY_CHUNKS * 64, 100_000
    rng = np.random.RandomState(0)
    rb = rng.randint(0, n_in * 5 // 3, (n_out, 27), dtype=np.int32)
    rb[rb >= n_in] = n_in  # 40% misses
    r = torch.from_numpy(rb).to(cuda)
    f = torch.from_numpy(rng.randn(n_in, 16).astype(np.float32)).to(
        cuda, dtype)
    d = torch.from_numpy(rng.randn(n_out, 16).astype(np.float32)).to(
        cuda, dtype)
    assert sc.conv_instance("sparse_conv_dw", dtype, 16, 16) in ("mma",
                                                                 "tf32")
    before = kt.sparse_conv_dw.launches
    dw = kt.sparse_conv_dw(f, r, d, 64)
    torch.cuda.synchronize()
    assert kt.sparse_conv_dw.launches == before + 1
    assert dw.dtype == dtype and dw.shape == (27, 16, 16)
    assert _err(dw, kt.sparse_conv_dw_ref(f, r, d)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_direct_bodies_reject_misaligned_inputs(cuda, dtype):
    """The direct bodies load each gathered row whole (16 bytes in f32, 8
    in bf16) and dW's its dout rows in 16-byte parts: a misaligned call
    raises before any launch; there is no fallback to another body."""
    feats, rb, w2, bias, dout, mask, _ = _direct_inputs(3000, 2500)
    f, r, w, d, m = _on(cuda, dtype, torch.int32, feats, rb, w2, dout, mask)
    b = torch.from_numpy(bias).to(cuda)
    f_off = torch.zeros(f.numel() + 2, dtype=dtype,
                        device=cuda)[2:].view_as(f)
    d_off = torch.zeros(d.numel() + 2, dtype=dtype,
                        device=cuda)[2:].view_as(d)
    inv = sp.inverse_rulebook(r, 3000)
    fns = (sc.fused_sparse_conv, kt.sparse_conv_fwd, kt.sparse_conv_dfeat,
           kt.sparse_conv_dw)
    before = [fn.launches for fn in fns]
    for call in (lambda: sc.fused_sparse_conv(f_off, r, w, b, 3000),
                 lambda: kt.sparse_conv_fwd(f_off, r, w, m),
                 lambda: kt.sparse_conv_dfeat(d_off, inv, w),
                 lambda: kt.sparse_conv_dw(f_off, r, d),
                 lambda: kt.sparse_conv_dw(f, r, d_off)):
        with pytest.raises(ValueError, match="aligned"):
            call()
    assert [fn.launches for fn in fns] == before


def _named_calls(cuda, dtype):
    """(kernel name, call) of every wrapper at ``dtype``; in bf16 also K1
    at S = 4."""
    feats, rb, w2, bias = (torch.from_numpy(a).to(cuda)
                           for a in _inputs(16, 32, 27))
    feats, w2, rb = feats.to(dtype), w2.to(dtype), rb.int()
    f, r, w, d, m = _on(cuda, dtype, torch.int32, *_train_inputs(16, 32, 27))
    inv = sp.inverse_rulebook(r, N_IN)
    calls = [("fused_sparse_conv_kernel", lambda: sc.fused_sparse_conv(
                 feats, rb, w2, bias, N_IN)),
             ("fused_sparse_conv_stream_kernel",
              lambda: sc.fused_sparse_conv_stream(feats, rb, w2, bias, N_IN)),
             ("sparse_conv_fwd_kernel", lambda: kt.sparse_conv_fwd(f, r, w,
                                                                   m)),
             ("sparse_conv_dfeat_kernel", lambda: kt.sparse_conv_dfeat(
                 d, inv, w)),
             ("sparse_conv_dw_partial_kernel", lambda: kt.sparse_conv_dw(
                 f, r, d))]
    if dtype == torch.bfloat16:
        calls += [
            ("fused_sparse_conv_kernel",
             lambda: sc.fused_sparse_conv_at_split(feats, rb, w2, bias, N_IN,
                                                   split=4))]
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernels_profile_under_their_own_names(cuda, dtype):
    """Each wrapper's launch shows in a device profile under a kernel name
    of its own, the names the step and request profilers
    (``sessd_torch/scripts/profile_*.py``) sum by: in f32 the 3xTF32
    bodies of K1, K3, K4, dFeat and dW, in bf16 the tensor-core ones (K1
    also at S = 4). A dFeat call is one kernel and nothing else: no transposed copy of the weights. The profiler on the card
    now and then delivers no device event of a whole profile; such an
    empty capture says nothing of the kernels, so it is taken again (at
    most 3 times)."""
    for name, call in _named_calls(cuda, dtype):
        call()  # warm: the profile holds only the call itself
        for _ in range(3):
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            launched = [e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
            if launched:
                break
        kernels = {k for k in launched if "sparse_conv" in k}
        assert any(name in k for k in kernels), (name, kernels)
        assert all(name in k or "sparse_conv_dw_reduce_kernel" in k
                   for k in kernels), (name, kernels)
        if name == "sparse_conv_dfeat_kernel":
            assert len(launched) == 1, launched


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
def test_ablate_full_is_the_in_order_scalar_sum(cuda):
    """S1's ``full`` mode is the scalar tile with no bias and no ReLU: the
    same bits as its in-order f32 sum in torch (``ablate.scalar_tile_sum``),
    and within 2e-2 of ``ablate.sparse_conv_ablate_ref`` on the same
    inputs."""
    from sessd_torch.ops.cuda import ablate
    _, x = _ablate_inputs(cuda)
    before = ablate.sparse_conv_ablate.launches
    got = ablate.sparse_conv_ablate(x["feats"], x["rb"], x["w2"], "full")
    want = ablate.scalar_tile_sum(x["feats"], x["rb"], x["w2"])
    torch.cuda.synchronize()
    assert ablate.sparse_conv_ablate.launches == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert _err(got, ablate.sparse_conv_ablate_ref(
        x["feats"], x["rb"], x["w2"], "full")) <= 2e-2


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
              ablate.sparse_conv_ablate_mma.launches,
              ablate.empty_launch.launches)
    with pytest.raises(ValueError, match="no kernel for device"):
        ablate.sparse_conv_ablate(feats, rb, w2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ablate.sparse_conv_ablate_mma(feats, rb, w2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ablate.empty_launch(feats)
    assert (ablate.sparse_conv_ablate.launches,
            ablate.sparse_conv_ablate_mma.launches,
            ablate.empty_launch.launches) == before


def _ablate_mma_inputs(cuda, channels):
    """The ablation's own input at 16 channels; at 64 a random rulebook
    with all-miss tiles (``_tile_inputs``), int32."""
    if channels == 16:
        bench, x = _ablate_inputs(cuda)
        return x["feats"], x["rb"], x["w2"]
    feats, rb, w2, _, _ = _tile_inputs(64, 64, 27)
    return (torch.from_numpy(feats).to(cuda, torch.bfloat16),
            torch.from_numpy(rb).to(cuda, torch.int32),
            torch.from_numpy(w2).to(cuda, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [16, 64])
def test_ablate_mma_full_equals_k4(cuda, channels):
    """The tensor-core ablation's ``full`` mode is the tile bf16 K4 runs:
    the same bits as ``sparse_conv_fwd`` without a mask."""
    from sessd_torch.ops.cuda import ablate
    feats, rb, w2 = _ablate_mma_inputs(cuda, channels)
    before = ablate.sparse_conv_ablate_mma.launches
    got = ablate.sparse_conv_ablate_mma(feats, rb, w2, "full")
    want = kt.sparse_conv_fwd(feats, rb, w2)
    torch.cuda.synchronize()
    assert ablate.sparse_conv_ablate_mma.launches == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [16, 64])
@pytest.mark.parametrize("mode", ["full", "linear", "no_gather", "mma_only",
                                  "copy_only", "fixed"])
def test_ablate_mma_mode_matches_plain(cuda, mode, channels):
    """Each tensor-core mode against its plain version: within 2e-2 of
    max|plain| (bf16 inputs and output, f32 sums), and exactly zero where
    the mode stores zeros."""
    from sessd_torch.ops.cuda import ablate
    feats, rb, w2 = _ablate_mma_inputs(cuda, channels)
    got = ablate.sparse_conv_ablate_mma(feats, rb, w2, mode)
    torch.cuda.synchronize()
    want = ablate.sparse_conv_ablate_mma_ref(feats, rb, w2, mode)
    assert got.shape == want.shape == (rb.shape[0], channels)
    assert got.dtype == torch.bfloat16
    if mode in ("copy_only", "fixed"):
        assert not got.any()
    else:
        assert _err(got, want) <= 2e-2


@pytest.mark.cuda
def test_ablate_mma_rejects_what_it_does_not_take(cuda):
    from sessd_torch.ops.cuda import ablate
    feats, rb, w2 = _ablate_mma_inputs(cuda, 16)
    before = ablate.sparse_conv_ablate_mma.launches
    with pytest.raises(ValueError):      # f32 features
        ablate.sparse_conv_ablate_mma(feats.float(), rb, w2.float())
    with pytest.raises(ValueError):      # no such mode
        ablate.sparse_conv_ablate_mma(feats, rb, w2, "fma_only")
    with pytest.raises(ValueError):      # no 32-channel instance
        ablate.sparse_conv_ablate_mma(
            torch.zeros(64, 32, dtype=torch.bfloat16, device=cuda),
            rb[:64].clamp(max=64), torch.zeros(27, 32, 32,
                                              dtype=torch.bfloat16,
                                              device=cuda))
    with pytest.raises(ValueError, match="aligned"):
        ablate.sparse_conv_ablate_mma(
            feats.view(-1)[4:4 + 100 * 16].view(100, 16),  # 8 bytes off
            rb.clamp(max=100), w2)
    assert ablate.sparse_conv_ablate_mma.launches == before
