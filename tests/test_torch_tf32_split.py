"""The 3xTF32 arithmetic of the f32 tensor-core tile (``kTf32Tile`` in
``sessd_torch/csrc/gather_mma.cuh``: f32 K1, K3, K4 and dFeat at Cin, Cout
in {16, 32, 64}), from the CPU, through its plain model
``ops.cuda.sparse_conv_train.gather_gemm_tf32``:

- ``tf32_round`` (the kernel's ``cvt.rna.tf32.f32``) against the rounding
  written out in numpy (11 significant bits, to nearest, ties away from
  zero) on random values and on exact ties, and ``split_tf32``'s parts;
- the model's 3-term sum on seeded inputs at the conv shapes (2500 rows,
  27 or 3 taps, 16-64 channels; injective taps, misses, all-miss rows)
  within 1e-4 of max|reference| of the JAX package's plain gather-GEMM
  (``sessd_tpu.ops.sparse.sparse_conv_apply``; its ``jax.vjp`` for the
  input gradient over the inverse rulebook) and of the port's twin, while
  the single TF32 product (1 pass) misses that bound: that is why the tile
  runs three;
- the model's order of products and its rounding are the kernel's (a
  parse of the tile's source).

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py
holds it against its twin and this model).
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.sparse import sparse_conv_apply
from sessd_torch.ops import sparse as tsp
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

CSRC = pathlib.Path(sc.__file__).resolve().parents[2] / "csrc"
N_IN, N_OUT = 3000, 2500  # 2500 = 39 tiles of 64 rows + 4
BOUND = 1e-4  # the f32 kernels' bound against their twins (chip_smoke.py)


def _np_tf32(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away from zero, to 11 significant bits, in
    float64 arithmetic: the TF32 value of each finite normal f32."""
    m, e = np.frexp(np.abs(x.astype(np.float64)))  # |x| = m 2^e, m in [.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5)
    return (np.sign(x) * np.ldexp(r, e - 11)).astype(np.float32)


def _random_f32(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)


def _ties(n, seed):
    """f32 values whose low 13 bits are exactly half a TF32 unit."""
    rng = np.random.RandomState(seed)
    sign = rng.randint(0, 2, n).astype(np.uint32) << 31
    exp = rng.randint(60, 190, n).astype(np.uint32) << 23
    mant = (rng.randint(0, 1 << 10, n).astype(np.uint32) << 13) | 0x1000
    return (sign | exp | mant).view(np.float32)


@pytest.mark.parametrize("make", [_random_f32, _ties],
                         ids=["random", "ties"])
def test_tf32_round_is_round_to_nearest_ties_away(make):
    x = make(20000, seed=3)
    got = kt.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _np_tf32(x).view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    if make is _ties:  # every tie moved away from zero
        assert (np.abs(got) > np.abs(x)).all()


def test_split_parts_are_tf32_and_sum_to_x():
    x = np.concatenate([_random_f32(20000, seed=4), _ties(2000, seed=5)])
    hi, lo = kt.split_tf32(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    # x - hi is exact, so only lo's own rounding is lost: 2^-11 of |x - hi|
    # <= 2^-11 * 2^-11 * |x| (times 2 for hi's ulp)
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                 - lo.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x)).all()
    assert np.abs(lo).max() > 0


def _rulebook(k, seed):
    """Injective taps (each maps distinct outputs to distinct inputs, as a
    conv's rulebook does) at a 60% rate, and 50 all-miss rows."""
    rng = np.random.RandomState(seed)
    rb = np.full((N_OUT, k), N_IN)
    for t in range(k):
        rows = rng.choice(N_OUT, int(N_OUT * 0.6), replace=False)
        rb[rows, t] = rng.choice(N_IN, len(rows), replace=False)
    rb[rng.choice(N_OUT, 50, replace=False)] = N_IN
    return rb


# the convs whose f32 input gradient (and forward comparison entry) take the
# 3xTF32 tile, as (conv Cin, conv Cout, taps): every pair of the plan with
# 16-64 channels, K 27, and the last down conv's 3 taps
TF32_CONVS = [(cin, cout, 27) for cin, cout in sc.FWD_PAIRS
              if cin in sc.MMA_CHANNELS and cout in sc.MMA_CHANNELS] + \
    [(64, 64, 3)]
IDS = [f"{a}x{b}x{c}" for a, b, c in TF32_CONVS]


def _inputs(cin, cout, k):
    rng = np.random.RandomState(cin * 7 + cout + k)
    rb = _rulebook(k, seed=cin + cout + k)
    feats = rng.randn(N_IN, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    dout = rng.randn(N_OUT, cout).astype(np.float32)
    return feats, rb, w2, dout


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("cin,cout,k", TF32_CONVS, ids=IDS)
def test_three_pass_forward_holds_the_f32_bound_and_one_pass_does_not(
        cin, cout, k):
    """The forward's 3xTF32 arithmetic (the comparison entry's; the f32
    training forward keeps the scalar tile) against JAX's plain conv."""
    feats, rb, w2, _ = _inputs(cin, cout, k)
    want = np.array(sparse_conv_apply(jnp.asarray(feats), jnp.asarray(rb),
                                      jnp.asarray(w2),
                                      jnp.ones(N_OUT, bool)))
    t = torch.from_numpy
    three = kt.gather_gemm_tf32(t(feats), t(rb), t(w2)).numpy()
    one = kt.gather_gemm_tf32(t(feats), t(rb), t(w2), passes=1).numpy()
    twin = kt.sparse_conv_fwd(t(feats), t(rb), t(w2)).numpy()
    assert _rel(three, want) <= BOUND and _rel(three, twin) <= BOUND
    assert _rel(twin, want) <= BOUND
    assert _rel(one, want) > BOUND and _rel(one, twin) > BOUND
    assert not three[(rb == N_IN).all(1)].any()  # all-miss rows stay 0


@pytest.mark.parametrize("cin,cout,k", TF32_CONVS, ids=IDS)
def test_three_pass_input_gradient_holds_the_f32_bound_and_one_pass_does_not(
        cin, cout, k):
    """dFeat's tile: the gather of dout over the inverse rulebook with W^T,
    each split as the forward's operands, against JAX's input gradient of
    its plain conv."""
    feats, rb, w2, dout = _inputs(cin, cout, k)
    assert sc.conv_instance("sparse_conv_dfeat", torch.float32, cout,
                            cin) == "tf32"
    _, vjp = jax.vjp(lambda x: sparse_conv_apply(
        x, jnp.asarray(rb), jnp.asarray(w2), jnp.ones(N_OUT, bool)),
        jnp.asarray(feats))
    want = np.array(vjp(jnp.asarray(dout))[0])
    t = torch.from_numpy
    inv = tsp.inverse_rulebook(t(rb), N_IN)
    wt = t(w2).transpose(1, 2)
    three = kt.gather_gemm_tf32(t(dout), inv, wt).numpy()
    one = kt.gather_gemm_tf32(t(dout), inv, wt, passes=1).numpy()
    twin = kt.sparse_conv_dfeat(t(dout), inv, t(w2)).numpy()
    assert _rel(three, want) <= BOUND and _rel(three, twin) <= BOUND
    assert _rel(twin, want) <= BOUND
    assert _rel(one, want) > BOUND and _rel(one, twin) > BOUND


def test_model_order_and_rounding_are_the_kernels():
    """The tile issues, per k8 step, lo_a hi_b, hi_a lo_b, hi_a hi_b into
    a per-tap partial added into the running sum (the model's order) and
    rounds both parts with cvt.rna; the f32 dispatch takes the tile in
    the forward, dFeat and both serving convs, and dW its own 3xTF32 body
    (tests/test_torch_tf32_dw.py parses it)."""
    text = (CSRC / "gather_mma.cuh").read_text()
    body = text[text.index("if constexpr (kTf32) {\n        split_tap"):]
    body = body[:body.index("wgmma.commit_group")]
    pairs = re.findall(r"WgmmaTf32<COUT>::mma\(\s*part, wgmma_desc\((\w+) "
                       r"\+ s \* 256[^;]*?wgmma_desc\((\w+) \+ s \* 256",
                       body, re.S)
    assert pairs == [("al", "bh"), ("a_s", "bl"), ("a_s", "bh")]
    for name, part in (("al", "a_lo"), ("bh", "b_hi"), ("bl", "b_lo")):
        assert f"const uint32_t {name} = smem_u32({part});" in body
    # each tap's partial starts from zero and joins the running sum after
    tail = text[text.index("fence_accumulators(part);"):]
    assert "for (int i = 0; i < COUT / 2; ++i) part[i] = 0.f;" in body
    assert tail.index("acc[i] += part[i];") < tail.index("} else if")
    assert "k8" in text and "cvt.rna.tf32.f32" in text
    for path, kernel, takes in (
            ("sparse_conv_train.cu", "sparse_conv_fwd_kernel", True),
            ("sparse_conv_train.cu", "sparse_conv_dfeat_kernel", True),
            ("sparse_conv_train.cu", "sparse_conv_dw_partial_kernel", True),
            ("sparse_conv.cu", "fused_sparse_conv_kernel", True),
            ("sparse_conv_stream.cu", "fused_sparse_conv_stream_kernel",
             True)):
        src = (CSRC / path).read_text()
        kbody = src[src.index(kernel + "("):]
        kbody = kbody[:kbody.index("\n}\n")]
        assert ("sessd::kTf32Tile<T, CIN, COUT>" in kbody) == takes, kernel
    train = (CSRC / "sparse_conv_train.cu").read_text()
    kbody = train[train.index("sparse_conv_fwd_kernel("):]
    assert "sessd::gather_mma_tile<IdxT, CIN, COUT, false>(" in \
        kbody[:kbody.index("\n}\n")]
