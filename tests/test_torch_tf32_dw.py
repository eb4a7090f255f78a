"""The f32 weight gradient and the f32 streaming conv on the tensor cores
through 3xTF32, from the CPU:

- dW's body (``dw_mma_partial`` in ``sessd_torch/csrc/sparse_conv_train.cu``
  for f32 at Cin, Cout in {16, 32, 64}, ``mma.sync`` m16n8k8) through its
  plain model ``ops.cuda.sparse_conv_train.dw_tf32`` (each (chunk, tap)'s
  hit rows compacted in order into 64-row steps, the split, the order of
  products, the partial per step, the warps' k-slice groups, the ordered
  chunk sums): within 1e-4 of max|reference| of the JAX weight
  gradient (``jax.vjp`` of ``sessd_tpu.ops.sparse.sparse_conv_apply`` with
  respect to the weights) and of the port's twin ``sparse_conv_dw_ref``, at
  the default chunk and at one step per chunk; one TF32 pass misses that
  bound (the 1-pass test);
- K3's f32 body (``gather_mma.cuh``'s 3xTF32 tile with the EPI store)
  through ``gather_gemm_tf32`` + bias + ReLU + the any-hit mask against
  JAX's plain conv with the same epilogue;
- the dW body's order of products, rounding and per-step partials parsed
  from the source, and its warp split against ``dw_warp_split``;
- ``conv_instance``: "tf32" for f32 dW, K1, K3 and K4 at 16-64 channels,
  "direct" for the 4-channel first conv.

The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py holds them against their twins, their
old bodies and these models).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.sparse import sparse_conv_apply
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from tests.test_torch_tf32_split import (BOUND, CSRC, IDS, N_IN, N_OUT,
                                         TF32_CONVS, _inputs, _rel)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

# dW's bound against its twin and the JAX gradient is the f32 kernels'
# 1e-4: the model keeps ~21 mantissa bits of each product and sums in f32
DW_BOUND = BOUND


@pytest.fixture(scope="module")
def jax_dw():
    """JAX's weight gradient of its plain conv, per conv of TF32_CONVS."""
    cache = {}

    def get(cin, cout, k):
        if (cin, cout, k) not in cache:
            feats, rb, w2, dout = _inputs(cin, cout, k)
            _, vjp = jax.vjp(lambda w: sparse_conv_apply(
                jnp.asarray(feats), jnp.asarray(rb), w,
                jnp.ones(N_OUT, bool)), jnp.asarray(w2))
            cache[cin, cout, k] = np.array(vjp(jnp.asarray(dout))[0])
        return cache[cin, cout, k]

    return get


@pytest.mark.parametrize("cin,cout,k", TF32_CONVS, ids=IDS)
def test_dw_model_holds_the_f32_bound(cin, cout, k, jax_dw):
    feats, rb, _, dout = _inputs(cin, cout, k)
    assert sc.conv_instance("sparse_conv_dw", torch.float32, cin,
                            cout) == "tf32"
    t = torch.from_numpy
    want = jax_dw(cin, cout, k)
    twin = kt.sparse_conv_dw_ref(t(feats), t(rb), t(dout)).numpy()
    model = kt.dw_tf32(t(feats), t(rb), t(dout)).numpy()
    assert model.shape == (k, cin, cout)
    assert _rel(model, want) <= DW_BOUND and _rel(model, twin) <= DW_BOUND
    assert _rel(twin, want) <= DW_BOUND


@pytest.mark.parametrize("cin,cout,k", TF32_CONVS, ids=IDS)
def test_dw_model_at_one_step_per_chunk(cin, cout, k, jax_dw):
    """A chunk of 64 rows (40 chunks here, each one step): every partial
    is one step's, and the ordered chunk sum carries the rest."""
    feats, rb, _, dout = _inputs(cin, cout, k)
    t = torch.from_numpy
    model = kt.dw_tf32(t(feats), t(rb), t(dout), chunk_rows=64).numpy()
    assert _rel(model, jax_dw(cin, cout, k)) <= DW_BOUND


@pytest.mark.parametrize("cin,cout,k", TF32_CONVS, ids=IDS)
def test_one_pass_dw_misses_the_f32_bound(cin, cout, k, jax_dw):
    """The single TF32 product hi_a hi_b per slice (one pass) misses the
    1e-4 that three passes hold: why the body runs three."""
    feats, rb, _, dout = _inputs(cin, cout, k)
    t = torch.from_numpy
    one = kt.dw_tf32(t(feats), t(rb), t(dout), passes=1).numpy()
    assert _rel(one, jax_dw(cin, cout, k)) > DW_BOUND


@pytest.mark.parametrize("cin,cout,k", TF32_CONVS, ids=IDS)
def test_k3_f32_model_with_epilogue_against_jax(cin, cout, k):
    """f32 K3's arithmetic: the 3xTF32 gather-GEMM, then bias, ReLU and
    zero where no tap of the row hits, against JAX's plain conv with the
    same epilogue."""
    feats, rb, w2, _ = _inputs(cin, cout, k)
    bias = (np.random.RandomState(k).randn(cout) * 0.3).astype(np.float32)
    assert sc.conv_instance("fused_sparse_conv_stream", torch.float32, cin,
                            cout) == "tf32"
    conv = np.array(sparse_conv_apply(jnp.asarray(feats), jnp.asarray(rb),
                                      jnp.asarray(w2),
                                      jnp.ones(N_OUT, bool)))
    hit = (rb != N_IN).any(1, keepdims=True)
    want = np.where(hit, np.maximum(conv + bias, 0.0), 0.0)
    t = torch.from_numpy
    acc = kt.gather_gemm_tf32(t(feats), t(rb), t(w2))
    model = torch.where(t(hit), torch.relu(acc + t(bias)), 0.0).numpy()
    twin = sc.fused_sparse_conv_ref(t(feats), t(rb), t(w2), t(bias),
                                    N_IN).numpy()
    assert _rel(model, want) <= BOUND and _rel(model, twin) <= BOUND
    assert not model[~hit[:, 0]].any() and (model >= 0).all()


def _dw_body() -> str:
    text = (CSRC / "sparse_conv_train.cu").read_text()
    body = text[text.index("if constexpr (L::kTf32) {\n      // A = G^T"):]
    return body[:body.index("} else {")]


def test_dw_model_order_and_rounding_are_the_kernels():
    """Per k8 slice the body issues lo_a hi_b, hi_a lo_b, hi_a hi_b into a
    partial of the step that starts from zero and joins the running sum
    after the step's slices, splits both operands with cvt.rna, and
    deals the slices to kWk groups of warps as ``dw_warp_split`` says."""
    body = _dw_body()
    calls = re.findall(r"mma_tf32_1688\(part\[m\]\[n\], (\w+)\[m\], "
                       r"(\w+)\[0\], (\w+)\[1\]\);", body)
    assert calls == [("a_lo", "b_hi", "b_hi"), ("a_hi", "b_lo", "b_lo"),
                     ("a_hi", "b_hi", "b_hi")]
    assert "for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;" in body
    assert body.index("part[m][n][e] = 0.f;") < body.index(
        "for (int j = 0; j < L::kSlices / L::kWk; ++j) {") < body.index(
        "const int kk = wk + j * L::kWk;") < body.index(
        "acc[m][n][e] += part[m][n][e];")
    text = (CSRC / "sparse_conv_train.cu").read_text()
    split = text[text.index("void split_tf32_u32("):]
    split = split[:split.index("\n}\n")]
    assert "sessd::tf32_rna(x)" in split and "tf32_rna(x - h)" in split
    assert "cvt.rna.tf32.f32" in (CSRC / "gather_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    # the slices of a step and the warp split the model follows
    assert "kSliceRows = kTf32 ? 8 : 16;" in text
    assert kt.TF32_DEPTH == 8 and sc.TILE_ROWS == 64
    assert "kWm = CIN / 16 < 2 ? CIN / 16 : 2;" in text
    assert "kWn = COUT / 16 < 2 ? COUT / 16 : 2;" in text
    assert "kWk = kWarps / (kWm * kWn);" in text
    assert f"kWarps = kTf32 ? {kt.DW_TF32_WARPS} : 4;" in text
    assert [kt.dw_warp_split(a, b) for a, b in sc.DW_PAIRS if a != 4] == \
        [8, 4, 2, 2, 2]
    # the groups' tiles and the chunks are summed in order
    assert "for (int w = 1; w < L::kWk; ++w) v += red[w * CIN * COUT + e];" \
        in text
    assert "for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * size " \
        "+ e];" in text


def test_dw_model_sums_groups_and_chunks_in_order():
    """With exactly representable inputs every order gives the same sum:
    the model equals the twin bit for bit there, whatever its grouping."""
    rng = np.random.RandomState(7)
    rb = rng.randint(0, 301, (700, 27))
    feats = rng.randint(-4, 5, (300, 16)).astype(np.float32)
    dout = rng.randint(-4, 5, (700, 32)).astype(np.float32)
    t = torch.from_numpy
    for chunk in (64, 256, 2048):
        got = kt.dw_tf32(t(feats), t(rb), t(dout), chunk_rows=chunk)
        assert torch.equal(got, kt.sparse_conv_dw_ref(t(feats), t(rb),
                                                      t(dout)))
    with pytest.raises(ValueError, match="passes"):
        kt.dw_tf32(t(feats), t(rb), t(dout), passes=2)


@pytest.mark.parametrize("entry", ["sparse_conv_dw",
                                   "fused_sparse_conv_stream",
                                   "fused_sparse_conv", "sparse_conv_fwd"])
def test_conv_instance_names_the_f32_bodies(entry):
    """f32 dW, K3, K1 and K4 take their 3xTF32 bodies at 16-64 channels;
    every 4-channel instance takes the direct body."""
    for cin, cout in sc._PAIRS[entry]:
        got = sc.conv_instance(entry, torch.float32, cin, cout)
        if 4 in (cin, cout):
            assert got == "direct", (cin, cout)
        else:
            assert got == "tf32", (cin, cout)
        assert sc.conv_instance(entry, torch.bfloat16, cin, cout) == (
            "direct" if 4 in (cin, cout) else "mma")
