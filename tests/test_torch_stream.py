"""The streaming fused sparse conv (``fused_sparse_conv_stream``) against the
JAX package on the CPU.

- Its plain twin against the Pallas ``fused_conv_affine_t(..., stream=True,
  interpret=True)`` at small windows, where over-span blocks are patched:
  ``_fused_stream_kernel`` and ``_patch_stream_kernel`` both run (asserted
  through ``pvalid``), and the port, which has no window, must give the
  same output. Tolerance 2e-4 (f32 sums in another order).
- Which convs stream: the port's choice per conv against the JAX rule
  (``cols_for`` and ``STREAM_FEATS_BYTES`` of ``sessd_tpu/ops/pallas/
  wconv.py``) at batch 1/4/8, f32/bf16, SERVING_CAPS and TRAIN_CAPS, and
  the backbone's forward taking each conv's kernel by that rule.

The kernel itself runs only on a CUDA device:
tests/test_torch_kernels_cuda.py."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.pallas import wconv
from sessd_torch.models import backbone as bb
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.serve import SERVING_CAPS, TRAIN_CAPS
from tests.test_torch_common import CAPS, host_inputs, to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

# (name, Cin, Cout, rulebook kind, chain index, n_in) of the convs that can
# stream: every (Cin, Cout, K) of the plan but the 4-channel first conv
STREAM_CONVS = [
    ("subm0_b", 16, 16, "subm", 0, CAPS[0]),
    ("down0", 16, 32, "down", 0, CAPS[0]),
    ("subm1", 32, 32, "subm", 1, CAPS[1]),
    ("down1", 32, 64, "down", 1, CAPS[1]),
    ("subm2", 64, 64, "subm", 2, CAPS[2]),
    # kernel (3, 1, 1): K = 3; its taps are z-neighbours, adjacent rows of
    # the z-minor order, so the input rows are shuffled (the same conv on
    # renumbered rows) to give it blocks past the window
    ("down3", 64, 64, "down", 3, CAPS[3]),
]
WINDOW = 128  # the smallest window: most blocks' spans pass it


@pytest.fixture(scope="module")
def chain():
    return host_inputs(seed=3)[3]


def _conv_inputs(chain, case, seed=0):
    name, cin, cout, kind, i, n_in = case
    rng = np.random.RandomState(seed)
    rb = np.asarray(chain[kind][i], np.int32)
    k = rb.shape[1]
    feats = rng.randn(n_in, cin).astype(np.float32)
    if name == "down3":
        new = rng.permutation(n_in)  # input row i becomes row new[i]
        feats[new] = feats.copy()
        rb = np.where(rb < n_in, new[np.minimum(rb, n_in - 1)], n_in)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.randn(cout) * 0.3).astype(np.float32)
    return feats, rb, w2, bias, n_in


@pytest.fixture(scope="module")
def pallas_stream_outputs(chain):
    """fused_conv_affine_t through the stream kernels, per conv: the main
    kernel at WINDOW and the patch kernel at the full buffer for every
    over-span block. Returns {name: (out [n_out, Cout], patched blocks)}."""
    out = {}
    for case in STREAM_CONVS:
        feats, rb, w2, bias, n_in = _conv_inputs(chain, case)
        cols_in = wconv.cols_for(n_in)
        feats_t = jnp.zeros((feats.shape[1], cols_in)).at[:, :n_in].set(
            feats.T)
        n_blocks = wconv.cols_for(rb.shape[0]) // 256
        prep = wconv.prep_rulebook(jnp.asarray(rb), n_in, cols_in,
                                   window=WINDOW, window_large=cols_in,
                                   patch_max=n_blocks)
        assert bool(prep[-1]), "span check failed: the slow path would run"
        w2t = jnp.asarray(w2.reshape(-1, w2.shape[-1]).T)
        y_t = wconv.fused_conv_affine_t(
            feats_t, *prep, w2t, jnp.asarray(bias)[:, None], n_in,
            window=WINDOW, window_large=cols_in, relu=True, interpret=True,
            stream=True)
        out[case[0]] = (np.asarray(y_t[:, :rb.shape[0]].T),
                        int(np.asarray(prep[4]).sum()))
    return out


@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("case", STREAM_CONVS,
                         ids=[c[0] for c in STREAM_CONVS])
def test_stream_twin_matches_pallas_stream(chain, pallas_stream_outputs,
                                           case, idx_dtype):
    feats, rb, w2, bias, n_in = _conv_inputs(chain, case)
    want, patched = pallas_stream_outputs[case[0]]
    assert patched > 0  # _patch_stream_kernel ran on over-span blocks
    args = (to_torch(feats), to_torch(rb).to(idx_dtype), to_torch(w2),
            to_torch(bias), n_in)
    before = sc.fused_sparse_conv_stream.launches
    got = sc.fused_sparse_conv_stream(*args).numpy()
    assert sc.fused_sparse_conv_stream.launches == before  # twin on the CPU
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    assert np.abs(want).max() > 0


# (Cin, n_in stage) of the 14 convs in call order
PLAN_INPUTS = ([(4, 0), (16, 0)] + [(16, 0)] + [(32, 1)] * 2 + [(32, 1)]
               + [(64, 2)] * 3 + [(64, 2)] + [(64, 3)] * 3 + [(64, 3)])


def _jax_streams(cin, n_in, dtype):
    itemsize = jnp.dtype(dtype).itemsize
    return cin * wconv.cols_for(n_in) * itemsize > wconv.STREAM_FEATS_BYTES


@pytest.mark.parametrize("batch,dtype,caps", list(itertools.product(
    (1, 4, 8), (torch.float32, torch.bfloat16),
    (SERVING_CAPS, TRAIN_CAPS))))
def test_stream_decision_is_the_jax_rule(batch, dtype, caps):
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    port = [bb.pick_conv(cin, caps[s] * batch, dtype)
            is sc.fused_sparse_conv_stream for cin, s in PLAN_INPUTS]
    want = [_jax_streams(cin, caps[s] * batch, jdtype)
            for cin, s in PLAN_INPUTS]
    assert port == want
    assert sc.STREAM_FEATS_BYTES == wconv.STREAM_FEATS_BYTES
    n = sum(port)
    if (batch, dtype, caps) == (4, torch.float32, TRAIN_CAPS):
        assert n == 11 and not any(port[:3])  # eval: stages 1-3
    if (batch, dtype, caps) == (8, torch.bfloat16, SERVING_CAPS):
        assert port == [False] * 3 + [True] * 7 + [False] * 4  # stages 1-2
    if batch == 1:
        assert n == 0


def test_backbone_forward_takes_the_rule(monkeypatch):
    """With the byte limit lowered so that a tiny chain streams some convs,
    the forward calls the stream kernel exactly on the convs the JAX rule
    picks at that limit, and the resident kernel on the rest."""
    limit = 40 * 1024
    monkeypatch.setattr(sc, "STREAM_FEATS_BYTES", limit)
    calls = []

    def recorder(name, fn):
        def conv(x, rb, w2, bias, n_in):
            calls.append((name, x.shape[1], n_in))
            return fn(x, rb, w2, bias, n_in)
        return conv

    monkeypatch.setattr(bb, "fused_sparse_conv",
                        recorder("resident", sc.fused_sparse_conv))
    monkeypatch.setattr(bb, "fused_sparse_conv_stream",
                        recorder("stream", sc.fused_sparse_conv_stream))
    feats, _, _, rb = host_inputs(seed=0)
    net = bb.SpMiddleFHD()
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        net.eval()(to_torch(feats), {k: ([to_torch(a) for a in v]
                                         if isinstance(v, list)
                                         else to_torch(v))
                                     for k, v in rb.items()},
                   1, (41, 32, 32), torch.float32)
    assert len(calls) == 14
    want = ["stream" if cin * wconv.cols_for(n) * 4 > limit else "resident"
            for _, cin, n in calls]
    assert [c[0] for c in calls] == want
    assert 0 < want.count("stream") < 14
