"""Fused sparse conv (sessd_torch/ops/cuda/sparse_conv.py) against the JAX
package: its plain twin vs the Pallas ``fused_conv_affine_t`` in interpret
mode and vs the plain gather ``sparse_conv_apply``, for every (Cin, Cout, K)
of the backbone plan, with int16 and int32 rulebooks. Tolerance atol 3e-4,
rtol 1e-3 (f32 sums in another order; the Pallas one-hot GEMM rounds its
gathered operand through the MXU path). The kernel itself runs only on a
CUDA device: tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops import sparse as jsp
from sessd_tpu.ops.pallas.wconv import (cols_for, fused_conv_affine_t,
                                        prep_rulebook)
from sessd_torch.ops import sparse as tsp
from sessd_torch.ops.cuda import sparse_conv as sc
from tests.test_torch_common import CAPS, as_int16, host_inputs, to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

# (name, Cin, Cout, rulebook kind, chain index, n_in) of the backbone plan
PLAN_CONVS = [
    ("subm0_a", 4, 16, "subm", 0, CAPS[0]),
    ("subm0_b", 16, 16, "subm", 0, CAPS[0]),
    ("down0", 16, 32, "down", 0, CAPS[0]),
    ("subm1", 32, 32, "subm", 1, CAPS[1]),
    ("down1", 32, 64, "down", 1, CAPS[1]),
    ("subm2", 64, 64, "subm", 2, CAPS[2]),
    ("down3", 64, 64, "down", 3, CAPS[3]),   # kernel (3, 1, 1): K = 3
]


@pytest.fixture(scope="module")
def chain():
    return host_inputs(seed=1)[3]


def _conv_inputs(chain, case, seed=0):
    name, cin, cout, kind, i, n_in = case
    rng = np.random.RandomState(seed)
    rb = np.asarray(chain[kind][i], np.int32)
    k = rb.shape[1]
    # one all-miss row past the chain's own (a saturated stage has none)
    rb = np.concatenate([rb, np.full((1, k), n_in, np.int32)])
    feats = rng.randn(n_in, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.randn(cout) * 0.3).astype(np.float32)
    return feats, rb, w2, bias, n_in


@pytest.fixture(scope="module")
def pallas_outputs(chain):
    """fused_conv_affine_t (interpret mode) per plan conv, computed once."""
    out = {}
    for case in PLAN_CONVS:
        feats, rb, w2, bias, n_in = _conv_inputs(chain, case)
        cols_in = cols_for(n_in)
        feats_t = jnp.zeros((feats.shape[1], cols_in)).at[:, :n_in].set(
            feats.T)
        prep = prep_rulebook(jnp.asarray(rb), n_in, cols_in, window=cols_in)
        w2t = jnp.asarray(w2.reshape(-1, w2.shape[-1]).T)
        y_t = fused_conv_affine_t(feats_t, *prep, w2t,
                                  jnp.asarray(bias)[:, None], n_in,
                                  window=cols_in, relu=True, interpret=True)
        out[case[0]] = np.asarray(y_t[:, :rb.shape[0]].T)
    return out


def _twin(feats, rb, w2, bias, n_in, idx_dtype):
    return sc.fused_sparse_conv_ref(
        to_torch(feats), to_torch(rb.astype(idx_dtype)), to_torch(w2),
        to_torch(bias), n_in).numpy()


@pytest.mark.parametrize("idx_dtype", [np.int16, np.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("case", PLAN_CONVS, ids=[c[0] for c in PLAN_CONVS])
def test_twin_matches_pallas_fused(chain, pallas_outputs, case, idx_dtype):
    feats, rb, w2, bias, n_in = _conv_inputs(chain, case)
    got = _twin(feats, rb, w2, bias, n_in, idx_dtype)
    np.testing.assert_allclose(got, pallas_outputs[case[0]], atol=3e-4,
                               rtol=1e-3)
    # rows with no tap hit stay exactly zero
    miss = (rb == n_in).all(1)
    assert miss[-1] and not np.any(got[miss])


@pytest.mark.parametrize("case", PLAN_CONVS, ids=[c[0] for c in PLAN_CONVS])
def test_twin_matches_gather_conv(chain, case):
    """twin == relu(sparse_conv_apply + bias) under the hit mask, with the
    JAX and the port's sparse_conv_apply agreeing as well."""
    feats, rb, w2, bias, n_in = _conv_inputs(chain, case)
    hit = (rb != n_in).any(1)
    want = np.asarray(jsp.sparse_conv_apply(
        jnp.asarray(feats), jnp.asarray(rb), jnp.asarray(w2),
        jnp.asarray(hit)))
    port = tsp.sparse_conv_apply(to_torch(feats), to_torch(rb), to_torch(w2),
                                 to_torch(hit)).numpy()
    np.testing.assert_allclose(port, want, atol=3e-4, rtol=1e-3)
    ref = np.where(hit[:, None], np.maximum(want + bias, 0.0), 0.0)
    np.testing.assert_allclose(_twin(feats, rb, w2, bias, n_in, np.int32),
                               ref, atol=3e-4, rtol=1e-3)


def test_wrapper_takes_twin_on_cpu(chain):
    feats, rb, w2, bias, n_in = _conv_inputs(chain, PLAN_CONVS[2])
    args = (to_torch(feats), to_torch(rb.astype(np.int16)), to_torch(w2),
            to_torch(bias), n_in)
    before = sc.fused_sparse_conv.launches
    got = sc.fused_sparse_conv(*args, relu=False)
    assert torch.equal(got, sc.fused_sparse_conv_ref(*args, relu=False))
    assert sc.fused_sparse_conv.launches == before  # no kernel on the CPU
    assert (got < 0).any()  # relu=False keeps negatives


def test_int16_chain_equals_int32(chain):
    """The transfer-compressed chain is the same chain."""
    c16 = as_int16(chain)
    for kind in ("subm", "down"):
        for a, b in zip(chain[kind], c16[kind]):
            assert b.dtype == np.int16 and np.array_equal(a, b)
