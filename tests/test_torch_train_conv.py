"""The trainable sparse conv (``sessd_torch.ops.sparse.SparseConvFunction``)
against the JAX package: its forward and both gradients, computed on the CPU
through the kernels' twins (K4 forward, K5 input gradient over the inverse
rulebook, K5 weight gradient), held against ``windowed_conv`` with the
Pallas core in interpret mode and ``jax.grad`` through its custom VJP, and
against ``jax.grad`` of the plain ``sparse_conv_apply``. Every (Cin, Cout, K)
of the training plans, int16 and int32 chains. Tolerance atol 3e-4, rtol
1e-3 (f32 sums in another order). Also: gradcheck in f64, and the inverse
rulebook's properties. The kernels themselves run only on a CUDA device:
tests/test_torch_kernels_cuda.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops import sparse as jsp
from sessd_tpu.ops.pallas.wconv import windowed_conv
from sessd_torch.ops import sparse as tsp
from sessd_torch.ops.cuda import sparse_conv_train as kt
from tests.test_torch_common import CAPS, as_int16, host_inputs, to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

# (name, Cin, Cout, rulebook kind, chain index, n_in) of the training plans
TRAIN_CONVS = [
    ("subm0_a", 4, 16, "subm", 0, CAPS[0]),
    ("subm0_b", 16, 16, "subm", 0, CAPS[0]),
    ("down0", 16, 32, "down", 0, CAPS[0]),
    ("subm1", 32, 32, "subm", 1, CAPS[1]),
    ("down1", 32, 64, "down", 1, CAPS[1]),
    ("subm2", 64, 64, "subm", 2, CAPS[2]),
    ("down3", 64, 64, "down", 3, CAPS[3]),   # kernel (3, 1, 1): K = 3
]
ATOL, RTOL = 3e-4, 1e-3
WINDOW, BLOCK = 256, 32  # every (block, tap) span of these chains fits


@functools.lru_cache(maxsize=None)
def chain():
    return host_inputs(seed=1, b=2)[3]


def _inputs(case, seed=0):
    name, cin, cout, kind, i, n_in = case
    rng = np.random.RandomState(seed)
    rb = np.asarray(chain()[kind][i], np.int32)
    n_in *= 2  # batch 2
    k = rb.shape[1]
    ids = chain()["ids"][i + (kind == "down")]
    out_mask = ids < np.iinfo(np.int32).max
    feats = rng.randn(n_in, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    cot = rng.randn(rb.shape[0], cout).astype(np.float32)
    return feats, rb, w2, out_mask, cot


@functools.lru_cache(maxsize=None)
def jax_reference(case):
    """(out, dfeat, dw) of windowed_conv (Pallas core, interpret mode) and
    of the plain sparse_conv_apply, for a loss sum(out * cot)."""
    feats, rb, w2, mask, cot = _inputs(case)

    def run(conv):
        def loss(x, w):
            y = conv(x, jnp.asarray(rb), w, jnp.asarray(mask))
            return jnp.sum(y * cot), y
        (_, y), (gx, gw) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            jnp.asarray(feats), jnp.asarray(w2))
        return tuple(np.array(a) for a in (y, gx, gw))

    pallas = run(functools.partial(windowed_conv, window=WINDOW, block=BLOCK,
                                   interpret=True))
    plain = run(jsp.sparse_conv_apply)
    return pallas, plain


def _span_fits(rb, n_in):
    """windowed_conv's own span check: the Pallas core runs, not its
    gather fallback."""
    n_pad = -(-rb.shape[0] // BLOCK) * BLOCK
    r = np.full((n_pad, rb.shape[1]), n_in)
    r[:rb.shape[0]] = rb
    blocks = r.T.reshape(rb.shape[1], -1, BLOCK)
    valid = blocks < n_in
    lo = np.where(valid, blocks, 1 << 30).min(-1) & ~127
    hi = np.where(valid, blocks, -1).max(-1)
    return bool(np.all(np.where(valid.any(-1), hi - lo < WINDOW, True)))


def port_run(case, idx_dtype):
    feats, rb, w2, mask, cot = _inputs(case)
    rb_t = to_torch(rb).to(idx_dtype)
    x = to_torch(feats).requires_grad_(True)
    w = to_torch(w2).requires_grad_(True)
    inv = tsp.inverse_rulebook(rb_t, x.shape[0])
    y = tsp.SparseConvFunction.apply(x, w, rb_t, to_torch(mask), inv)
    (y * to_torch(cot)).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("case", TRAIN_CONVS, ids=[c[0] for c in TRAIN_CONVS])
def test_sparse_conv_function_matches_jax(case, idx_dtype):
    feats, rb, *_ = _inputs(case)
    assert _span_fits(rb, feats.shape[0])
    got = port_run(case, idx_dtype)
    pallas, plain = jax_reference(case)
    for name, g, p, q in zip(("out", "dfeat", "dw"), got, pallas, plain):
        np.testing.assert_allclose(g, p, atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(g, q, atol=ATOL, rtol=RTOL, err_msg=name)
    assert np.abs(got[1]).max() > 0 and np.abs(got[2]).max() > 0


def test_masked_rows_give_no_gradient():
    """Rows outside out_mask are zero in the forward and pass no gradient,
    whatever the cotangent holds there."""
    case = TRAIN_CONVS[2]
    feats, rb, w2, mask, cot = _inputs(case)
    mask = mask.copy()
    mask[::3] = False
    rb_t = to_torch(rb)
    grads = []
    for c in (cot, np.where(mask[:, None], cot, 1e3).astype(np.float32)):
        x = to_torch(feats).requires_grad_(True)
        w = to_torch(w2).requires_grad_(True)
        y = tsp.SparseConvFunction.apply(x, w, rb_t, to_torch(mask), None)
        assert not y[~to_torch(mask)].any()
        (y * to_torch(c)).sum().backward()
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gradcheck_twin_path_f64():
    rng = np.random.RandomState(3)
    n_in, n_out, k, cin, cout = 20, 15, 5, 3, 4
    rb = np.full((n_out, k), n_in)
    for t in range(k):  # injective per tap, with misses
        rows = rng.choice(n_out, 10, replace=False)
        rb[rows, t] = rng.choice(n_in, 10, replace=False)
    rb_t = torch.from_numpy(rb).to(torch.int32)
    mask = torch.from_numpy(rng.rand(n_out) > 0.2)
    x = torch.randn(n_in, cin, dtype=torch.float64, requires_grad=True)
    w = torch.randn(k, cin, cout, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, w: tsp.SparseConvFunction.apply(x, w, rb_t, mask, None),
        (x, w))


@pytest.mark.parametrize("kind,i", [("subm", 0), ("subm", 1), ("subm", 2),
                                    ("subm", 3), ("down", 0), ("down", 1),
                                    ("down", 2), ("down", 3)])
def test_inverse_rulebook(kind, i):
    rb = chain()[kind][i]
    n_in = 2 * CAPS[i]
    for rbk in (rb, as_int16({"ids": None, kind: [rb]})[kind][0]):
        inv = tsp.inverse_rulebook(to_torch(rbk), n_in).numpy()
        assert inv.dtype == rbk.dtype and inv.shape == (n_in, rb.shape[1])
        n, t = np.nonzero(rb < n_in)
        # inv undoes rb, and has one entry per rulebook hit (injective taps)
        np.testing.assert_array_equal(inv[rb[n, t], t], n)
        assert (inv < rb.shape[0]).sum() == len(n)
    if kind == "subm":
        # mirror symmetry of submanifold rulebooks on the valid rows
        valid = chain()["ids"][i] < np.iinfo(np.int32).max
        inv = tsp.inverse_rulebook(to_torch(rb), n_in).numpy()
        np.testing.assert_array_equal(inv[valid], rb[valid, ::-1])


def test_wrappers_take_twins_on_cpu():
    feats, rb, w2, mask, cot = _inputs(TRAIN_CONVS[1])
    args = to_torch(feats), to_torch(rb), to_torch(w2)
    fns = (kt.sparse_conv_fwd, kt.sparse_conv_dfeat, kt.sparse_conv_dw)
    before = [fn.launches for fn in fns]
    out = kt.sparse_conv_fwd(*args, to_torch(mask))
    inv = tsp.inverse_rulebook(args[1], feats.shape[0])
    dfeat = kt.sparse_conv_dfeat(out, inv, args[2])
    assert torch.equal(dfeat, kt.sparse_conv_dfeat_ref(out, inv, args[2]))
    kt.sparse_conv_dw(args[0], args[1], out)
    assert [fn.launches for fn in fns] == before
    with pytest.raises(ValueError, match="no kernel for device"):
        kt.sparse_conv_fwd(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="no kernel for device"):
        kt.sparse_conv_dfeat(*(a.to("meta") for a in (out, inv, args[2])))
