"""The micro-benchmark kernels' plain versions on the CPU
(sessd_torch/ops/cuda/ablate.py): S1's ``full`` mode against the JAX
package's Pallas conv (``windowed_conv`` in interpret mode, which runs the
Pallas ``_fwd_kernel`` that ``scripts/bench_wconv_ablate.py`` ablates) at a
few hundred rows with a sorted rulebook, 16 -> 16 channels, f32, within
1e-5; every other mode against its definition written out in numpy (f64)
within 1e-5 relative; the empty kernel's plain version is zeros. The
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.pallas.wconv import windowed_conv
from sessd_torch.ops.cuda import ablate
from sessd_torch.scripts import bench_launch_overhead as bench_launch
from sessd_torch.scripts import bench_sparse_conv_ablate as bench

N, NPAD, C, K = 300, 320, 16, 27
WINDOW, BLOCK = 256, 32


def _inputs(seed=0):
    """The TPU script's construction at a small size: features, a rulebook
    sorted per tap (no misses), weights."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, C).astype(np.float32)
    rb = np.sort(rng.randint(0, N - 1, (K, NPAD)), axis=1).T.astype(np.int32)
    w2 = (rng.randn(K, C, C) / np.sqrt(K * C)).astype(np.float32)
    return feats, np.ascontiguousarray(rb), w2


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_full_plain_matches_pallas_interpret():
    feats, rb, w2 = _inputs()
    # every (block, tap) source span fits the window, so windowed_conv
    # takes the Pallas kernel and not its exact gather fallback
    blocks = rb.reshape(NPAD // BLOCK, BLOCK, K)
    lo = blocks.min(axis=1) & ~127
    assert (blocks.max(axis=1) - lo < WINDOW).all()
    want = np.asarray(windowed_conv(
        jnp.asarray(feats), jnp.asarray(rb), jnp.asarray(w2),
        jnp.ones((NPAD,), bool), window=WINDOW, block=BLOCK,
        interpret=True))
    got = ablate.sparse_conv_ablate_ref(*_torch(feats, rb, w2), "full")
    assert got.dtype == torch.float32 and got.shape == (NPAD, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _definition(feats, rb, w2, mode):
    """Each mode written out row by row in f64."""
    n_out, taps = rb.shape
    x = feats.astype(np.float64)
    w = w2.astype(np.float64)
    out = np.zeros((n_out, C))
    for n in range(n_out):
        for k in range(taps):
            if mode == "full":
                src = rb[n, k]
                row = x[src] if src < N else np.zeros(C)
                out[n] += row @ w[k]
            elif mode == "linear":
                row = x[n] if n < N else np.zeros(C)
                out[n] += row @ w[k]
            elif mode == "no_gather":
                hit = 0 <= rb[n, k] < N
                out[n] += hit * ablate.NO_GATHER_VALUE * w[k].sum(axis=0)
            else:  # fma_only: tap 0's rows and weights, every tap
                row = x[n] if n < N else np.zeros(C)
                out[n] += row @ w[0]
    return out


@pytest.mark.parametrize("variant", ["full", "k9", "linear", "no_gather",
                                     "fma_only"])
def test_mode_plain_matches_definition(variant):
    feats, rb, w2 = _inputs(1)
    rb[::7, 3] = N  # some misses
    mode, taps = bench.VARIANTS[variant]
    rb = np.ascontiguousarray(rb[:, :taps])
    w2 = np.ascontiguousarray(w2[:taps])
    got = ablate.sparse_conv_ablate(*_torch(feats, rb, w2), mode)
    want = _definition(feats, rb, w2, mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert ablate.sparse_conv_ablate.launches == 0  # CPU: no kernel


def test_empty_plain_is_zeros():
    out = torch.ones((NPAD, C), dtype=torch.bfloat16)
    assert not ablate.empty_launch_ref(out).any() and out.all()
    assert ablate.empty_launch(out, 256) is out and not out.any()
    out.fill_(1)
    ablate.empty_launch_repeat(out, 512, 3)
    assert not out.any() and ablate.empty_launch.launches == 0


def test_bench_inputs_and_differences():
    """The benchmark's arrays have the TPU script's shapes in the port's
    layouts, and its differences are the labelled subtractions."""
    x = bench.make_inputs("cpu")
    assert x["feats"].shape == (bench.N, 16) and x["rb"].shape == (
        bench.NPAD, bench.K) and x["w2"].shape == (bench.K, 16, 16)
    assert x["rb"].dtype == torch.int32 and x["feats"].dtype == torch.bfloat16
    assert bool((x["rb"][1:] >= x["rb"][:-1]).all())  # sorted per tap
    f, rb9, w9, mode = bench.variant_args(x, "k9")
    assert rb9.shape == (bench.NPAD, 9) and rb9.is_contiguous() and \
        w9.shape == (9, 16, 16) and mode == "full"
    times = {"full": 5.0, "k9": 2.0, "linear": 4.0, "no_gather": 3.0,
             "fma_only": 1.0}
    d = bench.differences(times)
    assert list(d.values()) == [1.0, 2.0, 3.0, 1.0, 3.0 / 18]


def test_benches_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.run()
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench_launch.run()
