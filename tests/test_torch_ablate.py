"""The micro-benchmark kernels' plain versions on the CPU
(sessd_torch/ops/cuda/ablate.py): S1's ``full`` mode against the JAX
package's Pallas conv (``windowed_conv`` in interpret mode, which runs the
Pallas ``_fwd_kernel`` that ``scripts/bench_wconv_ablate.py`` ablates) at a
few hundred rows with a sorted rulebook, 16 -> 16 channels, f32, within
1e-5; every other mode of the scalar tile's copy and every mode of the
tensor-core tile (16 and 64 channels, with an all-miss tile) against its
definition written out in numpy (f64) within 1e-5 relative; the benchmark's
difference tables and its batch-1 chain inputs; the wrappers' contracts
(CPU tensors take the plain version, other devices raise); the empty
kernel's plain version is zeros. The kernels themselves run only on the
card (tests/test_torch_kernels_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.pallas.wconv import windowed_conv
from sessd_torch.ops.cuda import ablate
from sessd_torch.scripts import bench_launch_overhead as bench_launch
from sessd_torch.scripts import bench_sparse_conv_ablate as bench
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

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


def test_scalar_tile_sum_matches_definition():
    """The scalar tile's in-order sum (the card's oracle of S1's ``full``
    bits) is the gather-GEMM, misses as zero rows."""
    feats, rb, w2 = _inputs(2)
    rb[::5, 7] = N
    got = ablate.scalar_tile_sum(*_torch(feats, rb, w2))
    assert got.dtype == torch.float32 and got.shape == (NPAD, C)
    np.testing.assert_allclose(got.numpy(), _definition(feats, rb, w2,
                                                        "full"),
                               rtol=1e-5, atol=1e-5)


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


def _mma_inputs(c, seed=2):
    """A sorted rulebook with misses and one all-miss 64-row tile, C -> C."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, c).astype(np.float32)
    rb = np.sort(rng.randint(0, N - 1, (K, NPAD)), axis=1).T.astype(np.int32)
    rb[::5, 7] = N
    rb[64:128] = N
    w2 = (rng.randn(K, c, c) / np.sqrt(K * c)).astype(np.float32)
    return feats, np.ascontiguousarray(rb), w2


def _mma_definition(feats, rb, w2, mode):
    """Each tensor-core mode written out row by row in f64."""
    n_out, taps = rb.shape
    x = feats.astype(np.float64)
    w = w2.astype(np.float64)
    c = w.shape[2]
    out = np.zeros((n_out, c))
    if mode in ("copy_only", "fixed"):
        return out
    x = np.concatenate([x, np.zeros((1, x.shape[1]))])  # row N: a miss
    for n in range(n_out):
        tile = rb[n // 64 * 64:(n // 64 + 1) * 64]
        for k in range(taps):
            src = rb[n, k]
            if mode == "full":
                out[n] += x[src] @ w[k]
            elif mode == "linear":
                out[n] += x[min(n, N)] @ w[k]
            elif mode == "no_gather":
                out[n] += x[0 if src < N else N] @ w[k]
            elif (tile[:, k] < N).any():  # mma_only: per tap the tile hits
                out[n] += x[rb[n, 0]] @ w[0]
    return out


@pytest.mark.parametrize("c", ablate.MMA_CHANNELS)
@pytest.mark.parametrize("mode", list(ablate.MMA_MODES))
def test_mma_mode_plain_matches_definition(mode, c):
    feats, rb, w2 = _mma_inputs(c)
    before = ablate.sparse_conv_ablate_mma.launches
    got = ablate.sparse_conv_ablate_mma(*_torch(feats, rb, w2), mode)
    want = _mma_definition(feats, rb, w2, mode)
    assert got.dtype == torch.float32 and got.shape == (NPAD, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert ablate.sparse_conv_ablate_mma.launches == before  # CPU: no kernel
    if mode == "mma_only":  # the all-miss tile runs no tap
        assert not got[64:128].any() and got[128:].abs().max() > 0


def test_mma_differences_tables():
    """The tensor-core table's differences are the labelled subtractions;
    the chain's leave out the 9-tap variant it does not run."""
    times = {"full": 9.0, "k9": 6.0, "linear": 7.0, "no_gather": 5.0,
             "mma_only": 4.0, "copy_only": 3.0, "fixed": 1.0}
    d = bench.differences(times, bench.MMA_DIFFERENCES)
    assert list(d.values()) == [1.0, 8.0, 2.0, 4.0, 2.0, 3.0, 3.0 / 18]
    assert set(bench.MMA_VARIANTS) == set(times)
    assert {m for m, _ in bench.MMA_VARIANTS.values()} == set(
        ablate.MMA_MODES)
    chain = bench.differences(
        {m: times[m] for m in ablate.MMA_MODES}, bench.MMA_DIFFERENCES_CHAIN)
    assert list(chain.values()) == list(d.values())[:-1]
    f, rb, w2, mode = bench.mma_variant_args(bench.make_inputs("cpu"), "k9")
    assert rb.shape == (bench.NPAD, 9) and w2.shape == (9, 16, 16) and \
        mode == "full"


def test_chain_inputs_are_the_batch1_convs():
    """subm0b, subm3a and down3 of ``make_scene(0)`` at SERVING_CAPS: int32
    rulebooks of the caps' rows (misses = the input stage's cap), bf16
    features and weights of the conv's widths."""
    from sessd_torch.serve import SERVING_CAPS
    chain = bench.chain_inputs("cpu")
    want = {"subm0b": (SERVING_CAPS[0], SERVING_CAPS[0], 27, 16),
            "subm3a": (SERVING_CAPS[3], SERVING_CAPS[3], 27, 64),
            "down3": (SERVING_CAPS[3], SERVING_CAPS[4], 3, 64)}
    assert set(chain) == set(want)
    for name, (feats, rb, w2) in chain.items():
        n_in, n_out, k, c = want[name]
        assert feats.shape == (n_in, c) and feats.dtype == torch.bfloat16
        assert rb.shape == (n_out, k) and rb.dtype == torch.int32
        assert w2.shape == (k, c, c) and w2.dtype == torch.bfloat16
        assert int(rb.min()) >= 0 and int(rb.max()) == n_in
        assert 0 < int((rb < n_in).sum()) < rb.numel()


def test_mma_wrapper_takes_the_plain_version_on_cpu_and_raises_elsewhere():
    feats, rb, w2 = _torch(*_mma_inputs(16))
    bf = feats.to(torch.bfloat16), rb, w2.to(torch.bfloat16)
    before = ablate.sparse_conv_ablate_mma.launches
    assert torch.equal(ablate.sparse_conv_ablate_mma(*bf),
                       ablate.sparse_conv_ablate_mma_ref(*bf, "full"))
    with pytest.raises(ValueError, match="no kernel for device"):
        ablate.sparse_conv_ablate_mma(*(t.to("meta") for t in bf))
    with pytest.raises(ValueError, match="mode"):
        ablate.sparse_conv_ablate_mma_ref(*bf, "fma_only")
    assert ablate.sparse_conv_ablate_mma.launches == before


def test_mma_benches_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (bench.run_mma, bench.run_chain, bench.k1_at_splits):
        with pytest.raises(RuntimeError, match="CUDA device"):
            run()
