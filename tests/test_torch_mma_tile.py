"""The tensor-core gather tile of the bf16 training forward (K4) and the bf16
streaming serving conv (K3), ``sessd_torch/csrc/gather_mma.cuh``, from the
CPU:

- ``ops.sparse.tile_tap_hits``, the per-(tile, tap) any-hit flags that
  decide which taps the tile gathers and multiplies, against a numpy loop
  on random rulebooks (ragged last tile, all-miss tiles, K = 3 and 27) and
  on the host chains of ``native.build_rulebooks``;
- the tile's arithmetic with the skipped taps left out, written out in
  torch, against the JAX package's ``windowed_conv`` (the Pallas
  ``_fwd_kernel`` in interpret mode) on those chains: a tap that no row of a
  tile hits adds zero, so the sum is the same (atol 3e-4, rtol 1e-3: f32
  sums in another order);
- ``ops.cuda.sparse_conv.conv_instance``, which names the body a call takes
  (tensor-core or scalar), against the C entries' dispatch tables and the
  header's rule;
- the wrappers' contracts: CPU tensors take the plain twin, any device but
  CPU and CUDA raises.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""
import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.pallas.wconv import windowed_conv
from sessd_torch.ops import sparse as tsp
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from tests.test_torch_common import CAPS, host_inputs

CSRC = pathlib.Path(sc.__file__).resolve().parents[2] / "csrc"
ROWS = 64  # output rows per tile (csrc/gather_gemm.cuh: kRows)


def _loop_hits(rb, miss, rows=ROWS):
    """The tile's decision, written out: tap k of tile t is gathered iff
    some row of the tile reads an input row in [0, miss)."""
    n_out, k = rb.shape
    tiles = -(-n_out // rows)
    hits = np.zeros((tiles, k), bool)
    for t in range(tiles):
        for tap in range(k):
            for n in range(t * rows, min(n_out, (t + 1) * rows)):
                if 0 <= rb[n, tap] < miss:
                    hits[t, tap] = True
                    break
    return hits


def _random_rulebook(n_out, k, miss, seed):
    rng = np.random.RandomState(seed)
    rb = rng.randint(0, miss, (n_out, k))
    rb[rng.rand(n_out, k) < 0.7] = miss                # misses
    if n_out > ROWS:
        rb[ROWS:2 * ROWS] = miss                        # an all-miss tile
    rb[-1, :] = miss                                    # an all-miss row
    if n_out > 2 * ROWS:                                # one tap, one row
        rb[2 * ROWS:3 * ROWS] = miss
        rb[2 * ROWS + 5, k // 2] = 7
    return rb


@pytest.mark.parametrize("k", [3, 27])
@pytest.mark.parametrize("n_out", [1, 63, 64, 200, 257])
def test_tile_tap_hits_matches_loop_random(n_out, k):
    miss = 500
    rb = _random_rulebook(n_out, k, miss, seed=n_out * 31 + k)
    for dtype in (torch.int16, torch.int32):
        hits, skipped = tsp.tile_tap_hits(torch.from_numpy(rb).to(dtype),
                                          miss)
        want = _loop_hits(rb, miss)
        assert hits.dtype == torch.bool and hits.shape == want.shape
        np.testing.assert_array_equal(hits.numpy(), want)
        assert skipped == pytest.approx(1.0 - want.mean())
    if n_out > 2 * ROWS:
        assert not want[1].any()                        # all-miss tile
        assert want[2].sum() == 1 and want[2, k // 2]   # one tap, one row


@functools.lru_cache(maxsize=None)
def chain():
    return host_inputs(seed=1, b=2)[3]


# (kind, chain index) of each rulebook of the chain
CHAIN_RBS = [("subm", i) for i in range(4)] + [("down", i) for i in range(4)]


def _miss(kind, i):
    return CAPS[i] * 2  # batch 2: subm i and down i read stage i


@pytest.mark.parametrize("kind,i", CHAIN_RBS,
                         ids=[f"{a}{b}" for a, b in CHAIN_RBS])
def test_tile_tap_hits_on_host_chains(kind, i):
    rb = np.asarray(chain()[kind][i])
    miss = _miss(kind, i)
    hits, skipped = tsp.tile_tap_hits(torch.from_numpy(rb), miss)
    want = _loop_hits(rb, miss)
    np.testing.assert_array_equal(hits.numpy(), want)
    assert skipped == pytest.approx(1.0 - want.mean())
    # sparse voxels on a real grid: a subm conv's center tap reads each
    # valid row itself, and many other (tile, tap) pairs hit nothing
    if kind == "subm":
        assert hits[0, 13]
    assert 0.0 < skipped < 1.0


def _tile_sum(feats, rb, w2, miss):
    """The tensor-core tile's sum: per tile, only the taps it gathers, in
    tap order, in f64."""
    hits, _ = tsp.tile_tap_hits(rb, miss)
    x = torch.cat([feats.double(), feats.new_zeros(1, feats.shape[1])
                   .double()])
    w = w2.double()
    n_out = rb.shape[0]
    out = torch.zeros(n_out, w2.shape[2], dtype=torch.float64)
    idx = torch.where((rb >= 0) & (rb < miss), rb.long(), feats.shape[0])
    for t in range(hits.shape[0]):
        rows = slice(t * ROWS, min(n_out, (t + 1) * ROWS))
        for tap in torch.nonzero(hits[t]).flatten().tolist():
            out[rows] += x[idx[rows, tap]] @ w[tap]
    return out


# (Cin, Cout, kind, chain index) of the training plans' tensor-core convs
MMA_CONVS = [(16, 16, "subm", 0), (16, 32, "down", 0), (32, 64, "down", 1),
             (64, 64, "subm", 2), (64, 64, "down", 3)]


@functools.lru_cache(maxsize=None)
def _jax_forward(case):
    cin, cout, kind, i = case
    rb = np.asarray(chain()[kind][i], np.int32)
    n_in = _miss(kind, i)
    rng = np.random.RandomState(cin + cout + i)
    feats = rng.randn(n_in, cin).astype(np.float32)
    w2 = (rng.randn(rb.shape[1], cin, cout)
          / np.sqrt(rb.shape[1] * cin)).astype(np.float32)
    mask = np.ones(rb.shape[0], bool)
    want = np.array(windowed_conv(jnp.asarray(feats), jnp.asarray(rb),
                                  jnp.asarray(w2), jnp.asarray(mask),
                                  window=256, block=32, interpret=True))
    return feats, rb, w2, want


@pytest.mark.parametrize("case", MMA_CONVS,
                         ids=[f"{a}x{b}_{c}{d}" for a, b, c, d in MMA_CONVS])
def test_tile_sum_with_skipped_taps_matches_jax(case):
    feats, rb, w2, want = _jax_forward(case)
    t = torch.from_numpy
    got = _tile_sum(t(feats), t(rb), t(w2), feats.shape[0])
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)
    # and the port's twin agrees with both
    twin = kt.sparse_conv_fwd(t(feats), t(rb), t(w2))
    np.testing.assert_allclose(twin.numpy(), want, atol=3e-4, rtol=1e-3)


def _source_pairs(path, macro):
    """The (Cin, Cout) cases of a dispatch macro in a C source."""
    text = (CSRC / path).read_text()
    block = text[text.index(f"#define {macro}"):]
    block = block[:block.index("\n\n")]
    return tuple((int(a), int(b))
                 for a, b in re.findall(r"CASE\((\d+), (\d+)\)", block))


ENTRIES = {"sparse_conv_fwd": ("sparse_conv_train.cu", "SESSD_FWD_PAIRS"),
           "fused_sparse_conv_stream": ("sparse_conv_stream.cu",
                                        "SESSD_STREAM_PAIRS")}
INSTANCE_CASES = [(entry, dtype, pair)
                  for entry, (path, macro) in ENTRIES.items()
                  for pair in _source_pairs(path, macro)
                  for dtype in (torch.float32, torch.bfloat16)]


def test_python_pairs_equal_the_c_dispatch_tables():
    assert sc.FWD_PAIRS == _source_pairs(*ENTRIES["sparse_conv_fwd"])
    assert sc.STREAM_PAIRS == _source_pairs(
        *ENTRIES["fused_sparse_conv_stream"])
    rule = (CSRC / "gather_mma.cuh").read_text()
    rule = rule[rule.index("constexpr bool kMmaTile"):]
    rule = rule[:rule.index(";")]
    assert tuple(sorted({int(c) for c in re.findall(r"CIN == (\d+)", rule)})
                 ) == sc.MMA_CHANNELS
    assert tuple(sorted({int(c) for c in re.findall(r"COUT == (\d+)",
                                                    rule)})) == \
        sc.MMA_CHANNELS
    assert "std::is_same<T, __nv_bfloat16>" in rule


@pytest.mark.parametrize(
    "entry,dtype,pair", INSTANCE_CASES,
    ids=[f"{e}-{str(d)[6:]}-{p[0]}x{p[1]}" for e, d, p in INSTANCE_CASES])
def test_conv_instance_follows_the_dispatch(entry, dtype, pair):
    cin, cout = pair
    got = sc.conv_instance(entry, dtype, cin, cout)
    mma = dtype == torch.bfloat16 and cin != 4
    assert got == ("mma" if mma else "scalar")


@pytest.mark.parametrize("entry,pair", [
    ("sparse_conv_fwd", (8, 16)), ("sparse_conv_fwd", (16, 64)),
    ("fused_sparse_conv_stream", (4, 16)),
    ("fused_sparse_conv_stream", (64, 32))])
def test_conv_instance_rejects_what_no_entry_has(entry, pair):
    with pytest.raises(ValueError, match="no instance"):
        sc.conv_instance(entry, torch.bfloat16, *pair)
    with pytest.raises(ValueError, match="no instance"):
        sc.conv_instance(entry, torch.float16, 16, 16)


def _conv_inputs(cin, cout, k, n_in=300, n_out=200, seed=0):
    rb = _random_rulebook(n_out, k, n_in, seed)
    rng = np.random.RandomState(seed)
    feats = rng.randn(n_in, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.randn(cout) * 0.3).astype(np.float32)
    mask = rng.rand(n_out) > 0.2
    return feats, rb, w2, bias, mask


@pytest.mark.parametrize("wrapper", ["sparse_conv_fwd",
                                     "fused_sparse_conv_stream"])
def test_wrappers_raise_on_meta_tensors(wrapper):
    feats, rb, w2, bias, mask = (torch.from_numpy(a).to("meta") for a in
                                 _conv_inputs(16, 32, 27))
    fn = getattr(kt if wrapper == "sparse_conv_fwd" else sc, wrapper)
    args = ((feats, rb, w2, mask) if wrapper == "sparse_conv_fwd"
            else (feats, rb, w2, bias, 300))
    before = fn.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,k", [(16, 16, 27), (32, 64, 27),
                                        (64, 64, 3)])
def test_wrappers_on_cpu_take_their_twins(cin, cout, k, dtype):
    """On CPU tensors K4 and K3 return their plain twins' values, in the
    features' dtype and shape, without a launch; K4 zeroes masked rows, K3
    rows with no hit."""
    feats, rb, w2, bias, mask = _conv_inputs(cin, cout, k, seed=cin + k)
    f = torch.from_numpy(feats).to(dtype)
    r = torch.from_numpy(rb).to(torch.int32)
    w = torch.from_numpy(w2).to(dtype)
    b = torch.from_numpy(bias)
    m = torch.from_numpy(mask)
    before = (kt.sparse_conv_fwd.launches, sc.fused_sparse_conv_stream.launches)
    y4 = kt.sparse_conv_fwd(f, r, w, m)
    y3 = sc.fused_sparse_conv_stream(f, r, w, b, f.shape[0])
    assert (kt.sparse_conv_fwd.launches,
            sc.fused_sparse_conv_stream.launches) == before
    assert y4.dtype == y3.dtype == dtype
    assert y4.shape == y3.shape == (rb.shape[0], cout)
    assert torch.equal(y4, kt.sparse_conv_fwd_ref(f, r, w, m))
    assert torch.equal(y3, sc.fused_sparse_conv_ref(f, r, w, b, f.shape[0]))
    assert not y4[~m].any()
    assert not y3[torch.from_numpy((rb == f.shape[0]).all(1))].any()
