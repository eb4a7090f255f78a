"""The tensor-core gather tile of the bf16 convs (K1, K3, K4) and of the bf16
input gradient (dFeat, over the inverse rulebook with a K-major B), and of
the f32 input gradient through 3xTF32, ``sessd_torch/csrc/gather_mma.cuh``,
from the CPU:

- ``ops.sparse.tile_tap_hits``, the per-(tile, tap) any-hit flags that
  decide which taps the tile gathers and multiplies, against a numpy loop
  on random rulebooks (ragged last tile, all-miss tiles, K = 3 and 27), on
  the host chains of ``native.build_rulebooks`` and on their inverse
  rulebooks (where a strided conv's input row hits at most 8 of 27 taps);
- the tile's arithmetic with the skipped taps left out, written out in
  torch, against the JAX package's ``windowed_conv`` (the Pallas
  ``_fwd_kernel`` in interpret mode) on those chains, and the same over the
  inverse rulebook with W^T against the JAX input gradient (``jax.vjp``
  through ``windowed_conv``: ``_core``'s custom VJP, the Pallas
  ``_bwd_kernel`` in interpret mode): a tap that no row of a tile hits adds
  zero, so the sum is the same (atol 3e-4, rtol 1e-3: f32 sums in another
  order);
- ``ops.cuda.sparse_conv.conv_instance``, which names the body a call takes
  (tensor-core bf16, 3xTF32, or the direct body of the first conv's
  4-channel side) for K4, K3, K1, dFeat and dW, against the C entries'
  dispatch tables and the headers' rules;
- the wrappers' contracts: CPU tensors take the plain twin, any device but
  CPU and CUDA raises.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.pallas.wconv import windowed_conv
from sessd_torch.ops import sparse as tsp
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from tests.test_torch_common import CAPS, host_inputs
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

CSRC = pathlib.Path(sc.__file__).resolve().parents[2] / "csrc"
ROWS = 64  # output rows per tile (csrc/gather_common.cuh: kRows)


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


@pytest.mark.parametrize("kind,i", CHAIN_RBS,
                         ids=[f"{a}{b}" for a, b in CHAIN_RBS])
def test_tile_tap_hits_on_inverse_chains(kind, i):
    """The tiles dFeat runs: 64 input rows over the inverse rulebook, whose
    miss is the conv's output row count. A row of a strided conv's input
    hits at most 8 of the 27 taps (one of two offsets per axis by its
    coordinate's parity; the (3, 1, 1) conv: at most 2 of 3)."""
    rb = chain()[kind][i]
    n_in, n_out = _miss(kind, i), rb.shape[0]
    for rbk in (rb, rb.astype(np.int16)):
        inv = tsp.inverse_rulebook(torch.from_numpy(rbk), n_in)
        hits, skipped = tsp.tile_tap_hits(inv, n_out)
        want = _loop_hits(inv.numpy(), n_out)
        np.testing.assert_array_equal(hits.numpy(), want)
        assert skipped == pytest.approx(1.0 - want.mean())
    per_row = (inv < n_out).sum(1)
    if kind == "down":
        assert int(per_row.max()) <= (8 if rb.shape[1] == 27 else 2)
    else:  # a subm conv's inverse is its rulebook mirrored
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


# (Cin, Cout, kind, chain index) of one conv per input-gradient pair
# (its gather's (Cout, Cin)): 16->16, 32->16, 32->32, 64->32, 64->64 (K 27
# and 3)
DFEAT_CONVS = MMA_CONVS + [(32, 32, "subm", 1)]
DFEAT_IDS = [f"{a}x{b}_{c}{d}" for a, b, c, d in DFEAT_CONVS]


@functools.lru_cache(maxsize=None)
def _jax_dfeat(case):
    """dfeat = the JAX input gradient of windowed_conv (Pallas core in
    interpret mode) for a cotangent dout on every output row."""
    feats, rb, w2, _ = _jax_forward(case)
    rng = np.random.RandomState(7 + case[0] + case[1])
    dout = rng.randn(rb.shape[0], case[1]).astype(np.float32)
    mask = jnp.ones(rb.shape[0], bool)
    _, vjp = jax.vjp(lambda x: windowed_conv(
        x, jnp.asarray(rb), jnp.asarray(w2), mask, window=256, block=32,
        interpret=True), jnp.asarray(feats))
    return dout, np.array(vjp(jnp.asarray(dout))[0])


@pytest.mark.parametrize("case", DFEAT_CONVS, ids=DFEAT_IDS)
def test_dfeat_tile_sum_with_skipped_taps_matches_jax(case):
    """dFeat's tile arithmetic: per 64-row tile of inputs, only the taps of
    the inverse rulebook some row hits, each dout row times W[k]^T, in tap
    order. Compared in f32: the JAX kernel rounds dG = W^T dout to the
    features' dtype before its scatter (wconv.py:78-80) while the port
    rounds once at the end, so bf16 is held only against the twin, on the
    card (tests/test_torch_kernels_cuda.py)."""
    feats, rb, w2, _ = _jax_forward(case)
    dout, want = _jax_dfeat(case)
    t = torch.from_numpy
    inv = tsp.inverse_rulebook(t(rb), feats.shape[0])
    got = _tile_sum(t(dout), inv, t(w2).transpose(1, 2), rb.shape[0])
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)
    twin = kt.sparse_conv_dfeat(t(dout), inv, t(w2))
    np.testing.assert_allclose(twin.numpy(), want, atol=3e-4, rtol=1e-3)
    assert np.abs(want).max() > 0


def _source_pairs(path, macro):
    """The (Cin, Cout) cases of a dispatch macro in a C source."""
    text = (CSRC / path).read_text()
    block = text[text.index(f"#define {macro}"):]
    block = block[:block.index("\n\n")]
    return tuple((int(a), int(b))
                 for a, b in re.findall(r"CASE\((\d+), (\d+)\)", block))


ENTRIES = {"sparse_conv_fwd": ("sparse_conv_train.cu", "SESSD_FWD_PAIRS"),
           "fused_sparse_conv_stream": ("sparse_conv_stream.cu",
                                        "SESSD_STREAM_PAIRS"),
           "fused_sparse_conv": ("sparse_conv.cu", "SESSD_FUSED_PAIRS"),
           "sparse_conv_dfeat": ("sparse_conv_train.cu",
                                 "SESSD_DFEAT_PAIRS"),
           "sparse_conv_dw": ("sparse_conv_train.cu", "SESSD_DW_PAIRS")}
INSTANCE_CASES = [(entry, dtype, pair)
                  for entry, (path, macro) in ENTRIES.items()
                  for pair in _source_pairs(path, macro)
                  for dtype in (torch.float32, torch.bfloat16)]


def test_python_pairs_equal_the_c_dispatch_tables():
    assert sc.FWD_PAIRS == _source_pairs(*ENTRIES["sparse_conv_fwd"])
    assert sc.STREAM_PAIRS == _source_pairs(
        *ENTRIES["fused_sparse_conv_stream"])
    assert sc.FUSED_PAIRS == _source_pairs(*ENTRIES["fused_sparse_conv"])
    assert sc.DW_PAIRS == _source_pairs(*ENTRIES["sparse_conv_dw"])
    assert sc.DFEAT_PAIRS == _source_pairs(*ENTRIES["sparse_conv_dfeat"])
    # the input gradient's pairs are the convs' swapped, the first's too
    assert sc.DFEAT_PAIRS == tuple(sorted((b, a) for a, b in sc.FWD_PAIRS))
    # each __global__ with two bodies picks the tensor-core one by the rule:
    # bf16 (kMmaTile) and f32 through 3xTF32 (kTf32Tile) in every entry
    mma = "if constexpr (sessd::kMmaTile<T, CIN, COUT>"
    tf32 = "sessd::kTf32Tile<T, CIN, COUT>"
    for path, kernel in (("sparse_conv.cu", "fused_sparse_conv_kernel("),
                         ("sparse_conv_stream.cu",
                          "fused_sparse_conv_stream_kernel("),
                         ("sparse_conv_train.cu", "sparse_conv_fwd_kernel("),
                         ("sparse_conv_train.cu",
                          "sparse_conv_dfeat_kernel("),
                         ("sparse_conv_train.cu",
                          "sparse_conv_dw_partial_kernel(")):
        text = (CSRC / path).read_text()
        body = text[text.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert mma in body
        assert tf32 in body, kernel
    header = (CSRC / "gather_mma.cuh").read_text()
    for name, dtype in (("kMmaTile", "__nv_bfloat16"), ("kTf32Tile",
                                                         "float")):
        rule = header[header.index(f"constexpr bool {name}"):]
        rule = rule[:rule.index(";")]
        assert tuple(sorted({int(c) for c in re.findall(r"CIN == (\d+)",
                                                        rule)})) == \
            sc.MMA_CHANNELS
        assert tuple(sorted({int(c) for c in re.findall(r"COUT == (\d+)",
                                                        rule)})) == \
            sc.MMA_CHANNELS
        assert f"std::is_same<T, {dtype}>" in rule
    # the other body of each of those kernels but the stream kernel's, by
    # the direct rule: the pairs with a 4-channel side, in both types
    for path, kernel, rule in (
            ("sparse_conv.cu", "fused_sparse_conv_kernel(",
             "sessd::kDirect<T, CIN, COUT>"),
            ("sparse_conv_train.cu", "sparse_conv_fwd_kernel(",
             "sessd::kDirect<T, CIN, COUT>"),
            ("sparse_conv_train.cu", "sparse_conv_dfeat_kernel(",
             "sessd::kDirect<T, CIN, COUT>"),
            ("sparse_conv_train.cu", "sparse_conv_dw_partial_kernel(",
             "kDwDirect<T, CIN, COUT>")):
        text = (CSRC / path).read_text()
        body = text[text.index(kernel):]
        assert rule in body[:body.index("\n}\n")], kernel
    header = (CSRC / "gather_direct.cuh").read_text()
    rule = header[header.index("constexpr bool kDirect"):]
    rule = rule[:rule.index(";")]
    direct = set(map(tuple, (map(int, m) for m in re.findall(
        r"CIN == (\d+) && COUT == (\d+)", rule))))
    assert direct == {p for p in sc.FWD_PAIRS + sc.DFEAT_PAIRS if 4 in p}


@pytest.mark.parametrize(
    "entry,dtype,pair", INSTANCE_CASES,
    ids=[f"{e}-{str(d)[6:]}-{p[0]}x{p[1]}" for e, d, p in INSTANCE_CASES])
def test_conv_instance_follows_the_dispatch(entry, dtype, pair):
    """bf16 with Cin, Cout in {16, 32, 64} takes the tensor-core body in
    every entry: K4 and K3 since the wgmma tile, K1 (with its cluster tap
    split) and dW (mma.sync) since their redesign, dFeat (five of its six
    pairs, K-major B) since its own; f32 at those channels takes the same
    bodies through 3xTF32 in every entry (dW's on m16n8k8); the 4-channel
    side of the first conv, in both types, the direct one."""
    cin, cout = pair
    got = sc.conv_instance(entry, dtype, cin, cout)
    tensor = 4 not in pair
    if dtype == torch.bfloat16:
        want = "mma" if tensor else "direct"
    else:
        want = "tf32" if tensor else "direct"
    assert got == want


WIDE_MACROS = {"fused_sparse_conv": ("sparse_conv.cu",
                                     "SESSD_FUSED_WIDE_PAIRS"),
               "fused_sparse_conv_stream": ("sparse_conv_stream.cu",
                                            "SESSD_STREAM_WIDE_PAIRS")}


@pytest.mark.parametrize("entry", sorted(WIDE_MACROS))
def test_wide_pairs_equal_the_c_tables(entry):
    """The 128-channel pairs of the two serving entries (CenterPoint's
    last stages): the C tables and ``kWideTile`` name ``WIDE_PAIRS``, bf16
    only, and each kernel takes the tile for them."""
    assert _source_pairs(*WIDE_MACROS[entry]) == sc.WIDE_PAIRS
    assert set(sc.WIDE_ENTRIES) == set(WIDE_MACROS)
    header = (CSRC / "gather_mma.cuh").read_text()
    rule = header[header.index("constexpr bool kWideTile"):]
    rule = rule[:rule.index(";")]
    assert "std::is_same<T, __nv_bfloat16>" in rule
    assert {int(c) for c in re.findall(r"CIN == (\d+)", rule)} == {
        cin for cin, _ in sc.WIDE_PAIRS}
    assert {int(c) for c in re.findall(r"COUT == (\d+)", rule)} == {
        cout for _, cout in sc.WIDE_PAIRS}
    path, _ = WIDE_MACROS[entry]
    kernel = {"fused_sparse_conv": "fused_sparse_conv_kernel(",
              "fused_sparse_conv_stream": "fused_sparse_conv_stream_kernel("}
    text = (CSRC / path).read_text()
    body = text[text.index(kernel[entry]):]
    assert "sessd::kWideTile<T, CIN, COUT>" in body[:body.index("\n}\n")]


@pytest.mark.parametrize("pair", [(64, 128), (128, 128)])
@pytest.mark.parametrize("entry", ["fused_sparse_conv",
                                   "fused_sparse_conv_stream",
                                   "sparse_conv_fwd", "sparse_conv_dfeat",
                                   "sparse_conv_dw"])
def test_conv_instance_of_the_wide_pairs(entry, pair):
    """bf16 K1 and K3 take the tensor-core tile at (64, 128) and (128,
    128); f32 and the training entries have no instance of them."""
    if entry in sc.WIDE_ENTRIES:
        assert sc.conv_instance(entry, torch.bfloat16, *pair) == "mma"
    else:
        with pytest.raises(ValueError, match="no instance"):
            sc.conv_instance(entry, torch.bfloat16, *pair)
    with pytest.raises(ValueError, match="no instance"):
        sc.conv_instance(entry, torch.float32, *pair)


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
