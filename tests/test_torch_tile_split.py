"""The arithmetic of the redesigned bf16 K1 (a tile's hit taps split over a
cluster of S CTAs) and the tensor-core dW (split-K over chunks, with
skipped steps and chunks), written out in torch from the CPU and held
against the JAX package:

- K1's split-tap sum: per 64-row tile, the taps some row hits, dealt to S
  ranks as the kernel deals them (tap k to rank k mod S), each
  rank's partial summed in f32 in tap order, the partials added in rank
  order, then bias, ReLU and the any-hit mask; against the Pallas
  ``fused_conv_affine_t`` in interpret mode, S in {1, 2, 4}; and a row's
  output bit-equal at one S wherever the rows around it put it in a tile
  (what lets a scan's detections not depend on the scans batched with it
  in batches of one size);
- dW's chunked sum: per (chunk, tap), the 64-row steps some row of which
  hits the tap, each step's G^T D in f32, a zero partial where no row of
  the chunk hits; the chunks then summed in order; against ``jax.grad``
  through ``windowed_conv`` (the Pallas ``_bwd_kernel``, interpret mode);
- the Python mirrors of the kernels' rules (``cluster_split``, the
  deal by tap index, ``conv_instance`` for K1 and dW) against the C
  sources, by regex, and the comparison-only wrappers' CPU contracts;
- every C entry of the CUDA sources bound through ctypes, and no scalar
  or ring body left beside the one each kernel runs.

Inputs come from a numpy seed on the host chains of
``tests.test_torch_common.host_inputs`` at ``CAPS``. Tolerance atol 3e-4,
rtol 1e-3 (f32 sums in another order). The kernels themselves run only on
the card (tests/test_torch_kernels_cuda.py).
"""
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops.pallas.wconv import (cols_for, fused_conv_affine_t,
                                        prep_rulebook, windowed_conv)
from sessd_torch.ops import sparse as tsp
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from tests.test_torch_common import CAPS, host_inputs
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

CSRC = pathlib.Path(sc.__file__).resolve().parents[2] / "csrc"
ROWS = 64  # rows of a tile and of a dW step (csrc/gather_common.cuh: kRows)
ATOL, RTOL = 3e-4, 1e-3

# (name, Cin, Cout, rulebook kind, chain index) of the plan's convs that
# take the tensor-core bodies (bf16, Cin and Cout in {16, 32, 64})
MMA_CONVS = [
    ("subm0_b", 16, 16, "subm", 0),
    ("down0", 16, 32, "down", 0),
    ("subm1", 32, 32, "subm", 1),
    ("down1", 32, 64, "down", 1),
    ("subm2", 64, 64, "subm", 2),
    ("down3", 64, 64, "down", 3),   # kernel (3, 1, 1): K = 3
]
IDS = [c[0] for c in MMA_CONVS]


@functools.lru_cache(maxsize=None)
def chain(b):
    return host_inputs(seed=1, b=b)[3]


def deal(taps, split):
    """The hit taps of one tile dealt to ``split`` ranks as the kernel deals
    them: rank r takes the taps k with k % split == r, in order."""
    return [[k for k in taps if k % split == r] for r in range(split)]


def split_tile_sum(feats, rb, w2, bias, n_in, split, relu=True):
    """K1's output with every tile's hit taps split over ``split`` ranks:
    each rank's partial in f32 in tap order, partials added in rank order,
    then bias, ReLU and the any-hit mask."""
    hits, _ = tsp.tile_tap_hits(rb, n_in)
    x = torch.cat([feats.float(), feats.new_zeros(1, feats.shape[1])])
    idx = torch.where((rb >= 0) & (rb < n_in), rb.long(), n_in)
    w = w2.float()
    n_out = rb.shape[0]
    out = torch.zeros(n_out, w2.shape[2])
    for t in range(hits.shape[0]):
        rows = slice(t * ROWS, min(n_out, (t + 1) * ROWS))
        taps = torch.nonzero(hits[t]).flatten().tolist()
        acc = None
        for mine in deal(taps, split):
            part = torch.zeros(rows.stop - rows.start, w2.shape[2])
            for tap in mine:
                part += x[idx[rows, tap]] @ w[tap]
            acc = part if acc is None else acc + part
        out[rows] = acc
    out = out + bias.float()
    if relu:
        out = out.clamp_min(0.0)
    return torch.where((rb != n_in).any(1, keepdim=True), out, 0.0)


def _k1_inputs(case, seed=0):
    name, cin, cout, kind, i = case
    n_in = CAPS[i]
    rng = np.random.RandomState(seed)
    rb = np.asarray(chain(1)[kind][i], np.int32)
    k = rb.shape[1]
    # one all-miss row past the chain's own
    rb = np.concatenate([rb, np.full((1, k), n_in, np.int32)])
    feats = rng.randn(n_in, cin).astype(np.float32)
    w2 = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.randn(cout) * 0.3).astype(np.float32)
    return feats, rb, w2, bias, n_in


@functools.lru_cache(maxsize=None)
def pallas_fused(case):
    """fused_conv_affine_t (interpret mode) on the case's inputs."""
    feats, rb, w2, bias, n_in = _k1_inputs(case)
    cols_in = cols_for(n_in)
    feats_t = jnp.zeros((feats.shape[1], cols_in)).at[:, :n_in].set(feats.T)
    prep = prep_rulebook(jnp.asarray(rb), n_in, cols_in, window=cols_in)
    w2t = jnp.asarray(w2.reshape(-1, w2.shape[-1]).T)
    y_t = fused_conv_affine_t(feats_t, *prep, w2t, jnp.asarray(bias)[:, None],
                              n_in, window=cols_in, relu=True,
                              interpret=True)
    return np.asarray(y_t[:, :rb.shape[0]].T)


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("case", MMA_CONVS, ids=IDS)
def test_k1_split_tap_sum_matches_pallas_fused(case, split):
    feats, rb, w2, bias, n_in = _k1_inputs(case)
    t = torch.from_numpy
    got = split_tile_sum(t(feats), t(rb), t(w2), t(bias), n_in, split)
    np.testing.assert_allclose(got.numpy(), pallas_fused(case), atol=ATOL,
                               rtol=RTOL)
    # the deal covers each hit tap of a tile once, each rank its residue
    # class; a tile that hits every tap gets the ranks' counts within one
    # of each other
    hits, _ = tsp.tile_tap_hits(t(rb), n_in)
    for row in hits:
        taps = torch.nonzero(row).flatten().tolist()
        dealt = deal(taps, split)
        assert sorted(sum(dealt, [])) == taps
        assert all(k % split == r for r, mine in enumerate(dealt)
                   for k in mine)
    full = deal(list(range(rb.shape[1])), split)
    assert max(map(len, full)) - min(map(len, full)) <= 1


@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("case", MMA_CONVS, ids=IDS)
def test_k1_split_tap_sum_does_not_depend_on_tile_alignment(case, split):
    """Rows moved to other tiles (all-miss rows put before them, as another
    scan of a batch would) keep their outputs bit for bit: each rank sums a
    row's own taps of its residue class, whatever else the tile hits."""
    feats, rb, w2, bias, n_in = (torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in _k1_inputs(case))
    want = split_tile_sum(feats, rb, w2, bias, n_in, split)
    for shift in (1, 23, 40):
        moved = torch.cat([torch.full((shift, rb.shape[1]), n_in,
                                      dtype=rb.dtype), rb])
        got = split_tile_sum(feats, moved, w2, bias, n_in, split)[shift:]
        assert torch.equal(got, want), shift


def chunked_dw(feats, rb, dout, n_in, chunk_rows):
    """dW as the tensor-core partial kernel sums it: per (chunk, tap) the
    hit steps' G^T D in f32 in step order (a zero partial where the chunk
    has no hit), then the chunks in order. Returns (dw, the skipped shares
    of (chunk, tap) and (step, tap) pairs)."""
    n_out, k = rb.shape
    x = torch.cat([feats.float(), feats.new_zeros(1, feats.shape[1])])
    hit = (rb >= 0) & (rb < n_in)
    idx = torch.where(hit, rb.long(), n_in)
    d = dout.float()
    chunks = -(-n_out // chunk_rows)
    partial = torch.zeros(chunks, k, feats.shape[1], dout.shape[1])
    pairs = [0, 0, 0, 0]  # chunk pairs, skipped; step pairs, skipped
    for c in range(chunks):
        lo, hi = c * chunk_rows, min(n_out, (c + 1) * chunk_rows)
        for tap in range(k):
            pairs[0] += 1
            if not hit[lo:hi, tap].any():
                pairs[1] += 1
                steps = -(-(hi - lo) // ROWS)
                pairs[2] += steps
                pairs[3] += steps
                continue
            for s in range(lo, hi, ROWS):
                rows = slice(s, min(hi, s + ROWS))
                pairs[2] += 1
                if not hit[rows, tap].any():
                    pairs[3] += 1
                    continue
                partial[c, tap] += x[idx[rows, tap]].T @ d[rows]
    dw = partial[0].clone()
    for c in range(1, chunks):
        dw += partial[c]
    return dw, pairs[1] / pairs[0], pairs[3] / pairs[2]


def _dw_inputs(case, seed=0):
    name, cin, cout, kind, i = case
    rng = np.random.RandomState(seed)
    rb = np.asarray(chain(2)[kind][i], np.int32)
    n_in = CAPS[i] * 2  # batch 2
    ids = chain(2)["ids"][i + (kind == "down")]
    mask = ids < np.iinfo(np.int32).max
    feats = rng.randn(n_in, cin).astype(np.float32)
    w2 = (rng.randn(rb.shape[1], cin, cout)
          / np.sqrt(rb.shape[1] * cin)).astype(np.float32)
    cot = rng.randn(rb.shape[0], cout).astype(np.float32)
    return feats, rb, w2, mask, cot


@functools.lru_cache(maxsize=None)
def jax_dw(case):
    """jax.grad of sum(windowed_conv(x, rb, w) * cot) by w, the Pallas core
    in interpret mode."""
    feats, rb, w2, mask, cot = _dw_inputs(case)

    def loss(w):
        y = windowed_conv(jnp.asarray(feats), jnp.asarray(rb), w,
                          jnp.asarray(mask), window=256, block=32,
                          interpret=True)
        return jnp.sum(y * cot)

    return np.array(jax.grad(loss)(jnp.asarray(w2)))


@pytest.mark.parametrize("chunk_rows", [64, 256])
@pytest.mark.parametrize("case", MMA_CONVS, ids=IDS)
def test_dw_chunked_sum_with_skips_matches_jax_grad(case, chunk_rows):
    feats, rb, w2, mask, cot = _dw_inputs(case)
    # the cotangent reaches the kernel zeroed on masked rows
    dout = np.where(mask[:, None], cot, 0.0).astype(np.float32)
    t = torch.from_numpy
    got, chunk_skip, step_skip = chunked_dw(t(feats), t(rb), t(dout),
                                            feats.shape[0], chunk_rows)
    np.testing.assert_allclose(got.numpy(), jax_dw(case), atol=ATOL,
                               rtol=RTOL)
    # the chains' padding rows past each stage's voxels are whole steps
    # that no tap hits; the step shares are those of the kernel's 64-row
    # flags
    assert 0.0 < step_skip < 1.0
    _, want_step = tsp.tile_tap_hits(t(rb), feats.shape[0])
    assert step_skip == pytest.approx(want_step)
    _, want_chunk = tsp.tile_tap_hits(t(rb), feats.shape[0], chunk_rows)
    assert chunk_skip == pytest.approx(want_chunk)
    twin = kt.sparse_conv_dw(t(feats), t(rb), t(dout), chunk_rows)
    np.testing.assert_allclose(twin.numpy(), jax_dw(case), atol=ATOL,
                               rtol=RTOL)


def _function(path, head):
    """The text of a C function from ``head`` to its closing brace."""
    text = (CSRC / path).read_text()
    body = text[text.index(head):]
    return body[:body.index("\n}\n") + 2]


def test_cluster_split_mirrors_the_header():
    rule = _function("gather_mma.cuh", "inline int cluster_split(")
    assert re.search(r"if \(tiles >= wave\) return 1;", rule)
    assert re.search(r"return tiles \* 4 <= wave \? 4 : 2;", rule)
    text = (CSRC / "gather_mma.cuh").read_text()
    assert re.search(r"constexpr int kMaxSplit = (\d+);", text).group(1) \
        == str(sc.MAX_SPLIT)
    assert re.search(r"constexpr int kRows = (\d+);",
                     (CSRC / "gather_common.cuh").read_text()).group(1) \
        == str(sc.TILE_ROWS)
    # the deal: rank r takes the hit taps k with k % split == r, in order
    assert "hit = hit && k % split == rank;" in text
    assert "issue(my_taps[ahead], ahead % kStages)" in text
    # the C entry launches K1 with the rule's S, in clusters along x
    entry = (CSRC / "sparse_conv.cu").read_text()
    assert "if (split == 0) split = sessd::cluster_split(tiles, wave);" \
        in entry
    assert "attr[0].val.clusterDim.x = split;" in entry


@pytest.mark.parametrize("tiles,wave,want", [
    (63, 396, 4), (94, 396, 4), (99, 396, 4), (100, 396, 2), (188, 396, 2),
    (395, 396, 2), (396, 396, 1), (2500, 396, 1), (344, 1716, 4),
    (429, 1716, 4), (430, 1716, 2), (1, 132, 4)])
def test_cluster_split_picks_by_wave(tiles, wave, want):
    assert sc.cluster_split(tiles, wave) == want


def test_dw_chunk_limits_mirror_the_source():
    text = (CSRC / "sparse_conv_train.cu").read_text()
    assert re.search(r"constexpr int kDwMaxChunkRows = (\d+);",
                     text).group(1) == str(kt.DW_MAX_CHUNK_ROWS)
    assert kt.DW_CHUNK_ROWS % sc.TILE_ROWS == 0
    assert 0 < kt.DW_CHUNK_ROWS <= kt.DW_MAX_CHUNK_ROWS
    # tap-fastest grid of one dimension: the K blocks of a chunk run
    # together, and any chunk count up to GRID_X_MAX blocks launches
    assert re.search(r"constexpr long long kGridXMax = (\d+);",
                     text).group(1) == str(kt.GRID_X_MAX)
    assert "blocks = static_cast<long long>(taps) * chunks;" in text
    assert "if (blocks > kGridXMax) return" in text
    assert "kern<<<static_cast<unsigned>(blocks), L::kBlock," in text
    assert re.search(r"dw_mma_partial<T, IdxT, CIN, COUT>\(\s*feats, rb, "
                     r"dout, partial, n_in, n_out, taps, chunk_rows,\s*"
                     r"static_cast<int>\(blockIdx\.x / taps\),\s*"
                     r"static_cast<int>\(blockIdx\.x % taps\)\);", text)


@pytest.mark.parametrize("chunk_rows,refused", [
    (1, True), (2, False), (64, False), (0, True), (-64, True)])
def test_dw_refuses_a_grid_past_its_blocks_before_any_launch(chunk_rows,
                                                             refused):
    """dW launches chunks x taps blocks on x: 80 M rows x 27 taps at one
    row a chunk pass GRID_X_MAX and raise in the wrapper's check (shapes
    only: meta tensors, no memory), as does a chunk of no rows; two rows a
    chunk fit."""
    n = 80_000_000
    f = torch.empty(100, 4, device="meta")
    r = torch.empty(n, 27, dtype=torch.int32, device="meta")
    d = torch.empty(n, 16, device="meta")
    if refused:
        with pytest.raises(ValueError, match="chunk"):
            kt._check_dw(f, r, d, chunk_rows)
    else:
        kt._check_dw(f, r, d, chunk_rows)


def _conv_args(cin=32, cout=64, k=27, n_in=300, n_out=200, seed=0,
               dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    rb = rng.randint(0, n_in, (n_out, k))
    rb[rng.rand(n_out, k) < 0.6] = n_in
    rb[:5] = n_in
    feats = torch.from_numpy(rng.randn(n_in, cin).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(k, cin, cout) / np.sqrt(k * cin))
                          .astype(np.float32))
    bias = torch.from_numpy((rng.randn(cout) * 0.3).astype(np.float32))
    dout = torch.from_numpy(rng.randn(n_out, cout).astype(np.float32))
    return (feats.to(dtype), torch.from_numpy(rb).int(), w2.to(dtype), bias,
            n_in, dout.to(dtype))


def test_comparison_wrappers_on_cpu_take_their_twins():
    """The entry kept for comparisons (K1 at a forced cluster size) returns
    the twin's values on CPU tensors without a launch, in the features'
    dtype."""
    feats, rb, w2, bias, n_in, _ = _conv_args()
    count = sc.fused_sparse_conv_at_split.launches
    want = sc.fused_sparse_conv_ref(feats, rb, w2, bias, n_in)
    for split in (1, 2, 4):
        assert torch.equal(sc.fused_sparse_conv_at_split(
            feats, rb, w2, bias, n_in, split), want)
    assert count == sc.fused_sparse_conv_at_split.launches
    assert want.dtype == torch.bfloat16 and not want[:5].any()


def test_comparison_wrappers_raise_off_cpu_and_cuda():
    feats, rb, w2, bias, n_in, dout = (
        a.to("meta") if isinstance(a, torch.Tensor) else a
        for a in _conv_args())
    for call in (
            lambda: sc.fused_sparse_conv_at_split(feats, rb, w2, bias, n_in,
                                                  2),
            lambda: kt.sparse_conv_dw(feats, rb, dout)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


CU_SOURCES = ("rotated_nms.cu", "sparse_conv.cu", "sparse_conv_ablate.cu",
              "sparse_conv_stream.cu", "sparse_conv_train.cu")


def test_cu_sources_are_the_listed_five():
    assert tuple(sorted(p.name for p in CSRC.glob("*.cu"))) == CU_SOURCES


@pytest.mark.parametrize("source", CU_SOURCES)
def test_every_c_entry_is_bound_and_none_is_a_retired_body(source):
    """Every ``extern "C"`` function of the source is bound through ctypes
    by a module of ``ops/cuda``; outside the ablation's source (S1, which
    keeps its own copy of the scalar tile) no kernel, template or entry is
    named for a scalar or ring body: one body per kernel."""
    text = (CSRC / source).read_text()
    entries = set(re.findall(r'extern "C" [^(;]*?\b(sessd_\w+)\s*\(', text))
    assert entries
    bindings = "".join(p.read_text()
                       for p in pathlib.Path(sc.__file__).parent.glob("*.py"))
    for name in entries:
        assert re.search(rf"\blib\.{name}\b", bindings), name
    if source != "sparse_conv_ablate.cu":
        code = re.sub(r"//[^\n]*", "", text)
        assert not re.findall(r"\b\w*_(?:scalar|ring)\w*\b", code)


@pytest.mark.parametrize("chunk_rows", [64, 200, 2048])
def test_dw_twin_is_independent_of_chunk_rows_on_cpu(chunk_rows):
    """On CPU tensors the chunk size only reaches the kernel: the twin
    answers the same for any."""
    feats, rb, w2, bias, n_in, dout = _conv_args(dtype=torch.float32)
    assert torch.equal(kt.sparse_conv_dw(feats, rb, dout, chunk_rows),
                       kt.sparse_conv_dw_ref(feats, rb, dout))
