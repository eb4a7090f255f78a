"""DI-NMS of the port (``sessd_torch.core.nms.rotate_weighted_nms`` and
predict's ``nms_type="rotate_weighted_nms"`` branch) against the JAX
package's ``rotate_weighted_nms`` and against the port's copy of the
literal host oracle (``sessd_torch.core.nms_np``), on the clustered boxes,
two labels and padding cases of tests/test_dinms_parity.py (the port
takes the first unpadded and the rest padded to one size; JAX takes all
at that size, so it compiles once), f32 on the CPU.

Tolerances: the kept count, pick order, labels and directions exactly;
merged boxes 1e-4 and scores 1e-5 (absolute, plus 1e-4 relative), as the
JAX package holds itself against the oracle: the oracle sums in float64.
Against JAX, whose f32 sums run in another order: boxes 1e-5, scores 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.core.nms import rotate_weighted_nms as jax_dinms
from sessd_tpu.models import predict as jax_predict
from sessd_torch.core import nms_np
from sessd_torch.core.nms import rotate_weighted_nms
from sessd_torch.models import predict
import test_torch_threads  # noqa: F401 (torch's threads under xdist)


def _clustered_boxes(rng, n_clusters=6, max_per=6):
    """tests/test_dinms_parity.py:12-26."""
    boxes = []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(5, 65), rng.uniform(-30, 30)
        m = rng.randint(2, max_per + 1)
        for _ in range(m):
            boxes.append([
                cx + rng.normal(0, 0.4), cy + rng.normal(0, 0.4),
                rng.uniform(-1.2, -0.8),
                1.6 + rng.normal(0, 0.05), 3.9 + rng.normal(0, 0.08),
                1.5 + rng.normal(0, 0.03),
                rng.uniform(-0.3, 0.3),
            ])
    return np.asarray(boxes, np.float32)


ROWS = 96  # every padded case has this many rows: JAX compiles once


def _case(seed, two_labels, padded, dense=False):
    """(inputs in call order, n real boxes) of the parity test's cases:
    seeds 0-2 single-label, seed 7 two labels; ``padded``: -inf-score rows
    up to ROWS. ``dense``: clusters of up to 12 boxes with IoU predictions
    in [0.6, 1], where most leaders pass cnt > 2.6 (the parity cases keep 0
    or 1)."""
    rng = np.random.RandomState(seed)
    b7 = _clustered_boxes(rng, n_clusters=4 if two_labels else 6,
                          max_per=12 if dense else 6)
    n = b7.shape[0]
    b5 = b7[:, [0, 1, 3, 4, 6]]
    scores = rng.uniform(0.3, 1.0, n).astype(np.float32)
    iou_preds = rng.uniform(0.6 if dense else 0.2 if two_labels else 0.1,
                            1.0, n).astype(np.float32)
    dirs = rng.randint(0, 2, n).astype(np.int32)
    labels = ((rng.rand(n) < 0.5).astype(np.int32) if two_labels
              else np.zeros(n, np.int32))
    anchors = b7 + rng.normal(0, 0.2, b7.shape).astype(np.float32)
    arrays = [b7, b5, dirs, labels, scores, iou_preds, anchors]
    return (_pad(arrays) if padded else arrays), n


def _pad(arrays):
    """The inputs with -inf-score rows up to ROWS."""
    pad = ROWS - len(arrays[0])
    fills = [0.0, 0.0, 0, 0, -np.inf, 0.0, 0.0]
    return [np.concatenate([a, np.full((pad,) + a.shape[1:], f, a.dtype)])
            for a, f in zip(arrays, fills)]


CASES = [(0, False, False, False), (1, False, True, False),
         (2, False, True, False), (7, True, True, False),
         (4, False, True, True), (6, True, True, True)]


@pytest.mark.parametrize("seed,two_labels,padded,dense", CASES)
def test_dinms_matches_oracle_and_jax(seed, two_labels, padded, dense):
    arrays, n = _case(seed, two_labels, padded, dense)
    b7, b5, dirs, labels, scores, iou_preds, anchors = arrays
    damped = nms_np.centerness_damp(b7[:n], anchors[:n], scores[:n])
    ref_b, ref_d, ref_l, ref_s, _ = nms_np.rotate_weighted_nms_np(
        b7[:n], b5[:n], dirs[:n], labels[:n], damped, iou_preds[:n])

    post = 32
    got = rotate_weighted_nms(*map(torch.from_numpy, arrays),
                              pre_max_size=len(b7), post_max_size=post)
    got = [t.numpy() for t in got]
    # JAX always takes ROWS rows (padding rows are never kept), so it
    # compiles once for every case
    want = [np.asarray(t) for t in jax_dinms(
        *map(jnp.asarray, _pad(arrays)), pre_max_size=ROWS,
        post_max_size=post)]

    m = int(got[4].sum())
    assert m == len(ref_b) == int(want[4].sum())
    assert m >= (3 if dense else 0)
    assert got[4][:m].all() and not got[4][m:].any()
    np.testing.assert_allclose(got[0][:m], ref_b, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[1][:m], ref_d)
    np.testing.assert_array_equal(got[2][:m], ref_l)
    np.testing.assert_allclose(got[3][:m], ref_s, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0][:m], want[0][:m], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3][:m], want[3][:m], rtol=0, atol=1e-6)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g[:m], w[:m])
    assert np.isneginf(got[3][m:]).all()


def test_dinms_no_candidates():
    """Every row padding: nothing kept, no leader loop."""
    arrays, _ = _case(0, False, True)
    arrays[4] = np.full_like(arrays[4], -np.inf)
    got = rotate_weighted_nms(*map(torch.from_numpy, arrays),
                              post_max_size=32)
    assert not got[4].any() and np.isneginf(got[3].numpy()).all()


@pytest.mark.parametrize("two_labels", [False, True])
def test_predict_single_dinms_matches_jax(two_labels):
    """predict_single with nms_type="rotate_weighted_nms" on head outputs
    made around a set of anchors: 8 x 8 cells x 2 rotations, cars spread
    over them, random box codes, IoU and direction predictions; with two
    labels, a 2-class score head."""
    rng = np.random.RandomState(3)
    ys, xs = np.meshgrid(np.arange(8) * 1.2 - 4.8, np.arange(8) * 1.2 + 10,
                         indexing="ij")
    centers = np.stack([xs, ys], -1).reshape(-1, 1, 2).repeat(2, 1)
    a = centers.shape[0] * 2
    anchors = np.zeros((a, 7), np.float32)
    anchors[:, :2] = centers.reshape(-1, 2)
    anchors[:, 2:6] = (-1.0, 1.6, 3.9, 1.56)
    anchors[:, 6] = np.tile([0.0, np.pi / 2], a // 2)
    c = 2 if two_labels else 1
    preds = {"box_preds": rng.randn(a, 7).astype(np.float32) * 0.1,
             "cls_preds": rng.randn(a, c).astype(np.float32) + 0.5,
             "iou_preds": rng.uniform(0.3, 1.0, (a, 1)).astype(np.float32),
             "dir_cls_preds": rng.randn(a, 2).astype(np.float32)}
    kw = dict(nms_pre_max_size=96, nms_post_max_size=24,
              post_center_range=(0.0, -40.0, -5.0, 70.4, 40.0, 5.0),
              nms_type="rotate_weighted_nms")
    got = predict.predict_single(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        torch.from_numpy(anchors), predict.PredictConfig(**kw))
    want = jax_predict.predict_single(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(anchors),
        None, jax_predict.PredictConfig(**kw))
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["label_preds"], want["label_preds"])
    np.testing.assert_allclose(got["box3d_lidar"], want["box3d_lidar"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-6)
    if two_labels:
        assert len(set(got["label_preds"][got["valid"]].tolist())) == 2


def test_predict_batch_dinms_skips_the_small_capacity():
    """The two-level small path is rotate_nms's only: with DI-NMS the
    batch runs at nms_pre_max_size, as JAX does (predict.py:158)."""
    rng = np.random.RandomState(0)
    a = 64
    preds = {"box_preds": torch.randn(1, a, 7) * 0.1,
             "cls_preds": torch.full((1, a, 1), -5.0),
             "iou_preds": torch.ones(1, a, 1),
             "dir_cls_preds": torch.zeros(1, a, 2)}
    anchors = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 40, (a, 2)), np.tile([-1.0, 1.6, 3.9, 1.56, 0.0],
                                             (a, 1))], 1).astype(np.float32))
    calls = []
    real = predict.rotate_weighted_nms

    def spy(*args, **kw):
        calls.append(kw["pre_max_size"])
        return real(*args, **kw)

    predict.rotate_weighted_nms = spy
    try:
        predict.predict_batch(preds, anchors, predict.PredictConfig(
            nms_pre_max_size=48, nms_pre_small=8,
            nms_type="rotate_weighted_nms"))
    finally:
        predict.rotate_weighted_nms = real
    assert calls == [48]
