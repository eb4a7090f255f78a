"""The port's decode path against the JAX package and the numpy oracles:
box decode, rotated BEV IoU (vs JAX and core/rotated_iou_np.py, atol 1e-5),
rotated NMS indices (vs JAX and core/nms_np.py, on tie-free scores), and
both nms_pre_small branches of predict_batch (vs JAX predict_batch). Then
the port alone: predict_batch, which runs rotate_nms once for the batch,
bit for bit equal to predict_single scene by scene (both branches, with
and without the frustum cull), and the batched NMS's CPU twin equal to
rotate_nms scene by scene."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.core import box_jax, rotated_iou_np
from sessd_tpu.core import nms as jnms
from sessd_tpu.core import rotated_iou as jiou
from sessd_tpu.core.anchors import create_anchors_3d_range
from sessd_tpu.core.nms_np import rotate_nms_np
from sessd_tpu.models import predict as jpredict
from sessd_torch.core import box_np, box_torch, nms, rotated_iou
from sessd_torch.models import predict
from sessd_torch.ops.cuda import nms as nms_cuda
from sessd_torch.utils import kitti_synth
from tests.test_torch_common import to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)


def _clustered_boxes(rng, n_clusters=8, per=6):
    """Car-sized boxes in tight clusters, so NMS suppresses. A fixed count
    keeps JAX's compiled shapes the same across seeds."""
    boxes = []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(5, 65), rng.uniform(-30, 30)
        for _ in range(per):
            boxes.append([cx + rng.normal(0, 0.5), cy + rng.normal(0, 0.5),
                          rng.uniform(-1.2, -0.8), 1.6 + rng.normal(0, 0.05),
                          3.9 + rng.normal(0, 0.08), 1.5,
                          rng.uniform(-np.pi, np.pi)])
    return np.asarray(boxes, np.float32)


def _anchors(h=8, w=11):
    return create_anchors_3d_range(
        [1, h, w], [0, -40.0, -1.0, 70.4, 40.0, -1.0]).reshape(-1, 7)


def test_second_box_decode_matches_jax():
    rng = np.random.RandomState(0)
    anchors = _anchors()
    enc = (rng.randn(*anchors.shape) * 0.3).astype(np.float32)
    want = np.asarray(box_jax.second_box_decode(jnp.asarray(enc),
                                                jnp.asarray(anchors)))
    got = box_torch.second_box_decode(to_torch(enc), to_torch(anchors))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_bev_corners_match_jax():
    b7 = _clustered_boxes(np.random.RandomState(1))
    for b in (b7, b7[:, [0, 1, 3, 4, 6]]):
        np.testing.assert_allclose(
            box_torch.bev_corners(to_torch(b)).numpy(),
            np.asarray(box_jax.bev_corners(jnp.asarray(b))), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_bev_matrix_matches_jax_and_numpy(seed):
    rng = np.random.RandomState(seed)
    b7 = _clustered_boxes(rng)
    b7[:3] = b7[3]  # identical boxes: the coincident-edge case, IoU 1
    got = rotated_iou.iou_bev_matrix(to_torch(b7), to_torch(b7)).numpy()
    assert (got > 0.05).sum() > 2 * len(b7)  # overlaps beyond the diagonal
    # self-IoU is 1 up to f32 rounding of areas at |x| ~ 60 m
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jiou.iou_bev_matrix(jnp.asarray(b7),
                                            jnp.asarray(b7))), atol=1e-5)
    # the float64 numpy oracle: compare the same algorithm in float64
    got64 = rotated_iou.iou_bev_matrix(to_torch(b7).double(),
                                       to_torch(b7).double()).numpy()
    np.testing.assert_allclose(got64, rotated_iou_np.iou_bev_matrix(b7, b7),
                               atol=1e-5)


@pytest.mark.parametrize("thresh", [0.01, 0.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_rotate_nms_matches_jax_and_numpy(seed, thresh):
    rng = np.random.RandomState(seed)
    b5 = _clustered_boxes(rng)[:, [0, 1, 3, 4, 6]]
    n = len(b5)
    # -inf padding rows never surface; scores are tie-free
    b5 = np.concatenate([b5, np.zeros((9, 5), np.float32)])
    scores = np.concatenate([rng.permutation(n).astype(np.float32) / n + 0.01,
                             np.full(9, -np.inf, np.float32)])
    pre = n - 3  # pre_max_size truncates by score
    idx, valid = nms.rotate_nms(to_torch(b5), to_torch(scores),
                                pre_max_size=pre, post_max_size=20,
                                iou_threshold=thresh)
    jidx, jvalid = jnms.rotate_nms(jnp.asarray(b5), jnp.asarray(scores),
                                   pre_max_size=pre, post_max_size=20,
                                   iou_threshold=thresh)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    ref = rotate_nms_np(b5[:n], scores[:n], thresh, pre_max_size=pre,
                        post_max_size=20)
    m = int(valid.sum())
    assert 0 < m == len(ref) < pre
    np.testing.assert_array_equal(idx.numpy()[:m], ref)


def _preds(rng, a, n_hot, b=2):
    """Batch of head outputs: distinct logits, n_hot confident anchors."""
    out = {"box_preds": [], "cls_preds": [], "dir_cls_preds": [],
           "iou_preds": []}
    for _ in range(b):
        cls = rng.randn(a, 1) - 4.0
        cls[rng.choice(a, n_hot, replace=False), 0] = rng.uniform(1, 3, n_hot)
        out["cls_preds"].append(cls)
        out["box_preds"].append(rng.randn(a, 7) * 0.1)
        out["dir_cls_preds"].append(rng.randn(a, 2))
        out["iou_preds"].append(rng.uniform(-1, 1, (a, 1)))
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("n_hot,branch", [(20, "small"), (50, "full")])
def test_predict_batch_matches_jax(n_hot, branch):
    rng = np.random.RandomState(n_hot)
    anchors = _anchors()
    preds = _preds(rng, len(anchors), n_hot)
    cfg = predict.PredictConfig(nms_pre_max_size=64, nms_post_max_size=16,
                                nms_pre_small=32)
    jcfg = jpredict.PredictConfig(nms_pre_max_size=64, nms_post_max_size=16,
                                  nms_pre_small=32)
    counts = (1 / (1 + np.exp(-preds["cls_preds"][..., 0])) >= 0.3).sum(1)
    assert (counts.max() <= 32) == (branch == "small")
    got = predict.predict_batch({k: to_torch(v) for k, v in preds.items()},
                                to_torch(anchors), cfg)
    want = jpredict.predict_batch(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(anchors),
        None, jcfg)
    valid = np.asarray(want["valid"])
    assert valid.sum() > 2
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  np.asarray(want["label_preds"]))
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


def test_direction_flip_as_jax():
    """Headings flip by pi exactly where the JAX rule flips them."""
    rng = np.random.RandomState(5)
    anchors = _anchors()
    preds = _preds(rng, len(anchors), 12, b=1)
    preds["box_preds"][..., 6] = rng.uniform(-1.5, 1.5, len(anchors))
    cfg = predict.PredictConfig(nms_pre_max_size=64, nms_post_max_size=16,
                                post_center_range=(-100,) * 3 + (100,) * 3)
    on = predict.predict_batch({k: to_torch(v) for k, v in preds.items()},
                               to_torch(anchors), cfg)
    off = predict.predict_batch({k: to_torch(v) for k, v in preds.items()},
                                to_torch(anchors),
                                cfg._replace(use_dir_classifier=False))
    d = (on["box3d_lidar"] - off["box3d_lidar"])[..., 6].numpy()
    assert np.all(np.isclose(d, 0) | np.isclose(d, np.pi))
    assert np.isclose(d, np.pi).any() and np.isclose(d, 0).any()


def _frustums(b):
    """[b, 6, 4, 3] camera frustums of the synthetic KITTI calibration, the
    image narrowing scene by scene, so each scene culls its own boxes."""
    return np.stack([box_np.get_valid_frustum(
        kitti_synth.R0, kitti_synth.TR, (375, w), kitti_synth.P2)[0]
        for w in np.linspace(1242, 400, b).astype(int)]).astype(np.float32)


@pytest.mark.parametrize("frustum", [False, True], ids=["serving", "frustum"])
@pytest.mark.parametrize("n_hot,branch", [(20, "small"), (50, "full")])
@pytest.mark.parametrize("b", [3, 8])
def test_predict_batch_equals_predict_single_per_scene(b, n_hot, branch,
                                                       frustum):
    rng = np.random.RandomState(100 * b + n_hot)
    anchors = to_torch(_anchors(8, 16))
    preds = {k: to_torch(v)
             for k, v in _preds(rng, len(anchors), n_hot, b).items()}
    cfg = predict.PredictConfig(nms_pre_max_size=64, nms_post_max_size=24,
                                nms_pre_small=32)
    surf = to_torch(_frustums(b)) if frustum else None
    got = predict.predict_batch(preds, anchors, cfg, surf)
    scene_cfg = cfg._replace(nms_pre_max_size=32) if branch == "small" \
        else cfg
    want = [predict.predict_single({k: v[i] for k, v in preds.items()},
                                   anchors, scene_cfg,
                                   None if surf is None else surf[i])
            for i in range(b)]
    for k, v in got.items():
        assert torch.equal(v, torch.stack([w[k] for w in want])), k
    kept = got["valid"].sum(dim=1)
    assert (kept > 0).all()
    if frustum:
        whole = predict.predict_batch(preds, anchors, cfg)["valid"]
        assert (got["valid"] <= whole).all()
        assert got["valid"].sum() < whole.sum()
    elif branch == "small":
        assert (kept < 24).all()  # fewer kept than post
    else:
        assert (kept == 24).any()  # post cuts the kept list


@pytest.mark.parametrize("post", [12, 40])
@pytest.mark.parametrize("thresh", [0.01, 0.3])
def test_batched_nms_twin_equals_rotate_nms_per_scene(thresh, post):
    """The twin the wrapper takes on the CPU: -inf padding, an all-padding
    scene, a one-box scene and tied scores, against rotate_nms after the
    same stable sort; post under pre and equal to it."""
    rng = np.random.RandomState(7)
    b7 = np.stack([_clustered_boxes(rng) for _ in range(4)])  # [4, 48, 7]
    scores = rng.rand(4, 48).astype(np.float32)
    scores[0, 30:] = -np.inf
    scores[1] = -np.inf
    scores[2, 1:] = -np.inf
    scores[3, ::2] = 0.5
    top, order = nms.score_order(to_torch(scores), 40)
    rows = order[..., None].expand(-1, -1, 7)
    keep, valid = nms_cuda.rotated_nms(to_torch(b7).gather(1, rows),
                                       top.contiguous(), post, thresh)
    assert keep.shape == valid.shape == (4, post)
    for i in range(4):
        idx, ok = nms.rotate_nms(to_torch(b7[i][:, [0, 1, 3, 4, 6]]),
                                 to_torch(scores[i]), pre_max_size=40,
                                 post_max_size=post, iou_threshold=thresh)
        assert torch.equal(valid[i], ok)
        assert torch.equal(torch.where(ok, order[i][keep[i]], 0), idx)
    assert valid[1].sum() == 0 and valid[2].sum() == 1
    assert valid[0].sum() > 1


def test_batched_nms_raises_off_cpu_and_cuda():
    """Only CPU tensors take the twin; any other device raises."""
    before = nms_cuda.rotated_nms.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        nms_cuda.rotated_nms(torch.zeros(2, 8, 7, device="meta"),
                             torch.zeros(2, 8, device="meta"), 4, 0.01)
    assert nms_cuda.rotated_nms.launches == before
