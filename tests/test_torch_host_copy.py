"""The port's copy of the JAX package's host layer against the original, on
the CPU: configs, synthetic scenes and KITTI roots, the serving
preprocessor, the dataset (augmentation, GT sampling, targets), the batch
rulebook chain, the KITTI AP evaluation, the frustum cull and the host NMS
oracles all give the same values, bit for bit. The two packages build the C++ host library from
the same sources into separate files."""
import pathlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu import builder as jax_builder
from sessd_tpu import config as jax_config
from sessd_tpu import serve as jax_serve
from sessd_tpu.core import nms_np as jax_nms_np
from sessd_tpu.data import kitti_eval as jax_kitti_eval
from sessd_tpu.data import rulebooks as jax_rulebooks
from sessd_tpu.models import predict as jax_predict
from sessd_tpu.utils import synth_scene as jax_synth
from sessd_torch import builder, config, serve
from sessd_torch.core import nms_np
from sessd_torch.data import kitti_eval, rulebooks
from sessd_torch.models import predict
from sessd_torch.ops.voxelize import KITTI_VOXELIZER
from sessd_torch.tools import train as train_cli
from sessd_torch.tools.create_data import create_kitti_data
from sessd_torch.utils import kitti_synth, synth_scene

import kitti_synth as jax_kitti_synth
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_same(a, b, path="out"):
    """Equal structure, types and values; arrays bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), path


def _public(cfg):
    return {k: v for k, v in cfg._cfg.items() if not k.startswith("_")}


@pytest.mark.parametrize("name", ["se_ssd_kitti_car.py",
                                  "se_ssd_kitti_car_bf16.py",
                                  "cia_ssd_kitti_car.py",
                                  "se_ssd_kitti_3class.py",
                                  "point_pillars_kitti_car.py"])
def test_config_copy(name):
    ours = builder.load_config(name)
    theirs = jax_config.Config.fromfile(
        REPO_ROOT / "sessd_tpu" / "configs" / name)
    assert isinstance(ours, config.Config)
    _assert_same(_public(ours), _public(theirs))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_scene_copy(seed):
    _assert_same(synth_scene.make_scene(seed=seed),
                 jax_synth.make_scene(seed=seed))


@pytest.fixture(scope="module")
def scenes():
    return [jax_synth.make_scene(seed=s)[0] for s in range(8)]


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_host_preprocessor_copy(scenes, batch):
    ours = serve.HostPreprocessor(KITTI_VOXELIZER, serve.SERVING_CAPS)
    theirs = jax_serve.HostPreprocessor(KITTI_VOXELIZER, serve.SERVING_CAPS)
    assert ours.native is not theirs.native
    if batch == 1:
        got, want = ours(scenes[0]), theirs(scenes[0])
    else:
        got, want = ours.batch(scenes[:batch]), theirs.batch(scenes[:batch])
    _assert_same(got, want)
    assert got["rulebooks"]["subm"][0].dtype == (np.int16 if batch == 1
                                                 else np.int32)
    assert serve.saturated_stages(got["rulebooks"], [
        c * batch for c in serve.SERVING_CAPS]) == jax_serve.saturated_stages(
        want["rulebooks"], [c * batch for c in serve.SERVING_CAPS])
    assert (serve.SERVING_CAPS, serve.TRAIN_CAPS, serve.DOWNS) == (
        jax_serve.SERVING_CAPS, jax_serve.TRAIN_CAPS, jax_rulebooks.DOWNS)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_copy")
    root = tmp / "kitti"
    boxes = kitti_synth.make_kitti_root(root, num_frames=2, num_cars=3)
    create_kitti_data(str(root), {"train": range(2), "val": range(2)})
    return root, boxes, tmp


def test_kitti_root_copy(kitti_root):
    root, boxes, tmp = kitti_root
    want = jax_kitti_synth.make_kitti_root(tmp / "ref", num_frames=2,
                                           num_cars=3)
    _assert_same(boxes, want)
    for sub in ("velodyne", "label_2", "calib"):
        for f in sorted((root / "training" / sub).iterdir()):
            assert f.read_bytes() == (tmp / "ref" / "training" / sub
                                      / f.name).read_bytes(), f


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_copy(kitti_root, split):
    """One example of each split, augmentation and GT sampling included,
    from the same seeds."""
    root = kitti_root[0]
    cfg = train_cli.load("se_ssd_kitti_car.py", str(root))
    ours = builder.build_dataset(cfg, split, seed=1)
    theirs = jax_builder.build_dataset(cfg, split, seed=1)
    got = ours.get_sensor_data(1, rng=np.random.RandomState(5))
    want = theirs.get_sensor_data(1, rng=np.random.RandomState(5))
    _assert_same(got, want)
    assert got["voxel_mask"].any()


def test_batch_rulebooks_copy(scenes):
    """The loader's chain over a batch of two voxelized scenes."""
    prep = serve.HostPreprocessor(KITTI_VOXELIZER, serve.TRAIN_CAPS)
    coords, mask = [], []
    for pts in scenes[:2]:
        _, c, _ = prep.native.voxelize(pts, KITTI_VOXELIZER.point_cloud_range,
                                       KITTI_VOXELIZER.voxel_size, 5, 20000)
        coords.append(np.zeros((20000, 3), np.int32))
        coords[-1][:len(c)] = c
        mask.append(np.arange(20000) < len(c))
    args = (np.stack(coords), np.stack(mask), KITTI_VOXELIZER.sparse_shape,
            serve.TRAIN_CAPS)
    _assert_same(rulebooks.build_batch_rulebooks(*args),
                 jax_rulebooks.build_batch_rulebooks(*args))


def _annos(rng, n_frames=6):
    """Random Car ground truth and jittered detections of it, some missed
    and some false, so every AP lies strictly between 0 and 100."""
    gts, dts = [], []
    for _ in range(n_frames):
        n = rng.randint(3, 8)
        loc = np.stack([rng.uniform(-20, 20, n), rng.uniform(0.5, 2.5, n),
                        rng.uniform(5, 60, n)], axis=1)
        dims = np.stack([rng.uniform(3.2, 4.6, n), rng.uniform(1.4, 1.8, n),
                         rng.uniform(1.5, 1.9, n)], axis=1)
        bbox = np.stack([rng.uniform(0, 500, n), rng.uniform(0, 200, n)], 1)
        gt = {"name": np.array(["Car"] * n), "truncated": np.zeros(n),
              "occluded": rng.randint(0, 3, n).astype(np.int64),
              "alpha": rng.uniform(-np.pi, np.pi, n),
              "bbox": np.concatenate([bbox, bbox + [100, 80]], axis=1),
              "dimensions": dims, "location": loc,
              "rotation_y": rng.uniform(-np.pi, np.pi, n),
              "score": np.zeros(n)}
        keep = rng.rand(n) > 0.2
        dt = {k: v[keep].copy() for k, v in gt.items()}
        m = int(keep.sum())
        dt["location"] += rng.normal(0, 0.1, (m, 3))
        dt["dimensions"] *= rng.uniform(0.95, 1.05, (m, 3))
        dt["rotation_y"] += rng.normal(0, 0.05, m)
        dt["bbox"] += rng.normal(0, 2, (m, 4))
        dt["score"] = rng.uniform(0.2, 1.0, m)
        gts.append(gt)
        dts.append(dt)
    return gts, dts


def test_kitti_eval_copy():
    gts, dts = _annos(np.random.RandomState(0))
    got = kitti_eval.get_official_eval_result(gts, dts, classes=("Car",))
    want = jax_kitti_eval.get_official_eval_result(gts, dts,
                                                    classes=("Car",))
    _assert_same(got, want)
    aps = [v for m in got["Car"].values() for d in m.values()
           for k, v in d.items() if k.startswith("AP")]
    assert 0 < min(aps) and max(aps) < 100
    assert kitti_eval.format_results(got) == \
        jax_kitti_eval.format_results(want)
    assert pickle.dumps(got) == pickle.dumps(want)


def test_points_in_frustum_copy(kitti_root):
    """The port's cull against the JAX one on a real frustum of the
    synthetic root (the val pipeline's) and points around it."""
    cfg = train_cli.load("se_ssd_kitti_car.py", str(kitti_root[0]))
    frustum = builder.build_dataset(cfg, "val").get_sensor_data(0)["frustum"]
    pts = np.random.RandomState(0).uniform(
        [-10, -60, -4], [90, 60, 4], (4000, 3)).astype(np.float32)
    got = predict.points_in_frustum(torch.from_numpy(pts),
                                    torch.from_numpy(frustum)).numpy()
    want = np.asarray(jax_predict.points_in_frustum(jnp.asarray(pts),
                                                    jnp.asarray(frustum)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("seed", [0, 6])
def test_nms_np_copy(seed):
    """``core/nms_np.py``: DI-NMS with its centerness damping, and the plain
    rotated NMS, on clustered boxes with two labels."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform([5, -30], [65, 30], (6, 2))
    n = 40
    b7 = np.zeros((n, 7), np.float32)
    b7[:, :2] = centers[rng.randint(0, 6, n)] + rng.normal(0, 0.4, (n, 2))
    b7[:, 2:6] = (-1.0, 1.6, 3.9, 1.5) + rng.normal(0, 0.05, (n, 4))
    b7[:, 6] = rng.uniform(-0.3, 0.3, n)
    b5 = b7[:, [0, 1, 3, 4, 6]]
    scores = rng.uniform(0.3, 1.0, n).astype(np.float32)
    iou_preds = rng.uniform(0.6, 1.0, n).astype(np.float32)
    dirs = rng.randint(0, 2, n).astype(np.int32)
    labels = rng.randint(0, 2, n).astype(np.int32)
    anchors = b7 + rng.normal(0, 0.2, b7.shape).astype(np.float32)
    damped = nms_np.centerness_damp(b7, anchors, scores)
    _assert_same(damped, jax_nms_np.centerness_damp(b7, anchors, scores))
    got = nms_np.rotate_weighted_nms_np(b7, b5, dirs, labels, damped,
                                        iou_preds)
    _assert_same(got, jax_nms_np.rotate_weighted_nms_np(
        b7, b5, dirs, labels, damped, iou_preds))
    assert len(got[4]) > 0
    _assert_same(nms_np.rotate_nms_np(b5, scores, 0.1),
                 jax_nms_np.rotate_nms_np(b5, scores, 0.1))
