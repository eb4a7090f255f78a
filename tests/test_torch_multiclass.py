"""The 3-class SE-SSD config (``sessd_torch/configs/se_ssd_kitti_3class.py``)
in the port, on the CPU in f32, against the JAX package:

- ``builder.build_anchors`` equals the dataset's anchors
  (``Pipeline.anchors``, the port's copy and JAX's) for the Car, 3-class and
  PointPillars configs: 70,400, 211,200 and 107,136 anchors in the head's
  (y, x, class, rot) order;
- the 3-class VoxelNet forward on a tiny grid (tests/test_multiclass.py:159)
  equals JAX's on the same weights within 1e-4 of each output's max, with
  ``cls_preds`` [B, H*W*6, 3];
- one supervised (``enable_ssl=False``) 3-class step equals
  ``make_train_step(enable_ssl=False)``: loss terms within 1e-4 relative,
  each gradient tensor within 1e-3 of its max (sums through 24 convs,
  BatchNorm and the ODIoU geometry in another order, as
  tests/test_torch_train_step.py says).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sessd_tpu import builder as jax_builder
from sessd_tpu.config import Config as JaxConfig
from sessd_tpu.data.pipeline import Pipeline as JaxPipeline
from sessd_tpu.models import VoxelNet as JaxVoxelNet
from sessd_tpu.train import losses as jl
from sessd_tpu.train import optim as jo
from sessd_tpu.train.train_step import TrainState as JaxTrainState
from sessd_tpu.train.train_step import make_train_step as jax_make_step
from sessd_torch import builder
from sessd_torch.core.anchors import create_anchors_3d_range
from sessd_torch.data.pipeline import Pipeline
from sessd_torch.models.detector import VoxelNet
from sessd_torch.tools import train as train_cli
from sessd_torch.train import losses as tl
from sessd_torch.train import optim as to
from sessd_torch.train.train_step import TrainState, make_train_step
from sessd_torch.utils.convert_jax import convert_jax, convert_train_state
from tests.test_torch_common import (CAPS, SPARSE_SHAPE, host_inputs,
                                     random_variables, rel_err, to_torch)
from tests.test_torch_train_step import (_capture_grads, as_torch,
                                         port_batch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

REPO = builder.CONFIG_DIR.parents[1]
TASKS = (dict(num_class=3, class_names=("Car", "Pedestrian", "Cyclist")),)
B = 2
K = 64  # top-K of positives (96 anchors)
OCFG = dict(lr_max=3e-3, total_steps=100)


@pytest.mark.parametrize("name,count", [
    ("se_ssd_kitti_car.py", 70400), ("se_ssd_kitti_3class.py", 211200),
    ("point_pillars_kitti_car.py", 107136)])
def test_build_anchors_equal_the_datasets(name, count):
    cfg = builder.load_config(name)
    got = builder.build_anchors(cfg)
    assert got.shape == (count, 7) and got.dtype == np.float32
    want = Pipeline(builder.build_pipeline_config(cfg), mode="val").anchors
    np.testing.assert_array_equal(got, want)
    jcfg = JaxConfig.fromfile(REPO / "sessd_tpu" / "configs" / name)
    np.testing.assert_array_equal(got, JaxPipeline(
        jax_builder.build_pipeline_config(jcfg), mode="val").anchors)


def test_3class_anchor_order():
    """Per cell: Car, Pedestrian, Cyclist, each at rotations 0 and pi/2."""
    grid = builder.build_anchors(builder.load_config(
        "se_ssd_kitti_3class.py")).reshape(200, 176, 3, 2, 7)
    np.testing.assert_allclose(grid[0, 0, :, 0, 3:6], [
        [1.6, 3.9, 1.56], [0.6, 0.8, 1.73], [0.6, 1.76, 1.73]], atol=1e-6)
    np.testing.assert_allclose(grid[0, 0, 0, :, 6], [0.0, np.pi / 2],
                               atol=1e-6)


def test_3class_builders():
    cfg = builder.load_config("se_ssd_kitti_3class.py")
    model = builder.build_detector(cfg)
    assert isinstance(model, VoxelNet)
    head = model.bbox_head.tasks[0]
    assert head.conv_cls.out_channels == 18 and head.conv_box.out_channels \
        == 42
    assert not cfg.my_paras["enable_ssl"]
    assert builder.build_loss_config(cfg).reg_loss == "odiou"
    pcfg = builder.build_predict_config(cfg)
    assert pcfg.nms_type == "rotate_nms"
    cfg.test_cfg["nms"]["nms_type"] = "rotate_weighted_nms"
    assert builder.build_predict_config(cfg).nms_type == \
        "rotate_weighted_nms" == jax_builder.build_predict_config(
            cfg).nms_type
    cfg.test_cfg["nms"]["nms_type"] = "other"
    with pytest.raises(ValueError):
        builder.build_predict_config(cfg)


def test_data_root_swap(tmp_path):
    cfg = train_cli.load("se_ssd_kitti_3class.py", str(tmp_path))
    paths = [cfg.data[s][k] for s in ("train", "val", "test")
             for k in ("root_path", "info_path")]
    paths.append(cfg.db_sampler["db_info_path"])
    assert all(p.startswith(str(tmp_path)) for p in paths), paths
    assert cfg.data["train"]["class_names"] == ["Car", "Pedestrian",
                                                "Cyclist"]


@functools.lru_cache(maxsize=None)
def jax_variables():
    feats, coords, valid, rb = host_inputs(0)
    model = JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                        tasks=TASKS, dense_from_stage=5, conv_impl="gather")
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), feats[:, None, :], coords,
                           np.ones(len(feats), np.int32), valid, 1,
                           train=False, rulebooks=rb))
    return random_variables(shapes, seed=6)


def test_3class_forward_matches_jax():
    feats, coords, valid, rb = host_inputs(3, b=B)
    model_j = JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                          tasks=TASKS, dense_from_stage=5, conv_impl="gather")
    ones = np.ones(len(feats), np.int32)
    want = model_j.apply(jax_variables(), feats[:, None, :], coords, ones,
                         valid, B, train=False, rulebooks=rb)[0]
    model = VoxelNet(sparse_shape=SPARSE_SHAPE, tasks=TASKS)
    model.load_state_dict(convert_jax(jax.tree_util.tree_map(
        np.asarray, jax_variables())))
    with torch.inference_mode():
        got = model.eval()(to_torch(feats)[:, None, :], to_torch(ones),
                           as_torch(rb), B)[0]
    assert got["cls_preds"].shape == (B, 4 * 4 * 6, 3)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) < 1e-4, k


def make_batch(seed=21):
    """Loader-layout batch over the 4 x 4 x 3 x 2 anchors of the cropped
    grid, labels in {-1, 0, 1, 2, 3}."""
    feats, coords, valid, rb = host_inputs(seed, b=B)
    rng = np.random.RandomState(seed)
    v = CAPS[0]
    anchors = np.concatenate([create_anchors_3d_range(
        [1, 4, 4], [0, -40, z, 70.4, 40, z], sizes) for z, sizes in (
            (-1.0, (1.6, 3.9, 1.56)), (-0.6, (0.6, 0.8, 1.73)),
            (-0.6, (0.6, 1.76, 1.73)))], axis=3).reshape(-1, 7)
    a = anchors.shape[0]
    labels = rng.choice([-1, 0, 1, 2, 3], (B, a),
                        p=[0.1, 0.5, 0.2, 0.1, 0.1]).astype(np.int32)
    return {
        "voxels": feats.reshape(B, v, 1, 4),
        "coords": coords[:, 1:].reshape(B, v, 3),
        "num_points": np.ones((B, v), np.int32),
        "voxel_mask": valid.reshape(B, v),
        "rulebooks": rb,
        "anchors": np.broadcast_to(anchors, (B, a, 7)).astype(np.float32),
        "labels": labels,
        "reg_targets": (rng.randn(B, a, 7) * 0.1).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def steps():
    """(JAX grads as a port state dict, JAX metrics, port grads by
    parameter name, port metrics) of one supervised step from one state."""
    var = jax_variables()
    model = JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                        tasks=TASKS, dense_from_stage=3, conv_impl="gather",
                        backbone_remat=False)
    opt = optax.chain(_capture_grads(),
                      jo.build_optimizer(jo.OneCycleConfig(**OCFG)))
    state = JaxTrainState(
        step=jnp.int32(3), params=var["params"],
        batch_stats=var["batch_stats"], ema_params=var["params"],
        ema_batch_stats=var["batch_stats"],
        opt_state=opt.init(var["params"]))
    step = jax_make_step(model, opt, jl.LossConfig(max_positive_anchors=K),
                         enable_ssl=False)
    new, metrics = jax.jit(step)(state, make_batch(), jnp.float32(0.0))
    new = jax.tree_util.tree_map(np.asarray, new)
    want_grads = convert_train_state(
        new._replace(params=new.opt_state[0]))["student"]

    conv = convert_train_state(jax.tree_util.tree_map(np.asarray, state))
    student = VoxelNet(sparse_shape=SPARSE_SHAPE, tasks=TASKS,
                       dense_from_stage=3)
    teacher = VoxelNet(sparse_shape=SPARSE_SHAPE, tasks=TASKS)
    student.load_state_dict(conv["student"])
    teacher.load_state_dict(conv["teacher"])
    ocfg = to.OneCycleConfig(**OCFG)
    opt_t = to.AdamW(list(student.parameters()), to.one_cycle_lr(ocfg),
                     to.one_cycle_mom(ocfg))
    grads = {}
    real = opt_t.step

    def capture(gs):
        grads.update(zip([n for n, _ in student.named_parameters()],
                         [g.clone() for g in gs]))
        return real(gs)

    opt_t.step = capture
    got = make_train_step(tl.LossConfig(max_positive_anchors=K),
                          enable_ssl=False)(
        TrainState(conv["step"], student, teacher, opt_t),
        port_batch(make_batch()), 0.0)
    return (want_grads, {k: float(v) for k, v in metrics.items()}, grads,
            {k: float(v) for k, v in got.items()})


def test_3class_step_loss_terms():
    _, want, _, got = steps()
    assert set(want) == set(got)
    assert want["num_pos"] > 0 and want["ious_loss"] > 0
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v) + 1e-7, (k, got[k], v)


def test_3class_step_gradients():
    want, _, got, _ = steps()
    assert set(got) <= set(want)
    assert got["bbox_head.tasks.0.conv_cls.weight"].shape[0] == 18
    for name, g in got.items():
        w = want[name].numpy()
        if not np.any(w):
            assert not g.any(), name
            continue
        assert rel_err(g, w) < 1e-3, name
