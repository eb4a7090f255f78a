"""PointPillars of the port (``sessd_torch/models/pillars.py``) against the
JAX package's (``sessd_tpu/models/pillars.py``) and the reference's own
torch code, on the CPU in f32:

- PFN (both ``ref_compat``), scatter, RPN and the whole chain through the
  head, in eval and in train-mode BatchNorm (running statistics too), on
  seeded numpy inputs with JAX variables carried across by
  ``convert_jax``: within 1e-4 of the JAX output's max;
- the reference's state dict (``tests/goldens/ref_pillars.npz``, weights
  regenerated from its names) loaded into the port as it is: PFN, canvas
  and RPN within the bounds of tests/test_pillars_goldens.py (1e-5, 1e-6
  absolute, 2e-4 relative);
- the quarter-scale predict chain of tests/test_pillars_predict_e2e.py:
  the same detections as JAX (boxes 1e-4, scores 1e-5, masks exactly);
- serving through ``PillarPreprocessor`` + ``make_pillar_infer_fn``, and a
  tiny PointPillars ``Trainer`` that takes two steps and validates.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.models import pillars as jp
from sessd_tpu.models.predict import PredictConfig as JaxPredictConfig
from sessd_tpu.models.predict import predict_batch as jax_predict_batch
from sessd_tpu.ops.voxelize import VoxelizerSpec, voxelize_np
from sessd_tpu.utils.synth_scene import make_scene
from sessd_torch import builder
from sessd_torch.core.anchors import create_anchors_3d_range
from sessd_torch.models import pillars as tp
from sessd_torch.models.predict import PredictConfig, predict_batch
from sessd_torch.serve import PillarPreprocessor, make_pillar_infer_fn
from sessd_torch.tools import train as train_cli
from sessd_torch.tools.create_data import create_kitti_data
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils.convert_jax import convert_jax
from sessd_torch.utils.kitti_synth import make_kitti_root
from tests.golden_utils import reference_state_dict
from tests.test_torch_common import random_variables, rel_err, to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

B, V, P = 2, 96, 8
PC_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VOXEL = (0.5, 0.5)
NY = NX = 32
TOL = 1e-4


def make_inputs(seed=0):
    """B samples of V pillar slots, the first 60-80 real: unique cells,
    1..P points each inside their pillar; padding rows carry garbage the
    masks must hide."""
    rng = np.random.RandomState(seed)
    voxels = rng.randn(B * V, P, 4).astype(np.float32)
    coords = np.zeros((B * V, 4), np.int32)
    num_points = np.zeros(B * V, np.int32)
    valid = np.zeros(B * V, bool)
    for s in range(B):
        n = rng.randint(60, 81)
        cells = rng.choice(NY * NX, n, replace=False)
        o = s * V
        coords[o:o + n, 0] = s
        coords[o:o + n, 2], coords[o:o + n, 3] = np.divmod(cells, NX)
        num_points[o:o + n] = rng.randint(1, P + 1, n)
        x0 = coords[o:o + n, 3] * VOXEL[0] + PC_RANGE[0]
        y0 = coords[o:o + n, 2] * VOXEL[1] + PC_RANGE[1]
        voxels[o:o + n, :, 0] = x0[:, None] + rng.rand(n, P) * VOXEL[0]
        voxels[o:o + n, :, 1] = y0[:, None] + rng.rand(n, P) * VOXEL[1]
        valid[o:o + n] = True
    return voxels, coords, num_points, valid


@functools.lru_cache(maxsize=None)
def variables():
    """Random nontrivial PointPillars variables (tree from tracing init)."""
    inputs = make_inputs()
    shapes = jax.eval_shape(lambda: jp.PointPillars(
        grid_size=(NY, NX), voxel_size=VOXEL, pc_range=PC_RANGE).init(
        jax.random.PRNGKey(0), *inputs[:1], inputs[1], inputs[2], inputs[3],
        B, train=False))
    return random_variables(shapes, seed=3)


def port_model(ref_compat=False):
    m = tp.PointPillars(grid_size=(NY, NX), voxel_size=VOXEL,
                        pc_range=PC_RANGE, ref_compat=ref_compat)
    m.load_state_dict(convert_jax(jax.tree_util.tree_map(np.asarray,
                                                         variables())))
    return m


def _sub(variables_, name):
    return {k: v[name] for k, v in variables_.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("ref_compat", [False, True])
def test_pfn_matches_jax(ref_compat, train):
    voxels, coords, npts, valid = make_inputs(1)
    net = jp.PillarFeatureNet(voxel_size=VOXEL, pc_range=PC_RANGE,
                              ref_compat=ref_compat)
    reader = _sub(variables(), "reader")
    out = net.apply(reader, voxels, npts, coords, valid, train,
                    mutable=["batch_stats"] if train else False)
    want, new = (out if train else (out, None))
    model = port_model(ref_compat)
    model.train(train)
    got = model.reader(*map(to_torch, (voxels, npts, coords, valid)))
    assert rel_err(got.detach(), want) < TOL
    assert not got[~to_torch(valid)].any()
    if train:
        stats = new["batch_stats"]["PFNLayer_0"]["MaskedBatchNorm_0"]
        norm = model.reader.pfn_layers[0].norm
        assert rel_err(norm.running_mean, stats["mean"]) < 1e-5
        assert rel_err(norm.running_var, stats["var"]) < 1e-5


def test_scatter_matches_jax():
    voxels, coords, npts, valid = make_inputs(2)
    feats = np.random.RandomState(0).randn(B * V, 64).astype(np.float32)
    want = jp.pillar_scatter(jnp.asarray(feats), coords, valid, B, NY, NX)
    got = tp.pillar_scatter(*map(to_torch, (feats, coords, valid)), B, NY,
                            NX)
    assert got.shape == (B, 64, NY, NX)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_rpn_matches_jax(train):
    x = np.random.RandomState(4).randn(B, NY, NX, 64).astype(np.float32)
    neck = _sub(variables(), "neck")
    out = jp.RPN().apply(neck, x, train,
                         mutable=["batch_stats"] if train else False)
    want = out[0] if train else out
    model = port_model()
    model.train(train)
    got = model.neck(to_torch(x).permute(0, 3, 1, 2))
    assert got.shape == (B, 384, NY // 2, NX // 2)
    assert rel_err(got.detach().permute(0, 2, 3, 1), want) < TOL
    if train:  # the last upsampler's BatchNorm moved as flax's did
        stats = out[1]["batch_stats"]["ConvBnRelu_18"]["BatchNorm_0"]
        bn = model.neck.deblocks[2][1]
        assert rel_err(bn.running_mean, stats["mean"]) < 1e-5
        assert rel_err(bn.running_var, stats["var"]) < 1e-5


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_full_chain_matches_jax(train):
    """PFN -> scatter -> RPN -> head, every head output."""
    voxels, coords, npts, valid = make_inputs(5)
    model_j = jp.PointPillars(grid_size=(NY, NX), voxel_size=VOXEL,
                              pc_range=PC_RANGE)
    out = model_j.apply(variables(), voxels, coords, npts, valid, B,
                        train=train,
                        mutable=["batch_stats"] if train else False)
    want = (out[0] if train else out)[0]
    model = port_model()
    model.train(train)
    got = model(to_torch(voxels), to_torch(npts),
                {"coords": to_torch(coords), "valid": to_torch(valid)}, B)[0]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k].detach(), want[k]) < TOL, k


def test_reset_parameters_is_seeded():
    a, b = (tp.PointPillars(grid_size=(NY, NX)) for _ in range(2))
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(7))
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    assert a.reader.pfn_layers[0].linear.weight.std() > 0


# --- the reference's own torch code (tests/test_pillars_goldens.py) ------

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "ref_pillars.npz")
GOLDEN_RANGE = (0.0, -9.6, -3.0, 19.2, 9.6, 1.0)


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    sd = reference_state_dict(g["sd_names"], g["sd_shapes"])
    model = tp.PointPillars(grid_size=(96, 96), voxel_size=(0.2, 0.2),
                            pc_range=GOLDEN_RANGE, ref_compat=True)
    # the reference's reader and neck, loaded as they are; the head is ours
    head = {k: v for k, v in model.state_dict().items()
            if k.startswith("bbox_head.")}
    model.load_state_dict({**{k: torch.from_numpy(v) for k, v in sd.items()},
                           **head})
    return g, model.eval()


def _golden_pfn(g, model):
    n = g["voxels"].shape[0]
    coords = np.concatenate([np.zeros((n, 1), np.int32), g["coords_zyx"]], 1)
    with torch.no_grad():
        return model.reader(to_torch(g["voxels"]), to_torch(g["num_points"]),
                            to_torch(coords), torch.ones(n, dtype=bool)), \
            to_torch(coords)


def test_golden_pfn(golden):
    g, model = golden
    got = _golden_pfn(g, model)[0].numpy()
    ref = g["pfn_out"]
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6) < 1e-5
    # the default PFN does not match: ref_compat is load-bearing
    model.reader.ref_compat = False
    for layer in model.reader.pfn_layers:
        layer.ref_compat = False
    try:
        assert np.abs(_golden_pfn(g, model)[0].numpy() - ref).max() > 1e-3
    finally:
        model.reader.ref_compat = True
        for layer in model.reader.pfn_layers:
            layer.ref_compat = True


def test_golden_canvas_and_rpn(golden):
    g, model = golden
    n = g["pfn_out"].shape[0]
    coords = np.concatenate([np.zeros((n, 1), np.int32), g["coords_zyx"]], 1)
    canvas = tp.pillar_scatter(to_torch(g["pfn_out"]), to_torch(coords),
                               torch.ones(n, dtype=bool), 1, 96, 96)
    np.testing.assert_allclose(canvas.numpy(), g["canvas"], atol=1e-6)
    with torch.no_grad():
        rpn = model.neck(to_torch(g["canvas"])).numpy()
        feats, coords_t = _golden_pfn(g, model)
        chain = model.neck(tp.pillar_scatter(
            feats, coords_t, torch.ones(n, dtype=bool), 1, 96, 96)).numpy()
    ref = g["rpn_out"]
    scale = np.abs(ref).max() + 1e-6
    assert rpn.shape == ref.shape
    assert np.abs(rpn - ref).max() / scale < 2e-4
    assert np.abs(chain - ref).max() / scale < 5e-4


# --- the quarter-scale predict chain (tests/test_pillars_predict_e2e.py) --

E2E_SPEC = VoxelizerSpec((0.0, -20.48, -3.0, 35.84, 20.48, 1.0),
                         (0.32, 0.32, 4.0), max_points=32, max_voxels=4000)


@pytest.mark.parametrize("score_threshold", [0.01, 0.5])
def test_predict_chain_matches_jax(score_threshold):
    spec = E2E_SPEC
    nx, ny, _ = spec.grid_size
    voxels, coords, npts, masks = [], [], [], []
    for s in range(B):
        pts, _ = make_scene(seed=s, n_cars=6)
        keep = ((pts[:, 0] >= 0) & (pts[:, 0] < 35.84)
                & (np.abs(pts[:, 1]) < 20.48))
        v, c, n = voxelize_np(pts[keep], spec)
        k = v.shape[0]
        pv = np.zeros((spec.max_voxels, spec.max_points, 4), np.float32)
        pc = np.zeros((spec.max_voxels, 3), np.int32)
        pn = np.zeros((spec.max_voxels,), np.int32)
        pm = np.zeros((spec.max_voxels,), bool)
        pv[:k], pc[:k], pn[:k], pm[:k] = v, c, n, True
        voxels.append(pv), coords.append(pc), npts.append(pn)
        masks.append(pm)
    voxels = np.stack(voxels).reshape(-1, spec.max_points, 4)
    placement = tp.pillar_inputs(np.stack(coords), np.stack(masks))
    npts = np.stack(npts).reshape(-1)
    model_j = jp.PointPillars(grid_size=(ny, nx), voxel_size=(0.32, 0.32),
                              pc_range=spec.point_cloud_range)
    args = (voxels, placement["coords"], npts, placement["valid"], B)
    var = model_j.init(jax.random.PRNGKey(0), *args, train=False)
    anchors = create_anchors_3d_range(
        (1, ny // 2, nx // 2),
        (0.0, -20.48, -1.0, 35.84, 20.48, -1.0)).reshape(-1, 7)
    kw = dict(nms_pre_max_size=256, nms_post_max_size=32,
              score_threshold=score_threshold,
              post_center_range=(0.0, -20.48, -5.0, 35.84, 20.48, 5.0))
    preds_j = model_j.apply(var, *args, train=False)
    want = jax.device_get(jax_predict_batch(
        preds_j[0], jnp.asarray(anchors), None, JaxPredictConfig(**kw)))

    model = tp.PointPillars(grid_size=(ny, nx), voxel_size=(0.32, 0.32),
                            pc_range=spec.point_cloud_range)
    model.load_state_dict(convert_jax(jax.device_get(var)))
    with torch.no_grad():
        preds = model.eval()(to_torch(voxels), to_torch(npts),
                             {k: to_torch(v) for k, v in placement.items()},
                             B)
    for k in preds_j[0]:
        assert rel_err(preds[0][k], preds_j[0][k]) < TOL, k
    got = predict_batch(preds[0], to_torch(anchors), PredictConfig(**kw))
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               want["box3d_lidar"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    assert got["valid"].sum() > 0


# --- entry points ---------------------------------------------------------

def test_builder_pillars():
    cfg = builder.load_config("point_pillars_kitti_car.py")
    model = builder.build_detector(cfg)
    assert isinstance(model, tp.PointPillars)
    assert model.grid_size == (496, 432)
    assert model.reader.voxel_size == (0.16, 0.16)
    assert model.bbox_head.tasks[0].conv_cls.in_channels == 384
    assert builder.build_anchors(cfg).shape == (107136, 7)
    # inherited as in JAX (sessd_tpu/builder.py:228): ROADMAP's reg_loss gap
    assert builder.build_loss_config(cfg).reg_loss == "odiou"


TINY = """
__file__ = _base = "{BASE}"
exec(compile(open(_base).read(), _base, "exec"))
voxel_generator = dict(voxel_generator,
                       range=[0, -20.48, -3.0, 40.96, 20.48, 1.0],
                       voxel_size=[0.64, 0.64, 4.0], max_points_in_voxel=16,
                       max_voxel_num=1500)
test_cfg = dict(test_cfg, score_threshold=0.05,
                post_center_limit_range=[0, -20.48, -5.0, 40.96, 20.48, 5.0])
data = dict(data, samples_per_gpu=2, workers_per_gpu=2)
total_epochs = 1
"""


def test_trainer_steps_and_validates(tmp_path):
    """A PointPillars Trainer (no rulebooks) on a 3-frame synthetic root at
    a 64 x 64 pillar grid: two finite steps that move the student, a
    validation with an AP table; serving the trained student gives the
    same head outputs as the eval path's model call."""
    root = tmp_path / "kitti"
    make_kitti_root(root, num_frames=3, num_cars=3)
    create_kitti_data(str(root), {"train": range(3), "val": range(3)})
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text(TINY.replace("{BASE}", str(
        builder.CONFIG_DIR / "point_pillars_kitti_car.py")))
    cfg = train_cli.load(str(cfg_path), str(root))
    trainer = Trainer(cfg, work_dir=str(tmp_path / "work"), device="cpu")
    batches = iter(trainer.train_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    # the model's host inputs: the pillars' placement, no chain
    assert "rulebooks" not in batch and batch["saturated"] == []
    assert set(batch["inputs"]) == {"coords", "valid"}
    start = [p.detach().clone() for p in trainer.state.student.parameters()]
    assert trainer.run(max_steps=2) is None
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert any(not torch.equal(p, q) for p, q in
               zip(trainer.state.student.parameters(), start))
    results = trainer.validate()
    assert set(results) == {"Car"} and trainer.val_history

    spec = builder.build_voxelizer(cfg.voxel_generator)
    prep = PillarPreprocessor(spec)
    pts = make_scene(seed=1)[0]
    p = prep(pts)
    v, c, n = prep.native.voxelize(pts, spec.point_cloud_range,
                                   spec.voxel_size, spec.max_points,
                                   spec.max_voxels)
    assert p["pillars"]["valid"].sum() == len(c) > 0
    np.testing.assert_array_equal(p["pillars"]["coords"][:len(c), 1:], c)
    model = trainer.state.student
    infer = make_pillar_infer_fn(model, trainer.anchors,
                                 trainer.predict_cfg, 1, "cpu")
    boxes, scores, valid = infer(p)
    post = trainer.predict_cfg.nms_post_max_size
    assert boxes.shape == (1, post, 7) and valid.shape == (1, post)
    with torch.inference_mode():
        preds = model(to_torch(p["voxels"]), to_torch(p["num_points"]),
                      {k: to_torch(x) for k, x in p["pillars"].items()}, 1)
    want = predict_batch({k: x.float() for k, x in preds[0].items()},
                         trainer.anchors, trainer.predict_cfg)
    np.testing.assert_array_equal(valid.numpy(), want["valid"].numpy())
    np.testing.assert_array_equal(boxes.numpy(), want["box3d_lidar"].numpy())


def test_data_root_swap(tmp_path):
    cfg = train_cli.load("point_pillars_kitti_car.py", str(tmp_path))
    paths = [cfg.data[s][k] for s in ("train", "val")
             for k in ("root_path", "info_path")]
    paths.append(cfg.db_sampler["db_info_path"])
    assert all(p.startswith(str(tmp_path)) for p in paths), paths
