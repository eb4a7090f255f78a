"""The port's serving front end and builder on the CPU, at a cropped grid:
ExactBatchServer's capacity-saturation re-run, batch-4 and batch-8 serving
on int32 chains (batch 8 partly through the stream kernel's path) against
batch-1 serving, and the config builders (det3d parameter
names, compute dtype, the predict config the JAX builder gives)."""
import os

import numpy as np
import pytest
import torch

from sessd_tpu.builder import build_predict_config as jax_predict_config
from sessd_tpu.config import Config
from sessd_tpu.core.anchors import create_anchors_3d_range
from sessd_tpu.ops.voxelize import KITTI_VOXELIZER, VoxelizerSpec
from sessd_torch import builder
from sessd_torch.models import backbone as bb
from sessd_torch.models.detector import VoxelNet
from sessd_torch.models.predict import PredictConfig
from sessd_torch.ops.voxelize import KITTI_VOXELIZER as PORT_KITTI_VOXELIZER
from sessd_torch.serve import ExactBatchServer, make_infer_fn
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAR = os.path.join(REPO, "sessd_tpu", "configs", "se_ssd_kitti_car.py")
# a 3.2 m x 3.2 m crop at the KITTI voxel size: sparse shape (41, 64, 64)
SPEC = VoxelizerSpec((0.0, -1.6, -3.0, 3.2, 1.6, 1.0), (0.05, 0.05, 0.1),
                     max_points=5, max_voxels=20000)
ANCHORS = create_anchors_3d_range(
    [1, 8, 8], [0.0, -1.6, -1.0, 3.2, 1.6, -1.0]).reshape(-1, 7)
CFG = PredictConfig(post_center_range=(-10.0, -10.0, -10.0, 10.0, 10.0, 10.0))
# stage occupancies of these scenes: ~1.5k / 4.4k / 2.6k / 320 / 128
SAFE_CAPS = (2048, 6144, 4096, 1024, 512)


def _scene(seed, n=1500):
    rng = np.random.RandomState(seed)
    lo, hi = np.array(SPEC.point_cloud_range[:3]), np.array(
        SPEC.point_cloud_range[3:])
    pts = lo + rng.rand(n, 3) * (hi - lo)
    return np.concatenate([pts, rng.rand(n, 1)], 1).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    m = VoxelNet(sparse_shape=SPEC.sparse_shape)
    m.reset_parameters(torch.Generator().manual_seed(0))
    return m.eval()


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)


def test_saturated_batch_reruns_at_safe_caps(model):
    # stage 1 below this scene's occupancy: the fast chain truncates
    tight = (2048, 1024, 4096, 1024, 512)
    server = ExactBatchServer(model, ANCHORS, CFG, SPEC, "cpu",
                              serving_caps=tight, safe_caps=SAFE_CAPS)
    pts = _scene(0)
    out = server([pts])
    assert server.stats == {"fast": 0, "exact_fallback": 1,
                            "safe_saturated": 0}
    exact = make_infer_fn(model, ANCHORS, CFG, SAFE_CAPS, 1, "cpu")
    _close(out, exact(**server.safe_prep(pts)))
    assert out[2].sum() > 0


def test_unsaturated_batch_takes_fast_path(model):
    server = ExactBatchServer(model, ANCHORS, CFG, SPEC, "cpu",
                              serving_caps=SAFE_CAPS, safe_caps=SAFE_CAPS)
    out = server([_scene(1)])
    assert server.stats["fast"] == 1 and server.stats["exact_fallback"] == 0
    assert out[0].shape == (1, CFG.nms_post_max_size, 7)
    assert all(torch.isfinite(o.float()).all() for o in out)


def test_batch4_int32_chain_matches_batch1(model):
    """caps x 4 pass 2^15, so the batched chain is int32; every scene's
    detections equal its batch-1 detections (int16 chain)."""
    caps = (8192, 8192, 4096, 2048, 1024)
    scenes = [_scene(s) for s in range(4)]
    b4 = ExactBatchServer(model, ANCHORS, CFG, SPEC, "cpu",
                          serving_caps=caps, safe_caps=caps, batch_size=4)
    assert b4.fast_prep.batch(scenes)["rulebooks"]["subm"][0].dtype == np.int32
    assert b4.fast_prep(scenes[0])["rulebooks"]["subm"][0].dtype == np.int16
    out4 = b4(scenes)
    b1 = ExactBatchServer(model, ANCHORS, CFG, SPEC, "cpu",
                          serving_caps=caps, safe_caps=caps)
    for i, pts in enumerate(scenes):
        _close([o[i] for o in out4], [o[0] for o in b1([pts])])


def test_batch8_streams_stage2_and_matches_batch1(model, monkeypatch):
    """At batch 8 the f32 stage-2 feature buffer passes the stream limit
    (64 x cols_for(8 x 4096) x 4 bytes > 8 MiB), so the 4 convs that read
    stage-2 rows take the stream kernel's path; every scene's detections
    equal its batch-1 detections, where nothing streams."""
    taken = []

    def recorder(name, fn):
        def conv(*args, **kw):
            taken.append(name)
            return fn(*args, **kw)
        return conv

    monkeypatch.setattr(bb, "fused_sparse_conv",
                        recorder("resident", bb.fused_sparse_conv))
    monkeypatch.setattr(bb, "fused_sparse_conv_stream",
                        recorder("stream", bb.fused_sparse_conv_stream))
    scenes = [_scene(s) for s in range(8)]
    b8 = ExactBatchServer(model, ANCHORS, CFG, SPEC, "cpu",
                          serving_caps=SAFE_CAPS, safe_caps=SAFE_CAPS,
                          batch_size=8)
    out8 = b8(scenes)
    assert b8.stats["fast"] == 1
    assert taken == ["resident"] * 6 + ["stream"] * 4 + ["resident"] * 4
    b1 = ExactBatchServer(model, ANCHORS, CFG, SPEC, "cpu",
                          serving_caps=SAFE_CAPS, safe_caps=SAFE_CAPS)
    del taken[:]
    for i, pts in enumerate(scenes):
        _close([o[i] for o in out8], [o[0] for o in b1([pts])])
    assert taken == ["resident"] * 14 * 8


def test_builder_det3d_names_and_dtype():
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                             "ref_full_model.npz"))
    cfg = Config.fromfile(CAR)
    m = builder.build_detector(cfg)
    assert m.sparse_shape == (41, 1600, 1408) and m.dtype == torch.float32
    assert sorted(m.state_dict()) == sorted(golden["sd_names"].tolist())
    bf16 = builder.build_detector(
        Config.fromfile(CAR.replace("car.py", "car_bf16.py")))
    assert bf16.dtype == torch.bfloat16
    # parameters stay f32 (the optimizer's master copy); convs cast their
    # weights to the compute dtype of their input
    assert bf16.neck.conv_0[0].weight.dtype == torch.float32
    assert bf16.backbone.middle_conv[0].weight.dtype == torch.float32
    with torch.inference_mode():
        y = bf16.eval().neck(torch.zeros(1, 128, 8, 8, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16


def test_builder_predict_config_as_jax():
    """Every field JAX's config has equal; the port's own field (``center``,
    a center head's decode grid) empty for SE-SSD's anchor head."""
    cfg = Config.fromfile(CAR)
    ours, theirs = builder.build_predict_config(cfg), jax_predict_config(cfg)
    assert set(theirs._fields) == set(ours._fields) - {"center"}
    for field in theirs._fields:
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.center == ()


def test_builder_serving_helpers():
    """What chip_smoke.py takes from the builder instead of sessd_tpu: the
    config by name, the KITTI voxelizer, the 70,400 anchors bench.py serves
    (config rotations 1.57 against its pi/2), and the cls prior."""
    cfg = builder.load_config("se_ssd_kitti_car.py")
    assert cfg.model == Config.fromfile(CAR).model
    spec = builder.build_voxelizer(cfg.voxel_generator)
    assert spec == PORT_KITTI_VOXELIZER
    assert vars(spec) == vars(KITTI_VOXELIZER)
    anchors = builder.build_anchors(cfg)
    assert anchors.shape == (70400, 7)
    np.testing.assert_allclose(anchors, create_anchors_3d_range(
        [1, 200, 176], [0, -40.0, -1.0, 70.4, 40.0, -1.0]).reshape(-1, 7),
        atol=1e-3)
    m = builder.build_detector(cfg)
    builder.set_cls_prior(m)
    bias = m.bbox_head.tasks[0].conv_cls.bias
    torch.testing.assert_close(bias,
                               torch.full_like(bias, np.log(0.01 / 0.99)))
    builder.set_cls_prior(m, None)
    assert not bias.any()
