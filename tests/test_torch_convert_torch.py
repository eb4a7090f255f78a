"""Reference (det3d) checkpoints into the port: ``sessd_torch.utils.
convert_torch`` against ``sessd_tpu.utils.convert_torch``.

A synthetic det3d-layout ``state_dict`` (the reference's module names and
shapes: spconv [kd, kh, kw, cin, cout] kernels, Conv2d, ConvTranspose2d,
BatchNorm with running stats and ``num_batches_tracked``, DDP's
``module.`` prefix) is saved with ``torch.save`` as {state_dict, meta,
optimizer}, loaded into JAX through ``convert_torch.load_torch_checkpoint``
and into the port through its own loader, and both run one scene of a
small Car config (sparse shape (41, 32, 32)): heads within 1e-4 of the max
(f32), and the decoded boxes after predict within 1e-4.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.core.anchors import create_anchors_3d_range
from sessd_tpu.models import VoxelNet as JaxVoxelNet
from sessd_tpu.models import predict as jpredict
from sessd_tpu.utils import convert_torch as jconvert
from sessd_torch import builder
from sessd_torch.models.predict import PredictConfig
from sessd_torch.serve import make_infer_fn, stage_inputs
from sessd_torch.utils import convert_torch
from tests.test_torch_common import (CAPS, SPARSE_SHAPE, as_int16,
                                     host_inputs, rel_err)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

WIDE_RANGE = (-100.0, -100.0, -100.0, 100.0, 100.0, 100.0)
# (cin, cout, kernel) of the reference's 14 backbone blocks (scn.py:105-151)
BACKBONE = [(4, 16, (3, 3, 3)), (16, 16, (3, 3, 3)), (16, 32, (3, 3, 3)),
            (32, 32, (3, 3, 3)), (32, 32, (3, 3, 3)), (32, 64, (3, 3, 3)),
            (64, 64, (3, 3, 3)), (64, 64, (3, 3, 3)), (64, 64, (3, 3, 3)),
            (64, 64, (3, 3, 3)), (64, 64, (3, 3, 3)), (64, 64, (3, 3, 3)),
            (64, 64, (3, 3, 3)), (64, 64, (3, 1, 1))]
# (conv, BN, cin, cout, kernel, transposed) of the SSFA neck (rpn_v1.py)
NECK = [("bottom_up_block_0.1", "bottom_up_block_0.2", 128, 128, 3, False),
        ("bottom_up_block_0.4", "bottom_up_block_0.5", 128, 128, 3, False),
        ("bottom_up_block_0.7", "bottom_up_block_0.8", 128, 128, 3, False),
        ("bottom_up_block_1.0", "bottom_up_block_1.1", 128, 256, 3, False),
        ("bottom_up_block_1.3", "bottom_up_block_1.4", 256, 256, 3, False),
        ("bottom_up_block_1.6", "bottom_up_block_1.7", 256, 256, 3, False),
        ("trans_0.0", "trans_0.1", 128, 128, 1, False),
        ("trans_1.0", "trans_1.1", 256, 256, 1, False),
        ("deconv_block_0.0", "deconv_block_0.1", 256, 128, 3, True),
        ("deconv_block_1.0", "deconv_block_1.1", 256, 128, 3, True),
        ("conv_0.0", "conv_0.1", 128, 128, 3, False),
        ("conv_1.0", "conv_1.1", 128, 128, 3, False),
        ("w_0.0", "w_0.1", 128, 1, 1, False),
        ("w_1.0", "w_1.1", 128, 1, 1, False)]
HEAD = [("conv_box", 14), ("conv_cls", 2), ("conv_iou", 2), ("conv_dir", 4)]


def det3d_state_dict(seed=0):
    """The reference VoxelNet's state dict, by its own names and layouts,
    with fan-in-scaled kernels and nontrivial BatchNorm statistics; the cls
    bias at +1 so that predict keeps boxes."""
    rng = np.random.RandomState(seed)
    sd = {}

    def bn(prefix, c):
        sd[prefix + ".weight"] = 1.0 + 0.2 * rng.randn(c)
        sd[prefix + ".bias"] = 0.3 * rng.randn(c)
        sd[prefix + ".running_mean"] = 0.3 * rng.randn(c)
        sd[prefix + ".running_var"] = rng.rand(c) + 0.5
        sd[prefix + ".num_batches_tracked"] = np.array(1000, np.int64)

    for i, (cin, cout, k) in enumerate(BACKBONE):
        sd[f"backbone.middle_conv.{3 * i}.weight"] = rng.randn(
            *k, cin, cout) / np.sqrt(np.prod(k) * cin)
        bn(f"backbone.middle_conv.{3 * i + 1}", cout)
    for conv, norm, cin, cout, k, transposed in NECK:
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        sd[f"neck.{conv}.weight"] = rng.randn(*shape) / np.sqrt(cin * k * k)
        bn(f"neck.{norm}", cout)
    for name, cout in HEAD:
        sd[f"bbox_head.tasks.0.{name}.weight"] = rng.randn(
            cout, 128, 1, 1) / np.sqrt(128)
        sd[f"bbox_head.tasks.0.{name}.bias"] = 0.1 * rng.randn(cout)
    sd["bbox_head.tasks.0.conv_cls.bias"][:] = 1.0
    return {k: (v if v.dtype == np.int64 else v.astype(np.float32))
            for k, v in sd.items()}


def save_pth(path, sd, ddp=True):
    """``torch.save`` of {state_dict, meta, optimizer} as det3d writes it
    (trainer/checkpoint.py:189-220), keys under DDP's ``module.``."""
    torch.save({"state_dict": {("module." if ddp else "") + k:
                               torch.from_numpy(np.array(v))
                               for k, v in sd.items()},
                "meta": {"epoch": 60, "iter": 55680},
                "optimizer": {"state": {}, "param_groups": [{"lr": 3e-3}]}},
               path)
    return str(path)


def small_car_config(tmp_path):
    """The shipped Car config on a 1.6 m x 1.6 m crop: sparse shape (41, 32,
    32), one Car task, f32."""
    path = tmp_path / "car_small.py"
    path.write_text(
        f"__file__ = {str(builder.CONFIG_DIR / 'se_ssd_kitti_car.py')!r}\n"
        "exec(compile(open(__file__).read(), __file__, 'exec'))\n"
        "voxel_generator = dict(voxel_generator, "
        "range=[0.0, -0.8, -3.0, 1.6, 0.8, 1.0])\n")
    cfg = builder.Config.fromfile(path)
    assert builder.build_voxelizer(cfg.voxel_generator).sparse_shape == \
        SPARSE_SHAPE
    return cfg


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("det3d")
    sd = det3d_state_dict()
    return save_pth(tmp / "se_ssd.pth", sd), sd, small_car_config(tmp)


def test_checkpoint_heads_and_boxes_match_jax(checkpoint):
    path, _, cfg = checkpoint
    feats, coords, valid, rb = host_inputs(0)
    anchors = create_anchors_3d_range(
        [1, 4, 4], [0.0, -0.8, -1.0, 1.6, 0.8, -1.0]).reshape(-1, 7)

    params, stats, jmeta = jconvert.load_torch_checkpoint(path)
    jmodel = JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                         dense_from_stage=5, conv_impl="gather")
    jpreds = jmodel.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(feats)[:, None, :], coords,
                          np.ones(len(feats), np.int32), valid, 1,
                          train=False, rulebooks=rb)[0]
    pcfg = jpredict.PredictConfig(post_center_range=WIDE_RANGE)
    jdets = jpredict.predict_batch(jpreds, jnp.asarray(anchors), None, pcfg)

    model, meta = convert_torch.load_torch_checkpoint(path, cfg, "cpu")
    assert meta == jmeta == {"epoch": 60, "iter": 55680}
    assert model.sparse_shape == SPARSE_SHAPE and not model.training
    f, chain = stage_inputs(feats, as_int16(rb), "cpu")
    with torch.inference_mode():
        preds = model(f[:, None, :], torch.ones(CAPS[0], dtype=torch.int32),
                      chain, 1)[0]
    assert set(preds) == set(jpreds)
    for k, v in preds.items():
        assert rel_err(v.numpy(), np.asarray(jpreds[k])) <= 1e-4, k

    infer = make_infer_fn(model, anchors,
                          PredictConfig(post_center_range=WIDE_RANGE), CAPS,
                          1, "cpu")
    boxes, scores, keep = infer(feats, as_int16(rb))
    want = np.asarray(jdets["valid"])
    assert want.sum() > 0
    np.testing.assert_array_equal(keep.numpy(), want)
    np.testing.assert_allclose(boxes.numpy()[want],
                               np.asarray(jdets["box3d_lidar"])[want],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores.numpy()[want],
                               np.asarray(jdets["scores"])[want],
                               rtol=1e-4, atol=1e-4)


def test_every_entry_loads_as_it_lies(checkpoint):
    """No key missing or unexpected; each weight and BatchNorm statistic
    arrives unchanged (the spconv 5-D kernels, Conv2d, the unflipped
    ConvTranspose2d); only ``num_batches_tracked`` is passed over."""
    _, sd, _ = checkpoint
    got = convert_torch.convert_state_dict(
        {"module." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    want = {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = builder.build_detector(builder.load_config("se_ssd_kitti_car.py"))
    assert set(model.state_dict()) == set(got)


def test_conv_transpose_needs_no_flip(checkpoint):
    """The reference's SSFA deconv (ConvTranspose2d k3 s2 p1 op1,
    rpn_v1.py:180) and the port's deconv block holding the converted
    weight give the same map bit for bit; the BatchNorm after it, in eval
    mode, matches ``nn.BatchNorm2d(eps=1e-3)`` on the same statistics."""
    path, sd, cfg = checkpoint
    model, _ = convert_torch.load_torch_checkpoint(path, cfg, "cpu")
    ref = torch.nn.ConvTranspose2d(256, 128, 3, stride=2, padding=1,
                                   output_padding=1, bias=False)
    ref.weight.data = torch.from_numpy(sd["neck.deconv_block_0.0.weight"])
    norm = torch.nn.BatchNorm2d(128, eps=1e-3).eval()
    for k in ("weight", "bias", "running_mean", "running_var"):
        getattr(norm, k).data = torch.from_numpy(
            sd[f"neck.deconv_block_0.1.{k}"])
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 256, 5, 6).astype(np.float32))
    with torch.no_grad():
        want = ref(x)
        got = model.neck.deconv_block_0[0](x)
        assert got.shape == (1, 128, 10, 12)
        assert torch.equal(got, want)
        np.testing.assert_allclose(model.neck.deconv_block_0[1](got).numpy(),
                                   norm(want).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("change", ["missing", "unexpected", "shape"])
def test_bad_keys_and_shapes_raise(checkpoint, tmp_path, change):
    """A key the model lacks or the checkpoint lacks is an error, named in
    it, never dropped; so is a spconv kernel of another shape."""
    _, sd, cfg = checkpoint
    sd = dict(sd)
    if change == "missing":
        del sd["neck.w_1.1.running_var"]
        name = "neck.w_1.1.running_var"
    elif change == "unexpected":
        sd["neck.extra.weight"] = np.zeros(3, np.float32)
        name = "neck.extra.weight"
    else:
        key = "backbone.middle_conv.39.weight"
        sd[key] = sd[key].reshape(3, 1, 1, 64, 64)[::-1].copy().reshape(
            1, 3, 1, 64, 64)
        name = f"{key}: copying a param with shape torch.Size([1, 3, 1, 64"
    path = save_pth(tmp_path / "bad.pth", sd)
    with pytest.raises(RuntimeError, match=re.escape(name)):
        convert_torch.load_torch_checkpoint(path, cfg, "cpu")


def test_loader_refuses_a_pillars_config(checkpoint):
    path, _, _ = checkpoint
    with pytest.raises(ValueError, match="VoxelNet"):
        convert_torch.load_torch_checkpoint(path,
                                            "point_pillars_kitti_car.py",
                                            "cpu")


def test_loader_defaults_to_the_card(checkpoint):
    """With no device the model lands on CUDA, as the port's other entry
    points do; where CUDA is absent the loader says so instead of falling
    back to the CPU."""
    path, _, cfg = checkpoint
    if torch.cuda.is_available():
        model, _ = convert_torch.load_torch_checkpoint(path, cfg)
        assert all(p.is_cuda for p in model.parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert_torch.load_torch_checkpoint(path, cfg)
