"""The serving slice as a whole.

1. ``sessd_torch.serve.make_infer_fn`` vs the JAX ``VoxelNet(conv_impl=
   "fused")`` + ``predict_batch`` (what ``sessd_tpu.serve.make_infer_fn``
   runs) on the same weights and host rulebooks: head outputs to 1e-3
   relative, the same valid mask, boxes to 1e-4.
2. The port vs the reference-torch goldens (tests/goldens/ref_full_model.npz,
   det3d's own VoxelNet on a cropped scene) to < 2e-4 relative, loading the
   golden weights straight by their det3d names.
3. ``convert_state_dict(convert_jax(v)) == v``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.core.anchors import create_anchors_3d_range
from sessd_tpu.data.rulebooks import DOWNS
from sessd_tpu.models import predict as jpredict
from sessd_tpu.serve import TRAIN_CAPS
from sessd_tpu.utils.convert_torch import convert_state_dict
from sessd_torch.models.detector import VoxelNet
from sessd_torch.models.predict import PredictConfig
from sessd_torch.serve import make_infer_fn, stage_inputs
from sessd_torch.utils.convert_jax import convert_jax
from tests.golden_utils import reference_state_dict
from tests.test_torch_common import (CAPS, NATIVE, SEED, as_int16,
                                     host_inputs,
                                     jax_fused_reference,
                                     jax_voxelnet_variables, port_voxelnet,
                                     rel_err, to_torch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "ref_full_model.npz")
WIDE_RANGE = (-100.0, -100.0, -100.0, 100.0, 100.0, 100.0)


@pytest.fixture(scope="module")
def variables():
    return jax_voxelnet_variables()


def test_infer_fn_matches_jax_serving(variables):
    feats, _, _, rb = host_inputs(SEED)
    anchors = create_anchors_3d_range(
        [1, 4, 4], [0.0, -0.8, -1.0, 1.6, 0.8, -1.0]).reshape(-1, 7)

    # JAX: the body of sessd_tpu.serve.make_infer_fn, with head outputs kept
    jpreds = jax_fused_reference(SEED)[1]
    jdets = jpredict.predict_batch(
        {k: jnp.asarray(v) for k, v in jpreds.items()}, jnp.asarray(anchors),
        None, jpredict.PredictConfig(post_center_range=WIDE_RANGE))

    model = port_voxelnet(variables)
    f, chain = stage_inputs(feats, as_int16(rb), "cpu")
    with torch.inference_mode():
        preds = model(f[:, None, :], torch.ones(CAPS[0], dtype=torch.int32),
                      chain, 1)[0]
    for k, v in preds.items():
        assert rel_err(v.numpy(), jpreds[k]) < 1e-3, k
    infer = make_infer_fn(model, anchors,
                          PredictConfig(post_center_range=WIDE_RANGE), CAPS,
                          1, "cpu")
    boxes, scores, valid_out = infer(feats, as_int16(rb))
    want_valid = np.asarray(jdets["valid"])
    assert want_valid.sum() > 0
    np.testing.assert_array_equal(valid_out.numpy(), want_valid)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jdets["box3d_lidar"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jdets["scores"]),
                               rtol=1e-4, atol=1e-4)


def test_port_matches_reference_goldens():
    golden = np.load(GOLDEN)
    sd = reference_state_dict(golden["sd_names"], golden["sd_shapes"])
    # cropped grid: x in [0, 17.6), y in [-8, 8) at 0.05 m
    model = VoxelNet(sparse_shape=(41, 320, 352))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.eval()

    cap0 = TRAIN_CAPS[0]
    n = golden["voxels"].shape[0]
    voxels = np.zeros((cap0,) + golden["voxels"].shape[1:], np.float32)
    voxels[:n] = golden["voxels"]
    num_points = np.ones((cap0,), np.int32)
    num_points[:n] = golden["num_points"]
    coords = np.zeros((cap0, 4), np.int32)
    coords[:n, 1:] = golden["coords_zyx"]
    valid = np.arange(cap0) < n
    rb = NATIVE.build_rulebooks(coords, valid, (1, 41, 320, 352),
                                TRAIN_CAPS, DOWNS, out_dtype=np.int16)
    _, chain = stage_inputs(voxels[:, 0], rb, "cpu")
    with torch.inference_mode():
        preds = model(to_torch(voxels), to_torch(num_points), chain, 1)[0]
    for ours, theirs in [("box_preds", "box_preds"),
                         ("cls_preds", "cls_preds"),
                         ("iou_preds", "iou_preds"),
                         ("dir_cls_preds", "dir_preds")]:
        ref = golden[theirs]  # [1, H, W, C]; ours [1, H*W*anchors, c]
        got = preds[ours].numpy().reshape(1, -1)
        assert got.size == ref.size, (ours, got.shape, ref.shape)
        assert rel_err(got, ref.reshape(1, -1)) < 2e-4, ours


def test_convert_jax_round_trip(variables):
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in convert_jax(variables).items()})
    back = {"params": params, "batch_stats": stats}
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
