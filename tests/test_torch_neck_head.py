"""The port's SSFA neck and multi-group head against the JAX modules on the
same weights (converted by convert_jax), on a BEV map with odd extents, where
the stride-2 branch and the deconv crop matter. Tolerance 1e-4 relative to
the largest output (f32 convolutions summed in another order)."""
import numpy as np
import pytest
import torch

from sessd_tpu.models.head import MultiGroupHead as JaxHead
from sessd_tpu.models.ssfa import SSFA as JaxSSFA
from tests.test_torch_common import (jax_voxelnet_variables, port_voxelnet,
                                     rel_err, to_torch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)


@pytest.fixture(scope="module")
def variables():
    return jax_voxelnet_variables()


@pytest.fixture(scope="module")
def bev():
    # odd H and W: ceil(h/2) at stride 2, deconv output cropped back
    return np.random.RandomState(3).randn(1, 7, 9, 128).astype(np.float32)


@pytest.fixture(scope="module")
def jax_out(variables, bev):
    p, s = variables["params"], variables["batch_stats"]
    neck = np.asarray(JaxSSFA().apply({"params": p["neck"],
                                       "batch_stats": s["neck"]},
                                      bev, train=False))
    head = JaxHead().apply({"params": p["head"]}, neck)[0]
    return neck, {k: np.asarray(v) for k, v in head.items()}


@pytest.fixture(scope="module")
def port_out(variables, bev):
    model = port_voxelnet(variables)
    with torch.inference_mode():
        neck = model.neck(to_torch(bev).permute(0, 3, 1, 2))
        head = model.bbox_head(neck)[0]
    return (neck.permute(0, 2, 3, 1).numpy(),
            {k: v.numpy() for k, v in head.items()})


def test_ssfa_matches_jax(jax_out, port_out):
    want, got = jax_out[0], port_out[0]
    assert got.shape == want.shape == (1, 7, 9, 128)
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("name", ["box_preds", "cls_preds", "iou_preds",
                                  "dir_cls_preds"])
def test_head_matches_jax(jax_out, port_out, name):
    want, got = jax_out[1][name], port_out[1][name]
    # [B, H*W*anchors, c] in the anchor order (y, x, rot)
    assert got.shape == want.shape and got.shape[1] == 7 * 9 * 2
    assert rel_err(got, want) < 1e-4
