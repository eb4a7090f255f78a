"""The port's training-mode model against the JAX package on the CPU:
BatchNorm with batch statistics (masked, as ``MaskedBatchNorm``; unmasked,
as flax ``nn.BatchNorm``) including the running statistics it leaves, and
the whole VoxelNet forward in training mode for the student plan
(``dense_from_stage=3``: ten sparse convs through ``SparseConvFunction``,
then masked dense conv3d) and the teacher plan (all fourteen convs sparse),
with the BatchNorm statistics both frameworks leave behind; and the casts
and folds that eval keeps outside autograd. f32 throughout;
tolerances 1e-5 relative for the BatchNorm layers, 1e-4 of each head
output's max and 1e-5 on the statistics for the model (f32 sums taken in
another order through 14 convs and two BatchNorm reductions per layer)."""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.models import VoxelNet as JaxVoxelNet
from sessd_tpu.models.layers import MaskedBatchNorm, batch_norm_2d
from sessd_torch.models.backbone import SpMiddleFHD
from sessd_torch.models.layers import BatchNorm, Conv2d, ConvTranspose2d
from sessd_torch.utils.convert_jax import convert_jax
from tests.test_torch_common import (CAPS, SPARSE_SHAPE, host_inputs,
                                     jax_voxelnet_variables, port_voxelnet,
                                     rel_err, to_torch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

B = 2


def _bn_case(seed, shape):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    params = {"scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
              "bias": (0.3 * rng.randn(c)).astype(np.float32)}
    stats = {"mean": (0.3 * rng.randn(c)).astype(np.float32),
             "var": (rng.rand(c) + 0.5).astype(np.float32)}
    bn = BatchNorm(c).train()
    bn.load_state_dict({"weight": to_torch(params["scale"]),
                        "bias": to_torch(params["bias"]),
                        "running_mean": to_torch(stats["mean"]),
                        "running_var": to_torch(stats["var"])})
    return x, params, stats, bn


def _check_bn(out, new_stats, y, bn):
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats["var"]), rtol=1e-5,
                               atol=1e-6)


def test_masked_batchnorm_train_matches_flax():
    x, params, stats, bn = _bn_case(0, (300, 16))
    mask = np.random.RandomState(1).rand(300) > 0.4
    x[~mask] = 50.0  # padding rows must not reach the statistics
    out, upd = MaskedBatchNorm().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(mask), True, mutable=["batch_stats"])
    y = bn(to_torch(x), to_torch(mask)[:, None])
    _check_bn(out, upd["batch_stats"], y, bn)


def test_batchnorm_2d_train_matches_flax():
    x, params, stats, bn = _bn_case(2, (2, 6, 5, 8))  # NHWC

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return batch_norm_2d(x, train=True, name="bn")

    out, upd = M().apply({"params": {"bn": params},
                          "batch_stats": {"bn": stats}}, jnp.asarray(x),
                         mutable=["batch_stats"])
    y = bn(to_torch(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _check_bn(out, upd["batch_stats"]["bn"], y, bn)


def train_inputs(seed=5):
    """B=2 host inputs as the loader's flattened voxels."""
    feats, coords, valid, rb = host_inputs(seed, b=B)
    return feats[:, None, :], coords, valid, rb


@functools.lru_cache(maxsize=None)
def jax_train_forward(dense_from_stage):
    """JAX VoxelNet(train=True) on train_inputs(): (head outputs, the new
    batch_stats tree), as numpy."""
    voxels, coords, valid, rb = train_inputs()
    model = JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                        dense_from_stage=dense_from_stage, conv_impl="gather",
                        backbone_remat=False)
    preds, upd = model.apply(
        jax_voxelnet_variables(), jnp.asarray(voxels), coords,
        np.ones(len(voxels), np.int32), valid, B, train=True, rulebooks=rb,
        mutable=["batch_stats"])
    return ({k: np.array(v) for k, v in preds[0].items()},
            jax.tree_util.tree_map(np.array, upd["batch_stats"]))


@pytest.mark.parametrize("dense_from_stage", [3, 5],
                         ids=["student_dfs3", "teacher_dfs5"])
def test_voxelnet_train_forward_matches_jax(dense_from_stage):
    want, want_stats = jax_train_forward(dense_from_stage)
    variables = jax_voxelnet_variables()
    model = port_voxelnet(variables).train()
    model.dense_from_stage = dense_from_stage
    voxels, _, _, rb = train_inputs()
    chain = {k: ([to_torch(a) for a in v] if isinstance(v, list)
                 else to_torch(v)) for k, v in rb.items()}
    got = model(to_torch(voxels), torch.ones(len(voxels), dtype=torch.int32),
                chain, B, train=True)[0]
    for k, v in want.items():
        assert rel_err(got[k].detach(), v) < 1e-4, k
    new = convert_jax({"params": variables["params"],
                       "batch_stats": want_stats})
    sd = model.state_dict()
    for k, v in new.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("make", [
    lambda: Conv2d(8, 4, 3, padding=1),
    lambda: ConvTranspose2d(8, 4, 3, stride=2, padding=1, output_padding=1,
                            bias=False),
    lambda: BatchNorm(8).eval(),
], ids=["conv2d", "deconv2d", "batchnorm_eval"])
def test_eval_casts_kept_until_an_update(make):
    """Outside autograd a layer casts (and BatchNorm folds) its f32
    parameters once; an in-place update, as an optimizer or EMA step makes,
    is seen at the next call, and with autograd on gradients reach the f32
    parameters."""
    layer = make()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn_like(p))
    x = torch.randn(2, 8, 5, 6).to(torch.bfloat16)

    def fresh():
        ref = make()
        ref.load_state_dict(layer.state_dict())
        with torch.no_grad():
            return ref(x)

    with torch.no_grad():
        y1 = layer(x)
        kept = dict(layer._derived)
        y2 = layer(x)
    assert all(layer._derived[k][1] is v[1] for k, v in kept.items())
    assert torch.equal(y1, y2) and torch.equal(y1, fresh())
    with torch.no_grad():
        next(layer.parameters()).mul_(-2.0)
        y3 = layer(x)
    assert not torch.equal(y3, y1) and torch.equal(y3, fresh())
    layer(x.float()).sum().backward()
    assert next(layer.parameters()).grad is not None


def test_backbone_folded_kept_until_an_update():
    backbone = SpMiddleFHD(4).eval()
    backbone.reset_parameters(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        first = backbone.folded(torch.bfloat16)
        assert backbone.folded(torch.bfloat16) is first
    conv, bn = backbone.blocks()[3]
    with torch.no_grad():
        bn.running_var.mul_(4.0)
    with torch.inference_mode():
        again = backbone.folded(torch.bfloat16)
    assert again is not first
    torch.testing.assert_close(again[3][0].float(),
                               first[3][0].float() / 2, rtol=1e-2, atol=0)
