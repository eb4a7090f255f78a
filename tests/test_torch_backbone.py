"""The port's all-sparse backbone against the JAX fused serving plan
(``SpMiddleFHD(conv_impl="fused", dense_from_stage=5)``, Pallas in interpret
mode) on the same weights and host rulebook chain, with nontrivial BN
statistics. Run once at the default windows and once at tiny small-windows,
which send over-span blocks through the JAX patch kernel (``_patch_kernel``)
— the kernel the port covers by having no window. Tolerance atol 3e-4,
rtol 1e-3 (f32 sums in another order)."""
import numpy as np
import pytest
import torch

from sessd_tpu.models.backbone import SpMiddleFHD as JaxSpMiddleFHD
from sessd_tpu.serve import fallback_telemetry
from sessd_torch.ops.cuda.sparse_conv import fused_sparse_conv_ref
from sessd_torch.serve import stage_inputs
from tests.test_torch_common import (CAPS, SEED, SPARSE_SHAPE, as_int16,
                                     host_inputs, jax_fused_reference,
                                     jax_voxelnet_variables, port_voxelnet)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

TINY = dict(subm_windows_small=(128,) * 4, down_windows_small=(128,) * 4)


@pytest.fixture(scope="module")
def inputs():
    return host_inputs(SEED)


@pytest.fixture(scope="module")
def variables():
    return jax_voxelnet_variables()


@pytest.fixture(scope="module")
def jax_bev(inputs, variables):
    """JAX fused-plan BEV [1, H, W, C*D] at default and tiny windows; the
    default run is the one the slice test shares."""
    feats, coords, valid, rb = inputs
    v = {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]}
    model = JaxSpMiddleFHD(stage_capacity=CAPS, dense_from_stage=5,
                           conv_impl="fused", **TINY)
    return {"default": jax_fused_reference(SEED)[0],
            "tiny_windows": np.asarray(model.apply(
                v, feats, coords, valid, 1, SPARSE_SHAPE, train=False,
                rulebooks=rb))}


@pytest.fixture(scope="module")
def port_bev(inputs, variables):
    """The port's BEV [1, C*D, H, W] per rulebook dtype, as NHWC."""
    feats, _, _, rb = inputs
    model = port_voxelnet(variables)
    out = {}
    for name, chain in (("int32", rb), ("int16", as_int16(rb))):
        f, chain = stage_inputs(feats, chain, "cpu")
        with torch.inference_mode():
            bev = model.backbone(f, chain, 1, SPARSE_SHAPE, torch.float32)
        out[name] = bev.permute(0, 2, 3, 1).numpy()
    return out


def test_tiny_windows_take_the_patch_kernel(inputs):
    """The tiny-window JAX run really goes through _patch_kernel (blocks
    patched, no whole-conv fallback); the default run patches none."""
    rb = inputs[3]
    tiny = fallback_telemetry(rb, CAPS, JaxSpMiddleFHD(stage_capacity=CAPS,
                                                       **TINY))
    default = fallback_telemetry(rb, CAPS, JaxSpMiddleFHD(stage_capacity=CAPS))
    assert tiny["patched_blocks"] > 0 and tiny["fallback_convs"] == 0
    assert default["patched_blocks"] == 0 and default["fallback_convs"] == 0


@pytest.mark.parametrize("idx", ["int16", "int32"])
@pytest.mark.parametrize("windows", ["default", "tiny_windows"])
def test_backbone_matches_jax_fused(jax_bev, port_bev, windows, idx):
    want, got = jax_bev[windows], port_bev[idx]
    assert got.shape == want.shape == (1, 4, 4, 128)
    assert np.abs(want).max() > 0.1  # a live signal, not all zeros
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)


def test_backbone_twin_path_is_the_cpu_path(inputs, variables):
    """On the CPU the wrapper is the twin, so passing the twin explicitly
    (as the smoke check does on the card) changes nothing."""
    feats, _, _, rb = inputs
    model = port_voxelnet(variables)
    f, chain = stage_inputs(feats, rb, "cpu")
    with torch.inference_mode():
        a = model.backbone(f, chain, 1, SPARSE_SHAPE, torch.float32)
        b = model.backbone(f, chain, 1, SPARSE_SHAPE, torch.float32,
                           conv=fused_sparse_conv_ref)
    assert torch.equal(a, b)


def test_backbone_bf16_close_to_f32(inputs, variables):
    """bf16 compute (weights folded in f32, then cast) tracks f32."""
    feats, _, _, rb = inputs
    model = port_voxelnet(variables)
    f, chain = stage_inputs(feats, rb, "cpu")
    with torch.inference_mode():
        a = model.backbone(f, chain, 1, SPARSE_SHAPE, torch.float32)
        b = model.backbone(f, chain, 1, SPARSE_SHAPE, torch.bfloat16)
    assert b.dtype == torch.bfloat16
    err = (b.float() - a).abs().max() / a.abs().max()
    assert float(err) < 5e-2
