"""JAX ``VoxelNet`` variables -> the port's state dict (det3d names).

The exact inverse of ``sessd_tpu/utils/convert_torch.convert_state_dict``
(convert_torch.py:80-130), so ``convert_state_dict(convert_jax(v)) == v``.
Inputs are the flax variables ``{"params", "batch_stats"}`` as numpy (or
array-like) leaves; this module imports no JAX.

Layer mappings:
- sparse kernels [K, cin, cout] -> spconv [kd, kh, kw, cin, cout]
- flax Conv [kh, kw, in, out] -> torch Conv2d [out, in, kh, kw]
- flax ConvTranspose [kh, kw, in, out], spatially flipped -> torch
  ConvTranspose2d [in, out, kh, kw] (the flip of convert_torch.py:32-35,
  undone)
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.backbone import PLAN

# the forward converter's tables (sessd_tpu/utils/convert_torch.py:60-77):
# SSFA submodules in the JAX call order (ConvBnRelu_i) -> the reference's
# (conv, BN) entries, and which of them are the deconv blocks
SSFA_MODULES = [
    # the block's leading zero-pad layer shifts its indices by one
    ("neck.bottom_up_block_0.1", "neck.bottom_up_block_0.2"),
    ("neck.bottom_up_block_0.4", "neck.bottom_up_block_0.5"),
    ("neck.bottom_up_block_0.7", "neck.bottom_up_block_0.8"),
    ("neck.bottom_up_block_1.0", "neck.bottom_up_block_1.1"),
    ("neck.bottom_up_block_1.3", "neck.bottom_up_block_1.4"),
    ("neck.bottom_up_block_1.6", "neck.bottom_up_block_1.7"),
    ("neck.trans_0.0", "neck.trans_0.1"),
    ("neck.trans_1.0", "neck.trans_1.1"),
    ("neck.deconv_block_0.0", "neck.deconv_block_0.1"),
    ("neck.deconv_block_1.0", "neck.deconv_block_1.1"),
    ("neck.conv_0.0", "neck.conv_0.1"),
    ("neck.conv_1.0", "neck.conv_1.1"),
    ("neck.w_0.0", "neck.w_0.1"),
    ("neck.w_1.0", "neck.w_1.1"),
]
SSFA_TRANSPOSE = {8, 9}  # deconv blocks

# kernel shape of each backbone block, in call order
BACKBONE_KERNELS = [k for _, n_subm, dk, _, _ in PLAN
                    for k in ([dk] if dk else []) + [(3, 3, 3)] * n_subm]


def _bn(prefix: str, params: dict, stats: dict) -> Dict[str, np.ndarray]:
    return {prefix + ".weight": params["scale"],
            prefix + ".bias": params["bias"],
            prefix + ".running_mean": stats["mean"],
            prefix + ".running_var": stats["var"]}


def convert_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of sessd_tpu's VoxelNet -> state dict for
    ``sessd_torch.models.detector.VoxelNet`` (float32 CPU tensors)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    for b, kshape in enumerate(BACKBONE_KERNELS):
        blk = f"SparseConvBlock_{b}"
        kernel = np.asarray(params["backbone"][blk]["kernel"])
        sd[f"backbone.middle_conv.{3 * b}.weight"] = kernel.reshape(
            *kshape, *kernel.shape[1:])
        sd.update(_bn(f"backbone.middle_conv.{3 * b + 1}",
                      params["backbone"][blk]["MaskedBatchNorm_0"],
                      stats["backbone"][blk]["MaskedBatchNorm_0"]))

    for i, (conv_prefix, bn_prefix) in enumerate(SSFA_MODULES):
        p = params["neck"][f"ConvBnRelu_{i}"]
        if i in SSFA_TRANSPOSE:  # -> ConvTranspose2d [in, out, kh, kw]
            kernel = np.transpose(
                np.asarray(p["ConvTranspose_0"]["kernel"])[::-1, ::-1],
                (2, 3, 0, 1))
        else:  # -> Conv2d [out, in, kh, kw]
            kernel = np.transpose(np.asarray(p["Conv_0"]["kernel"]),
                                  (3, 2, 0, 1))
        sd[conv_prefix + ".weight"] = kernel
        sd.update(_bn(bn_prefix, p["BatchNorm_0"],
                      stats["neck"][f"ConvBnRelu_{i}"]["BatchNorm_0"]))

    for name, conv in params["head"]["task_0"].items():
        prefix = f"bbox_head.tasks.0.{name}"
        sd[prefix + ".weight"] = np.transpose(np.asarray(conv["kernel"]),
                                              (3, 2, 0, 1))
        sd[prefix + ".bias"] = conv["bias"]

    return {k: torch.tensor(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def convert_train_state(state) -> dict:
    """A JAX ``TrainState`` (sessd_tpu/train/train_step.py; numpy or
    array-like leaves) -> {"step": int, "student": state dict of ``params``
    + ``batch_stats``, "teacher": state dict of ``ema_params`` +
    ``ema_batch_stats``}, for the port's two ``VoxelNet`` modules. The
    optimizer state is not carried."""
    return {
        "step": int(np.asarray(state.step)),
        "student": convert_jax({"params": state.params,
                                "batch_stats": state.batch_stats}),
        "teacher": convert_jax({"params": state.ema_params,
                                "batch_stats": state.ema_batch_stats}),
    }
