"""JAX ``VoxelNet`` and ``PointPillars`` variables -> the port's state dict
(det3d names).

For VoxelNet the exact inverse of
``sessd_tpu/utils/convert_torch.convert_state_dict`` (convert_torch.py:
80-130), so ``convert_state_dict(convert_jax(v)) == v``. Inputs are the
flax variables ``{"params", "batch_stats"}`` as numpy (or array-like)
leaves; this module imports no JAX.

Layer mappings:
- sparse kernels [K, cin, cout] -> spconv [kd, kh, kw, cin, cout]
- flax Conv [kh, kw, in, out] -> torch Conv2d [out, in, kh, kw]
- flax ConvTranspose [kh, kw, in, out], spatially flipped -> torch
  ConvTranspose2d [in, out, kh, kw] (the flip of convert_torch.py:32-35,
  undone)
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var
- PointPillars: the PFN's flax Dense [in, out] -> Linear [out, in]; the
  RPN's stride-1 upsampler, a flax 1x1 Conv, -> the reference's 1x1
  ConvTranspose2d [in, out, 1, 1]
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

# the PointPillars RPN's (conv, BN) entries in the JAX call order
# (ConvBnRelu_i): per stage the strided conv (index 1, after the block's
# zero pad), its 3 or 5 convs at 4 + 3j, then the upsampler
RPN_MODULES = [
    pair for i, n in enumerate((3, 5, 5))
    for pair in [(f"neck.blocks.{i}.{c}", f"neck.blocks.{i}.{c + 1}")
                 for c in [1] + [4 + 3 * j for j in range(n)]]
    + [(f"neck.deblocks.{i}.0", f"neck.deblocks.{i}.1")]]

# kernel shape of each backbone block, in call order
BACKBONE_KERNELS = [k for _, n_subm, dk, _, _ in PLAN
                    for k in ([dk] if dk else []) + [(3, 3, 3)] * n_subm]


def _bn(prefix: str, params: dict, stats: dict) -> Dict[str, np.ndarray]:
    return {prefix + ".weight": params["scale"],
            prefix + ".bias": params["bias"],
            prefix + ".running_mean": stats["mean"],
            prefix + ".running_var": stats["var"]}


def _conv2d(p: dict) -> np.ndarray:
    """A flax ``Conv_0`` [kh, kw, in, out] -> torch Conv2d [out, in, kh, kw],
    or a ``ConvTranspose_0``, spatially flipped, -> ConvTranspose2d [in,
    out, kh, kw]."""
    if "ConvTranspose_0" in p:
        return np.transpose(
            np.asarray(p["ConvTranspose_0"]["kernel"])[::-1, ::-1],
            (2, 3, 0, 1))
    return np.transpose(np.asarray(p["Conv_0"]["kernel"]), (3, 2, 0, 1))


def _convert_pillars(params: dict, stats: dict) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    pfn, pfn_stats = params["reader"]["PFNLayer_0"], \
        stats["reader"]["PFNLayer_0"]
    sd["reader.pfn_layers.0.linear.weight"] = np.asarray(
        pfn["Dense_0"]["kernel"]).T
    sd.update(_bn("reader.pfn_layers.0.norm", pfn["MaskedBatchNorm_0"],
                  pfn_stats["MaskedBatchNorm_0"]))
    for i, (conv_prefix, bn_prefix) in enumerate(RPN_MODULES):
        p = params["neck"][f"ConvBnRelu_{i}"]
        kernel = _conv2d(p)
        if conv_prefix.startswith("neck.deblocks") and "Conv_0" in p:
            # 1x1 conv -> the reference's 1x1 ConvTranspose2d [in, out]
            kernel = np.transpose(kernel, (1, 0, 2, 3))
        sd[conv_prefix + ".weight"] = kernel
        sd.update(_bn(bn_prefix, p["BatchNorm_0"],
                      stats["neck"][f"ConvBnRelu_{i}"]["BatchNorm_0"]))
    return sd


def convert_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of sessd_tpu's VoxelNet or PointPillars ->
    state dict for ``sessd_torch.models.detector.VoxelNet`` or
    ``sessd_torch.models.pillars.PointPillars`` (float32 CPU tensors)."""
    params, stats = variables["params"], variables["batch_stats"]
    if "PFNLayer_0" in params.get("reader", {}):
        sd = _convert_pillars(params, stats)
    else:
        sd = _convert_voxelnet(params, stats)
    for name, conv in params["head"]["task_0"].items():
        prefix = f"bbox_head.tasks.0.{name}"
        sd[prefix + ".weight"] = np.transpose(np.asarray(conv["kernel"]),
                                              (3, 2, 0, 1))
        sd[prefix + ".bias"] = conv["bias"]
    return {k: torch.tensor(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def _convert_voxelnet(params: dict, stats: dict) -> Dict[str, np.ndarray]:
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
        sd[conv_prefix + ".weight"] = _conv2d(p)
        sd.update(_bn(bn_prefix, p["BatchNorm_0"],
                      stats["neck"][f"ConvBnRelu_{i}"]["BatchNorm_0"]))
    return sd


def _find(tree, *attrs):
    """The first node of an optax state (nested tuples of NamedTuples) that
    has every attribute in ``attrs``, depth first; None if there is none."""
    if all(hasattr(tree, a) for a in attrs):
        return tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            found = _find(sub, *attrs)
            if found is not None:
                return found
    return None


def convert_train_state(state) -> dict:
    """A JAX ``TrainState`` (sessd_tpu/train/train_step.py; numpy or
    array-like leaves) -> {"step": int, "student": state dict of ``params``
    + ``batch_stats``, "teacher": state dict of ``ema_params`` +
    ``ema_batch_stats``, "optimizer": {"count", "sched_count", "mu",
    "nu"}}, for the port's two ``VoxelNet`` modules and its ``AdamW``
    (``load_train_state`` puts it in place).

    The optimizer comes from the state's ``inject_hyperparams`` stage
    (``opt_state[1]`` of ``sessd_tpu.train.optim.build_optimizer``; found
    by its fields, so a chain with more stages works too): ``count`` is the
    inner Adam count (``inner_state[0].count``), ``sched_count`` the
    schedule count, and the moments ``inner_state[0].mu`` / ``nu`` are
    mapped with the parameters' reshapes and transposes, keyed by the
    student's parameter names. A state with no such stage gives
    "optimizer": None."""
    out = {
        "step": int(np.asarray(state.step)),
        "student": convert_jax({"params": state.params,
                                "batch_stats": state.batch_stats}),
        "teacher": convert_jax({"params": state.ema_params,
                                "batch_stats": state.ema_batch_stats}),
        "optimizer": None,
    }
    inject = _find(state.opt_state, "hyperparams", "inner_state", "count")
    adam = (None if inject is None
            else _find(inject.inner_state, "mu", "nu", "count"))
    if adam is not None:
        def moments(tree):
            sd = convert_jax({"params": tree,
                              "batch_stats": state.batch_stats})
            return {k: v for k, v in sd.items() if "running_" not in k}

        out["optimizer"] = {"count": int(np.asarray(adam.count)),
                            "sched_count": int(np.asarray(inject.count)),
                            "mu": moments(adam.mu), "nu": moments(adam.nu)}
    return out


def load_train_state(state, converted: dict):
    """Put ``convert_train_state``'s output into the port's ``TrainState``
    in place: both modules, the step, and (when carried) the optimizer's
    counts and moments in ``student.parameters()`` order."""
    state.student.load_state_dict(converted["student"])
    state.teacher.load_state_dict(converted["teacher"])
    state.step = converted["step"]
    opt = converted["optimizer"]
    if opt is not None:
        names = [n for n, _ in state.student.named_parameters()]
        state.optimizer.load_state_dict(
            {"count": opt["count"], "sched_count": opt["sched_count"],
             "mu": [opt["mu"][n] for n in names],
             "nu": [opt["nu"][n] for n in names]})
    return state
