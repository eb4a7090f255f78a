"""Builders: the shared plain-dict configs (``sessd_tpu/configs/*.py``, read
with ``Config``) -> the port's objects (port of the serving half of
``sessd_tpu/builder.py``). ``Config`` is re-exported from the JAX-free
``sessd_tpu.config``, so callers of the port need no ``sessd_tpu`` import."""
from __future__ import annotations

import math
import pathlib
from typing import Optional

import numpy as np
import torch

from sessd_tpu.config import Config
from sessd_tpu.core.anchors import create_anchors_3d_range
from sessd_tpu.ops.voxelize import VoxelizerSpec

from .models.detector import VoxelNet
from .models.predict import PredictConfig

__all__ = ["Config", "load_config", "build_voxelizer", "build_detector",
           "build_anchors", "set_cls_prior", "build_predict_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONFIG_DIR = (pathlib.Path(__file__).resolve().parents[1] / "sessd_tpu"
              / "configs")


def load_config(name: str) -> Config:
    """A shared config by file name, e.g. ``se_ssd_kitti_car_bf16.py``."""
    return Config.fromfile(CONFIG_DIR / name)


def build_voxelizer(cfg) -> VoxelizerSpec:
    """cfg: the ``voxel_generator`` section."""
    return VoxelizerSpec(
        point_cloud_range=tuple(cfg["range"]),
        voxel_size=tuple(cfg["voxel_size"]),
        max_points=cfg.get("max_points_in_voxel", 5),
        max_voxels=cfg.get("max_voxel_num", 20000),
    )


def build_detector(cfg) -> VoxelNet:
    """cfg: the full config (model + voxel_generator sections; ``precision``
    sets the compute dtype). Parameters are left at construction values;
    load a state dict or call ``reset_parameters(generator)``."""
    m = cfg.model
    if m["type"] != "VoxelNet":
        raise ValueError(f"detector type {m['type']} is not ported yet")
    return VoxelNet(
        num_input_features=m["reader"].get("num_input_features", 4),
        sparse_shape=build_voxelizer(cfg.voxel_generator).sparse_shape,
        tasks=tuple(dict(t) for t in m["bbox_head"]["tasks"]),
        dtype=_DTYPES[cfg.get("precision", "float32")],
    )


def build_anchors(cfg) -> np.ndarray:
    """[H*W*rotations, 7] anchors of the (single) anchor generator over the
    BEV grid, the sparse shape's (y, x) extent // 8, in the head's
    (y, x, rot) output order."""
    gen = cfg.target_assigner["anchor_generators"][0]
    _, h, w = build_voxelizer(cfg.voxel_generator).sparse_shape
    return create_anchors_3d_range([1, h // 8, w // 8], gen["anchor_ranges"],
                                   sizes=gen["sizes"],
                                   rotations=gen["rotations"]).reshape(-1, 7)


def set_cls_prior(model: VoxelNet, pi: Optional[float] = 0.01) -> None:
    """Every ``conv_cls`` bias to the focal prior logit log(pi / (1 - pi)),
    where a trained detector's background sits (bench.py:102-128); with
    ``pi=None`` the bias is 0 and every anchor scores about 0.5."""
    value = 0.0 if pi is None else math.log(pi / (1.0 - pi))
    with torch.no_grad():
        for task in model.bbox_head.tasks:
            task.conv_cls.bias.fill_(value)


def build_predict_config(cfg) -> PredictConfig:
    tc = cfg.test_cfg
    nms_type = tc["nms"].get("nms_type", "rotate_nms")
    if nms_type != "rotate_nms":
        raise ValueError(f"nms_type {nms_type} is not ported yet")
    return PredictConfig(
        score_threshold=tc["score_threshold"],
        nms_pre_max_size=tc["nms"]["nms_pre_max_size"],
        nms_post_max_size=tc["nms"]["nms_post_max_size"],
        nms_iou_threshold=tc["nms"]["nms_iou_threshold"],
        nms_pre_small=tc["nms"].get("nms_pre_small", 256),
        post_center_range=tuple(tc["post_center_limit_range"]),
        use_dir_classifier=cfg.model["bbox_head"].get("loss_aux") is not None,
        direction_offset=cfg.model["bbox_head"].get("direction_offset", 0.0),
    )
