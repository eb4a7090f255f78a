"""Builders: the plain-dict configs (``sessd_torch/configs/*.py``, read with
``Config``) -> the port's objects (port of ``sessd_tpu/builder.py``).

The data path is the port's copy of the JAX package's host code:
``KittiDataset``, its ``Pipeline`` and GT-AUG sampler, and ``DataLoader``
(``sessd_torch/data``, numpy and C++ only)."""
from __future__ import annotations

import math
import pathlib
from typing import Optional

import numpy as np
import torch

from .config import Config
from .core.anchors import create_anchors_3d_range
from .data.augment import GroundTruthSampler
from .data.dataset import KittiDataset
from .data.loader import DataLoader
from .data.pipeline import PipelineConfig
from .models.backbone import SpMiddleResNetFHD
from .models.detector import VoxelNet
from .models.head import CenterHead
from .models.layers import sync_batch_norm
from .models.pillars import RPN, PointPillars
from .models.predict import PredictConfig
from .ops.voxelize import VoxelizerSpec
from .train.losses import ConsistencyConfig, LossConfig
from .train.optim import (AdamW, OneCycleConfig, build_legacy_schedule,
                          one_cycle_lr, one_cycle_mom)

__all__ = ["Config", "load_config", "build_voxelizer", "build_detector",
           "build_anchors", "set_cls_prior", "build_predict_config",
           "build_pipeline_config", "build_sampler", "build_dataset",
           "build_dataloader", "build_optimizer_from_cfg",
           "build_loss_config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONFIG_DIR = pathlib.Path(__file__).resolve().parent / "configs"


def load_config(name: str) -> Config:
    """A shared config by file name, e.g. ``se_ssd_kitti_car_bf16.py``."""
    return Config.fromfile(CONFIG_DIR / name)


def build_voxelizer(cfg) -> VoxelizerSpec:
    """cfg: the ``voxel_generator`` section. A (training, test) pair of
    voxel caps (det3d's Waymo configs) takes the test cap, which serving
    runs at."""
    max_voxels = cfg.get("max_voxel_num", 20000)
    if isinstance(max_voxels, (list, tuple)):
        max_voxels = max_voxels[-1]
    return VoxelizerSpec(
        point_cloud_range=tuple(cfg["range"]),
        voxel_size=tuple(cfg["voxel_size"]),
        max_points=cfg.get("max_points_in_voxel", 5),
        max_voxels=max_voxels,
    )


def build_detector(cfg, dense_from_stage: Optional[int] = None,
                   process_group=None):
    """cfg: the full config (model + voxel_generator sections; ``precision``
    sets the compute dtype) -> ``VoxelNet`` or ``PointPillars``
    (sessd_tpu/builder.py:44-84). ``dense_from_stage`` is VoxelNet's
    training plan, 3 by default as in sessd_tpu/builder.py:70; the argument
    overrides it, e.g. with ``teacher_dense_from_stage``. VoxelNet's
    backbone, neck and head follow their config types: SE-SSD's
    (SpMiddleFHD, SSFA, MultiGroupHead) or CenterPoint's
    (``_center_modules``). With a
    ``process_group`` every BatchNorm takes its training statistics over
    the group's ranks (the JAX builder's ``axis_name``). Parameters are
    left at construction values; load a state dict or call
    ``reset_parameters(generator)``."""
    m = cfg.model
    voxelizer = build_voxelizer(cfg.voxel_generator)
    kw = dict(num_input_features=m["reader"].get("num_input_features", 4),
              tasks=tuple(dict(t) for t in m["bbox_head"]["tasks"]),
              dtype=_DTYPES[cfg.get("precision", "float32")])
    if m["type"] == "VoxelNet":
        if cfg.get("stage_capacity") is not None:
            kw["stage_capacity"] = tuple(int(c)
                                         for c in cfg["stage_capacity"])
        model = VoxelNet(
            sparse_shape=voxelizer.sparse_shape,
            dense_from_stage=(cfg.get("dense_from_stage", 3)
                              if dense_from_stage is None
                              else dense_from_stage),
            **_center_modules(m, kw["num_input_features"]), **kw)
    elif m["type"] == "PointPillars":
        nx, ny, _ = voxelizer.grid_size
        model = PointPillars(grid_size=(ny, nx),
                             voxel_size=tuple(voxelizer.voxel_size[:2]),
                             pc_range=tuple(voxelizer.point_cloud_range),
                             **kw)
    else:
        raise ValueError(f"unknown detector type {m['type']}")
    return sync_batch_norm(model, process_group)


_SSD_TYPES = {"backbone": "SpMiddleFHD", "neck": "SSFA",
              "bbox_head": "MultiGroupHead"}


def _center_modules(m, num_input_features: int) -> dict:
    """VoxelNet's ``backbone`` / ``neck`` / ``bbox_head`` arguments for
    the config's module types: none for SE-SSD's (VoxelNet builds its
    own), CenterPoint's ``SpMiddleResNetFHD``, ``RPN`` and ``CenterHead``
    from their sections."""
    out = {}
    for key, default in _SSD_TYPES.items():
        sec = m[key]
        kind = sec["type"]
        if kind == default:
            continue
        if kind == "SpMiddleResNetFHD":
            out[key] = SpMiddleResNetFHD(
                sec.get("num_input_features", num_input_features))
        elif kind == "RPN":
            out[key] = RPN(sec["num_input_features"], sec["layer_nums"],
                           sec["ds_layer_strides"], sec["ds_num_filters"],
                           sec["us_layer_strides"], sec["us_num_filters"])
        elif kind == "CenterHead":
            out[key] = CenterHead(
                [dict(t) for t in sec["tasks"]], sec["in_channels"],
                sec["share_conv_channel"],
                {k: tuple(v) for k, v in sec["common_heads"].items()},
                sec.get("num_hm_conv", 2), sec.get("init_bias", -2.19))
        else:
            raise ValueError(f"unknown {key} type {kind}")
    return out


def build_anchors(cfg) -> np.ndarray:
    """[H*W*classes*rotations, 7] anchors over the head's output grid (the
    voxel grid // ``assigner.out_size_factor``), one block per anchor
    generator, in the head's (y, x, class, rot) output order: the anchors
    of the config's dataset (``data.pipeline.Pipeline.anchors``)."""
    p = build_pipeline_config(cfg)
    specs = p.anchor_specs or (dict(anchor_range=p.anchor_range,
                                    sizes=p.anchor_sizes),)
    return np.concatenate([create_anchors_3d_range(
        p.feature_map_size, s["anchor_range"], s["sizes"],
        p.anchor_rotations) for s in specs], axis=3).reshape(-1, 7)


def set_cls_prior(model, pi: Optional[float] = 0.01) -> None:
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
    if nms_type not in ("rotate_nms", "rotate_weighted_nms"):
        raise ValueError(f"unknown nms_type {nms_type}")
    center = ()
    if cfg.model["bbox_head"]["type"] == "CenterHead":
        # the head's grid: the voxel grid // out_size_factor, each cell
        # out_size_factor voxels wide (center_head.py's decode)
        f = tc["out_size_factor"]
        nx, ny, _ = build_voxelizer(cfg.voxel_generator).grid_size
        center = (ny // f, nx // f, f * tc["voxel_size"][0],
                  f * tc["voxel_size"][1], tc["pc_range"][0],
                  tc["pc_range"][1])
    return PredictConfig(
        score_threshold=tc["score_threshold"],
        nms_pre_max_size=tc["nms"]["nms_pre_max_size"],
        nms_post_max_size=tc["nms"]["nms_post_max_size"],
        nms_iou_threshold=tc["nms"]["nms_iou_threshold"],
        nms_pre_small=tc["nms"].get("nms_pre_small", 256),
        post_center_range=tuple(tc["post_center_limit_range"]),
        use_dir_classifier=cfg.model["bbox_head"].get("loss_aux") is not None,
        direction_offset=cfg.model["bbox_head"].get("direction_offset", 0.0),
        nms_type=nms_type,
        center=center,
    )


def _feature_map_size(voxelizer: VoxelizerSpec, out_size_factor: int = 8):
    nx, ny, _ = voxelizer.grid_size
    return (1, ny // out_size_factor, nx // out_size_factor)


def build_pipeline_config(cfg) -> PipelineConfig:
    """sessd_tpu/builder.py:87-133."""
    voxelizer = build_voxelizer(cfg.voxel_generator)
    gens = cfg.target_assigner["anchor_generators"]
    ag = gens[0]
    tp = cfg.get("train_preprocessor", {})
    assigner = cfg.get("assigner", {})
    anchor_specs = None
    if len(gens) > 1:
        anchor_specs = tuple(
            dict(class_name=g["class_name"], sizes=tuple(g["sizes"]),
                 anchor_range=tuple(g["anchor_ranges"]),
                 matched_threshold=g.get("matched_threshold", 0.6),
                 unmatched_threshold=g.get("unmatched_threshold", 0.45))
            for g in gens)
    return PipelineConfig(
        anchor_specs=anchor_specs,
        class_names=tuple(cfg.class_names),
        enable_similar_type=bool(assigner.get("enable_similar_type", True)),
        voxelizer=voxelizer,
        feature_map_size=_feature_map_size(
            voxelizer, assigner.get("out_size_factor", 8)),
        anchor_range=tuple(ag["anchor_ranges"]),
        anchor_sizes=tuple(ag["sizes"]),
        anchor_rotations=(0.0, math.pi / 2),
        matched_threshold=ag.get("matched_threshold", 0.6),
        unmatched_threshold=ag.get("unmatched_threshold", 0.45),
        gt_loc_noise=tuple(tp.get("gt_loc_noise", (1.0, 1.0, 0.5))),
        gt_rot_noise=tuple(tp.get("gt_rot_noise", (-0.785, 0.785))),
        global_rot_noise=tuple(tp.get("global_rot_noise", (-0.785, 0.785))),
        global_scale_noise=tuple(tp.get("global_scale_noise", (0.95, 1.05))),
        remove_points_after_sample=tp.get("remove_points_after_sample", True),
        sa_dropout=tp.get("sa_dropout", 0.25),
        sa_sparsity=tuple(tp.get("sa_sparsity", (0.05, 50))),
        sa_swap=tuple(tp.get("sa_swap", (0.1, 50))),
        shuffle_points=tp.get("shuffle_points", True),
        # CIA-SSD has no teacher: no raw twin of each sample
        produce_raw=bool(cfg.get("my_paras", {}).get("enable_ssl", True)),
    )


def build_sampler(cfg, seed: int = 0) -> Optional[GroundTruthSampler]:
    """The GT-AUG database sampler (sessd_tpu/builder.py:136-160)."""
    db = cfg.get("db_sampler")
    if db is None or not db.get("enable", True):
        return None
    groups = {}
    for g in db["sample_groups"]:
        groups.update(g)
    min_points, removed_difficulty = {}, (-1,)
    for step in db.get("db_prep_steps", []):
        if "filter_by_min_num_points" in step:
            min_points.update(step["filter_by_min_num_points"])
        if "filter_by_difficulty" in step:
            removed_difficulty = tuple(step["filter_by_difficulty"])
    return GroundTruthSampler(
        db_info_path=db["db_info_path"], root_path=cfg.data_root,
        sample_groups=groups, min_points=min_points,
        removed_difficulty=removed_difficulty, rate=db.get("rate", 1.0),
        seed=seed)


def build_dataset(cfg, split: str, seed: int = 0) -> KittiDataset:
    dcfg = cfg.data[split]
    mode = "train" if split == "train" else "val"
    return KittiDataset(
        root_path=dcfg["root_path"], info_path=dcfg["info_path"],
        class_names=dcfg.get("class_names", cfg.class_names), mode=mode,
        pipeline_cfg=build_pipeline_config(cfg),
        sampler=build_sampler(cfg, seed) if mode == "train" else None)


def build_dataloader(cfg, dataset, shuffle: bool, seed: int = 0,
                     num_shards: int = 1, shard_index: int = 0) -> DataLoader:
    """One process's loader: ``samples_per_gpu`` scenes per batch from
    shard ``shard_index`` of ``num_shards`` of every epoch (one shard per
    rank, padded by wrapping to equal sizes)."""
    return DataLoader(
        dataset, batch_size=cfg.data["samples_per_gpu"], shuffle=shuffle,
        seed=seed, num_workers=cfg.data.get("workers_per_gpu", 4),
        drop_last=shuffle, num_shards=num_shards, shard_index=shard_index,
        worker_type=cfg.data.get("worker_type", "thread"))


def build_optimizer_from_cfg(cfg, steps_per_epoch: int, params):
    """(AdamW over ``params``, lr_fn(step) -> lr) (sessd_tpu/builder.py:
    183-215). ``lr_config.type``: "one_cycle" (the SE-SSD/CIA-SSD recipe:
    one-cycle lr and beta1) or a legacy LrUpdaterHook policy, fixed / step
    / exp / poly / cosine with an optional warmup
    (``build_legacy_schedule``), under AdamW with beta1 0.9."""
    lr = cfg.lr_config
    total = cfg.total_epochs * steps_per_epoch
    wd = cfg.optimizer.get("wd", 0.01)
    clip = cfg.optimizer_config["grad_clip"]["max_norm"]
    policy = lr.get("type", lr.get("policy", "one_cycle"))
    if policy == "one_cycle":
        ocfg = OneCycleConfig(
            lr_max=lr["lr_max"], moms=tuple(lr["moms"]),
            div_factor=lr["div_factor"], pct_start=lr["pct_start"],
            total_steps=total, wd=wd, grad_clip_norm=clip)
        lr_fn = one_cycle_lr(ocfg)
        return AdamW(params, lr_fn, one_cycle_mom(ocfg), b2=ocfg.beta2,
                     eps=ocfg.eps, wd=ocfg.wd,
                     grad_clip_norm=ocfg.grad_clip_norm), lr_fn
    lr_fn = build_legacy_schedule(
        policy, lr.get("lr", cfg.optimizer.get("lr", 3e-3)), steps_per_epoch,
        total, gamma=lr.get("gamma", 0.1), milestones=lr.get("step", ()),
        power=lr.get("power", 1.0), min_lr=lr.get("min_lr", 0.0),
        warmup=lr.get("warmup"), warmup_iters=lr.get("warmup_iters", 500),
        warmup_ratio=lr.get("warmup_ratio", 1.0 / 3.0))
    return AdamW(params, lr_fn, lambda step: 0.9, b2=0.99, eps=1e-8, wd=wd,
                 grad_clip_norm=clip), lr_fn


def build_loss_config(cfg) -> LossConfig:
    """sessd_tpu/builder.py:218-233."""
    h = cfg.model["bbox_head"]
    tc = cfg.test_cfg
    return LossConfig(
        cls_loss_weight=h["loss_cls"].get("loss_weight", 1.0),
        loc_loss_weight=h["loss_bbox"].get("loss_weight", 2.0),
        dir_loss_weight=h["loss_aux"].get("loss_weight", 0.2),
        focal_alpha=h["loss_cls"].get("alpha", 0.25),
        focal_gamma=h["loss_cls"].get("gamma", 2.0),
        smooth_l1_sigma=h["loss_bbox"].get("sigma", 3.0),
        direction_offset=h.get("direction_offset", 0.0),
        reg_loss=h.get("reg_loss", "odiou"),
        consistency=ConsistencyConfig(
            score_thresh=tc.get("score_threshold", 0.3),
            post_center_range=tuple(tc["post_center_limit_range"])))
