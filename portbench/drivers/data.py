"""The cells' inputs, made from the seed by the frozen copy of the port's
host layer (``portbench/hostpath``): the configuration, the synthetic KITTI
root, the training data path and the serving scans.

``build_pipeline_config``, ``build_sampler`` and ``build_dataset`` repeat
``sessd_torch/builder.py``'s functions of those names on the frozen
modules (``builder.py`` itself also builds the models, so it is not
copied whole)."""
from __future__ import annotations

import concurrent.futures
import copy
import math
import multiprocessing
import os
from typing import Optional

from ..hostpath.config import Config
from ..hostpath.core.anchors import create_anchors_3d_range
from ..hostpath.data.augment import GroundTruthSampler
from ..hostpath.data.dataset import KittiDataset
from ..hostpath.data.loader import DataLoader
from ..hostpath.data.pipeline import PipelineConfig
from ..hostpath.ops.voxelize import VoxelizerSpec
from ..harness import PKG


def _merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def load_config(config: dict, traffic: dict, data_root: Optional[str] = None):
    """The program's config (the frozen copy of the file the configuration
    names) with the configuration's and the traffic's overrides, and the
    data paths moved under ``data_root`` as ``tools/train.py``'s ``load``
    moves them."""
    cfg = Config.fromfile(PKG / "hostpath" / "configs"
                          / config["program_config"])
    _merge(cfg._cfg, config.get("overrides", {}))
    _merge(cfg._cfg, traffic.get("overrides", {}))
    cfg._cfg = type(cfg._cfg)._wrap(dict(cfg._cfg))
    if data_root:
        old = cfg.data_root.rstrip("/")

        def swap(path):
            return (data_root.rstrip("/") + path[len(old):]
                    if path.startswith(old) else path)

        for split in ("train", "val", "test"):
            if split in cfg.data:
                cfg.data[split]["root_path"] = swap(
                    cfg.data[split]["root_path"])
                cfg.data[split]["info_path"] = swap(
                    cfg.data[split]["info_path"])
        if cfg.get("db_sampler"):
            cfg.db_sampler["db_info_path"] = swap(
                cfg.db_sampler["db_info_path"])
        cfg._cfg["data_root"] = data_root
    check_sizes(cfg, config["sizes"])
    return cfg


def check_sizes(cfg, sizes: dict):
    """The configuration file's published sizes against the config as run:
    a copy that drifted from its configuration fails the run."""
    spec = build_voxelizer(cfg.voxel_generator)
    got = {"sparse_shape": list(spec.sparse_shape),
           "voxel_size": list(spec.voxel_size),
           "point_cloud_range": list(spec.point_cloud_range),
           "max_points_in_voxel": spec.max_points,
           "max_voxel_num": spec.max_voxels,
           "precision": cfg.get("precision", "float32"),
           "batch_size": cfg.data["samples_per_gpu"],
           "num_anchors": int(math.prod(build_anchors(cfg).shape[:-1])),
           "stage_capacity": list(cfg.get("stage_capacity") or [])}
    for k, v in sizes.items():
        if k in got and got[k] != v:
            raise SystemExit(f"config size {k}: the file says {v}, the "
                             f"config runs {got[k]}")


def build_voxelizer(vg) -> VoxelizerSpec:
    return VoxelizerSpec(point_cloud_range=tuple(vg["range"]),
                         voxel_size=tuple(vg["voxel_size"]),
                         max_points=vg.get("max_points_in_voxel", 5),
                         max_voxels=vg.get("max_voxel_num", 20000))


def build_pipeline_config(cfg) -> PipelineConfig:
    voxelizer = build_voxelizer(cfg.voxel_generator)
    ag = cfg.target_assigner["anchor_generators"][0]
    tp = cfg.get("train_preprocessor", {})
    assigner = cfg.get("assigner", {})
    nx, ny, _ = voxelizer.grid_size
    osf = assigner.get("out_size_factor", 8)
    return PipelineConfig(
        anchor_specs=None,
        class_names=tuple(cfg.class_names),
        enable_similar_type=bool(assigner.get("enable_similar_type", True)),
        voxelizer=voxelizer,
        feature_map_size=(1, ny // osf, nx // osf),
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
        produce_raw=bool(cfg.get("my_paras", {}).get("enable_ssl", True)),
    )


def build_anchors(cfg):
    p = build_pipeline_config(cfg)
    return create_anchors_3d_range(p.feature_map_size, p.anchor_range,
                                   p.anchor_sizes,
                                   p.anchor_rotations).reshape(-1, 7)


def build_sampler(cfg, seed: int) -> Optional[GroundTruthSampler]:
    db = cfg.get("db_sampler")
    if db is None or not db.get("enable", True):
        return None
    groups = {}
    for g in db["sample_groups"]:
        groups.update(g)
    min_points, removed = {}, (-1,)
    for step in db.get("db_prep_steps", []):
        if "filter_by_min_num_points" in step:
            min_points.update(step["filter_by_min_num_points"])
        if "filter_by_difficulty" in step:
            removed = tuple(step["filter_by_difficulty"])
    return GroundTruthSampler(
        db_info_path=db["db_info_path"], root_path=cfg.data_root,
        sample_groups=groups, min_points=min_points,
        removed_difficulty=removed, rate=db.get("rate", 1.0), seed=seed)


def train_loader(cfg, seed: int, workers: int) -> DataLoader:
    """The train split's loader, shuffled and augmented from ``seed``."""
    d = cfg.data["train"]
    ds = KittiDataset(root_path=d["root_path"], info_path=d["info_path"],
                      class_names=d.get("class_names", cfg.class_names),
                      mode="train", pipeline_cfg=build_pipeline_config(cfg),
                      sampler=build_sampler(cfg, seed))
    return DataLoader(ds, batch_size=cfg.data["samples_per_gpu"],
                      shuffle=True, seed=seed, num_workers=workers,
                      drop_last=True)


def make_root(root: str, traffic: dict, seed: int) -> None:
    """A synthetic KITTI root of ray-cast frames (``utils/kitti_synth``)
    with its infos and GT database, as the acceptance recipe makes one."""
    from ..hostpath.tools.create_data import create_kitti_data
    from ..hostpath.utils.kitti_synth import make_kitti_root

    n = traffic["frames"]
    make_kitti_root(root, num_frames=n, seed=seed,
                    num_cars=traffic["cars_per_frame"],
                    pts_per_car=traffic["pts_per_car"],
                    ground_points=traffic["ground_points"])
    create_kitti_data(root, {"train": range(n), "val": range(2)})


def _scene(seed: int):
    from ..hostpath.utils.synth_scene import make_scene

    return make_scene(seed=seed)[0]


def make_scans(scene_seeds, workers: int):
    """``make_scene`` scans [P, 4] f32 of each seed, made in ``workers``
    spawned processes (all ended on return)."""
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(workers, len(scene_seeds), os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        return list(ex.map(_scene, scene_seeds))
