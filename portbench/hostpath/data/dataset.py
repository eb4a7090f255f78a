"""KittiDataset — info-pkl-backed dataset + KITTI-format evaluation glue.

Redesign of det3d/datasets/kitti/kitti.py:19-226: the dataset owns a
Pipeline and yields fixed-capacity example dicts;
``convert_detection_to_kitti_annos`` converts lidar-frame detections into
KITTI camera-frame annos (kitti.py:71-139). (The benchmark's copy leaves
out the AP evaluation, which no cell runs.)
"""
from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np

from ..core import box_np
from ..core.target_assign import limit_period
from .pipeline import Pipeline, PipelineConfig
from .augment import GroundTruthSampler


class KittiDataset:
    def __init__(
        self,
        root_path: str,
        info_path: str,
        class_names: Sequence[str] = ("Car",),
        mode: str = "train",
        pipeline_cfg: Optional[PipelineConfig] = None,
        sampler: Optional[GroundTruthSampler] = None,
        labeled: bool = True,
    ):
        self.root_path = root_path
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)
        self.class_names = list(class_names)
        self.mode = mode
        self.labeled = labeled
        cfg = pipeline_cfg or PipelineConfig(class_names=tuple(class_names))
        self.pipeline = Pipeline(cfg, mode=mode if labeled else "val", sampler=sampler)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx):
        return self.get_sensor_data(idx)

    def get_sensor_data(self, idx, rng: Optional[np.random.RandomState] = None):
        return self.pipeline(self.infos[idx], self.root_path, rng=rng)

    @property
    def anchors(self) -> np.ndarray:
        return self.pipeline.anchors

    @property
    def group_flags(self) -> np.ndarray:
        """Image aspect-ratio group per sample (custom.py:161-170: flag 1
        when w/h > 1). Feeds the loader's group-aware batching; samples
        without image info land in group 0."""
        flags = np.zeros(len(self.infos), np.int64)
        for i, info in enumerate(self.infos):
            shape = info.get("image", {}).get("image_shape")
            if shape is not None and shape[1] / max(shape[0], 1) > 1:
                flags[i] = 1
        return flags

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    @property
    def ground_truth_annotations(self):
        if "annos" not in self.infos[0]:
            return None
        return [info["annos"] for info in self.infos]

    def convert_detection_to_kitti_annos(self, detections, indices=None):
        """detections: list (aligned with infos, or with ``indices`` for a
        partial hand-picked evaluation like the reference's partial=True,
        kitti.py:141-167) of dicts with numpy ``box3d_lidar`` [D, 7]
        (gravity-center), ``scores`` [D], ``label_preds`` [D]."""
        infos = (self.infos if indices is None
                 else [self.infos[int(i)] for i in indices])
        annos = []
        for det, info in zip(detections, infos):
            calib = info["calib"]
            rect, trv2c, p2 = calib["R0_rect"], calib["Tr_velo_to_cam"], calib["P2"]
            boxes = np.asarray(det["box3d_lidar"], dtype=np.float64).copy()
            scores = np.asarray(det["scores"])
            labels = np.asarray(det["label_preds"])
            anno = {k: [] for k in ("name", "truncated", "occluded", "alpha",
                                    "bbox", "dimensions", "location",
                                    "rotation_y", "score")}
            if len(boxes):
                boxes[:, 6] = limit_period(boxes[:, 6], offset=0.5, period=2 * np.pi)
                boxes[:, 2] -= boxes[:, 5] / 2  # gravity center -> bottom
                cam = box_np.box_lidar_to_camera(boxes, rect, trv2c)
                corners = box_np.center_to_corner_box3d(
                    cam[:, :3], cam[:, 3:6], cam[:, 6], origin=(0.5, 1.0, 0.5), axis=1)
                img = box_np.project_to_image(
                    corners.reshape(-1, 3), p2).reshape(-1, 8, 2)
                bbox = np.concatenate([img.min(axis=1), img.max(axis=1)], axis=1)
                shape = info["image"]["image_shape"]
                for j in range(len(boxes)):
                    if bbox[j, 0] > shape[1] or bbox[j, 1] > shape[0]:
                        continue
                    if bbox[j, 2] < 0 or bbox[j, 3] < 0:
                        continue
                    bb = bbox[j].copy()
                    bb[2:] = np.minimum(bb[2:], shape[::-1])
                    bb[:2] = np.maximum(bb[:2], 0)
                    anno["bbox"].append(bb)
                    anno["alpha"].append(
                        -np.arctan2(-boxes[j, 1], boxes[j, 0]) + cam[j, 6])
                    anno["dimensions"].append(cam[j, 3:6])
                    anno["location"].append(cam[j, :3])
                    anno["rotation_y"].append(cam[j, 6])
                    anno["name"].append(self.class_names[int(labels[j])])
                    anno["truncated"].append(0.0)
                    anno["occluded"].append(0)
                    anno["score"].append(scores[j])
            n = len(anno["name"])
            out = {
                "name": np.asarray(anno["name"]),
                "truncated": np.asarray(anno["truncated"]),
                "occluded": np.asarray(anno["occluded"], dtype=np.int64),
                "alpha": np.asarray(anno["alpha"]),
                "bbox": np.asarray(anno["bbox"]).reshape(n, 4),
                "dimensions": np.asarray(anno["dimensions"]).reshape(n, 3),
                "location": np.asarray(anno["location"]).reshape(n, 3),
                "rotation_y": np.asarray(anno["rotation_y"]),
                "score": np.asarray(anno["score"]),
                "metadata": det.get("metadata"),
            }
            annos.append(out)
        return annos
