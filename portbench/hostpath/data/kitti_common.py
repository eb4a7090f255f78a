"""KITTI file I/O and offline preparation (info pkls, reduced clouds,
GT database) — numpy re-implementation of det3d/datasets/kitti/
kitti_common.py and det3d/datasets/utils/create_gt_database.py.

Info-dict layout is kept byte-compatible with the reference so existing
``kitti_infos_*.pkl`` / ``dbinfos_*.pkl`` files load unchanged:
    info = {
      "image": {"image_idx", "image_path", "image_shape"},
      "point_cloud": {"num_features", "velodyne_path"},
      "calib": {"R0_rect", "Tr_velo_to_cam", "P0..P3"} (4x4 extended),
      "annos": {"name", "truncated", "occluded", "alpha", "bbox",
                "dimensions" (l,h,w), "location", "rotation_y", "score",
                "index", "group_ids", "difficulty", "num_points_in_gt"},
    }
"""
from __future__ import annotations

import concurrent.futures
import pathlib
import pickle
import struct
from typing import Optional

import numpy as np

from ..core import box_np

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting",
               "Truck", "Tram", "Misc", "DontCare"]


# ---------------------------------------------------------------------------
# raw file parsing
# ---------------------------------------------------------------------------

def read_label(path) -> dict:
    """Parse a KITTI label .txt into the reference's annos dict."""
    names, trunc, occ, alpha, bbox, dims, loc, rot = [], [], [], [], [], [], [], []
    with open(path, "r") as f:
        lines = [l.strip() for l in f.readlines() if l.strip()]
    for line in lines:
        v = line.split(" ")
        names.append(v[0])
        trunc.append(float(v[1]))
        occ.append(int(float(v[2])))
        alpha.append(float(v[3]))
        bbox.append([float(x) for x in v[4:8]])
        # label file order h, w, l -> store (l, h, w) like the reference
        dims.append([float(v[10]), float(v[8]), float(v[9])])
        loc.append([float(x) for x in v[11:14]])
        rot.append(float(v[14]))
    n = len(names)
    content_ok = n > 0
    annos = {
        "name": np.array(names),
        "truncated": np.array(trunc),
        "occluded": np.array(occ),
        "alpha": np.array(alpha),
        "bbox": np.array(bbox).reshape(-1, 4),
        "dimensions": np.array(dims).reshape(-1, 3),
        "location": np.array(loc).reshape(-1, 3),
        "rotation_y": np.array(rot),
        "score": np.zeros((n,)),
    }
    num_obj = int(np.sum(annos["name"] != "DontCare"))
    annos["index"] = np.concatenate(
        [np.arange(num_obj, dtype=np.int32),
         -np.ones(n - num_obj, dtype=np.int32)]) if content_ok else np.zeros((0,), np.int32)
    annos["group_ids"] = np.arange(n, dtype=np.int32)
    return annos


def _extend_matrix(mat: np.ndarray) -> np.ndarray:
    return np.concatenate([mat, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def read_calib(path) -> dict:
    """Parse calib .txt to 4x4-extended matrices."""
    out = {}
    with open(path, "r") as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.array([float(x) for x in vals.split()])
            if key.startswith("P"):
                out[key] = _extend_matrix(arr.reshape(3, 4))
            elif key == "R0_rect":
                m = np.eye(4)
                m[:3, :3] = arr.reshape(3, 3)
                out[key] = m
            elif key in ("Tr_velo_to_cam", "Tr_imu_to_velo"):
                out[key] = _extend_matrix(arr.reshape(3, 4))
    return out


def read_png_shape(path) -> np.ndarray:
    """(height, width) from the PNG IHDR without an image library."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a png: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return np.array([h, w], dtype=np.int32)


def remove_dontcare(annos: dict) -> dict:
    keep = [i for i, n in enumerate(annos["name"]) if n != "DontCare"]
    return {k: (v[keep] if isinstance(v, np.ndarray) and len(v) == len(annos["name"]) else v)
            for k, v in annos.items()}


def add_difficulty(annos: dict) -> np.ndarray:
    """KITTI difficulty: 0 easy / 1 moderate / 2 hard / -1 none
    (kitti_common.add_difficulty_to_annos semantics)."""
    min_height = [40, 25, 25]
    max_occ = [0, 1, 2]
    max_trunc = [0.15, 0.3, 0.5]
    h = annos["bbox"][:, 3] - annos["bbox"][:, 1]
    occ, trunc = annos["occluded"], annos["truncated"]
    n = len(h)
    easy = (h >= min_height[0]) & (occ <= max_occ[0]) & (trunc <= max_trunc[0])
    mod = (h >= min_height[1]) & (occ <= max_occ[1]) & (trunc <= max_trunc[1])
    hard = (h >= min_height[2]) & (occ <= max_occ[2]) & (trunc <= max_trunc[2])
    diff = np.full(n, -1, dtype=np.int32)
    diff[hard] = 2
    diff[mod] = 1
    diff[easy] = 0
    annos["difficulty"] = diff
    return diff


# ---------------------------------------------------------------------------
# frustum culling (reduced point clouds)
# ---------------------------------------------------------------------------

def remove_outside_points(points, rect, trv2c, p2, image_shape):
    """Keep points inside the camera's image frustum
    (box_np_ops.remove_outside_points)."""
    frustum_surfaces = box_np.get_valid_frustum(rect, trv2c, image_shape, p2)[0]
    mask = box_np.points_in_convex_polygon_3d(points[:, :3], frustum_surfaces[None])[:, 0]
    return points[mask]


# ---------------------------------------------------------------------------
# info creation (tools/create_data.py equivalents)
# ---------------------------------------------------------------------------

def create_kitti_info(root: str, image_ids, training: bool = True,
                      num_features: int = 4, with_annotations: bool = True,
                      relative_path: bool = True, num_workers: int = 8):
    """Build the info list for a split (kitti_common.get_kitti_image_info)."""
    root = pathlib.Path(root)
    sub = "training" if training else "testing"

    def one(idx):
        sid = f"{idx:06d}"
        info = {
            "image": {
                "image_idx": idx,
                "image_path": f"{sub}/image_2/{sid}.png",
                "image_shape": read_png_shape(root / sub / "image_2" / f"{sid}.png"),
            },
            "point_cloud": {
                "num_features": num_features,
                "velodyne_path": f"{sub}/velodyne/{sid}.bin",
            },
            "calib": read_calib(root / sub / "calib" / f"{sid}.txt"),
        }
        if with_annotations:
            annos = read_label(root / sub / "label_2" / f"{sid}.txt")
            add_difficulty(annos)
            info["annos"] = annos
        return info

    with concurrent.futures.ThreadPoolExecutor(num_workers) as ex:
        infos = list(ex.map(one, image_ids))

    if with_annotations:
        _calculate_num_points_in_gt(root, infos, num_features)
    return infos


def _calculate_num_points_in_gt(root, infos, num_features):
    for info in infos:
        v_path = pathlib.Path(root) / info["point_cloud"]["velodyne_path"]
        points = np.fromfile(str(v_path), dtype=np.float32).reshape(-1, num_features)
        calib = info["calib"]
        points = remove_outside_points(
            points, calib["R0_rect"], calib["Tr_velo_to_cam"], calib["P2"],
            info["image"]["image_shape"])
        annos = info["annos"]
        no_dc = remove_dontcare(annos)
        boxes_cam = np.concatenate(
            [no_dc["location"], no_dc["dimensions"], no_dc["rotation_y"][:, None]], axis=1)
        boxes_lidar = box_np.box_camera_to_lidar(
            boxes_cam, calib["R0_rect"], calib["Tr_velo_to_cam"])
        boxes_lidar[:, 2] += boxes_lidar[:, 5] / 2  # bottom -> gravity center
        cnt = box_np.points_count_rbbox(points, boxes_lidar)
        num_ignored = len(annos["name"]) - len(no_dc["name"])
        annos["num_points_in_gt"] = np.concatenate(
            [cnt.astype(np.int32), -np.ones(num_ignored, dtype=np.int32)])


def create_reduced_point_cloud(root: str, info_path: str, save_dir: Optional[str] = None):
    """Write velodyne_reduced/*.bin (kitti_common.py:154-213)."""
    root = pathlib.Path(root)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    for info in infos:
        v_path = root / info["point_cloud"]["velodyne_path"]
        points = np.fromfile(str(v_path), dtype=np.float32).reshape(
            -1, info["point_cloud"]["num_features"])
        calib = info["calib"]
        points = remove_outside_points(
            points, calib["R0_rect"], calib["Tr_velo_to_cam"], calib["P2"],
            info["image"]["image_shape"])
        if save_dir is None:
            out = v_path.parent.parent / (v_path.parent.stem + "_reduced") / v_path.name
        else:
            out = pathlib.Path(save_dir) / v_path.name
        out.parent.mkdir(parents=True, exist_ok=True)
        points.astype(np.float32).tofile(str(out))


def create_groundtruth_database(
    root: str, info_path: str, db_path: Optional[str] = None,
    dbinfo_path: Optional[str] = None, used_classes=None,
):
    """Crop per-gt point clouds (center-relative) into gt_database/ and write
    the dbinfos pkl (datasets/utils/create_gt_database.py:20+)."""
    root = pathlib.Path(root)
    db_path = pathlib.Path(db_path) if db_path else root / "gt_database"
    dbinfo_path = pathlib.Path(dbinfo_path) if dbinfo_path else root / "dbinfos_train.pkl"
    db_path.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)

    all_db_infos: dict = {}
    for info in infos:
        idx = info["image"]["image_idx"]
        v_path = root / info["point_cloud"]["velodyne_path"]
        reduced = v_path.parent.parent / (v_path.parent.stem + "_reduced") / v_path.name
        if reduced.exists():
            v_path = reduced
        points = np.fromfile(str(v_path), dtype=np.float32).reshape(
            -1, info["point_cloud"]["num_features"])
        annos = remove_dontcare(info["annos"])
        calib = info["calib"]
        boxes_cam = np.concatenate(
            [annos["location"], annos["dimensions"], annos["rotation_y"][:, None]], axis=1)
        boxes_lidar = box_np.box_camera_to_lidar(
            boxes_cam, calib["R0_rect"], calib["Tr_velo_to_cam"])
        boxes_lidar[:, 2] += boxes_lidar[:, 5] / 2
        mask = box_np.points_in_rbbox(points, boxes_lidar)
        for i, name in enumerate(annos["name"]):
            if used_classes is not None and name not in used_classes:
                continue
            gt_points = points[mask[:, i]].copy()
            gt_points[:, :3] -= boxes_lidar[i, :3]
            fname = f"{idx}_{name}_{i}.bin"
            gt_points.astype(np.float32).tofile(str(db_path / fname))
            db_info = {
                "name": name,
                "path": str(db_path.name + "/" + fname),
                "image_idx": idx,
                "gt_idx": i,
                "box3d_lidar": boxes_lidar[i].astype(np.float32),
                "num_points_in_gt": int(mask[:, i].sum()),
                "difficulty": int(annos["difficulty"][i]) if "difficulty" in annos else 0,
                "group_id": -1,
            }
            all_db_infos.setdefault(name, []).append(db_info)

    with open(dbinfo_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return all_db_infos


def annos_to_kitti_label(annos: dict) -> list:
    """KITTI label-file lines from a detection-anno dict
    (kitti_common.py:661-730 kitti_result_line/annos_to_kitti_label):
    ``name trunc occl alpha bbox(4) h w l x y z ry score`` — dimensions are
    stored (l, h, w) camera-frame and written h w l."""
    lines = []
    for i in range(len(annos["name"])):
        d = annos["dimensions"][i]
        vals = (
            [str(annos["name"][i]),
             f"{float(annos['truncated'][i]):.4f}",
             str(int(annos["occluded"][i])),
             f"{float(annos['alpha'][i]):.4f}"]
            + [f"{v:.4f}" for v in annos["bbox"][i]]
            + [f"{v:.4f}" for v in (d[1], d[2], d[0])]
            + [f"{v:.4f}" for v in annos["location"][i]]
            + [f"{float(annos['rotation_y'][i]):.4f}",
               f"{float(annos['score'][i]):.4f}"]
        )
        lines.append(" ".join(vals))
    return lines
