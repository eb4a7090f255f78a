"""Host-side data augmentation (numpy, runs in loader workers).

Re-implements the semantics of det3d/core/sampler/preprocess.py and
sample_ops.py without numba:

- ``GroundTruthSampler`` — GT-AUG: paste database objects up to a per-class
  budget with a BEV collision test (sample_ops.py:107-320).
- ``noise_per_object`` — per-gt location/rotation jitter with
  collision-checked retries (preprocess.py:615-660 ``noise_per_object_v4_``).
- ``random_flip`` / ``global_rotation`` / ``global_scaling`` — global
  transforms that RETURN their noise parameters for the consistency loss
  (preprocess.py:896-941, the ``_v2/_v3`` variants).

All randomness flows through an explicit ``np.random.RandomState`` so the
pipeline is deterministic per (seed, epoch, index) — the reference's hidden
global-RNG state (SURVEY §5.2) is deliberately not reproduced.
"""
from __future__ import annotations

import pathlib
import pickle
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core import box_np
from ..core.rotated_iou_np import overlap_bev_matrix


# ---------------------------------------------------------------------------
# collision tests
# ---------------------------------------------------------------------------

def box_collision_test(boxes5: np.ndarray, qboxes5: np.ndarray) -> np.ndarray:
    """[N, 5] x [K, 5] BEV polygon intersection test -> bool [N, K].

    Equivalent to prep.box_collision_test (preprocess.py:944-1035): true iff
    the rotated rectangles overlap (edge crossing or containment), which is
    exactly a positive intersection area.
    """
    if len(boxes5) == 0 or len(qboxes5) == 0:
        return np.zeros((len(boxes5), len(qboxes5)), dtype=bool)
    # bounding-circle prefilter (exact: a rotated rect lies inside its
    # half-diagonal circle, so disjoint circles => no overlap); the exact
    # polygon clipping runs only on rows/cols with a near pair — the
    # noise_per_object attempt matrices are ~95% far pairs
    r1 = 0.5 * np.hypot(boxes5[:, 2], boxes5[:, 3])
    r2 = 0.5 * np.hypot(qboxes5[:, 2], qboxes5[:, 3])
    d = np.linalg.norm(boxes5[:, None, :2] - qboxes5[None, :, :2], axis=-1)
    near = d <= r1[:, None] + r2[None, :]
    out = np.zeros(near.shape, dtype=bool)
    rows = np.flatnonzero(near.any(axis=1))
    if rows.size:
        cols = np.flatnonzero(near[rows].any(axis=0))
        sub = overlap_bev_matrix(boxes5[rows], qboxes5[cols]) > 1e-9
        out[np.ix_(rows, cols)] = sub
    return out


# ---------------------------------------------------------------------------
# global transforms (record parameters for the consistency loss)
# ---------------------------------------------------------------------------

def random_flip(gt_boxes, points, rng: np.random.RandomState, probability=0.5):
    flipped = bool(rng.rand() < probability)
    if flipped:
        if gt_boxes is not None and len(gt_boxes):
            gt_boxes[:, 1] = -gt_boxes[:, 1]
            gt_boxes[:, 6] = -gt_boxes[:, 6] + np.pi
        points[:, 1] = -points[:, 1]
    return gt_boxes, points, flipped


def global_rotation(gt_boxes, points, rng, rotation=(-np.pi / 4, np.pi / 4)):
    noise = float(rng.uniform(rotation[0], rotation[1]))
    points[:, :3] = box_np.rotation_points_single_angle(points[:, :3], noise, axis=2)
    if gt_boxes is not None and len(gt_boxes):
        gt_boxes[:, :3] = box_np.rotation_points_single_angle(gt_boxes[:, :3], noise, axis=2)
        gt_boxes[:, 6] += noise
    return gt_boxes, points, noise


def global_scaling(gt_boxes, points, rng, min_scale=0.95, max_scale=1.05):
    noise = float(rng.uniform(min_scale, max_scale))
    points[:, :3] *= noise
    if gt_boxes is not None and len(gt_boxes):
        gt_boxes[:, :6] *= noise
    return gt_boxes, points, noise


# ---------------------------------------------------------------------------
# per-object noise
# ---------------------------------------------------------------------------

def noise_per_object(
    gt_boxes: np.ndarray,
    points: Optional[np.ndarray],
    valid_mask: Optional[np.ndarray],
    rng: np.random.RandomState,
    rotation_perturb=(-np.pi / 4, np.pi / 4),
    center_noise_std=(1.0, 1.0, 0.5),
    num_try: int = 100,
):
    """In-place per-gt jitter with first-accepted-candidate collision retry.

    Boxes are processed in order; each draws ``num_try`` (loc, rot)
    candidates and takes the first whose moved BEV footprint collides with
    no *other* box (already-moved boxes are seen at their new location, as
    in noise_per_box / preprocess.py:580-613). Points inside a moved box
    rotate about the box center and translate with it.
    """
    n = len(gt_boxes)
    if n == 0:
        return
    if valid_mask is None:
        valid_mask = np.ones(n, dtype=bool)
    loc_noises = rng.normal(scale=center_noise_std, size=(n, num_try, 3))
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1], size=(n, num_try))

    # membership masks computed on ORIGINAL boxes (preprocess.py:648-650)
    if points is not None:
        point_masks = box_np.points_in_rbbox(points, gt_boxes)

    current5 = gt_boxes[:, [0, 1, 3, 4, 6]].copy()
    loc_sel = np.zeros((n, 3))
    rot_sel = np.zeros((n,))
    for i in range(n):
        if not valid_mask[i]:
            continue
        cand = np.tile(current5[i], (num_try, 1))
        cand[:, 0] += loc_noises[i, :, 0]
        cand[:, 1] += loc_noises[i, :, 1]
        cand[:, 4] += rot_noises[i]
        others = np.delete(current5, i, axis=0)
        coll = box_collision_test(cand, others).any(axis=1)
        ok = np.where(~coll)[0]
        if len(ok) == 0:
            continue
        t = ok[0]
        loc_sel[i] = loc_noises[i, t]
        rot_sel[i] = rot_noises[i, t]
        current5[i] = cand[t]

    # apply to points (first matching box wins, preprocess.py:552-560)
    if points is not None:
        owner = np.full(len(points), -1, dtype=np.int64)
        for j in range(n - 1, -1, -1):
            if valid_mask[j]:
                owner[point_masks[:, j]] = j
        moved = owner >= 0
        if moved.any():
            idx = owner[moved]
            centers = gt_boxes[idx, :3]
            local = points[moved, :3] - centers
            c, s = np.cos(rot_sel[idx]), np.sin(rot_sel[idx])
            lx = local[:, 0] * c + local[:, 1] * s
            ly = -local[:, 0] * s + local[:, 1] * c
            points[moved, 0] = lx + centers[:, 0] + loc_sel[idx, 0]
            points[moved, 1] = ly + centers[:, 1] + loc_sel[idx, 1]
            points[moved, 2] = local[:, 2] + centers[:, 2] + loc_sel[idx, 2]

    gt_boxes[:, :3] += loc_sel
    gt_boxes[:, 6] += rot_sel


# ---------------------------------------------------------------------------
# GT-AUG database sampler
# ---------------------------------------------------------------------------

@dataclass
class GroundTruthSampler:
    """GT-AUG: paste database objects into the scene (sample_ops.py:13-320).

    db_infos: {class: [info dicts with path/box3d_lidar/num_points_in_gt/
    difficulty]}, as produced by create_data.create_groundtruth_database.
    """

    db_info_path: str
    root_path: str
    sample_groups: dict = field(default_factory=lambda: {"Car": 15})
    min_points: dict = field(default_factory=lambda: {"Car": 5})
    removed_difficulty: tuple = (-1,)
    num_point_features: int = 4
    rate: float = 1.0
    seed: int = 0

    def __post_init__(self):
        with open(self.db_info_path, "rb") as f:
            db_infos = pickle.load(f)
        # db_prep_steps: filter_by_min_num_points + filter_by_difficulty
        self._infos = {}
        for cls, infos in db_infos.items():
            minp = self.min_points.get(cls, 0)
            keep = [
                i for i in infos
                if i["num_points_in_gt"] >= minp
                and i.get("difficulty", 0) not in self.removed_difficulty
            ]
            self._infos[cls] = keep
        self._rng = np.random.RandomState(self.seed)

    def sample_all(self, gt_boxes: np.ndarray, gt_names: np.ndarray,
                   rng: Optional[np.random.RandomState] = None):
        """Returns None or dict(gt_boxes [S, 7], gt_names [S], points [P, F]).

        ``rng``: the caller's per-(epoch, sample) RandomState. Draws are iid
        without replacement per call — a pure function of the rng, so the
        pipeline is deterministic and thread/process-worker agnostic. (The
        reference's BatchSampler keeps a shuffled epoch queue per WORKER
        PROCESS — its own multiprocess loader already breaks the global
        queue into independent per-worker streams, so iid draws match its
        effective statistics while removing the shared mutable state that a
        threaded loader would race on.)"""
        rng = rng if rng is not None else self._rng
        sampled_boxes, sampled_names, sampled_infos = [], [], []
        avoid = gt_boxes.copy()
        for cls, max_num in self.sample_groups.items():
            n_cls = len(self._infos.get(cls, ()))
            if n_cls == 0:
                continue
            want = int(round(self.rate * (max_num - int(np.sum(gt_names == cls)))))
            if want <= 0:
                continue
            idx = rng.choice(n_cls, size=min(want, n_cls), replace=False)
            cand_infos = [self._infos[cls][j] for j in idx]
            cand_boxes = np.stack([i["box3d_lidar"] for i in cand_infos]).astype(np.float64)

            # joint BEV collision test: existing + candidates (sample_class_v2)
            allb = np.concatenate([avoid, cand_boxes], axis=0)
            all5 = allb[:, [0, 1, 3, 4, 6]]
            coll = box_collision_test(all5, all5)
            np.fill_diagonal(coll, False)
            num_prev = len(avoid)
            accepted = []
            for i in range(num_prev, len(allb)):
                if coll[i].any():
                    coll[i] = False
                    coll[:, i] = False
                else:
                    accepted.append(i - num_prev)
            if accepted:
                acc_boxes = cand_boxes[accepted]
                sampled_boxes.append(acc_boxes)
                sampled_names.extend([cls] * len(accepted))
                sampled_infos.extend([cand_infos[a] for a in accepted])
                avoid = np.concatenate([avoid, acc_boxes], axis=0)

        if not sampled_infos:
            return None

        pts_list = []
        root = pathlib.Path(self.root_path)
        for info in sampled_infos:
            try:
                p = np.fromfile(str(root / info["path"]), dtype=np.float32).reshape(
                    -1, self.num_point_features)
            except (OSError, ValueError):
                continue
            p = p.copy()
            p[:, :3] += info["box3d_lidar"][:3]  # stored center-relative
            pts_list.append(p)
        if not pts_list:
            return None

        return {
            "gt_boxes": np.concatenate(sampled_boxes, axis=0).astype(np.float32),
            "gt_names": np.array(sampled_names),
            "points": np.concatenate(pts_list, axis=0),
        }
