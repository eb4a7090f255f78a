"""NumPy rotated-box overlap — host-side twin of
:mod:`sessd_tpu.core.rotated_iou` (same candidate-vertex + angle-sort
algorithm), used by the KITTI evaluator and the data pipeline where the
reference used numba/numba-CUDA kernels (det3d/ops/nms/nms_gpu.py:400-672).
"""
from __future__ import annotations

import numpy as np

from .box_np import center_to_corner_box2d

_EPS = 1e-8
_IN_BOX_EPS = 1e-5


def _bev5(boxes: np.ndarray) -> np.ndarray:
    if boxes.shape[-1] == 7:
        return boxes[..., [0, 1, 3, 4, 6]]
    return boxes


def _corners(b5: np.ndarray) -> np.ndarray:
    return center_to_corner_box2d(b5[..., :2], b5[..., 2:4], b5[..., 4])


def overlap_bev_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise intersection areas of rotated BEV boxes: [N, .] x [M, .] -> [N, M]."""
    b1 = _bev5(np.asarray(boxes1, dtype=np.float64))
    b2 = _bev5(np.asarray(boxes2, dtype=np.float64))
    n, m = b1.shape[0], b2.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), dtype=np.float64)
    c1 = _corners(b1)  # [N, 4, 2]
    c2 = _corners(b2)  # [M, 4, 2]

    # corners of A in B and B in A -> [N, M, 4]
    in2 = _points_in_rect(c1[:, None], b2[None, :])  # [N, M, 4]
    in1 = _points_in_rect(np.broadcast_to(c2[None, :], (n, m, 4, 2)), b1[:, None])

    # edge-edge intersections -> [N, M, 16]
    a0 = c1[:, None, :, None, :]                       # [N, 1, 4, 1, 2]
    a1 = np.roll(c1, -1, axis=1)[:, None, :, None, :]
    b0 = c2[None, :, None, :, :]                       # [1, M, 1, 4, 2]
    b1c = np.roll(c2, -1, axis=1)[None, :, None, :, :]
    r = a1 - a0
    s = b1c - b0
    qp = b0 - a0
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    denom = np.where(np.abs(rxs) < _EPS, 1.0, rxs)
    t = t_num / denom
    u = u_num / denom
    xval = (np.abs(rxs) >= _EPS) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    xpts = a0 + t[..., None] * r
    xpts = xpts.reshape(n, m, 16, 2)
    xval = xval.reshape(n, m, 16)

    pts = np.concatenate(
        [np.broadcast_to(c1[:, None], (n, m, 4, 2)),
         np.broadcast_to(c2[None, :], (n, m, 4, 2)),
         xpts],
        axis=2,
    )  # [N, M, 24, 2]
    valid = np.concatenate([in2, in1, xval], axis=2)  # [N, M, 24]

    nvalid = valid.sum(axis=-1)
    vf = valid.astype(np.float64)
    center = (pts * vf[..., None]).sum(axis=2) / np.maximum(nvalid, 1)[..., None]
    rel = pts - center[:, :, None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(valid, ang, np.inf)
    order = np.argsort(ang, axis=-1)
    rel = np.take_along_axis(rel, order[..., None], axis=2)

    idx = np.arange(24)
    succ = np.where(idx[None, None] + 1 < nvalid[..., None], idx + 1, 0)
    nxt = np.take_along_axis(rel, succ[..., None], axis=2)
    cross = rel[..., 0] * nxt[..., 1] - rel[..., 1] * nxt[..., 0]
    cross = np.where(idx[None, None] < nvalid[..., None], cross, 0.0)
    area = 0.5 * np.abs(cross.sum(axis=-1))
    return np.where(nvalid >= 3, area, 0.0)


def _points_in_rect(pts: np.ndarray, box5: np.ndarray) -> np.ndarray:
    d = pts - box5[..., None, :2]
    c, s = np.cos(box5[..., 4:5]), np.sin(box5[..., 4:5])
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    return (np.abs(lx) <= box5[..., None, 2] * 0.5 + _IN_BOX_EPS) & (
        np.abs(ly) <= box5[..., None, 3] * 0.5 + _IN_BOX_EPS
    )


def iou_bev_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    b1 = _bev5(np.asarray(boxes1, dtype=np.float64))
    b2 = _bev5(np.asarray(boxes2, dtype=np.float64))
    inter = overlap_bev_matrix(b1, b2)
    a1 = (b1[:, 2] * b1[:, 3])[:, None]
    a2 = (b2[:, 2] * b2[:, 3])[None, :]
    return inter / np.maximum(a1 + a2 - inter, 1e-7)


def rotate_iou_eval(boxes1: np.ndarray, boxes2: np.ndarray, criterion: int = -1) -> np.ndarray:
    """KITTI-eval rotated IoU on (x, z)-style 5-dof boxes [x, y, w, l, r].

    criterion -1: inter/union; 0: inter/area1; 1: inter/area2
    (port of nms_gpu.rotate_iou_gpu_eval / devRotateIoUEval semantics).
    """
    b1 = np.asarray(boxes1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    inter = overlap_bev_matrix(b1, b2)
    a1 = (b1[:, 2] * b1[:, 3])[:, None]
    a2 = (b2[:, 2] * b2[:, 3])[None, :]
    if criterion == -1:
        denom = a1 + a2 - inter
    elif criterion == 0:
        denom = np.broadcast_to(a1, inter.shape).copy()
    elif criterion == 1:
        denom = np.broadcast_to(a2, inter.shape).copy()
    else:
        raise ValueError(f"bad criterion {criterion}")
    return inter / np.maximum(denom, 1e-12)


def iou_3d_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise rotated 3D IoU of [N, 7] x [M, 7] gravity-center boxes."""
    b1 = np.asarray(boxes1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    inter_bev = overlap_bev_matrix(b1, b2)
    zmax1, zmin1 = b1[:, 2] + b1[:, 5] / 2, b1[:, 2] - b1[:, 5] / 2
    zmax2, zmin2 = b2[:, 2] + b2[:, 5] / 2, b2[:, 2] - b2[:, 5] / 2
    inter_h = np.maximum(
        np.minimum(zmax1[:, None], zmax2[None, :]) - np.maximum(zmin1[:, None], zmin2[None, :]),
        0.0,
    )
    inter = inter_bev * inter_h
    v1 = (b1[:, 3] * b1[:, 4] * b1[:, 5])[:, None]
    v2 = (b2[:, 3] * b2[:, 4] * b2[:, 5])[None, :]
    return inter / np.maximum(v1 + v2 - inter, 1e-7)


def rotate_nms_cpu(boxes5: np.ndarray, scores: np.ndarray, iou_threshold: float,
                   pre_max_size: int | None = None, post_max_size: int | None = None) -> np.ndarray:
    """Greedy rotated NMS on host (twin of nms_cpu.rotate_nms_cc used at
    mg_head_sessd.py:986-997). Returns kept indices into ``boxes5``."""
    order = np.argsort(-scores, kind="stable")
    if pre_max_size is not None:
        order = order[:pre_max_size]
    boxes = boxes5[order]
    iou = iou_bev_matrix(boxes, boxes)
    n = len(order)
    suppressed = np.zeros(n, dtype=bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(order[i])
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    keep = np.array(keep, dtype=np.int64)
    if post_max_size is not None:
        keep = keep[:post_max_size]
    return keep
