"""NumPy box math for the host-side data pipeline.

Pure-numpy re-implementation of the box semantics of the reference
(det3d/core/bbox/box_np_ops.py). Boxes are 7-dof ``[x, y, z, w, l, h, ry]``
in the LiDAR frame with (x, y, z) the *gravity center* (the reference shifts
KITTI bottom-center boxes to true centers at load time,
det3d/datasets/pipelines/loading.py). Local box axes: ``w`` (dims[0]) spans
the local x extent, ``l`` (dims[1]) the local y extent; rotation by ``ry`` is
clockwise-positive, i.e. corners = local_corner @ [[c, -s], [s, c]]
(reference rotation_2d, box_np_ops.py:433-446).

Device-side twins live in :mod:`sessd_tpu.core.box_jax`; both are golden
cross-checked in tests/test_box_ops.py.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# corners
# ---------------------------------------------------------------------------

# 2D corner layout (clockwise from min point), matching box_np_ops.py:288-289.
_CORNERS2D = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], dtype=np.float64)
# 3D corner layout matching box_np_ops.py:290-291.
_CORNERS3D = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
        [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0],
    ],
    dtype=np.float64,
)


def corners_nd(dims: np.ndarray, origin=0.5) -> np.ndarray:
    """Relative corner offsets for boxes of size ``dims`` ([N, 2 or 3])."""
    ndim = dims.shape[-1]
    base = _CORNERS2D if ndim == 2 else _CORNERS3D
    corners_norm = (base - np.asarray(origin, dtype=np.float64)).astype(dims.dtype)
    return dims[..., None, :] * corners_norm[None]


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate [N, P, 2] point sets clockwise by per-box ``angles`` [N]."""
    c, s = np.cos(angles), np.sin(angles)
    # out = p @ [[c, -s], [s, c]]  (box_np_ops.py:443-446)
    x = points[..., 0] * c[..., None] + points[..., 1] * s[..., None]
    y = -points[..., 0] * s[..., None] + points[..., 1] * c[..., None]
    return np.stack([x, y], axis=-1)


def rotation_3d_in_axis(points: np.ndarray, angles: np.ndarray, axis: int = 2) -> np.ndarray:
    """Rotate [N, P, 3] point sets by per-box ``angles`` about ``axis``."""
    c, s = np.cos(angles), np.sin(angles)
    ones, zeros = np.ones_like(c), np.zeros_like(c)
    if axis == 2:
        rot = np.stack(
            [c, -s, zeros, s, c, zeros, zeros, zeros, ones], axis=-1
        ).reshape(angles.shape + (3, 3))
    elif axis == 1:
        rot = np.stack(
            [c, zeros, -s, zeros, ones, zeros, s, zeros, c], axis=-1
        ).reshape(angles.shape + (3, 3))
    elif axis == 0:
        rot = np.stack(
            [ones, zeros, zeros, zeros, c, -s, zeros, s, c], axis=-1
        ).reshape(angles.shape + (3, 3))
    else:
        raise ValueError(f"axis must be 0/1/2, got {axis}")
    return np.einsum("npj,njk->npk", points, rot)


def rotation_points_single_angle(points: np.ndarray, angle: float, axis: int = 2) -> np.ndarray:
    """Rotate [N, 3] points by a single scalar angle (box_torch_ops.py:320-345)."""
    out = rotation_3d_in_axis(points[None], np.asarray([angle], dtype=points.dtype), axis=axis)
    return out[0]


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """[N, 2] centers + [N, 2] dims (+ [N] angles) -> [N, 4, 2] BEV corners."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers[..., None, :]


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 0.5, 0.5), axis=2):
    """[N, 3] centers + dims (+ angles) -> [N, 8, 3] corners."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers[..., None, :]


def box3d_to_bev_corners(boxes: np.ndarray) -> np.ndarray:
    """[N, 7] lidar boxes -> [N, 4, 2] BEV corners."""
    return center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5], boxes[:, 6])


def corner_to_standup_nd(corners: np.ndarray) -> np.ndarray:
    """[N, K, D] corners -> [N, 2D] axis-aligned (min..., max...) boxes."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=-1)


# ---------------------------------------------------------------------------
# anchor-offset box coder (SECOND style)
# ---------------------------------------------------------------------------

def second_box_encode(boxes: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Encode [N, 7] boxes against [N, 7] anchors (box_torch_ops.py:23-80).

    targets = [dx/diag, dy/diag, dz/ha, log(w/wa), log(l/la), log(h/ha), r-ra]
    """
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    xg, yg, zg, wg, lg, hg, rg = np.split(boxes, 7, axis=-1)
    diagonal = np.sqrt(la ** 2 + wa ** 2)
    return np.concatenate(
        [
            (xg - xa) / diagonal,
            (yg - ya) / diagonal,
            (zg - za) / ha,
            np.log(wg / wa),
            np.log(lg / la),
            np.log(hg / ha),
            rg - ra,
        ],
        axis=-1,
    )


def second_box_decode(encodings: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Inverse of :func:`second_box_encode` (box_torch_ops.py:83-150)."""
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    xt, yt, zt, wt, lt, ht, rt = np.split(encodings, 7, axis=-1)
    diagonal = np.sqrt(la ** 2 + wa ** 2)
    return np.concatenate(
        [
            xt * diagonal + xa,
            yt * diagonal + ya,
            zt * ha + za,
            np.exp(wt) * wa,
            np.exp(lt) * la,
            np.exp(ht) * ha,
            rt + ra,
        ],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# camera <-> lidar (KITTI calibration)
# ---------------------------------------------------------------------------

def camera_to_lidar(points: np.ndarray, r_rect: np.ndarray, velo2cam: np.ndarray) -> np.ndarray:
    """[N, 3] rect-camera points -> lidar frame (box_np_ops.py camera_to_lidar)."""
    num = points.shape[0]
    pts = np.concatenate([points, np.ones((num, 1), dtype=points.dtype)], axis=1)
    lidar = pts @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar[:, :3]


def lidar_to_camera(points: np.ndarray, r_rect: np.ndarray, velo2cam: np.ndarray) -> np.ndarray:
    num = points.shape[0]
    pts = np.concatenate([points, np.ones((num, 1), dtype=points.dtype)], axis=1)
    cam = pts @ (r_rect @ velo2cam).T
    return cam[:, :3]


def box_camera_to_lidar(boxes: np.ndarray, r_rect: np.ndarray, velo2cam: np.ndarray) -> np.ndarray:
    """[N, 7] camera boxes [x, y, z, l, h, w, ry] -> lidar [x, y, z, w, l, h, r].

    Mirrors box_np_ops.box_camera_to_lidar: the camera dims order (l, h, w)
    becomes lidar (w, l, h) and r = -ry - pi/2.
    """
    xyz = camera_to_lidar(boxes[:, :3], r_rect, velo2cam)
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    return np.concatenate([xyz, w, l, h, -r - np.pi / 2], axis=1)


def box_lidar_to_camera(boxes: np.ndarray, r_rect: np.ndarray, velo2cam: np.ndarray) -> np.ndarray:
    """Inverse of :func:`box_camera_to_lidar`."""
    xyz = lidar_to_camera(boxes[:, :3], r_rect, velo2cam)
    w, l, h = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    return np.concatenate([xyz, l, h, w, -r - np.pi / 2], axis=1)


def project_to_image(points_3d: np.ndarray, proj_mat: np.ndarray) -> np.ndarray:
    """[N, 3] camera points -> [N, 2] pixels."""
    num = points_3d.shape[0]
    pts = np.concatenate([points_3d, np.ones((num, 1), dtype=points_3d.dtype)], axis=-1)
    uvw = pts @ proj_mat.T
    return uvw[:, :2] / uvw[:, 2:3]


# ---------------------------------------------------------------------------
# point-in-box tests
# ---------------------------------------------------------------------------

def _points_in_rbbox_dense(p3: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    shifted = p3[:, None, :] - boxes[None, :, :3]  # [P, N, 3]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    # local = R(-ry) applied consistently with rotation_2d's convention:
    # global corner = local @ [[c, -s], [s, c]]  =>  local = global @ [[c, s], [-s, c]]
    lx = shifted[..., 0] * c[None] - shifted[..., 1] * s[None]
    ly = shifted[..., 0] * s[None] + shifted[..., 1] * c[None]
    lz = shifted[..., 2]
    half = boxes[:, 3:6] * 0.5
    return (
        (np.abs(lx) <= half[None, :, 0])
        & (np.abs(ly) <= half[None, :, 1])
        & (np.abs(lz) <= half[None, :, 2])
    )


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """[P, >=3] points vs [N, 7] center-origin lidar boxes -> bool [P, N].

    Equivalent to the reference's surface-based test
    (box_np_ops.points_in_rbbox) but done by rotating points into each box
    frame, which is exact for rectangular boxes. A bounding-sphere
    prefilter (one BLAS GEMM for all point-center distances; a box lies
    within ||half extents|| of its center) keeps the [P, N, 3] rotation
    tensors to the few points near boxes.
    """
    if boxes.shape[0] == 0 or points.shape[0] == 0:
        return np.zeros((points.shape[0], boxes.shape[0]), dtype=bool)
    p3 = np.ascontiguousarray(points[:, :3])
    centers = boxes[:, :3]
    r2 = (boxes[:, 3:6] ** 2).sum(-1) * 0.25
    d2 = ((p3 ** 2).sum(-1)[:, None] - 2.0 * (p3 @ centers.T)
          + (centers ** 2).sum(-1)[None, :])
    cand = np.flatnonzero(
        (d2 <= r2[None, :] * (1.0 + 1e-9) + 1e-12).any(axis=1))
    out = np.zeros((points.shape[0], boxes.shape[0]), dtype=bool)
    if cand.size:
        out[cand] = _points_in_rbbox_dense(p3[cand], boxes)
    return out


def points_count_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    return points_in_rbbox(points, boxes).sum(axis=0)


def remove_points_in_boxes(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    mask = points_in_rbbox(points, boxes).any(axis=1)
    return points[~mask]


def points_in_convex_polygon_3d(points: np.ndarray, polygon_surfaces: np.ndarray,
                                num_surfaces: np.ndarray | None = None) -> np.ndarray:
    """[P, 3] points vs [N, S, 4, 3] convex polyhedra (surfaces of >=3 verts,
    outward normal implied by first three, counterclockwise) -> bool [P, N].

    Vectorized port of geometry.points_in_convex_polygon_3d_jit
    (det3d/core/bbox/geometry.py:215-278).
    """
    n_poly, max_surfaces = polygon_surfaces.shape[:2]
    # surface normal from first three vertices (cross of edge vectors)
    sv0 = polygon_surfaces[:, :, 0, :] - polygon_surfaces[:, :, 1, :]
    sv1 = polygon_surfaces[:, :, 1, :] - polygon_surfaces[:, :, 2, :]
    normal = np.cross(sv0, sv1)  # [N, S, 3]
    d = np.einsum("nsk,nsk->ns", normal, polygon_surfaces[:, :, 0, :])
    # [P, 3] @ [3, N*S] dispatches to BLAS (the pk,nsk->pns einsum does
    # not and is ~10x slower at pipeline sizes)
    sign = (np.ascontiguousarray(points[:, :3])
            @ normal.reshape(n_poly * max_surfaces, 3).T
            ).reshape(len(points), n_poly, max_surfaces) - d[None]
    if num_surfaces is None:  # all surface slots valid: skip the mask pass
        return ~np.any(sign >= 0, axis=-1)
    surf_idx = np.arange(max_surfaces)[None, :] < num_surfaces[:, None]  # [N, S]
    return ~np.any((sign >= 0) & surf_idx[None], axis=-1)


def corner_surfaces_3d(corners: np.ndarray) -> np.ndarray:
    """[N, 8, 3] corners -> [N, 6, 4, 3] surfaces (box_np_ops.corner_to_surfaces_3d)."""
    idx = np.array(
        [
            [0, 1, 2, 3],
            [7, 6, 5, 4],
            [0, 3, 7, 4],
            [1, 5, 6, 2],
            [0, 4, 5, 1],
            [3, 2, 6, 7],
        ]
    )
    return corners[:, idx, :]


# ---------------------------------------------------------------------------
# axis-aligned IoU (np twin of box_np_ops.iou_jit)
# ---------------------------------------------------------------------------

def iou_2d_aligned_matrix(boxes: np.ndarray, query_boxes: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Axis-aligned [N, 4] x [K, 4] (x1, y1, x2, y2) IoU matrix."""
    area_q = (query_boxes[:, 2] - query_boxes[:, 0] + eps) * (
        query_boxes[:, 3] - query_boxes[:, 1] + eps
    )
    area_b = (boxes[:, 2] - boxes[:, 0] + eps) * (boxes[:, 3] - boxes[:, 1] + eps)
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    ) + eps
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    ) + eps
    iw = np.maximum(iw, 0.0)
    ih = np.maximum(ih, 0.0)
    inter = iw * ih
    union = area_b[:, None] + area_q[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


# ---------------------------------------------------------------------------
# frustum helpers (for the predict-path culling and data prep)
# ---------------------------------------------------------------------------

def get_frustum(bbox_image, c_mat, near_clip: float = 0.001, far_clip: float = 100.0) -> np.ndarray:
    """Image bbox [4] + camera intrinsics [4, 4] -> [8, 3] frustum corners in
    camera frame (port of box_np_ops.get_frustum)."""
    fku = c_mat[0, 0]
    fkv = -c_mat[1, 1]
    u0v0 = c_mat[0:2, 2]
    z_points = np.array([near_clip] * 4 + [far_clip] * 4, dtype=c_mat.dtype)[:, None]
    b = bbox_image
    box_corners = np.array(
        [[b[0], b[1]], [b[0], b[3]], [b[2], b[3]], [b[2], b[1]]], dtype=c_mat.dtype
    )
    near_box_corners = (box_corners - u0v0) / np.array(
        [fku / near_clip, -fkv / near_clip], dtype=c_mat.dtype
    )
    far_box_corners = (box_corners - u0v0) / np.array(
        [fku / far_clip, -fkv / far_clip], dtype=c_mat.dtype
    )
    ret_xy = np.concatenate([near_box_corners, far_box_corners], axis=0)
    return np.concatenate([ret_xy, z_points], axis=1)


def projection_matrix_to_crt(proj: np.ndarray):
    """Decompose P = C @ [R|T] with C upper-triangular (QR on the inverse,
    box_np_ops.projection_matrix_to_CRT_kitti)."""
    cr = proj[:3, :3]
    ct = proj[:3, 3]
    rinv_cinv = np.linalg.inv(cr)
    rinv, cinv = np.linalg.qr(rinv_cinv)
    return np.linalg.inv(cinv), np.linalg.inv(rinv), cinv @ ct


def get_valid_frustum(rect, trv2c, image_shape, p2, near_clip=0.001, far_clip=100.0):
    """Full-image frustum surfaces in lidar frame, [1, 6, 4, 3].

    Used by the predict path to cull detections outside the camera view
    (mg_head_sessd.py:1024-1030 via loading.py's 'frustum' calib entry).
    """
    c_mat, r_mat, t_vec = projection_matrix_to_crt(np.asarray(p2, dtype=np.float64))
    h, w = image_shape[:2]
    bbox_image = np.array([0, 0, w, h], dtype=np.float64)
    frustum = get_frustum(bbox_image, c_mat, near_clip, far_clip)
    frustum -= t_vec[None, :]
    frustum = (np.linalg.inv(r_mat) @ frustum.T).T
    frustum = camera_to_lidar(frustum, rect, trv2c)
    return corner_surfaces_3d(frustum[None, ...])
