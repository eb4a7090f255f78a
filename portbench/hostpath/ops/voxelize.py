"""Point-cloud voxelization, host (numpy, C++) and device (torch) versions.

Semantics follow the reference's first-come-first-serve binning kernel
(det3d/ops/point_cloud/point_cloud_ops_v2.py:9-63): points are walked in
order; a point outside the range is dropped; each new voxel claims the next
slot until ``max_voxels``; each voxel keeps its first ``max_points`` points.
Coordinates are emitted (z, y, x)-ordered like the reference.

The device version is the TPU-native fixed-capacity sort-and-segment design
(BASELINE.json north star): ids = linearized voxel coords, stable-sorted;
segment boundaries give voxel slots; every output is statically shaped and
mask-padded. The only semantic difference: when a cloud exceeds
``max_voxels``, the surviving voxels are the lowest-id ones rather than the
first-seen ones (both are arbitrary; KITTI at 20k cap rarely overflows).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VoxelizerSpec:
    point_cloud_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple  # (vx, vy, vz)
    max_points: int = 5
    max_voxels: int = 20000

    @property
    def grid_size(self) -> tuple:
        """(nx, ny, nz) — e.g. (1408, 1600, 40) for the SE-SSD config."""
        pcr = np.asarray(self.point_cloud_range)
        vs = np.asarray(self.voxel_size)
        return tuple(np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64).tolist())

    @property
    def sparse_shape(self) -> tuple:
        """(D, H, W) input shape of the sparse backbone: z-grid + 1 (the
        reference grows sparse_shape by [1, 0, 0], scn.py:179)."""
        nx, ny, nz = self.grid_size
        return (nz + 1, ny, nx)


KITTI_VOXELIZER = VoxelizerSpec(
    point_cloud_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
    voxel_size=(0.05, 0.05, 0.1),
    max_points=5,
    max_voxels=20000,
)


def voxelize_np(points: np.ndarray, spec: VoxelizerSpec):
    """Host voxelizer.

    Args:
        points: [P, F] (x, y, z, intensity, ...).
    Returns:
        voxels [V, max_points, F], coords [V, 3] (z, y, x), num_points [V]
        with V <= max_voxels (trimmed, not padded).
    """
    pcr = np.asarray(spec.point_cloud_range, dtype=points.dtype)
    vs = np.asarray(spec.voxel_size, dtype=points.dtype)
    nx, ny, nz = spec.grid_size

    c = np.floor((points[:, :3] - pcr[:3]) / vs).astype(np.int64)  # (cx, cy, cz)
    valid = (
        (c[:, 0] >= 0) & (c[:, 0] < nx)
        & (c[:, 1] >= 0) & (c[:, 1] < ny)
        & (c[:, 2] >= 0) & (c[:, 2] < nz)
    )
    pts = points[valid]
    c = c[valid]
    if len(pts) == 0:
        f = points.shape[1]
        return (
            np.zeros((0, spec.max_points, f), dtype=points.dtype),
            np.zeros((0, 3), dtype=np.int32),
            np.zeros((0,), dtype=np.int32),
        )
    ids = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]

    # first-occurrence voxel ordering (reference FCFS semantics)
    uniq, first_idx, inverse = np.unique(ids, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")  # voxel rank by first appearance
    rank_of_uniq = np.empty_like(order)
    rank_of_uniq[order] = np.arange(len(order))
    voxel_rank = rank_of_uniq[inverse]  # [P]

    # within-voxel slot = number of earlier points in the same voxel
    sort_by_voxel = np.argsort(voxel_rank, kind="stable")
    sorted_rank = voxel_rank[sort_by_voxel]
    starts = np.searchsorted(sorted_rank, np.arange(len(uniq)))
    slot_sorted = np.arange(len(sorted_rank)) - starts[sorted_rank]
    slot = np.empty_like(slot_sorted)
    slot[sort_by_voxel] = slot_sorted

    keep = (voxel_rank < spec.max_voxels) & (slot < spec.max_points)
    nv = min(len(uniq), spec.max_voxels)

    voxels = np.zeros((nv, spec.max_points, points.shape[1]), dtype=points.dtype)
    voxels[voxel_rank[keep], slot[keep]] = pts[keep]
    num_points = np.bincount(
        voxel_rank[keep], minlength=nv
    ).astype(np.int32)

    coords_all = np.stack([c[:, 2], c[:, 1], c[:, 0]], axis=1)  # (z, y, x)
    coords = np.zeros((nv, 3), dtype=np.int32)
    coords[voxel_rank[keep]] = coords_all[keep]
    return voxels, coords, num_points


def voxelize_host(points: np.ndarray, spec: VoxelizerSpec):
    """Host voxelizer with automatic native-C++ dispatch (same semantics as
    :func:`voxelize_np`; the C++ kernel lives in native/voxelize.cpp)."""
    from ..utils.native import get_native

    native = get_native()
    if native is not None:
        return native.voxelize(points, spec.point_cloud_range, spec.voxel_size,
                               spec.max_points, spec.max_voxels)
    return voxelize_np(points, spec)


def voxelize_torch(points, spec: VoxelizerSpec, num_valid_points=None):
    """Device voxelizer on the points' device (port of
    ``sessd_tpu/ops/voxelize.py:125-183``): fixed capacity, nothing read
    back to the host.

    Args:
        points: [P, F] tensor.
        num_valid_points: optional int or 0-dim tensor; rows >= it are
            padding.
    Returns:
        voxels [max_voxels, max_points, F], coords [max_voxels, 3] int32
        (z, y, x, -1-padded), num_points [max_voxels] int32, num_voxels
        0-dim int32. Voxels in id order; past ``max_voxels`` the lowest ids
        survive.
    """
    import torch

    dev, p = points.device, points.shape[0]
    nx, ny, nz = spec.grid_size
    mv, mp = spec.max_voxels, spec.max_points
    # per-axis bounds as device fills (a host list would be a copy), and a
    # true division by a tensor, as XLA divides
    lo = torch.stack([points.new_full((), v)
                      for v in spec.point_cloud_range[:3]])
    size = torch.stack([points.new_full((), v) for v in spec.voxel_size])
    c = torch.floor((points[:, :3] - lo) / size).int()
    valid = ((c[:, 0] >= 0) & (c[:, 0] < nx) & (c[:, 1] >= 0) & (c[:, 1] < ny)
             & (c[:, 2] >= 0) & (c[:, 2] < nz))
    if num_valid_points is not None:
        valid &= torch.arange(p, device=dev) < num_valid_points

    big = nx * ny * nz  # the id of an invalid point
    ids = torch.where(valid, (c[:, 2].long() * ny + c[:, 1]) * nx + c[:, 0],
                      big).int()
    order = torch.argsort(ids, stable=True)  # invalid points sort last
    sids = ids[order]
    spts = points[order]

    is_new = torch.cat([sids.new_ones(1, dtype=torch.bool),
                        sids[1:] != sids[:-1]]) & (sids < big)
    voxel_idx = torch.cumsum(is_new, 0) - 1  # garbage for invalid points
    slot = torch.arange(p, device=dev) - torch.searchsorted(sids, sids)
    num_voxels = is_new.sum().clamp(max=mv).int()

    keep = (sids < big) & (voxel_idx < mv) & (slot < mp)
    vi = torch.where(keep, voxel_idx, mv)  # row mv: the discarded overflow
    si = torch.where(keep, slot, 0)
    voxels = points.new_zeros((mv + 1, mp, points.shape[1]))
    voxels[vi, si] = spts
    num_points = torch.zeros(mv + 1, dtype=torch.int32, device=dev)
    num_points.index_add_(0, vi, keep.int())

    sc = c[order]
    coords = torch.full((mv + 1, 3), -1, dtype=torch.int32, device=dev)
    first = keep & (slot == 0)
    coords[torch.where(first, voxel_idx, mv)] = sc.flip(1)
    return voxels[:mv], coords[:mv], num_points[:mv], num_voxels
