"""Synthetic miniature KITTI tree for integration tests (no real data in CI)."""
import pathlib
import struct

import numpy as np

from ..core import box_np

P2 = np.array(
    [
        [721.5377, 0.0, 609.5593, 44.85728],
        [0.0, 721.5377, 172.854, 0.2163791],
        [0.0, 0.0, 1.0, 0.002745884],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
R0 = np.eye(4)
R0[:3, :3] = np.array(
    [[0.9999239, 0.00983776, -0.00744505],
     [-0.0098698, 0.9999421, -0.00427846],
     [0.00740253, 0.00435161, 0.9999631]]
)
TR = np.array(
    [
        [7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
        [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
        [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
IMAGE_SHAPE = (375, 1242)


def write_png_stub(path, h=375, w=1242):
    sig = b"\x89PNG\r\n\x1a\n"
    ihdr = struct.pack(">II", w, h) + b"\x08\x02\x00\x00\x00"
    chunk = struct.pack(">I", 13) + b"IHDR" + ihdr + b"\x00\x00\x00\x00"
    with open(path, "wb") as f:
        f.write(sig + chunk)


def car_points(box, n, rng):
    """Points on the surface of a lidar box [7]."""
    u = rng.uniform(-0.5, 0.5, (n, 3))
    # push to faces to mimic lidar surface returns
    face = rng.randint(0, 3, n)
    s = np.sign(rng.uniform(-1, 1, n))
    u[np.arange(n), face] = 0.5 * s
    local = u * box[3:6]
    c, ss = np.cos(box[6]), np.sin(box[6])
    gx = local[:, 0] * c + local[:, 1] * ss
    gy = -local[:, 0] * ss + local[:, 1] * c
    pts = np.stack([gx + box[0], gy + box[1], local[:, 2] + box[2],
                    rng.uniform(0, 1, n)], axis=1)
    return pts.astype(np.float32)


def make_frame(root, idx, rng, num_cars=3, pts_per_car=150, ground_points=4000):
    """One synthetic KITTI frame with RAY-CAST lidar points.

    Points come from the beam simulator (utils.synth_scene
    .raycast_points): dense-contiguous along scan rings like a real
    velodyne scan. This matters beyond realism — isolated uniform-random
    points each occupy one isolated voxel and DILATE ~3.5x under the
    strided sparse downsample, silently saturating the per-stage row
    capacities at the full 0.05 m grid (the bug class found in r4: 3 of 4
    batch samples truncated to zero features). Ray-cast returns share
    voxels along scan lines, so stage-1 occupancy ~= stage-0, matching the
    real-KITTI profile the capacities were sized for.

    ``pts_per_car``/``ground_points`` are kept for signature compatibility;
    density now follows the physical scan pattern (azimuth step shrinks
    mildly with ground_points). Cars rest ON the ground plane; cars with
    <20 returns (fully occluded / out of beam coverage) are left
    unlabeled, like real KITTI annotation practice.
    """
    root = pathlib.Path(root)
    for sub in ("velodyne", "calib", "label_2", "image_2"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    sid = f"{idx:06d}"

    # calib file
    def fmt(m, rows=3):
        return " ".join(f"{v:.12e}" for v in m[:rows].reshape(-1))

    with open(root / "training" / "calib" / f"{sid}.txt", "w") as f:
        for k in ("P0", "P1", "P2", "P3"):
            f.write(f"{k}: {fmt(P2, 3)}\n")
        f.write(f"R0_rect: {' '.join(f'{v:.12e}' for v in R0[:3, :3].reshape(-1))}\n")
        f.write(f"Tr_velo_to_cam: {fmt(TR, 3)}\n")
        f.write(f"Tr_imu_to_velo: {fmt(np.eye(4), 3)}\n")

    write_png_stub(root / "training" / "image_2" / f"{sid}.png", *IMAGE_SHAPE)

    # lidar boxes in front of the car, inside the camera frustum; rejection-
    # sample centers >5 m apart (> two worst-case BEV half-diagonals ~4.6 m)
    # so ground-truth cars never interpenetrate — overlapping GTs are
    # unlearnable and cap the achievable AP at IoU 0.7.
    # The whole scene is re-drawn (<=8 tries) if no car collects >=20
    # returns: a zero-label frame would exercise an untested rare path
    # downstream (create_kitti_info / gt-database / target assignment).
    from .synth_scene import GROUND_Z, raycast_points

    for _attempt in range(8):
        boxes = []
        centers = []
        for i in range(num_cars):
            for _ in range(100):
                x = rng.uniform(10, 50)
                # keep the car well inside the ~40deg half-angle camera FOV
                y = rng.uniform(-0.5, 0.5) * x * 0.6
                if all((x - cx) ** 2 + (y - cy) ** 2 > 25.0
                       for cx, cy in centers):
                    break
            centers.append((x, y))
            h = rng.uniform(1.4, 1.7)
            boxes.append([
                x, y, GROUND_Z + h / 2 + rng.uniform(-0.03, 0.03),
                rng.uniform(1.55, 1.7), rng.uniform(3.6, 4.2), h,
                rng.uniform(-np.pi, np.pi),
            ])
        boxes = np.array(boxes)

        # clutter: two building walls outside the car corridor + a few poles
        # (length runs along +y at yaw 0 in the framework convention, so a
        # road-parallel wall needs yaw ~= pi/2)
        walls = [
            (35.0, -rng.uniform(16.0, 20.0), GROUND_Z, 0.4, 60.0, 4.0,
             np.pi / 2 + rng.uniform(-0.05, 0.05)),
            (38.0, rng.uniform(16.0, 20.0), GROUND_Z, 0.4, 70.0, 4.0,
             np.pi / 2 + rng.uniform(-0.05, 0.05)),
        ]
        poles = []
        for _ in range(6):
            for _ in range(50):
                r = rng.uniform(5.0, 60.0)
                ang = rng.uniform(-0.7, 0.7)
                px, py = r * np.cos(ang), r * np.sin(ang)
                if all((px - cx) ** 2 + (py - cy) ** 2 > 16.0
                       for cx, cy in centers):
                    break
            poles.append((px, py, GROUND_Z, rng.uniform(0.2, 0.8),
                          rng.uniform(0.2, 0.8), rng.uniform(2.0, 5.0), 0.0))

        # ray-cast (z -> bottom-face convention for the caster); az step
        # shrinks mildly for very dense requests, keeping legacy callers'
        # scale intent
        az_step = 0.17 if ground_points <= 16000 else 0.12
        rc_boxes = boxes.copy()
        rc_boxes[:, 2] -= rc_boxes[:, 5] / 2.0
        points = raycast_points(rng, rc_boxes, walls, poles,
                                azimuth_step_deg=az_step)

        # label only cars the sensor actually sees (>=20 returns) — real
        # KITTI leaves fully-occluded cars unannotated; keeping them as GT
        # would make the eval floor unreachable by construction. Count
        # against a +0.2 m enlarged box: range noise puts surface returns a
        # few cm outside the exact hull, which would undercount ~2x.
        probe = boxes.copy()
        probe[:, 3:6] += 0.2
        n_hits = box_np.points_in_rbbox(points[:, :3], probe).sum(axis=0)
        if (n_hits >= 20).any():
            break
    points.tofile(str(root / "training" / "velodyne" / f"{sid}.bin"))
    keep = n_hits >= 20
    boxes = boxes[keep]

    # honest KITTI occlusion levels (0 fully visible / 1 partly / 2 largely
    # occluded): the official eval bins difficulty BY these fields
    # (clean_data MAX_OCCLUSION [0, 1, 2]) — writing 0 for every car puts a
    # 20-return car hiding behind two others into the MODERATE bin, where
    # its near-zero recall caps the bin's AP by construction (real KITTI
    # annotators mark such a car occluded 2 -> hard only). Visibility is
    # measured, not guessed: each labeled car is re-cast ALONE (same beam
    # pattern, no occluders) and occlusion = 1 - hits / solo_hits.
    occlusions = []
    for i in np.flatnonzero(keep):
        solo_box = rc_boxes[i:i + 1]
        solo_pts = raycast_points(np.random.RandomState(7919 + idx * 131 + i),
                                  solo_box, (), (), azimuth_step_deg=az_step)
        n_solo = box_np.points_in_rbbox(solo_pts[:, :3],
                                        probe[i:i + 1]).sum()
        ratio = float(n_hits[i]) / max(float(n_solo), 1.0)
        occlusions.append(0 if ratio >= 0.65 else (1 if ratio >= 0.30 else 2))

    # labels: lidar gravity-center -> camera bottom-center
    cam = box_np.box_lidar_to_camera(boxes, R0, TR)  # center xyz + (l, h, w) + ry
    with open(root / "training" / "label_2" / f"{sid}.txt", "w") as f:
        for i, b in enumerate(boxes):
            loc = cam[i, :3].copy()
            l, h, w = cam[i, 3], cam[i, 4], cam[i, 5]
            ry = cam[i, 6]
            loc[1] += h / 2  # bottom center in camera (y down)
            corners = box_np.center_to_corner_box3d(
                cam[i:i + 1, :3], cam[i:i + 1, 3:6], cam[i:i + 1, 6],
                origin=(0.5, 1.0, 0.5), axis=1)[0] + np.array([0, h / 2, 0])
            img = box_np.project_to_image(corners, P2)
            x1, y1 = img.min(0)
            x2, y2 = img.max(0)
            x1, y1 = max(x1, 0), max(y1, 0)
            x2 = min(x2, IMAGE_SHAPE[1])
            y2 = min(y2, IMAGE_SHAPE[0])
            alpha = -np.arctan2(-b[1], b[0]) + ry
            f.write(
                f"Car 0.00 {occlusions[i]} {alpha:.2f} "
                f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                f"{h:.2f} {w:.2f} {l:.2f} {loc[0]:.2f} {loc[1]:.2f} {loc[2]:.2f} "
                f"{ry:.2f}\n")
    return boxes


def make_kitti_root(tmpdir, num_frames=4, seed=0, num_cars=3,
                    pts_per_car=150, ground_points=4000):
    rng = np.random.RandomState(seed)
    boxes = {}
    for i in range(num_frames):
        boxes[i] = make_frame(tmpdir, i, rng, num_cars=num_cars,
                              pts_per_car=pts_per_car,
                              ground_points=ground_points)
    return boxes
