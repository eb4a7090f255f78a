"""Waymo-like scans from a seed: a 64-beam roof sensor's range image cast
against a street scene, for the CenterPoint-Voxel serving cell.

The sensor sits 2.1 m above the ground at the origin (the vehicle frame
of Waymo Open, z up) and casts a 64 x 2650 range image: 64 beams from
+2.4 to -17.6 degrees of elevation, closer together towards the horizon
(as the top lidar's inclinations are), 2650 azimuths over the full turn
(Waymo's top lidar). A ray returns its first hit within 75.2 m: the
ground plane z = 0, two building fronts along the street (the planes y =
+-w, 0-20 m high, w of 25-40 m drawn per scene), or one of 80 vehicles
(4.7 x 2.1 x 1.7 m), 40 pedestrians (0.9 x 0.9 x 1.8 m) and 10 cyclists
(1.8 x 0.8 x 1.7 m), boxes on the ground between the fronts at random
headings, none within 12 m of the sensor (the ego vehicle's lane). Ranges
carry 2 cm of noise, and the ground's returns scatter by 12 cm in height
(curbs, grass, the road's camber, a grazing beam's footprint). Each point
has Waymo's 5 features: x, y, z, intensity (tanh-squashed, as Waymo
stores it) and elongation.

At the published voxel size (0.1 x 0.1 x 0.15 m) a scan has ~160k points
in the range and ~100-110k non-empty voxels (the cell's notes give the
pool's counts).
"""
from __future__ import annotations

import concurrent.futures
import math
import multiprocessing
import os

import numpy as np

BEAMS, AZIMUTHS = 64, 2650
ELEVATION = (2.4, -17.6)  # degrees, top to bottom
BEAM_POWER = 1.3  # beam i at top + (bottom - top) (i / 63) ** BEAM_POWER
STREET = (25.0, 40.0)  # half widths between the fronts, m
FRONT_HEIGHT = 20.0
CLEAR = 12.0  # no object centre closer to the sensor, m
GROUND_SCATTER = 0.12  # m
SENSOR_Z = 2.1
MAX_RANGE = 75.2
OBJECTS = (("vehicle", 80, (4.7, 2.1, 1.7)), ("pedestrian", 40,
                                              (0.9, 0.9, 1.8)),
           ("cyclist", 10, (1.8, 0.8, 1.7)))


def _boxes(rng: np.random.Generator, half_width: float) -> np.ndarray:
    """[130, 7] (x, y, z, dx, dy, dz, heading) boxes on the ground within
    the street, none centred within ``CLEAR`` of the sensor."""
    out = []
    for _, n, size in OBJECTS:
        dims = np.asarray(size) * rng.uniform(0.9, 1.1, (n, 3))
        x = rng.uniform(-MAX_RANGE + 3, MAX_RANGE - 3, n)
        y = rng.uniform(-half_width + 1.5, half_width - 1.5, n)
        near = np.hypot(x, y) < CLEAR
        x[near] += np.sign(x[near] + 1e-3) * CLEAR
        heading = rng.uniform(-math.pi, math.pi, n)
        out.append(np.stack([x, y, dims[:, 2] / 2, dims[:, 0], dims[:, 1],
                             dims[:, 2], heading], 1))
    return np.concatenate(out)


def _ray_box(d: np.ndarray, o: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """[R] distances along unit rays ``d`` [R, 3] from ``o`` [3] to the
    nearest box of ``boxes`` [M, 7] (inf where none): a slab test in each
    box's frame."""
    best = np.full(len(d), np.inf)
    for b in boxes:
        c, s = math.cos(b[6]), math.sin(b[6])
        rel = o - b[:3]
        # into the box frame: rotate by -heading about z
        lo = np.array([c * rel[0] + s * rel[1], -s * rel[0] + c * rel[1],
                       rel[2]])
        ld = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                       d[:, 2]], 1)
        half = b[3:6] / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-half - lo) / ld
            t2 = (half - lo) / ld
        tmin = np.nanmax(np.minimum(t1, t2), 1)
        tmax = np.nanmin(np.maximum(t1, t2), 1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = np.where(tmin > 0, tmin, tmax)
        best = np.where(hit & (t < best), t, best)
    return best


def make_scene(seed: int) -> np.ndarray:
    """One scan [P, 5] float32 (x, y, z, intensity, elongation)."""
    rng = np.random.default_rng(seed)
    half_width = rng.uniform(*STREET)
    boxes = _boxes(rng, half_width)
    el = np.deg2rad(ELEVATION[0] + (ELEVATION[1] - ELEVATION[0])
                    * (np.arange(BEAMS) / (BEAMS - 1)) ** BEAM_POWER)
    az = np.linspace(-math.pi, math.pi, AZIMUTHS, endpoint=False)
    az = az + rng.uniform(0, 2 * math.pi / AZIMUTHS)
    e, a = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                 -1).reshape(-1, 3)
    o = np.array([0.0, 0.0, SENSOR_Z])
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(d[:, 2] < 0, -SENSOR_Z / d[:, 2], np.inf)
        t_wall = np.where(d[:, 1] != 0, half_width / np.abs(d[:, 1]), np.inf)
    wall_z = SENSOR_Z + t_wall * d[:, 2]
    t_wall = np.where((wall_z >= 0) & (wall_z <= FRONT_HEIGHT), t_wall,
                      np.inf)
    t_box = np.full(len(d), np.inf)
    for i in range(0, len(d), 16384):
        t_box[i:i + 16384] = _ray_box(d[i:i + 16384], o, boxes)
    t = np.minimum(np.minimum(t_ground, t_wall), t_box)
    kind = np.select([t == t_box, t == t_wall], [2, 1], 0)
    t = t + rng.normal(0.0, 0.02, len(t))
    ok = np.isfinite(t) & (t > 1.0) & (t * np.hypot(d[:, 0], d[:, 1])
                                       <= MAX_RANGE)
    pts = o + d[ok] * t[ok, None]
    kind = kind[ok]
    ground = kind == 0
    pts[ground, 2] += rng.normal(0.0, GROUND_SCATTER, int(ground.sum()))
    # intensity: tanh of a return strength by surface, as Waymo stores it
    strength = np.choose(kind, [0.15, 0.3, 0.6]) * rng.lognormal(0, 0.5,
                                                                 len(pts))
    intensity = np.tanh(strength)
    elongation = rng.exponential(0.05, len(pts))
    return np.concatenate([pts, intensity[:, None], elongation[:, None]],
                          1).astype(np.float32)


def make_scans(scene_seeds, workers: int):
    """``make_scene`` scans of each seed, made in ``workers`` spawned
    processes (all ended on return)."""
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(workers, len(scene_seeds), os.cpu_count() or 1))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        return list(ex.map(make_scene, scene_seeds))
