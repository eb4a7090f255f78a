"""What building a request's inputs on the card costs, on one CUDA device.

    python -m sessd_torch.scripts.profile_device_prep

The points-in topology (``serve.make_points_infer_fn``) builds on the
device what ``HostPreprocessor`` builds on one host core: the voxels
(``voxelize_torch``, one call per scan) and the rulebook chain
(``build_device_chain``, one per request). For ``make_scene(seed 0-7)``
at batch 1 (each scan a request) and batch 8 (the eight scans in one
request) at SERVING_CAPS, with the scans already on the card, it reports
medians over ``REPS`` requests of:

- ``device_prep``: CUDA events around voxelize + chain;
- the chain's steps, each between CUDA events recorded in the same pass:
  ``voxelize``, ``grid`` (the stable id sort and perm), per stage i
  ``lut{i}`` (the occupancy LUT, or nothing past the budget), ``subm{i}``
  and ``down{i}`` (the candidate sort, compaction and its lookups);
- ``host_prep``: ``HostPreprocessor`` on the same scans (host clock);
- ``busy`` and ``idle``: the union of device intervals per request under
  ``torch.profiler`` over ``PROFILED`` requests and its share of the
  ``device_prep`` window left idle (launch gaps); the ``TOP`` device
  activities by time.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from sessd_torch import builder
from sessd_torch.data.rulebooks import DOWNS
from sessd_torch.ops import sparse as sp
from sessd_torch.ops.voxelize import voxelize_torch
from sessd_torch.scripts.profile_serve import device_time
from sessd_torch.serve import SERVING_CAPS, HostPreprocessor, make_scene
from sessd_torch.utils.profiling import card_line

REPS = 20
PROFILED = 5
TOP = 10


class Marks:
    """CUDA events between the steps of one pass."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def split_ms(self) -> dict:
        return {b: ea.elapsed_time(eb) for (_, ea), (b, eb)
                in zip(self.events, self.events[1:])}


def prep_pass(points, spec, caps, mark) -> dict:
    """Voxelize each scan and build one chain over them, as
    ``build_device_chain`` does, with a mark after each step."""
    mark("start")
    coords = []
    for b, pts in enumerate(points):
        _, zyx, _, _ = voxelize_torch(pts, spec)
        coords.append(torch.cat([torch.full_like(zyx[:, :1], b), zyx], 1))
    mark("voxelize")
    coords = torch.cat(coords)
    shape = (len(points),) + spec.sparse_shape
    caps = [c * len(points) for c in caps]
    ids, _ = sp.grid_from_coords(coords, coords[:, 1] >= 0, shape, caps[0])
    mark("grid")
    for i, (dk, ds, dp) in enumerate(DOWNS):
        lut = sp.occupancy_lut(ids, shape)
        mark(f"lut{i}")
        sp.subm_rulebook(ids, shape, lut=lut)
        mark(f"subm{i}")
        ids, shape, _ = sp.downsample_rulebook(ids, shape, dk, ds, dp,
                                               caps[i + 1], lut=lut)
        mark(f"down{i}")
    return ids


def run(batch, scenes, spec, prep) -> dict:
    requests = [[scenes[(r * batch + j) % len(scenes)] for j in range(batch)]
                for r in range(len(scenes) // batch)]
    on_card = [[torch.from_numpy(p).cuda() for p in req] for req in requests]
    rows = []
    for rep in range(REPS + 2):  # two warm-up passes
        mark = Marks()
        prep_pass(on_card[rep % len(on_card)], spec, SERVING_CAPS, mark)
        torch.cuda.synchronize()
        if rep >= 2:
            split = mark.split_ms()
            rows.append({"device_prep": sum(split.values()), **split})
    host = []
    for rep in range(REPS):
        req = requests[rep % len(requests)]
        t0 = time.perf_counter()
        prep(req[0]) if batch == 1 else prep.batch(req)
        host.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for rep in range(PROFILED):
            prep_pass(on_card[rep % len(on_card)], spec, SERVING_CAPS,
                      Marks())
        torch.cuda.synchronize()
    busy, n_ops, by_name = device_time(prof)
    if busy == 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    out = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    out["device_prep_p90"] = float(np.percentile(
        [r["device_prep"] for r in rows], 90))
    out["host_prep"] = float(np.median(host))
    out["busy"] = busy / PROFILED / 1e3
    out["idle"] = 1.0 - out["busy"] / out["device_prep"]
    out["device_ops"] = n_ops / PROFILED
    out["top"] = [(name[:80], us / PROFILED / 1e3)
                  for name, us in by_name.most_common(TOP)]
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_device_prep: needs a CUDA device")
    card = card_line()
    print(card)
    cfg = builder.load_config("se_ssd_kitti_car_bf16.py")
    spec = builder.build_voxelizer(cfg.voxel_generator)
    scenes = [make_scene(seed=s)[0] for s in range(8)]
    prep = HostPreprocessor(spec, SERVING_CAPS)
    result = {"card": card, "caps": SERVING_CAPS, "reps": REPS}
    with torch.inference_mode():
        for batch in (1, 8):
            r = run(batch, scenes, spec, prep)
            result[f"b{batch}"] = r
            print(f"batch {batch}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r.items()
                if isinstance(v, float)))
            for name, ms in r["top"]:
                print(f"  device {ms:8.4f} ms/request  {name}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
