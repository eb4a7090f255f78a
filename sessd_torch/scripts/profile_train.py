"""Where the time of one SE-SSD training step goes, on one CUDA device.

    python -m sessd_torch.scripts.profile_train [--data-root R]

The bf16 SE-SSD Car config (``se_ssd_kitti_car_bf16.py``, batch 4, SSL on,
seeded random weights) on a KITTI root: ``R``, or by default a synthetic
one of 8 ray-cast frames (``make_synthetic_root``). The loader's first
``BATCHES`` batches (an epoch of the default root) are staged on the device
before any step, so the host data path is outside every number below:

- ``step``: host clock around one ``train_step`` that ends in a
  synchronize, median (and p90) over ``STEPS`` steps after ``WARMUP``;
- ``busy``: device time per step under ``torch.profiler``, the union of the
  kernel, memcpy and memset intervals, over ``PROFILED`` more steps, each
  profiled alone; ``idle`` = 1 - busy / step;
- ``fwd``, ``dfeat``, ``dw``: device time per step of the training
  kernels, by kernel name: ``sparse_conv_fwd_kernel`` (K4: teacher 14,
  student 10), ``sparse_conv_dfeat_kernel`` (K5 input gradient, 9) and
  ``sparse_conv_dw_partial_kernel`` + ``sparse_conv_dw_reduce_kernel`` (K5
  weight gradient, 10);
- ``peak_gib``: ``torch.cuda.max_memory_allocated`` over the timed steps;
- the ``TOP`` device activities by time per step.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..tools.create_data import create_kitti_data
from ..tools.train import load
from ..train.trainer import Trainer
from ..utils.kitti_synth import make_kitti_root
from ..utils.profiling import card_line

BATCHES = 2  # one epoch of the default root
WARMUP = 3
STEPS = 20
PROFILED = 5
TOP = 15
SEED = 0
# kernel name -> the training kernel it belongs to
KERNELS = {"sparse_conv_fwd_kernel": "fwd",
           "sparse_conv_dfeat_kernel": "dfeat",
           "sparse_conv_dw_partial_kernel": "dw",
           "sparse_conv_dw_reduce_kernel": "dw"}


def make_synthetic_root(root: str, num_frames: int = 8, num_cars: int = 10):
    """A synthetic KITTI root from the ray-cast generator
    (``utils.kitti_synth``), with infos, reduced clouds and the GT
    database, as ``scripts/acceptance_ap.py`` prepares one. The same frames
    form the train and the val split. Returns {split: info path}."""
    make_kitti_root(root, num_frames=num_frames, num_cars=num_cars,
                    pts_per_car=400, ground_points=16000)
    return create_kitti_data(root, {"train": range(num_frames),
                                    "val": range(num_frames)})


def kernel_split(prof) -> dict:
    """Device us of one profiled step: busy (union of intervals), the
    training kernels, the activity count and us per activity name."""
    out = collections.Counter()
    by_name = collections.Counter()
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        for kernel, part in KERNELS.items():
            if kernel in e.name:
                out[part] += us
    end = -float("inf")
    for a, b in sorted(spans):
        if b > end:
            out["busy"] += b - max(a, end)
            end = b
    out["device_ops"] = len(spans)
    return out, by_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    card = card_line()
    print(card)

    with tempfile.TemporaryDirectory(prefix="sessd_profile_") as tmp:
        root = args.data_root
        if root is None:
            root = f"{tmp}/kitti"
            make_synthetic_root(root, num_frames=8, num_cars=10)
        trainer = Trainer(load("se_ssd_kitti_car_bf16.py", root),
                          work_dir=f"{tmp}/work", seed=SEED, device="cuda")
        loader = iter(trainer.train_loader)
        try:
            batches = [trainer._device_batch(b)
                       for b in itertools.islice(loader, BATCHES)]
        finally:
            loader.close()

    state, step_fn = trainer.state, trainer.train_step

    def step(i):
        t0 = time.perf_counter()
        step_fn(state, batches[i % len(batches)], 1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(WARMUP):
        step(i)
    torch.cuda.reset_peak_memory_stats()
    times = [step(i) for i in range(STEPS)]
    peak = torch.cuda.max_memory_allocated()

    totals, names = collections.Counter(), collections.Counter()
    for i in range(PROFILED):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(i)
        split, by_name = kernel_split(prof)
        totals.update(split)
        names.update(by_name)
    if totals["busy"] == 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    missing = sorted({p for p in KERNELS.values() if totals[p] == 0})
    if missing:
        raise RuntimeError(f"no {missing} kernels in the profile")
    for name, us in names.most_common(TOP):
        print(f"  device {us / PROFILED / 1e3:8.4f} ms/step  {name[:90]}")

    r = {"card": card, "steps": STEPS, "profiled": PROFILED,
         "step": float(np.median(times)),
         "step_p90": float(np.percentile(times, 90)),
         "peak_gib": peak / 2 ** 30}
    for key in ("busy", "fwd", "dfeat", "dw"):
        r[key] = totals[key] / PROFILED / 1e3
    r["device_ops"] = totals["device_ops"] / PROFILED
    r["idle"] = 1.0 - r["busy"] / r["step"]
    r["kernels_of_step"] = (r["fwd"] + r["dfeat"] + r["dw"]) / r["step"]
    r["kernels_of_busy"] = (r["fwd"] + r["dfeat"] + r["dw"]) / r["busy"]
    print("summary: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in r.items()))
    print(json.dumps(r))


if __name__ == "__main__":
    main()
