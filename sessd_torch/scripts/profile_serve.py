"""Where the time of a batch-1 serving request goes, on one CUDA device.

    python -m sessd_torch.scripts.profile_serve

The SE-SSD Car model (``se_ssd_kitti_car_bf16.py``, seeded random weights,
70,400 anchors) serves ray-cast scenes of ``make_scene(seed 0-3)`` at
SERVING_CAPS, once with the cls bias at the focal prior (the small NMS
branch) and once without it (every anchor scores ~0.5: the 1000-box NMS).
Per request it reports medians (and p90) over ``REQUESTS`` requests of:

- ``prep``: host prep, C++ voxelize + rulebook chain (host clock);
- ``h2d``: staging the host arrays on the device, synchronised (host clock);
- ``infer``: the device-clock window of one ``make_infer_fn`` call on staged
  inputs, a CUDA event before the call to one after it; its split into
  ``reader``, ``backbone``, ``neck``, ``head`` and ``predict`` comes from
  CUDA events recorded by forward hooks;
- ``busy``: device time per request under ``torch.profiler``, the union of
  the kernel, memcpy and memset intervals, over ``PROFILED`` more requests;
  ``conv``, the part of it in the fused sparse conv kernel
  (``fused_sparse_conv_kernel``); ``device_ops``,
  the device activities per request; and the ``TOP`` activities by time.

From these: the device's idle share of the infer window, 1 - busy / infer,
and of the whole request, 1 - busy / (prep + h2d + infer). The last line is
one JSON object with every number.
"""
from __future__ import annotations

import collections
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from sessd_torch import builder
from sessd_torch.serve import (SERVING_CAPS, HostPreprocessor, make_infer_fn,
                               make_scene, stage_inputs)
from sessd_torch.utils.profiling import card_line

SPLIT = ("reader", "backbone", "neck", "head", "predict")
REQUESTS = 50  # a p90 with five samples beyond it
PROFILED = 10
TOP = 12
SEED = 0


class StageEvents:
    """CUDA events at the module boundaries of ``VoxelNet.forward``."""

    def __init__(self, model):
        self.events = {}
        model.backbone.register_forward_pre_hook(self._mark("reader"))
        for name, module in (("backbone", model.backbone),
                             ("neck", model.neck),
                             ("head", model.bbox_head)):
            module.register_forward_hook(self._mark(name))

    def _mark(self, name):
        def hook(*_):
            self.record(name)
        return hook

    def record(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name] = ev

    def split_ms(self) -> dict:
        """Elapsed ms of each stage, each from the previous mark."""
        marks = ["start", *SPLIT]
        return {b: self.events[a].elapsed_time(self.events[b])
                for a, b in zip(marks, marks[1:])}


def device_time(prof) -> tuple:
    """(union of the device intervals in us, device activities, us per
    activity name) of a profile."""
    spans, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += e.time_range.elapsed_us()
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total, len(spans), by_name


def run_regime(marks, infer, prep, scenes) -> dict:
    rows = []

    def request(pts):
        t0 = time.perf_counter()
        p = prep(pts)
        t1 = time.perf_counter()
        feats, rb = stage_inputs(p["feats"], p["rulebooks"], "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        marks.record("start")
        out = infer(feats, rb)
        marks.record("predict")
        torch.cuda.synchronize()
        return out, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    for i in range(3):  # warm-up: cuDNN plans, allocator
        request(scenes[i % len(scenes)])
    for i in range(REQUESTS):
        (_, _, valid), prep_ms, h2d_ms = request(scenes[i % len(scenes)])
        split = marks.split_ms()
        rows.append({"prep": prep_ms, "h2d": h2d_ms,
                     "infer": sum(split.values()), **split,
                     "valid": int(valid.sum())})
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED):
            request(scenes[i % len(scenes)])
    busy, n_ops, by_name = device_time(prof)
    if busy == 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    for name, us in by_name.most_common(TOP):
        print(f"  device {us / PROFILED / 1e3:8.4f} ms/request  {name[:90]}")

    out = {}
    for key in ("prep", "h2d", "infer", *SPLIT):
        vals = [r[key] for r in rows]
        out[key] = float(np.median(vals))
        out[key + "_p90"] = float(np.percentile(vals, 90))
    out["request"] = float(np.median([r["prep"] + r["h2d"] + r["infer"]
                                      for r in rows]))
    out["busy"] = busy / PROFILED / 1e3
    out["conv"] = sum(us for name, us in by_name.items()
                      if "fused_sparse_conv_kernel" in name) / PROFILED / 1e3
    if out["conv"] == 0:
        raise RuntimeError("no fused_sparse_conv_kernel in the profile")
    out["device_ops"] = n_ops / PROFILED
    out["idle_infer"] = 1.0 - out["busy"] / out["infer"]
    out["idle_request"] = 1.0 - out["busy"] / out["request"]
    out["valid"] = sorted({r["valid"] for r in rows})
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    card = card_line()
    print(card)

    cfg = builder.load_config("se_ssd_kitti_car_bf16.py")
    model = builder.build_detector(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    prep = HostPreprocessor(builder.build_voxelizer(cfg.voxel_generator),
                            SERVING_CAPS)
    infer = make_infer_fn(model, builder.build_anchors(cfg),
                          builder.build_predict_config(cfg), SERVING_CAPS, 1,
                          "cuda")
    scenes = [make_scene(seed=s)[0] for s in range(4)]
    marks = StageEvents(model)

    result = {"card": card, "requests": REQUESTS, "profiled": PROFILED}
    for regime, pi in (("prior", 0.01), ("no_prior", None)):
        builder.set_cls_prior(model, pi)
        print(f"{regime}:")
        r = run_regime(marks, infer, prep, scenes)
        result[regime] = r
        print(f"{regime} summary: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
