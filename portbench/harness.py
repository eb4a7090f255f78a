"""What every cell shares: the files a cell is made of, found by name; the
seeds; the statistics; the reduction of a profiler trace; the peaks the
rooflines are taken against; and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix:

- ``portbench/configs/<config>.json``: the program's config file it loads
  (from the frozen copy in ``portbench/hostpath/configs``), the keys it
  overrides, its published sizes, and the limits of its comparisons with
  the reference, per traffic mix;
- ``portbench/traffic/<traffic>.json``: the parameters of the mix and the
  driver that reads them (``portbench/drivers/<driver>.py``);
- ``portbench/metrics/<metric>.py``: one reader per per-layer metric, a
  function ``read(t)`` of the traced run's ``Trace`` that returns a number
  or None where it finds nothing to read.
"""
from __future__ import annotations

import bisect
import collections
import importlib.util
import json
import math
import pathlib
import sys
from typing import Dict, List, Optional

import numpy as np

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent

# NVIDIA's data sheet for one H100 SXM, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12}  # f32: TF32, its fastest
PEAK_BYTES = 3.35e12

FORBIDDEN = ("jax", "jaxlib", "flax", "sessd_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload entry, its configuration and its traffic, by name."""
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    return {"bench": bench, "workload": w,
            "config": load_json(PKG / "configs" / f"{w['config']}.json"),
            "traffic": load_json(PKG / "traffic" / f"{w['traffic']}.json")}


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    return load_module(PKG / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    listing it, and those without a list whose end-to-end metric it
    reports."""
    e2e = [m["name"] for m in cell_end_to_end(bench, workload)]
    if kind == "end_to_end":
        return cell_end_to_end(bench, workload)
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def cell_end_to_end(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 31-bit seeds drawn from the run's seed (any whole
    number >= 0)."""
    ss = np.random.SeedSequence(int(seed))
    return [int(v) >> 1 for v in ss.generate_state(n, dtype=np.uint32)]


def percentile(values, q: float) -> float:
    """The q-th percentile of all the samples, linear between ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ----------------------------------------------------------------------------
# trace reduction
# ----------------------------------------------------------------------------

def union_us(spans) -> float:
    """The length of the union of [start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_gaps(spans, window) -> List[tuple]:
    """(start, end) of every stretch of the window in which no device
    interval runs, longest first."""
    gaps, end = [], window[0]
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if window[1] > end:
        gaps.append((end, window[1]))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def _events(prof):
    """(device [((start, end), name)], host [((start, end), name)]) of a
    profile, in microseconds; the profiler's own buffer requests left out
    of the host's."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            dev.append((r, e.name))
        elif (e.device_type == DeviceType.CPU
              and e.name != "Activity Buffer Request"):
            host.append((r, e.name))
    return dev, host


class Trace:
    """A traced window, reduced: device busy time and the device's
    activities by name from ``prof`` (device activity only, so that the
    window runs near its untraced pace), and the longest idle gaps, each
    named by what the host ran through it, from ``host`` (a few more steps
    traced with the host's ops). Drivers add ``steps`` and ``extra``.
    Times in seconds."""

    def __init__(self, prof, window_s: float, host=None, top: int = 10):
        dev, _ = _events(prof)
        spans = [r for r, _ in dev]
        self.device_ops = len(spans)
        self.busy_s = union_us(spans) / 1e6
        self.window_s = window_s
        self.by_name: Dict[str, float] = collections.Counter()
        for (a, b), name in dev:
            self.by_name[name] += (b - a) / 1e6
        self.gaps = _named_gaps(host if host is not None else prof, top)
        self.top = top
        self.steps = 0
        self.extra: dict = {}

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the activities whose name holds one of
        ``names``."""
        return sum(s for n, s in self.by_name.items()
                   if any(k in n for k in names))

    def breakdown(self) -> dict:
        ops = collections.Counter(self.by_name).most_common(self.top)
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": self.gaps}


def _named_gaps(prof, top: int) -> List[list]:
    """The ``top`` longest stretches between the first and the last device
    activity of ``prof`` in which the device ran nothing, each named by
    the innermost host op running through its middle, or by the last one
    that ended before it ("after <op>": the host ran Python)."""
    dev, host = _events(prof)
    spans = [r for r, _ in dev]
    if not spans:
        return []
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    host.sort()
    starts = [a for (a, _), _ in host]
    out = []
    for a, b in idle_gaps(spans, (lo, hi))[:top]:
        mid = (a + b) / 2
        best, before = None, None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            (ha, hb), name = host[i]
            if hb >= mid and (best is None or hb - ha < best[0]):
                best = (hb - ha, name)
            if hb < mid and (before is None or hb > before[0]):
                before = (hb, name)
        name = (best[1] if best else
                f"after {before[1]}" if before else "host")
        out.append([name[:120], (b - a) / 1e6])
    return out


def roofline(bounds_s: Optional[float], measured_s: float) -> Optional[float]:
    """A share of the roofline in %, or None where nothing ran."""
    if not bounds_s or measured_s <= 0:
        return None
    return 100.0 * bounds_s / measured_s


def conv_bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
