"""The program's host spans and counters (``sessd_torch.utils.profiling``,
``records()``) reduced to per-layer numbers: each phase's host time a step
or a batch, each idle gap of the device split by the phase the host was in
through it, and the metrics read from those.

A span is (name, start_ns, end_ns, parent, root), its stamps on the clock
``torch.profiler`` stamps its events with; ``trace_start_ns`` of a
profile puts a span on that profile's time line, in microseconds, where
its device intervals lie. A phase is the innermost span open at a moment,
named by its path below the root ("train.student_fwd/model.backbone"); the
root's own name where no child is open, ``between`` where no span is.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

from .. import harness

BETWEEN = "between"

# each host-time metric: the spans it adds, and those it takes away
HOST_MS = {
    "forward_host_ms.train": (("train.inputs", "train.teacher_fwd",
                               "train.student_fwd"), ()),
    "loss_host_ms.train": (("train.loss", "train.teacher_metrics"), ()),
    "backward_host_ms.train": (("train.backward",), ()),
    "optim_ema_host_ms.train": (("train.optim", "train.ema"), ()),
    "forward_host_ms.infer": (("infer.stage", "infer.forward"), ()),
    "predict_host_ms.infer": (("infer.predict",), ("predict.sync",)),
    "sync_wait_ms.infer": (("predict.sync",), ()),
}
ROOTS = {"train": "train.step", "infer": "infer.batch"}


def phase_names(spans) -> List[str]:
    """Each span's path of names below its root; the root's own name."""
    out = []
    for i, (name, _, _, parent, _) in enumerate(spans):
        out.append(name if parent < 0 or spans[parent][3] < 0
                   else f"{out[parent]}/{name}")
    return out


def timeline(spans, trace_start_ns: int) -> List[Tuple[float, float, str]]:
    """Disjoint (start_us, end_us, phase) pieces, in order, of the
    innermost span open through each, on the profile's time line."""
    names = phase_names(spans)
    depth = []
    for _, _, _, parent, _ in spans:
        depth.append(0 if parent < 0 else depth[parent] + 1)
    us = [((a - trace_start_ns) / 1e3, (b - trace_start_ns) / 1e3)
          for _, a, b, _, _ in spans]
    cuts = sorted({t for r in us for t in r})
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        open_ = [i for i, (a, b) in enumerate(us) if a <= lo and hi <= b]
        if open_:
            out.append((lo, hi, names[max(open_, key=lambda i: depth[i])]))
    return out


def idle_by_phase(device_us: Sequence[Tuple[float, float]], spans,
                  trace_start_ns: int) -> Dict[str, float]:
    """Microseconds of device idle by phase, between the first and the
    last device interval of a profile (``device_us``, on its time line):
    each gap split by the pieces of ``timeline`` it meets, the rest of it
    under ``between``."""
    if not device_us:
        return {}
    lo = min(a for a, _ in device_us)
    hi = max(b for _, b in device_us)
    pieces = timeline(spans, trace_start_ns)
    out: Dict[str, float] = collections.Counter()
    j = 0
    for a, b in sorted(harness.idle_gaps(device_us, (lo, hi))):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            part = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if part > 0:
                out[pieces[k][2]] += part
                covered += part
            k += 1
        out[BETWEEN] += (b - a) - covered
    return dict(out)


def host_ms(spans, root: str) -> Dict[str, float]:
    """Each span name's host milliseconds, summed over its spans and
    divided by the number of ``root`` spans."""
    roots = sum(s[0] == root for s in spans)
    total: Dict[str, float] = collections.Counter()
    for name, a, b, _, _ in spans:
        total[name] += (b - a) / 1e6
    return {n: v / roots for n, v in total.items()} if roots else {}


def counts_per_root(spans, counts, root: str) -> Dict[str, float]:
    """Each counter's mean over the ``root`` spans."""
    roots = sum(s[0] == root for s in spans)
    total: Dict[str, float] = collections.Counter()
    for _, name, n in counts:
        total[name] += n
    return {n: v / roots for n, v in total.items()} if roots else {}


def metrics(kind: str, ms: Dict[str, float], busy_s: float,
            wall_s: float) -> Dict[str, float]:
    """The per-layer metrics of a cell of ``kind`` ("train" or "infer"):
    the host-time ones from ``ms`` (``host_ms`` of the unprofiled stretch
    with the spans on), and ``device_idle_untraced``, 100 x (1 - device
    busy a step or batch in the device-only window (``busy_s``) / the
    host clock's time a step or batch of that stretch (``wall_s``))."""
    if not ms:
        return {}
    out = {}
    for name, (plus, minus) in HOST_MS.items():
        if name.endswith("." + kind):
            out[name] = (sum(ms.get(n, 0.0) for n in plus)
                         - sum(ms.get(n, 0.0) for n in minus))
    if wall_s > 0:
        out[f"device_idle_untraced.{kind}"] = 100.0 * (1.0 - busy_s / wall_s)
    return out
