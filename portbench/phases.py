"""Where the host is, by phase, while a cell of the benchmark runs, read
from the program's own spans (``sessd_torch.utils.profiling``): one run of
one cell on the card.

    python3 -m portbench.phases --workload <cell> --seed <n> \
        [--rounds 6] [--out FILE]

The cell's driver (``drivers/train.py``, ``drivers/infer.py``) runs as in a
``--trace 1`` run of ``portbench.run``: its inputs, weights, set-up,
warm-up, traced window and comparison with the reference. Where its traced
window would start, ``measure`` takes over its loop (the step the training
driver hands to ``common.profiled``; for serving, the infer functions and
staged batches its warm-up called, closed with two batches in flight) and
runs, with ``n`` the cell's ``trace_steps`` or ``trace_batches``:

1. ``rounds`` pairs of unprofiled stretches of ``n`` steps (batches) each,
   ending in a synchronize, before any profile, the spans on in one and off
   in the other (in turns, which first alternating): host time by phase
   from the stretches with the spans on, the device's idle share at their
   pace, and what the spans cost: the median over the pairs of the time
   with them on over the time with them off;
2. ``n`` steps under ``torch.profiler`` with device activity only, the
   spans off, as the benchmark's traced window: device busy and device
   operations a step;
3. ``HOST_STEPS`` more with the host's ops too and the spans on: every idle
   gap of the device split by the phase the host was in
   (``drivers/spans.py``);
4. one more unprofiled stretch, the spans off: the pace the profiles leave
   behind in the process, against that of the stretches of 1.

Then the driver finishes its run (its checks are printed beside), and the
clock is checked: a span around one kernel launch against that launch's
``cudaLaunchKernel`` event in a host and device profile (``clock_check``);
and the host time of one empty span, off and on (``span_us``). Prints one
JSON object (and writes it to ``--out``). Needs a card. This tool goes once
``portbench.run`` reads the spans itself.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import pathlib
import statistics
import sys
import time

import torch

from . import harness
from .drivers import common, spans
from .run import _caches


def _profile(activities, run, n):
    common.sync()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run(n)
        window = time.perf_counter() - t0
    return prof, window


def clock_check(reps: int = 5) -> dict:
    """How the spans' stamps sit on a profile's time line, in microseconds.

    ``cudaLaunchKernel`` and ``aten::add_``: a span around one launch (the
    profile's second; its first pays the profiler's start-up) against the
    launch's runtime event and its op; ``lead`` from the span's start to
    the event's, ``lag`` from the event's end to the span's (both >= 0
    where the span brackets the event). ``record_function``: the clock
    read just before and just after a ``record_function`` range opens
    against the range's start (``lead``: start less the read before;
    ``lag``: the read after less the start), and the same at its close;
    both >= 0 where the clocks agree within the time between the reads."""
    from sessd_torch.utils import profiling

    a = torch.profiler.ProfilerActivity
    x = torch.zeros(1 << 20, device=common.DEVICE)
    x.add_(1)
    common.sync()
    out = {k: {"lead_us": [], "lag_us": []} for k in (
        "cudaLaunchKernel", "aten::add_", "record_function start",
        "record_function end")}

    def put(key, lo_ns, e_lo_us, e_hi_us, hi_ns, t0):
        out[key]["lead_us"].append(e_lo_us - (lo_ns - t0) / 1e3)
        out[key]["lag_us"].append((hi_ns - t0) / 1e3 - e_hi_us)

    for _ in range(reps):
        profiling.reset()
        profiling.enable()
        with torch.profiler.profile(activities=[a.CPU, a.CUDA]) as prof:
            x.add_(1)
            with profiling.span("clock"):
                x.add_(1)
            for _ in range(2):  # the first warms the range's path up
                rf = torch.profiler.record_function("clock_rf")
                t1 = time.time_ns()
                rf.__enter__()
                t2 = time.time_ns()
                t3 = time.time_ns()
                rf.__exit__(None, None, None)
                t4 = time.time_ns()
            common.sync()
        profiling.disable()
        (_, s0, s1, _, _), = profiling.records()[0]
        t0 = prof.profiler.kineto_results.trace_start_ns()
        for name in ("cudaLaunchKernel", "aten::add_"):
            ev = [e for e in prof.events() if e.name == name]
            if len(ev) != 2:
                raise RuntimeError(f"{len(ev)} {name} events, want 2")
            r = max(ev, key=lambda e: e.time_range.start).time_range
            put(name, s0, r.start, r.end, s1, t0)
        r = max((e for e in prof.events() if e.name == "clock_rf"),
                key=lambda e: e.time_range.start).time_range
        put("record_function start", t1, r.start, r.start, t2, t0)
        put("record_function end", t3, r.end, r.end, t4, t0)
    profiling.reset()
    return out


def span_us(calls: int = 100_000, every: int = 1000) -> dict:
    """Host microseconds of one empty span: the recorder off; on, its
    records reset every ``every`` spans, as a run reads them stretch by
    stretch (``on``); and on with all ``calls`` spans kept (``on_kept``).
    Beside them, one read of the spans' clock (``clock``), and the objects
    the garbage collector tracks (``tracked``)."""
    from sessd_torch.utils import profiling

    def empty():
        with profiling.span("empty"):
            pass

    gc.collect()
    out = {"tracked": len(gc.get_objects())}
    t = time.perf_counter()
    for _ in range(calls):
        time.time_ns()
    out["clock"] = (time.perf_counter() - t) / calls * 1e6
    for mode in ("off", "on", "on_kept"):
        profiling.reset()
        if mode != "off":
            profiling.enable()
        t = time.perf_counter()
        for k in range(calls):
            empty()
            if mode == "on" and k % every == every - 1:
                profiling.reset()
        out[mode] = (time.perf_counter() - t) / calls * 1e6
        profiling.disable()
        profiling.reset()
        gc.collect()
    return out


def measure(kind: str, run, n: int, rounds: int) -> dict:
    """The stretches 1-4 of the module's docstring over ``run(k)``, which runs
    k steps or batches and returns with the device done."""
    from sessd_torch.utils import profiling

    a = torch.profiler.ProfilerActivity
    root = spans.ROOTS[kind]
    out = {"kind": kind, "n": n}

    on_s, off_s, recs, counts = [], [], [], []
    for r in range(rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            profiling.reset()
            if on:
                profiling.enable()
            common.sync()
            t1 = time.perf_counter()
            run(n)
            (on_s if on else off_s).append(time.perf_counter() - t1)
            profiling.disable()
            if on:
                s, c = profiling.records()
                base = len(recs)
                recs += [(nm, x, y, p + base if p >= 0 else -1, rt + base)
                         for nm, x, y, p, rt in s]
                counts += [(rt + base if rt >= 0 else -1, nm, v)
                           for rt, nm, v in c]
    profiling.reset()

    prof, window = _profile(common.device_activity(), run, n)
    t = harness.Trace(prof, window)
    busy = t.busy_s / n
    out.update(device_ops_per_root=t.device_ops / n, busy_ms=1e3 * busy,
               traced_window_ms=1e3 * window / n)

    profiling.enable()
    host, _ = _profile(sorted({a.CPU, *common.device_activity()},
                              key=str), run, common.HOST_STEPS)
    profiling.disable()
    traced, _ = profiling.records()
    profiling.reset()
    dev, _ = harness._events(host)
    t0 = host.profiler.kineto_results.trace_start_ns()
    idle = spans.idle_by_phase([r for r, _ in dev], traced, t0)
    out["idle_ms"] = {k: v / 1e3 / common.HOST_STEPS
                      for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}
    out["idle_total_ms"] = sum(out["idle_ms"].values())

    common.sync()
    t1 = time.perf_counter()
    run(n)
    out["off_after_profiles_s"] = time.perf_counter() - t1
    out["after_profiles_pct"] = 100.0 * (
        out["off_after_profiles_s"] / statistics.median(off_s) - 1.0)

    ms = spans.host_ms(recs, root)
    out["host_ms"] = dict(sorted(ms.items(), key=lambda kv: -kv[1]))
    names = spans.phase_names(recs)
    self_ms = dict.fromkeys(names, 0.0)
    for name, v in zip(names, profiling.self_ns(recs)):
        self_ms[name] += v / 1e6 / (rounds * n)
    out["self_ms"] = dict(sorted(self_ms.items(), key=lambda kv: -kv[1]))
    out["counts"] = spans.counts_per_root(recs, counts, root)
    out["spans_per_root"] = len(recs) / (rounds * n)
    wall = statistics.median(on_s) / n
    out["metrics"] = spans.metrics(kind, ms, busy, wall)
    out.update(spans_on_s=on_s, spans_off_s=off_s,
               spans_cost_pct=100.0 * (statistics.median(
                   a / b for a, b in zip(on_s, off_s)) - 1.0))
    return out


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _checks(res: dict) -> dict:
    return {"correct": all(v <= lim for _, v, lim in res["checks"]),
            "checks": {k: [v, lim] for k, v, lim in res["checks"]}}


def train_cell(c: dict, seed: int, rounds: int) -> dict:
    """The training driver's run, ``measure`` on the step it hands to
    ``common.profiled`` before its traced window."""
    from .drivers import train

    out, profiled = {}, common.profiled

    def seam(one, n):
        i = itertools.count()

        def run(k):
            for _ in range(k):
                one(next(i))
            common.sync()

        out.update(measure("train", run, n, rounds))
        return profiled(one, n)

    with _patched(common, "profiled", seam):
        res = train.run(c, seed, 0.0, True, time.perf_counter())
    if not out:
        raise RuntimeError("the training driver never reached its window")
    out.update(_checks(res))
    return out


def infer_cell(c: dict, seed: int, rounds: int) -> dict:
    """The serving driver's run, ``measure`` on the infer functions and
    staged batches of its warm-up (one call a batch of the pool, in order)
    when it asks for its traced window's activities."""
    from sessd_torch import serve

    from .drivers import infer

    npool, n = int(c["traffic"]["pool"]), int(c["traffic"]["trace_batches"])
    calls, out, started = [], {}, []
    make, activity = serve.make_infer_fn, common.device_activity

    def make_seam(*args, **kw):
        fn = make(*args, **kw)

        def call(*inputs):
            if len(calls) < npool:
                calls.append((fn, inputs))
            return fn(*inputs)

        return call

    def activity_seam():
        if not started:  # measure asks for the activities too
            started.append(True)
            out.update(measure("infer", _closed_loop(calls), n, rounds))
        return activity()

    with _patched(serve, "make_infer_fn", make_seam), \
            _patched(common, "device_activity", activity_seam):
        res = infer.run(c, seed, 0.0, True, time.perf_counter())
    if not out:
        raise RuntimeError("the serving driver never reached its window")
    out.update(_checks(res))
    return out


def _closed_loop(calls):
    """``run(k)``: k batches cycling ``calls``, batch k + 1 issued before
    the host waits for batch k's detections in pinned host memory."""
    i = itertools.count()
    fn, inputs = calls[0]
    outs = fn(*inputs)
    slots = [tuple(torch.empty(o.shape, dtype=o.dtype,
                               pin_memory=common.DEVICE == "cuda")
                   for o in outs) for _ in range(2)]

    def run(k):
        prev = None
        for _ in range(k):
            j = next(i)
            fn, inputs = calls[j % len(calls)]
            for dst, src in zip(slots[j % 2], fn(*inputs)):
                dst.copy_(src, non_blocking=True)
            cur = common.event()
            cur.record()
            if prev is not None:
                prev.synchronize()
            prev = cur
        prev.synchronize()

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.phases: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _caches()
    c = harness.cell(args.workload)
    cell = {"train": train_cell,
            "infer": infer_cell}[c["traffic"]["driver"]]
    from sessd_torch.utils.profiling import card_line

    res = {"workload": args.workload, "seed": args.seed, "card": card_line()}
    res.update(cell(c, args.seed, args.rounds))
    res.update(clock=clock_check(), span_us=span_us())
    line = json.dumps(res)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
