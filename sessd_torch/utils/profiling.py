"""Profiling and timing helpers (the counterpart of
``sessd_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace of the enclosed block (host
and, on a CUDA machine, device activities) into ``log_dir`` for TensorBoard
or Perfetto. ``span`` and ``count`` record the host's time by phase and
its counts inside the training step and the serving pass, into memory,
while ``enable()`` has turned the recorder on; ``records()`` reads them.
``queued_device_ms`` and ``queued_span_ms`` time work on the card with CUDA
events while the launch waits behind a spin on the device, so the events
measure the device and not the host's issue time. ``card_line`` is the
card's name and power limit, as every recorded number carries it.
"""
from __future__ import annotations

import collections
import contextlib
import subprocess
import time

import numpy as np
import torch

# device cycles of the spin that holds the stream while the host issues
# the timed launches (~1 ms on an H100)
SPIN_CYCLES = 2_000_000


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block into ``log_dir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as p:
        yield p


class _Span:
    """An open span: [name, start, end, parent span, root span]."""

    __slots__ = ("rec", "entry")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.entry = [name, 0, None, None, None]

    def __enter__(self):
        stack, e = self.rec.stack, self.entry
        parent = stack[-1] if stack else None
        e[3], e[4] = parent, e if parent is None else parent[4]
        self.rec.spans.append(e)
        stack.append(e)
        e[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.entry[2] = time.time_ns()
        stack = self.rec.stack
        if stack and stack[-1] is self.entry:  # not where reset() came between
            stack.pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Recorder:
    """Host spans and counters, in memory, for one thread.

    A span records its name, its start and end on the clock that
    ``torch.profiler`` stamps its events with (``time.time_ns()``,
    CLOCK_REALTIME, on Linux), the span it opened inside and its root: the
    outermost span it belongs to, the training step or the serving batch.
    A counter adds up under the root open when it counts. Off, ``span``
    gives one shared object that does nothing: no clock read, no
    allocation. On or off, the recorder does no device work: no event, no
    synchronize, nothing the profiler sees, so a trace taken with it on
    holds the same events as one taken with it off.

    It is for one thread and for bounded stretches: spans opened on two
    threads at once nest into one another, and while it is on every span is
    kept until ``reset()``. A span open across ``reset()`` closes without
    a trace in the new records."""

    def __init__(self):
        self.on = False
        self.spans: list = []
        self.stack: list = []
        self.counts: collections.Counter = collections.Counter()

    def reset(self):
        self.spans, self.stack = [], []
        self.counts = collections.Counter()

    def records(self):
        """(spans, counters) as plain tuples: spans (name, start_ns,
        end_ns, parent, root) in the order they opened, parent and root
        their indices in that list (parent -1 for a root, end None while
        open); counters (root, name, n), root -1 outside any span."""
        ids = {id(e): i for i, e in enumerate(self.spans)}
        spans = [(n, a, b, -1 if p is None else ids[id(p)], ids[id(r)])
                 for n, a, b, p, r in self.spans]
        counts = [(ids.get(r, -1), n, v) for (r, n), v in self.counts.items()]
        return spans, counts


RECORDER = Recorder()


def span(name: str):
    """``with span(name):`` records the enclosed block as a span of the
    recorder while it is on."""
    return _Span(RECORDER, name) if RECORDER.on else NO_SPAN


def count(name: str, n: int = 1):
    """Adds ``n`` to the counter ``name`` of the current root while the
    recorder is on."""
    if RECORDER.on:
        stack = RECORDER.stack
        RECORDER.counts[(id(stack[0]) if stack else None, name)] += n


def enable():
    RECORDER.on = True


def disable():
    RECORDER.on = False


def reset():
    RECORDER.reset()


def records():
    return RECORDER.records()


def self_ns(spans) -> list:
    """Each span's self time in ns: its duration less the part of it that
    its children cover (``records()``'s spans, all closed)."""
    children = collections.defaultdict(list)
    for _, a, b, p, _ in spans:
        if p >= 0:
            children[p].append((a, b))
    out = []
    for i, (_, a, b, _, _) in enumerate(spans):
        covered, end = 0, a
        for ca, cb in sorted(children[i]):
            ca, cb = max(ca, end), min(cb, b)
            if cb > ca:
                covered += cb - ca
                end = cb
        out.append(b - a - covered)
    return out


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def queued_device_ms(fn, reps: int = 30,
                     spin_cycles: int = SPIN_CYCLES) -> float:
    """Median over ``reps`` calls of the device time of one ``fn()``: CUDA
    events around the call, issued while the stream spins, so the work
    starts right after the first event. One warm-up call first."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def queued_span_ms(fn, calls: int = 30,
                   spin_cycles: int = 20 * SPIN_CYCLES) -> float:
    """Device time per call of ``calls`` back-to-back ``fn()`` calls, all
    issued while the stream spins (CUDA events around the run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls
