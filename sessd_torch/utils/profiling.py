"""Profiling and timing helpers (the counterpart of
``sessd_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace of the enclosed block (host
and, on a CUDA machine, device activities) into ``log_dir`` for TensorBoard
or Perfetto; ``annotate`` names a region in it; ``StepTimer`` keeps running
averages of the (data, step) phases of a loop. ``queued_device_ms`` and
``queued_span_ms`` time work on the card with CUDA events while the launch
waits behind a spin on the device, so the events measure the device and
not the host's issue time. ``card_line`` is the card's name and power
limit, as every recorded number carries it.
"""
from __future__ import annotations

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


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock timing of (data, step) phases with running averages."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.n = 0
        self.data_time = 0.0
        self.step_time = 0.0
        self._t = time.perf_counter()

    def data_done(self):
        self._data = time.perf_counter() - self._t

    def step_done(self):
        dt = time.perf_counter() - self._t - self._data
        self.n += 1
        if self.n > self.warmup:
            self.data_time += self._data
            self.step_time += dt
        self._t = time.perf_counter()

    @property
    def averages(self):
        n = max(self.n - self.warmup, 1)
        return {"data_time": self.data_time / n,
                "step_time": self.step_time / n}


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
