"""Training logs: averaging buffer + text logger with ETA and stage timings
(the counterpart of ``sessd_tpu/utils/logging.py``, whose lines and
``log.json`` rows these are).

The step is eager PyTorch, but the trainer reads its metrics from the
device only at log points, so the reference's per-stage hook timings
collapse to (data_time, step_time) averaged over the log interval; deep
profiling goes through ``torch.profiler`` traces
(``sessd_torch/utils/profiling.py``).
"""
from __future__ import annotations

import json
import logging
import pathlib
import sys
import time
from collections import OrderedDict, defaultdict


def get_root_logger(work_dir=None, level=logging.INFO,
                    rank: int = 0) -> logging.Logger:
    """The run's logger: stdout and ``<work_dir>/train.log``, one logger
    per work dir (so two trainers in one process write their own files).
    Of a data-parallel run only rank 0 logs so; every other rank logs its
    warnings and errors to stdout alone (the reference's
    ``get_root_logger(log_level)`` with ``rank != 0``)."""
    name = "sessd_torch" if work_dir is None else \
        f"sessd_torch.train.{pathlib.Path(work_dir).resolve()}"
    logger = logging.getLogger(name)
    if work_dir is not None:
        pathlib.Path(work_dir).mkdir(parents=True, exist_ok=True)
    if logger.handlers:
        return logger
    logger.setLevel(level if rank == 0 else logging.WARNING)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    handlers = [logging.StreamHandler(sys.stdout)]
    if work_dir is not None and rank == 0:
        handlers.append(logging.FileHandler(
            pathlib.Path(work_dir) / "train.log"))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class LogBuffer:
    """Windowed averaging of scalar metrics (trainer/log_buffer.py)."""

    def __init__(self):
        self.history = defaultdict(list)
        self.output = OrderedDict()

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self.history[k].append(float(v))

    def average(self, n: int = 0):
        self.output = OrderedDict()
        for k, vals in self.history.items():
            window = vals[-n:] if n > 0 else vals
            if window:
                self.output[k] = sum(window) / len(window)
        return self.output

    def clear(self):
        self.history.clear()
        self.output.clear()


class TensorBoardLogger:
    """Optional TensorBoard scalars (the TensorboardLoggerHook equivalent,
    hooks/logger/tensorboard.py). No-op if tensorboard isn't importable."""

    def __init__(self, log_dir):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(str(log_dir))
        except Exception:
            self._writer = None

    def log(self, metrics: dict, step: int):
        if self._writer is None:
            return
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self._writer is not None:
            self._writer.close()


def device_memory_stats() -> dict:
    """Allocated and peak device memory of the current CUDA device (the
    max-memory stat the reference reduces across ranks,
    hooks/logger/text.py:22-27); {} without one."""
    import torch

    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}


class TextLogger:
    def __init__(self, logger, interval: int = 10, total_iters: int = 0,
                 json_path=None):
        self.logger = logger
        self.interval = interval
        self.total_iters = total_iters
        self.start = time.time()
        self.done = 0
        self.json_path = pathlib.Path(json_path) if json_path else None

    def will_log(self) -> bool:
        """True when the NEXT step() call will emit a log line — lets the
        caller skip per-step costs (device reads) that only feed log
        lines."""
        return (self.done + 1) % self.interval == 0

    def step(self, epoch, it, iters_per_epoch, metrics: dict,
             lr: float = 0.0, data_time: float = 0.0, step_time: float = 0.0):
        self.done += 1
        # gate on the GLOBAL step count, not the per-epoch iter: with tiny
        # epochs (iters_per_epoch < interval) the per-epoch gate never
        # fires and a whole run trains silently
        if self.done % self.interval:
            return
        elapsed = time.time() - self.start
        eta = ""
        if self.total_iters:
            remain = elapsed / max(self.done, 1) * (self.total_iters
                                                    - self.done)
            eta = (f"eta: {int(remain // 3600)}:"
                   f"{int(remain % 3600 // 60):02d}:{int(remain % 60):02d}, ")
        parts = ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()
                          if not k.startswith("_"))
        self.logger.info(
            f"Epoch [{epoch}][{it + 1}/{iters_per_epoch}] lr: {lr:.5f}, "
            f"{eta}data_time: {data_time:.3f}, step_time: {step_time:.3f}, "
            f"{parts}")
        if self.json_path:
            with open(self.json_path, "a") as f:
                rec = dict(epoch=epoch, iter=it + 1, lr=lr,
                           data_time=round(data_time, 4),
                           step_time=round(step_time, 4), **{
                               k: float(v) for k, v in metrics.items()})
                f.write(json.dumps(rec) + "\n")
