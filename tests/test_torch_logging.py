"""The port's training logs (sessd_torch/utils/logging.py) against the JAX
package's (sessd_tpu/utils/logging.py) on the same metrics: every
``TextLogger`` line and ``log.json`` row equal, with the log records'
timestamp prefix removed and the clock the ETA reads held at the same
values; ``LogBuffer`` averages equal. Also the port's logger file and
format, and the profiling helpers on the CPU."""
import itertools
import json
import logging

import numpy as np
import pytest
import torch

from sessd_tpu.utils import logging as jlog
from sessd_torch.utils import logging as tlog
from sessd_torch.utils import profiling
import test_torch_threads  # noqa: F401 (torch's threads under xdist)


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    log = logging.getLogger(f"test_torch_logging.{name}")
    log.handlers[:] = [_Capture()]
    log.setLevel(logging.INFO)
    log.propagate = False
    return log


def _metrics(rng):
    return {"loss": float(rng.rand() * 10), "cls_loss_reduced": float(
        rng.rand()), "num_pos": float(rng.randint(0, 50)),
        "_hidden": 1.0, "grad_norm": float(rng.rand() * 40)}


@pytest.mark.parametrize("interval,total", [(1, 0), (3, 20)])
def test_text_logger_matches_jax(tmp_path, monkeypatch, interval, total):
    outs = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        # the same clock readings for both: start, then one per line
        ticks = itertools.count(1000.0, 7.25)
        monkeypatch.setattr(mod.time, "time", lambda t=ticks: next(t))
        rng = np.random.RandomState(0)
        log = _logger(name)
        text = mod.TextLogger(log, interval, total_iters=total,
                              json_path=tmp_path / f"{name}.json")
        will = []
        for step in range(7):
            will.append(text.will_log())
            text.step(1 + step // 4, step % 4, 4, _metrics(rng),
                      lr=1e-3 * (step + 1), data_time=0.01 * step,
                      step_time=0.1 + 0.001 * step)
        outs[name] = (log.handlers[0].lines, (tmp_path / f"{name}.json")
                      .read_text().splitlines(), will)
    assert outs["torch"] == outs["jax"]
    lines, rows, _ = outs["torch"]
    assert len(lines) == 7 // interval and all(
        line.startswith("Epoch [") for line in lines)
    assert [json.loads(r)["iter"] for r in rows] == [
        s % 4 + 1 for s in range(7) if (s + 1) % interval == 0]
    assert ("eta: " in lines[0]) == bool(total)


def test_log_buffer_matches_jax():
    rng = np.random.RandomState(1)
    bufs = [jlog.LogBuffer(), tlog.LogBuffer()]
    for _ in range(13):
        m = {"a": rng.rand(), "b": rng.randn()}
        for b in bufs:
            b.update(m)
    for n in (0, 5, 10):
        assert bufs[1].average(n) == bufs[0].average(n)
    bufs[1].clear()
    assert bufs[1].average() == {}


def test_root_logger_writes_train_log(tmp_path, capsys):
    log = tlog.get_root_logger(tmp_path / "work")
    assert tlog.get_root_logger(tmp_path / "work") is log
    assert len(log.handlers) == 2
    log.info("Epoch [1][1/2] lr: 0.00030")
    text = (tmp_path / "work" / "train.log").read_text()
    assert text.rstrip().endswith(" - INFO - Epoch [1][1/2] lr: 0.00030")
    assert "Epoch [1][1/2]" in capsys.readouterr().out
    for h in log.handlers:
        h.close()
    log.handlers.clear()


def test_device_memory_stats_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tlog.device_memory_stats() == {}


def test_trace(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert any((tmp_path / "trace").iterdir())
