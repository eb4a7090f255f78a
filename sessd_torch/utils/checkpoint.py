"""Checkpoints of a training run through ``torch.save`` (the counterpart of
``sessd_tpu/utils/checkpoint.py``, which keeps one orbax tree per epoch):
student, EMA teacher (BatchNorm statistics included in their state dicts),
the optimizer's moments and its two counts (Adam's and the schedule's),
the step count and the epoch, in one file per epoch,
``<work_dir>/checkpoints/epoch_<n>.pt``.

``load_checkpoint`` restores a whole state (resume); ``load_params_only``
is the warm start of SE-SSD from a CIA-SSD checkpoint.
"""
from __future__ import annotations

import os
import pathlib
import re
import tempfile
from typing import Optional

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt$")


def _dir(work_dir) -> pathlib.Path:
    return pathlib.Path(work_dir) / "checkpoints"


def checkpoint_path(work_dir, epoch: int) -> pathlib.Path:
    return _dir(work_dir) / f"epoch_{int(epoch)}.pt"


def latest_epoch(work_dir) -> Optional[int]:
    """The highest epoch with a checkpoint under ``work_dir``, or None."""
    d = _dir(work_dir)
    epochs = [int(m.group(1)) for f in (d.iterdir() if d.is_dir() else ())
              if (m := _NAME.match(f.name))]
    return max(epochs, default=None)


def save_checkpoint(work_dir, state, epoch: int) -> pathlib.Path:
    """Write ``state`` (a ``train_step.TrainState``) at an epoch boundary;
    the file appears whole, through one rename."""
    path = checkpoint_path(work_dir, epoch)
    path.parent.mkdir(parents=True, exist_ok=True)
    opt = state.optimizer
    blob = {"epoch": int(epoch), "step": int(state.step),
            "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict(),
            "optimizer": {"count": int(opt.count),
                          "sched_count": int(opt.sched_count),
                          "mu": list(opt.mu), "nu": list(opt.nu)}}
    fd, tmp = tempfile.mkstemp(prefix=path.name, dir=path.parent)
    os.close(fd)
    try:
        torch.save(blob, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load(work_dir, epoch: Optional[int]):
    if epoch is None:
        epoch = latest_epoch(work_dir)
    if epoch is None or not checkpoint_path(work_dir, epoch).exists():
        return None
    return torch.load(checkpoint_path(work_dir, epoch), map_location="cpu",
                      weights_only=True)


def load_checkpoint(work_dir, state, epoch: Optional[int] = None):
    """Restore the checkpoint of ``epoch`` (default: the latest) into
    ``state`` in place, on the devices its tensors already live on.
    Returns (state, epoch), or (None, None) when there is none. A
    checkpoint written before the optimizer's two counts were split loads
    with the schedule count equal to Adam's."""
    blob = _load(work_dir, epoch)
    if blob is None:
        return None, None
    state.student.load_state_dict(blob["student"])
    state.teacher.load_state_dict(blob["teacher"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = blob["step"]
    return state, blob["epoch"]


def load_params_only(work_dir, state, epoch: Optional[int] = None):
    """Warm start (sessd_tpu/utils/checkpoint.py:96-109): the checkpoint's
    student weights and BatchNorm statistics into both student and
    teacher, its Adam moments and count restored, the lr and beta1
    schedules restarted; ``state.step`` stays, so the EMA's alpha starts
    from step 0 again. In place; returns ``state``, or None when there is
    no checkpoint."""
    blob = _load(work_dir, epoch)
    if blob is None:
        return None
    state.student.load_state_dict(blob["student"])
    state.teacher.load_state_dict(blob["student"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.optimizer.restart_schedule()
    return state
