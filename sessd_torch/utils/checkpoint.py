"""Checkpoints of a training run through ``torch.save`` (the counterpart of
``sessd_tpu/utils/checkpoint.py``, which keeps one orbax tree per epoch):
student, EMA teacher (BatchNorm statistics included in their state dicts),
the optimizer's moments and update count, the step count and the epoch, in
one file per epoch, ``<work_dir>/checkpoints/epoch_<n>.pt``.

Resume with the schedule restart and the ``load_from`` warm start are not
ported yet.
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


def load_checkpoint(work_dir, state, epoch: Optional[int] = None):
    """Restore the checkpoint of ``epoch`` (default: the latest) into
    ``state`` in place, on the devices its tensors already live on.
    Returns (state, epoch), or (None, None) when there is none."""
    if epoch is None:
        epoch = latest_epoch(work_dir)
    if epoch is None or not checkpoint_path(work_dir, epoch).exists():
        return None, None
    blob = torch.load(checkpoint_path(work_dir, epoch), map_location="cpu",
                      weights_only=True)
    state.student.load_state_dict(blob["student"])
    state.teacher.load_state_dict(blob["teacher"])
    opt = state.optimizer
    opt.count = blob["optimizer"]["count"]
    for mine, theirs in ((opt.mu, blob["optimizer"]["mu"]),
                         (opt.nu, blob["optimizer"]["nu"])):
        for m, t in zip(mine, theirs, strict=True):
            m.copy_(t)
    state.step = blob["step"]
    return state, blob["epoch"]
