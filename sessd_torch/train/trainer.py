"""A minimal SE-SSD trainer (port of the training loop of
``sessd_tpu/train/trainer.py``): the JAX package's host data path -> host
C++ rulebook chains -> one copy to the device -> the port's train step.

    loader (KittiDataset + GT-AUG + augmentation, threads)
      -> make_train_rulebook_transform (student and ``_raw`` teacher
         chains; int32 at batch 4, where the capacities exceed int16)
      -> H2D -> make_train_step (teacher fwd, student fwd + bwd, losses,
         AdamW, EMA)

Each loss term is logged every ``log_config.interval`` steps to the console
and to ``<work_dir>/train.log`` and ``log.json``. Checkpoints, resume,
``load_from``, validation and evaluation are not ported yet.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from sessd_tpu.data.rulebooks import make_train_rulebook_transform
from sessd_tpu.serve import TRAIN_CAPS

from .. import builder
from ..utils.native import ensure_native
from .train_step import TrainState, make_train_step, sigmoid_rampup

# batch keys the device step reads
_STEP_KEYS = ("voxels", "num_points", "labels", "reg_targets")


def _logger(work_dir: str) -> logging.Logger:
    log = logging.getLogger(f"sessd_torch.train.{work_dir}")
    if not log.handlers:
        log.setLevel(logging.INFO)
        fmt = logging.Formatter("%(asctime)s %(message)s")
        for h in (logging.StreamHandler(),
                  logging.FileHandler(os.path.join(work_dir, "train.log"))):
            h.setFormatter(fmt)
            log.addHandler(h)
    return log


class Trainer:
    """``Trainer(cfg, work_dir).run(max_steps=N)``; ``history`` holds one
    dict per step: step, epoch, lr, data_time and step_time (seconds, the
    step timed to the device's end) and every metric as a float."""

    def __init__(self, cfg, work_dir: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.work_dir = work_dir or cfg.work_dir
        os.makedirs(self.work_dir, exist_ok=True)
        self.logger = _logger(self.work_dir)
        self.device = torch.device(device)
        # the host library is whole before any loader thread loads it
        ensure_native()

        self.train_dataset = builder.build_dataset(cfg, "train", seed=seed)
        self.train_loader = builder.build_dataloader(
            cfg, self.train_dataset, shuffle=True, seed=seed)
        self.enable_ssl = bool(cfg.get("my_paras", {}).get("enable_ssl",
                                                           True))

        student = builder.build_detector(cfg)
        student.reset_parameters(torch.Generator().manual_seed(seed))
        # the teacher is inference-shaped (no grads), so it may take another
        # execution plan; the parameter tree is the same
        teacher = builder.build_detector(
            cfg, dense_from_stage=cfg.get("teacher_dense_from_stage"))
        teacher.load_state_dict(student.state_dict())
        student.to(self.device)
        teacher.to(self.device).requires_grad_(False)
        optimizer, self.lr_fn = builder.build_optimizer_from_cfg(
            cfg, len(self.train_loader), list(student.parameters()))
        self.state = TrainState(0, student, teacher, optimizer)
        self.train_step = make_train_step(
            builder.build_loss_config(cfg),
            ema_decay_cap=cfg.get("ema_decay_cap", 0.999),
            enable_ssl=self.enable_ssl)

        self.suffixes = ("", "_raw") if self.enable_ssl else ("",)
        caps = tuple(cfg.get("stage_capacity") or TRAIN_CAPS)
        transform = make_train_rulebook_transform(
            student.sparse_shape, caps, suffixes=self.suffixes)
        if transform is None:
            raise RuntimeError("host rulebooks need native/rulebook.cpp")
        self.train_loader.batch_transform = transform
        self.anchors = torch.from_numpy(
            self.train_dataset.anchors.astype(np.float32)).to(self.device)
        self.epoch = 0
        self.history: List[dict] = []

    def _device_batch(self, batch: dict) -> dict:
        """The step's inputs as device tensors; each rulebook leaf drops the
        loader's leading shard axis (one shard)."""
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        out = {}
        for sfx in self.suffixes:
            for k in _STEP_KEYS:
                out[k + sfx] = put(batch[k + sfx])
            out["rulebooks" + sfx] = {
                k: ([put(a[0]) for a in v] if isinstance(v, list)
                    else put(v[0]))
                for k, v in batch["rulebooks" + sfx].items()}
        if self.enable_ssl:
            out["transformation"] = {k: put(v) for k, v in
                                     batch["transformation"].items()}
        b = batch["voxels"].shape[0]
        out["anchors"] = self.anchors.expand(b, *self.anchors.shape)
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, max_steps: Optional[int] = None) -> List[dict]:
        """Train for ``total_epochs`` or until ``max_steps`` steps."""
        cfg = self.cfg
        interval = cfg.log_config.get("interval", 10)
        rampup = cfg.get("consistency_rampup_epochs", 15.0)
        json_log = open(os.path.join(self.work_dir, "log.json"), "a")
        try:
            while self.epoch < cfg.total_epochs:
                self.train_loader.set_epoch(self.epoch)
                cw = (sigmoid_rampup(self.epoch, rampup) if self.enable_ssl
                      else 0.0)
                batches = iter(self.train_loader)
                try:
                    if self._epoch(batches, cw, interval, json_log,
                                   max_steps):
                        break
                finally:
                    batches.close()  # joins the loader's prefetch threads
                self.epoch += 1
        finally:
            json_log.close()
        return self.history

    def _epoch(self, batches, cw, interval, json_log, max_steps) -> bool:
        """One pass over ``batches``; True once ``max_steps`` is reached."""
        t_data = time.perf_counter()
        for batch in batches:
            t0 = time.perf_counter()
            step = self.state.step
            metrics = self.train_step(self.state, self._device_batch(batch),
                                      cw)
            self._sync()
            t1 = time.perf_counter()
            rec = {"step": step + 1, "epoch": self.epoch + 1,
                   "lr": self.lr_fn(step), "data_time": t0 - t_data,
                   "step_time": t1 - t0}
            rec.update({k: float(v) for k, v in metrics.items()})
            self.history.append(rec)
            if (step + 1) % interval == 0:
                self.logger.info(" ".join(
                    f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in rec.items()))
                json_log.write(json.dumps(rec) + "\n")
            if max_steps is not None and len(self.history) >= max_steps:
                return True
            t_data = time.perf_counter()
        return False
