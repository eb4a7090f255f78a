"""The SE-SSD trainer (port of the training loop and the single-host
evaluation of ``sessd_tpu/train/trainer.py``): the host data path -> host
C++ rulebook chains -> one copy to the device -> the port's train step.

    loader (KittiDataset + GT-AUG + augmentation, threads)
      -> make_train_rulebook_transform (student and ``_raw`` teacher
         chains; int32 at batch 4, where the capacities exceed int16)
      -> H2D -> make_train_step (teacher fwd, student fwd + bwd, losses,
         AdamW, EMA)

Each loss term is logged every ``log_config.interval`` steps to the console
and to ``<work_dir>/train.log`` and ``log.json``. A checkpoint is written
every ``checkpoint_config.interval`` epochs and at the end of ``run``.

``validate`` runs the val split through the all-sparse serving plan on host
chains (the fused sparse conv kernels, streaming where the JAX package
streams), the predict path with the camera-frustum cull, and the official
KITTI AP. Resume with the schedule restart, ``load_from`` and multi-host
evaluation are not ported yet.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import builder
from ..data.kitti_eval import format_results
from ..data.loader import _stack_examples
from ..data.rulebooks import (build_batch_rulebooks,
                              make_train_rulebook_transform)
from ..models.predict import predict_batch
from ..serve import TRAIN_CAPS, saturated_stages
from ..utils import checkpoint as ckpt
from ..utils.native import ensure_native
from .train_step import TrainState, make_train_step, sigmoid_rampup

# batch keys the device step reads
_STEP_KEYS = ("voxels", "num_points", "labels", "reg_targets")
# eval batch keys padded to the full batch (trainer.py:777-784)
_EVAL_KEYS = ("voxels", "coords", "num_points", "voxel_mask", "frustum")


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
    step timed to the device's end) and every metric as a float.
    ``validate()`` returns the AP tables and appends a row to
    ``val_history``."""

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
        self.val_dataset = builder.build_dataset(cfg, "val", seed=seed)
        self.train_loader = builder.build_dataloader(
            cfg, self.train_dataset, shuffle=True, seed=seed)
        self.val_loader = builder.build_dataloader(
            cfg, self.val_dataset, shuffle=False, seed=seed)
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
        self.stage_capacity = tuple(cfg.get("stage_capacity") or TRAIN_CAPS)
        transform = make_train_rulebook_transform(
            student.sparse_shape, self.stage_capacity, suffixes=self.suffixes)
        if transform is None:
            raise RuntimeError("host rulebooks need native/rulebook.cpp")
        self.train_loader.batch_transform = transform
        self.anchors = torch.from_numpy(
            self.train_dataset.anchors.astype(np.float32)).to(self.device)
        self.predict_cfg = builder.build_predict_config(cfg)
        self.epoch = 0
        self.history: List[dict] = []
        self.val_history: List[dict] = []
        self._eval_fn = None
        self._eval_sat_warned = False
        self._saved_step = 0

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

    def save_checkpoint(self):
        """The state at the current epoch count (``utils/checkpoint``)."""
        path = ckpt.save_checkpoint(self.work_dir, self.state, self.epoch)
        self._saved_step = self.state.step
        self.logger.info(f"saved checkpoint at epoch {self.epoch}: {path}")

    def run(self, max_steps: Optional[int] = None) -> List[dict]:
        """Train for ``total_epochs`` or until ``max_steps`` steps; saves a
        checkpoint every ``checkpoint_config.interval`` epochs and at the
        end."""
        cfg = self.cfg
        interval = cfg.log_config.get("interval", 10)
        ckpt_interval = cfg.get("checkpoint_config", {}).get("interval", 1)
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
                if self.epoch % ckpt_interval == 0:
                    self.save_checkpoint()
        finally:
            json_log.close()
        if self.state.step != self._saved_step:
            self.save_checkpoint()
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

    # ------------------------------------------------------------------
    # evaluation (trainer.py:363-467, 592-636, 753-829)

    def _build_eval_fn(self):
        """``run(model, batch, rulebooks) -> dets``: the all-sparse serving
        plan of ``model`` (eval mode) on the batch's host chain, then
        ``predict_batch`` with the batch's camera frustum."""
        dev, anchors, pcfg = self.device, self.anchors, self.predict_cfg

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        @torch.inference_mode()
        def run(model, batch, rulebooks):
            vox = batch["voxels"]
            b, v = vox.shape[:2]
            rb = {k: ([put(a) for a in x] if isinstance(x, list) else put(x))
                  for k, x in rulebooks.items()}
            was_training = model.training
            model.eval()
            try:
                preds = model(put(vox).reshape(b * v, *vox.shape[2:]),
                              put(batch["num_points"]).reshape(b * v), rb, b)
            finally:
                model.train(was_training)
            return predict_batch(
                {k: x.float() for k, x in preds[0].items()}, anchors, pcfg,
                frustum_surfaces=put(batch["frustum"]).float())

        return run

    def _batch_rulebooks(self, batch):
        """The host C++ chain of a padded eval batch, with the capacity
        saturation warning (once per trainer): a full stage id table means
        truncated voxels, so degraded detections."""
        rb = build_batch_rulebooks(batch["coords"], batch["voxel_mask"],
                                   self.state.student.sparse_shape,
                                   self.stage_capacity)
        caps = [c * batch["coords"].shape[0] for c in self.stage_capacity]
        full = saturated_stages(rb, caps)
        if full and not self._eval_sat_warned:
            self.logger.warning(
                "EVAL CAP SATURATION at stages %s (rows %s): stage id table "
                "full — voxels may have been truncated (the chain reports no "
                "overflow count, so an exactly-full table also trips this); "
                "if truncated, detections are degraded — raise "
                "stage_capacity for this data density",
                full, [caps[i] for i in full])
            self._eval_sat_warned = True
        return rb

    def _eval_batch(self, batch, use_ema: bool) -> dict:
        """Pad a trailing batch to ``samples_per_gpu`` and run it; returns
        the detections as host numpy arrays, padding included."""
        full_b = self.cfg.data["samples_per_gpu"]
        nb = batch["voxels"].shape[0]
        if nb < full_b:
            batch = dict(batch, **{
                k: np.concatenate([batch[k], np.zeros(
                    (full_b - nb,) + batch[k].shape[1:], batch[k].dtype)])
                for k in _EVAL_KEYS})
        if self._eval_fn is None:
            self._eval_fn = self._build_eval_fn()
        model = self.state.teacher if use_ema else self.state.student
        dets = self._eval_fn(model, batch, self._batch_rulebooks(batch))
        return {k: v.cpu().numpy() for k, v in dets.items()}

    @staticmethod
    def _valid_dets(dets: dict, i: int, meta) -> dict:
        valid = dets["valid"][i]
        return {"box3d_lidar": dets["box3d_lidar"][i][valid],
                "scores": dets["scores"][i][valid],
                "label_preds": dets["label_preds"][i][valid],
                "metadata": meta}

    def predict_samples(self, indices, use_ema: bool = False) -> List[dict]:
        """Detections (lidar frame) of hand-picked val-set indices, aligned
        with ``indices`` (``tools/test --eval_ids``)."""
        full_b = self.cfg.data["samples_per_gpu"]
        examples = [self.val_dataset.get_sensor_data(int(i))
                    for i in indices]
        detections = []
        for off in range(0, len(examples), full_b):
            batch = _stack_examples(examples[off:off + full_b])
            dets = self._eval_batch(batch, use_ema)
            detections += [self._valid_dets(dets, i, meta)
                           for i, meta in enumerate(batch["metadata"])]
        return detections

    def validate(self, use_ema: bool = False,
                 max_batches: Optional[int] = None):
        """The student (or, with ``use_ema``, the teacher) over the val
        split -> official KITTI AP tables (None without ground truth).
        Single host."""
        detections = []
        batches = iter(self.val_loader)
        try:
            for bi, batch in enumerate(batches):
                if max_batches is not None and bi >= max_batches:
                    break
                dets = self._eval_batch(batch, use_ema)
                detections += [self._valid_dets(dets, i, meta)
                               for i, meta in enumerate(batch["metadata"])]
                if bi % 25 == 24:
                    self.logger.info(f"eval {len(detections)}/"
                                     f"{len(self.val_dataset)} samples")
        finally:
            batches.close()
        detections = detections[:len(self.val_dataset)]
        results, _ = self.val_dataset.evaluation(detections)
        if results is not None:
            self.logger.info("\n" + format_results(results))
        self._record_val(results, use_ema)
        return results

    def _record_val(self, results, use_ema: bool):
        """Append a compact AP row to ``val_history``."""
        if results is None:
            return
        row = {"epoch": self.epoch, "step": int(self.state.step),
               "ema": bool(use_ema)}
        for cls, tables in results.items():
            row[cls] = {m: {d: {k: round(float(v), 2)
                                for k, v in tables[m][d].items()}
                            for d in tables[m]}
                        for m in tables}
        self.val_history.append(row)
