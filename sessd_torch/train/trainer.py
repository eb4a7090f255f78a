"""The SE-SSD trainer (port of the training loop and the single-host
evaluation of ``sessd_tpu/train/trainer.py``): the host data path -> host
C++ rulebook chains -> one copy to the device -> the port's train step.

    loader (KittiDataset + GT-AUG + augmentation, threads)
      -> make_train_rulebook_transform (student and ``_raw`` teacher
         chains; int32 at batch 4, where the capacities exceed int16)
      -> pack_batch (``data.pack_targets``, on by default: sparse
         reg_targets, int8 labels, f16 voxels, int16 coords)
      -> H2D -> make_train_step (unpack, teacher fwd, student fwd + bwd,
         losses, AdamW, EMA)

The loop reads nothing back from the device between log points: every
``log_config.interval`` steps (and where ``max_steps`` or an epoch ends) one
bulk copy brings the pending steps' metrics to the host, and
``utils.logging.TextLogger`` writes the averaged line to the console,
``<work_dir>/train.log`` and ``log.json``; data_time and step_time are
averages over the interval. A checkpoint is written every
``checkpoint_config.interval`` epochs and at the end of ``run``; the val
split is evaluated every ``val_interval`` epochs before the last and once
at the end. ``resume`` continues a run from its own work dir; ``load_from``
is the warm start of SE-SSD from a CIA-SSD checkpoint (both nets from its
student, Adam moments kept, the schedule restarted).

``validate`` runs the val split through the all-sparse serving plan on host
chains (the fused sparse conv kernels, streaming where the JAX package
streams), the predict path with the camera-frustum cull, and the official
KITTI AP.

With ``data.host_rulebooks`` off (a model with stage capacities only;
trainer.py:146-157, 171-175, 365-378) the loader builds no chain: the
coords and masks go to the device and the step builds both chains there,
its saturation flags riding back with the metrics at the log points; an
eval batch's chain is built there too and runs the hybrid plan at the
student's ``dense_from_stage`` (K4 and cuDNN, BatchNorm in eval mode).

Data parallel (``parallel.mesh``, trainer.py:50-57, 67-78, 638-750): where
a process group is up (``init_distributed``), each process is one rank
with its own device and ``samples_per_gpu`` scenes per step. The train
loader reads the rank's shard of every epoch; both nets' BatchNorms take
their statistics over all ranks, the step averages gradients and metrics
over them, and the state starts from rank 0's (after init, ``resume`` and
``load_from``), so the ranks stay bit-equal. Rank 0 alone writes the run
context, checkpoints, ``train.log`` and ``log.json``; a barrier after each
checkpoint lets no rank read a half-written file. ``validate`` evaluates
the rank's shard of the val split, gathers fixed-shape detection buffers,
and rank 0 merges them by dataset index and computes the AP (the others
return None). Every rank must make the same calls in the same order.

The model builds its own third forward argument on the host
(``host_transform``): VoxelNet its rulebook chain, PointPillars its pillars'
coordinates and mask, with no chain (sessd_tpu/train/trainer.py:150-176);
VoxelNet's device twin is ``device_inputs``.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import builder
from ..data.kitti_eval import format_results
from ..data.loader import _stack_examples
from ..models.predict import predict_batch
from ..parallel import mesh
from ..serve import TRAIN_CAPS
from ..utils import checkpoint as ckpt
from ..utils.logging import (LogBuffer, TensorBoardLogger, TextLogger,
                             device_memory_stats, get_root_logger)
from ..utils.native import ensure_native
from .train_step import (TrainState, make_train_step, pack_batch,
                         sigmoid_rampup)

# batch keys the device step reads (reg_targets, or its packed
# ``reg_targets<sfx>_idx`` / ``_val``)
_STEP_KEYS = ("voxels", "num_points", "labels")
# eval batch keys padded to the full batch (trainer.py:777-784)
_EVAL_KEYS = ("voxels", "coords", "num_points", "voxel_mask", "frustum")
# the detection buffers a data-parallel eval gathers, one row per sample
_GATHER_KEYS = ("ids", "box3d_lidar", "scores", "label_preds", "valid")


def merge_rank_detections(gathered: dict, id_to_index: dict, n: int,
                          partial: bool = False) -> List[dict]:
    """Rank 0's merge of the gathered buffers ({key: [world, cap, ...]},
    ``_GATHER_KEYS``) into the detections of dataset indices 0..n-1, as
    ``validate`` lists them: the first row of each image id wins (the
    shards' wrap padding repeats samples), ids < 0 or outside the split
    are dropped, and an index no rank ran gets an empty entry. ``partial``
    (an eval cut by ``max_batches``) lists only as many indices as were
    run (trainer.py:718-736)."""
    ids = gathered["ids"]
    by_index = {}
    for r, row in np.ndindex(ids.shape):
        di = id_to_index.get(int(ids[r, row]))
        if ids[r, row] < 0 or di is None or di in by_index:
            continue
        v = gathered["valid"][r, row]
        by_index[di] = {"box3d_lidar": gathered["box3d_lidar"][r, row][v],
                        "scores": gathered["scores"][r, row][v],
                        "label_preds": gathered["label_preds"][r, row][v],
                        "metadata": {"image_idx": int(ids[r, row])}}
    boxes, scores, labels = (gathered[k] for k in _GATHER_KEYS[1:4])
    empty = {"box3d_lidar": np.zeros((0, boxes.shape[-1]), boxes.dtype),
             "scores": np.zeros((0,), scores.dtype),
             "label_preds": np.zeros((0,), labels.dtype), "metadata": None}
    n_eval = min(n, len(by_index)) if partial else n
    return [by_index.get(i, empty) for i in range(n_eval)]


class _LogState:
    """What the training loop carries between log points: the text and
    TensorBoard loggers, the metrics buffer, and the steps whose metrics
    are still on the device."""

    def __init__(self, text: TextLogger, tb, max_steps: Optional[int]):
        self.text, self.tb, self.max_steps = text, tb, max_steps
        self.buf = LogBuffer()
        self.pending: list = []   # (host record, stacked metrics tensor)
        self.keys: list = []      # the metric names, in stacking order
        self.t_int = time.perf_counter()


class Trainer:
    """``Trainer(cfg, work_dir).run(max_steps=N)``; ``history`` holds one
    dict per step: step, epoch, lr (the one the step applied), data_time
    (the loader wait before the step), step_time (seconds: the average over
    the steps read back together, less their data time) and every metric
    as a float. ``validate()`` returns the AP tables and appends a row to
    ``val_history``."""

    def __init__(self, cfg, work_dir: Optional[str] = None, seed: int = 0,
                 device="cuda", distributed: bool = True):
        self.cfg = cfg
        self.work_dir = work_dir or cfg.work_dir
        self.seed = seed
        # data parallel where a process group is up, one of any size (a
        # group of one still runs its collectives); ``distributed=False``
        # keeps this trainer out of it
        self.group = (dist.group.WORLD if distributed and dist.is_available()
                      and dist.is_initialized() else None)
        self.rank = dist.get_rank() if self.group is not None else 0
        self.world = dist.get_world_size() if self.group is not None else 1
        os.makedirs(self.work_dir, exist_ok=True)
        self.logger = get_root_logger(self.work_dir, rank=self.rank)
        self.device = torch.device(device)
        # the host library is whole before any loader thread loads it
        ensure_native()

        self.train_dataset = builder.build_dataset(cfg, "train", seed=seed)
        self.val_dataset = builder.build_dataset(cfg, "val", seed=seed)
        self.train_loader = builder.build_dataloader(
            cfg, self.train_dataset, shuffle=True, seed=seed,
            num_shards=self.world, shard_index=self.rank)
        self.val_loader = builder.build_dataloader(
            cfg, self.val_dataset, shuffle=False, seed=seed)
        self._rank_val_loader = None
        self.enable_ssl = bool(cfg.get("my_paras", {}).get("enable_ssl",
                                                           True))

        student = builder.build_detector(cfg, process_group=self.group)
        student.reset_parameters(torch.Generator().manual_seed(seed))
        # the teacher is inference-shaped (no grads), so it may take another
        # execution plan; the parameter tree is the same
        teacher = builder.build_detector(
            cfg, dense_from_stage=cfg.get("teacher_dense_from_stage"),
            process_group=self.group)
        teacher.load_state_dict(student.state_dict())
        student.to(self.device)
        teacher.to(self.device).requires_grad_(False)
        optimizer, self.lr_fn = builder.build_optimizer_from_cfg(
            cfg, len(self.train_loader), list(student.parameters()))
        self.state = TrainState(0, student, teacher, optimizer)
        self.train_step = make_train_step(
            builder.build_loss_config(cfg),
            ema_decay_cap=cfg.get("ema_decay_cap", 0.999),
            enable_ssl=self.enable_ssl, process_group=self.group)

        self.suffixes = ("", "_raw") if self.enable_ssl else ("",)
        self.stage_capacity = tuple(cfg.get("stage_capacity") or TRAIN_CAPS)
        # the model's third forward argument: built by the loader on the
        # host, or, with ``data.host_rulebooks`` off, the chain of a model
        # with stage capacities built on the device from the staged coords
        # and masks (trainer.py:146-157, 171-175)
        self.host_inputs = (bool(cfg.data.get("host_rulebooks", True))
                            or not hasattr(student, "stage_capacity"))
        # compress each train batch for its copy to the device
        # (``train_step.pack_batch``: sparse reg_targets, int8 labels, f16
        # voxels), on by default as in the JAX trainer (trainer.py:283-287)
        self.pack_targets = bool(cfg.data.get("pack_targets", True))
        if self.host_inputs:
            self.train_loader.batch_transform = student.host_transform(
                self.stage_capacity, self.suffixes)
        self.anchors = torch.from_numpy(
            self.train_dataset.anchors.astype(np.float32)).to(self.device)
        self.predict_cfg = builder.build_predict_config(cfg)
        self.epoch = 0
        self.history: List[dict] = []
        self.val_history: List[dict] = []
        # the per-image detections the last validate() scored (rank 0's
        # merge in data parallel; None on the other ranks)
        self.val_detections: Optional[List[dict]] = None
        self._eval_fn = None
        self._eval_sat_warned = False
        self._sat_warned = False
        self._sat_batches = 0
        self._sat_total = 0
        self._saved_step = 0
        self._replicate()
        self._snapshot_run_context()

    @property
    def saturated_batches(self) -> int:
        """Training batches of this trainer's life whose chain saturated a
        stage (truncated voxels); the per-epoch count resets, this one
        does not."""
        return self._sat_total

    def rank_report(self) -> dict:
        """What this rank of a run reports, to be held against the other
        ranks': its rank and world size, its step count and history, its
        saturated batches and the digest of its state."""
        return {"rank": self.rank, "world": self.world,
                "step": self.state.step, "history": self.history,
                "saturated": self.saturated_batches,
                "digest": mesh.state_digest(self.state)}

    def _replicate(self, found: bool = False) -> bool:
        """Rank 0's state and epoch on every rank (no-op outside data
        parallel); returns rank 0's ``found``."""
        if self.group is None:
            return found
        mesh.replicate(self.state, self.group)
        self.epoch, found = mesh.broadcast_ints(
            [self.epoch, found], self.device, self.group)
        return bool(found)

    def _device_batch(self, batch: dict) -> dict:
        """The step's inputs as device tensors. On a CUDA device each
        array goes through pinned memory with a non-blocking copy, so the
        host does not wait for the previous step's device work."""
        dev = self.device
        pin = dev.type == "cuda"

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.pin_memory() if pin else t).to(dev, non_blocking=pin)

        out = {}
        for sfx in self.suffixes:
            targets = [f"reg_targets{sfx}_idx", f"reg_targets{sfx}_val"] \
                if f"reg_targets{sfx}_idx" in batch else ["reg_targets" + sfx]
            for k in [k + sfx for k in _STEP_KEYS] + targets:
                out[k] = put(batch[k])
            if not self.host_inputs:
                out["coords" + sfx] = put(batch["coords" + sfx])
                out["voxel_mask" + sfx] = put(batch["voxel_mask" + sfx])
                continue
            out["inputs" + sfx] = {
                k: ([put(a) for a in v] if isinstance(v, list) else put(v))
                for k, v in batch["inputs" + sfx].items()}
        if self.enable_ssl:
            out["transformation"] = {k: put(v) for k, v in
                                     batch["transformation"].items()}
        b = batch["voxels"].shape[0]
        out["anchors"] = self.anchors.expand(b, *self.anchors.shape)
        return out

    def _snapshot_run_context(self):
        """Record the run's recipe in the work dir (trainer.py:181-213): the
        config text, the git revision, and the torch version and device.
        Observability only: a failure never stops training. Rank 0 only."""
        if self.rank != 0:
            return
        try:
            text = getattr(self.cfg, "text", "")
            if text:
                with open(os.path.join(self.work_dir, "config_snapshot.py"),
                          "w") as f:
                    f.write(text)
            try:
                sha = subprocess.run(
                    ["git", "rev-parse", "HEAD"], capture_output=True,
                    text=True, timeout=10,
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                ).stdout.strip()
            except Exception:
                sha = ""
            device = (torch.cuda.get_device_name(self.device)
                      if self.device.type == "cuda" else str(self.device))
            with open(os.path.join(self.work_dir, "run_env.txt"), "w") as f:
                f.write(f"git_sha: {sha}\n")
                f.write(f"torch: {torch.__version__}\n")
                f.write(f"cuda: {torch.version.cuda}\n")
                f.write(f"device: {device}\n")
        except Exception as e:
            self.logger.debug(f"run-context snapshot failed: {e}")

    def save_checkpoint(self):
        """The state at the current epoch count (``utils/checkpoint``),
        written by rank 0; every rank waits for the file."""
        if self.rank == 0:
            path = ckpt.save_checkpoint(self.work_dir, self.state, self.epoch)
            self.logger.info(f"saved checkpoint at epoch {self.epoch}: "
                             f"{path}")
        if self.group is not None:
            dist.barrier(group=self.group)
        self._saved_step = self.state.step

    def resume(self):
        """Continue the run of ``work_dir`` from its latest checkpoint
        (trainer.py:216-222): both nets, the optimizer, the step and the
        epoch; rank 0's on every rank."""
        state, epoch = ckpt.load_checkpoint(self.work_dir, self.state)
        if state is not None:
            self.epoch = epoch
        if self._replicate(state is not None):
            self._saved_step = self.state.step
            self.logger.info(f"resumed from epoch {self.epoch}")

    def load_from(self, pretrained_dir):
        """Warm start from the latest checkpoint under ``pretrained_dir``
        (trainer.py:224-229, ``checkpoint.load_params_only``); rank 0's on
        every rank."""
        found = ckpt.load_params_only(pretrained_dir, self.state) is not None
        if self._replicate(found):
            self.logger.info(f"warm start (student+teacher) from "
                             f"{pretrained_dir}")
        else:
            self.logger.warning(f"load_from: no checkpoint under "
                                f"{pretrained_dir}")

    def run(self, max_steps: Optional[int] = None):
        """Train until ``total_epochs``, or until ``history`` holds
        ``max_steps`` steps. Saves a checkpoint every
        ``checkpoint_config.interval`` epochs and at the end, validates
        every ``val_interval`` epochs before the last and once at the end
        (trainer.py:254-360). Returns the final validation's AP tables;
        None when ``max_steps`` cut the run, which then skips that
        validation."""
        cfg = self.cfg
        total = cfg.total_epochs
        iters = len(self.train_loader)
        lead = self.rank == 0
        log = _LogState(
            TextLogger(self.logger, cfg.log_config.get("interval", 10),
                       total_iters=total * iters,
                       json_path=os.path.join(self.work_dir, "log.json")
                       if lead else None),
            TensorBoardLogger(os.path.join(self.work_dir, "tb"))
            if lead and cfg.log_config.get("tensorboard", False) else None,
            max_steps)
        ckpt_interval = cfg.get("checkpoint_config", {}).get("interval", 1)
        val_interval = cfg.get("val_interval", 0)
        rampup = cfg.get("consistency_rampup_epochs", 15.0)
        cut = False
        try:
            while self.epoch < total:
                self.train_loader.set_epoch(self.epoch)
                cw = (sigmoid_rampup(self.epoch, rampup) if self.enable_ssl
                      else 0.0)
                batches = iter(self.train_loader)
                try:
                    cut = self._epoch(batches, cw, log)
                finally:
                    batches.close()  # joins the loader's prefetch threads
                if cut:
                    break
                self.epoch += 1
                if self._sat_batches:
                    self.logger.warning(
                        "epoch %d: %d batch(es) hit train cap saturation "
                        "(truncated voxels — see the first warning above)",
                        self.epoch, self._sat_batches)
                    self._sat_batches = 0
                if self.epoch % ckpt_interval == 0:
                    self.save_checkpoint()
                if (val_interval and self.epoch % val_interval == 0
                        and self.epoch < total):
                    self.validate()
        finally:
            if log.tb is not None:
                log.tb.close()
        if self.state.step != self._saved_step:
            self.save_checkpoint()
        return None if cut else self.validate()

    def _epoch(self, batches, cw, log: "_LogState") -> bool:
        """One pass over ``batches``; True once ``max_steps`` is reached.
        Between log points nothing is read from the device: each step's
        metrics stay there, stacked into one vector."""
        iters = len(self.train_loader)
        log.t_int = t_data = time.perf_counter()
        for it, batch in enumerate(batches):
            data_time = time.perf_counter() - t_data
            if self.host_inputs:
                self._check_train_saturation(batch)
            if self.pack_targets:
                batch = pack_batch(batch)
            opt = self.state.optimizer
            metrics = self.train_step(self.state, self._device_batch(batch),
                                      cw)
            # device chains' full stages ride behind the metrics, read
            # back with them at the log point
            sat = metrics.pop("saturated", None)
            log.keys = list(metrics)
            values = torch.stack([v.float() for v in metrics.values()])
            if sat is not None:
                values = torch.cat([values, sat.reshape(-1).float()])
            log.pending.append((
                {"step": self.state.step, "epoch": self.epoch + 1,
                 "lr": opt.hyperparams["learning_rate"],
                 "data_time": data_time}, values))
            done = (log.max_steps is not None and
                    len(self.history) + len(log.pending) >= log.max_steps)
            if log.text.will_log():
                self._log_interval(log, it, iters)
            else:
                log.text.step(self.epoch + 1, it, iters, {})
            if done:
                self._flush(log)
                return True
            t_data = time.perf_counter()
        self._flush(log)  # the epoch's boundary work stays out of the timing
        return False

    def _flush(self, log: "_LogState"):
        """Read the pending steps' metrics back in one copy and append their
        rows to ``history``. Returns (rows, mean data_time, step_time):
        step_time is the wall time since the interval began, less the data
        time, per step."""
        if not log.pending:
            return [], 0.0, 0.0
        values = torch.stack([v for _, v in log.pending]).cpu().tolist()
        now = time.perf_counter()
        n = len(log.pending)
        data = sum(rec["data_time"] for rec, _ in log.pending)
        step_time = max((now - log.t_int - data) / n, 0.0)
        rows = []
        caps = [c * self.cfg.data["samples_per_gpu"]
                for c in self.stage_capacity]
        for (rec, _), vals in zip(log.pending, values):
            rec["step_time"] = step_time
            rec.update(zip(log.keys, vals))
            rows.append(rec)
            full = vals[len(log.keys):]  # [chains x 5] of a device step
            self._note_saturation(
                [("coords" + sfx, i, c, c) for j, sfx in
                 enumerate(self.suffixes) for i, c in enumerate(caps)
                 if full and full[j * len(caps) + i]])
        self.history += rows
        log.pending = []
        log.t_int = now
        return rows, data / n, step_time

    def _log_interval(self, log: "_LogState", it: int, iters: int):
        """The log point (trainer.py:315-337): one read-back, then the
        averaged line, ``log.json`` row and TensorBoard scalars."""
        rows, data_time, step_time = self._flush(log)
        log.buf.update({k: rows[-1][k] for k in log.keys})
        avg = log.buf.average(10)
        mem = device_memory_stats()
        if mem.get("peak_bytes_in_use"):
            avg["peak_hbm_gb"] = mem["peak_bytes_in_use"] / 2 ** 30
        log.text.step(self.epoch + 1, it, iters, avg,
                      lr=self.lr_fn(self.state.optimizer.sched_count),
                      data_time=data_time, step_time=step_time)
        if log.tb is not None:
            log.tb.log(avg, self.state.step)

    def _check_train_saturation(self, batch):
        """Per-batch capacity guard on the loader-built model inputs
        (trainer.py:498-540). A stage whose id table is FULL has truncated
        voxels: the rest of that sample's scene contributes zero features.
        That is an accuracy fault, so every batch is checked (a few numpy
        sums) and the first one is warned about loudly; the count per epoch
        follows at the epoch's end."""
        self._note_saturation([("inputs" + sfx, *h) for sfx in self.suffixes
                               for h in batch["saturated" + sfx]])

    def _note_saturation(self, hit):
        """Count one batch whose chains saturated the stages ``hit`` lists
        as (chain, stage, rows, rows cap), and warn at the first."""
        if not hit:
            return
        self._sat_batches += 1
        self._sat_total += 1
        if not self._sat_warned:
            self.logger.warning(
                "TRAIN CAP SATURATION: %s — stage id table full; voxels past "
                "a full stage are silently dropped (those samples train on "
                "truncated or EMPTY features; an exactly-full table with "
                "zero drops also trips this — the builder reports no "
                "overflow count). Raise stage_capacity for this data "
                "density. Counting saturated batches; per-epoch totals "
                "follow.", ", ".join(f"{n} stage {i}: {o}/{c} rows"
                                     for n, i, o, c in hit))
            self._sat_warned = True

    # ------------------------------------------------------------------
    # evaluation (trainer.py:363-467, 592-636, 753-829)

    def _build_eval_fn(self):
        """``run(model, batch, inputs) -> (dets, saturated)``: ``model`` in
        eval mode on the batch's host inputs through the all-sparse serving
        plan (saturated None) or, with ``inputs`` None, on a chain built on
        the device through the hybrid plan at the student's
        ``dense_from_stage`` (K4 on the sparse stages, cuDNN on the dense
        ones; trainer.py:365-378; saturated [5] bool on the device); then
        ``predict_batch`` with the batch's camera frustum."""
        dev, anchors, pcfg = self.device, self.anchors, self.predict_cfg
        dfs = getattr(self.state.student, "dense_from_stage", None)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        @torch.inference_mode()
        def run(model, batch, inputs):
            vox = batch["voxels"]
            b, v = vox.shape[:2]
            sat, plan = None, {}
            if inputs is None:
                rb, sat = model.device_inputs(
                    put(batch["coords"]), put(batch["voxel_mask"]), b,
                    self.stage_capacity)
                plan = {"train": True, "dense_from_stage": dfs}
            else:
                rb = {k: ([put(a) for a in x] if isinstance(x, list)
                          else put(x)) for k, x in inputs.items()}
            was_training = model.training
            model.eval()
            try:
                preds = model(put(vox).reshape(b * v, *vox.shape[2:]),
                              put(batch["num_points"]).reshape(b * v), rb, b,
                              **plan)
            finally:
                model.train(was_training)
            return predict_batch(
                {k: x.float() for k, x in preds[0].items()}, anchors, pcfg,
                frustum_surfaces=put(batch["frustum"]).float()), sat

        return run

    def _eval_inputs(self, batch):
        """The model's host inputs for a padded eval batch (VoxelNet: its
        C++ chain; None where the chain is built on the device), with the
        capacity saturation warning."""
        if not self.host_inputs:
            return None
        out = self.state.student.host_transform(self.stage_capacity)(batch)
        self._eval_saturation([(i, c) for i, _, c in out["saturated"]])
        return out["inputs"]

    def _eval_saturation(self, full):
        """Warn once per trainer of an eval chain's full stages, listed as
        (stage, rows cap): a full stage id table means truncated voxels,
        so degraded detections."""
        if full and not self._eval_sat_warned:
            self.logger.warning(
                "EVAL CAP SATURATION at stages %s (rows %s): stage id table "
                "full — voxels may have been truncated (the chain reports no "
                "overflow count, so an exactly-full table also trips this); "
                "if truncated, detections are degraded — raise "
                "stage_capacity for this data density",
                [i for i, _ in full], [c for _, c in full])
            self._eval_sat_warned = True

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
        dets, sat = self._eval_fn(model, batch, self._eval_inputs(batch))
        out = {k: v.cpu().numpy() for k, v in dets.items()}
        if sat is not None:  # read with the detections, no extra wait
            self._eval_saturation([(i, c * full_b) for i, (s, c) in
                                   enumerate(zip(sat.tolist(),
                                                 self.stage_capacity)) if s])
        return out

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
        Data parallel: ``_validate_ranks``, and None on every rank but 0."""
        if self.group is not None:
            return self._validate_ranks(use_ema, max_batches)
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
        self.val_detections = detections
        results, _ = self.val_dataset.evaluation(detections)
        if results is not None:
            self.logger.info("\n" + format_results(results))
        self._record_val(results, use_ema)
        return results

    def _validate_ranks(self, use_ema: bool, max_batches: Optional[int]):
        """The eval of a data-parallel run (trainer.py:638-750): each rank
        runs its shard of the val split (the loader's padded-equal shards,
        the trailing batch padded), fills fixed-shape buffers of
        ceil(len(val) / world) rows (image ids, -1 where unused; boxes
        [post, 7], scores, labels and valid flags [post]) and gathers them;
        rank 0 merges them by dataset index and computes the AP, the others
        return None. All ranks must call it with the same ``max_batches``."""
        if self._rank_val_loader is None:
            self._rank_val_loader = builder.build_dataloader(
                self.cfg, self.val_dataset, shuffle=False, seed=self.seed,
                num_shards=self.world, shard_index=self.rank)
        full_b = self.cfg.data["samples_per_gpu"]
        cap = -(-len(self.val_dataset) // self.world)
        if max_batches is not None:
            cap = min(cap, max_batches * full_b)
        rows = []  # (image id, boxes, scores, labels, valid) per sample
        batches = iter(self._rank_val_loader)
        try:
            for bi, batch in enumerate(batches):
                if max_batches is not None and bi >= max_batches:
                    break
                dets = self._eval_batch(batch, use_ema)
                rows += [(int(meta["image_idx"]), dets["box3d_lidar"][i],
                          dets["scores"][i], dets["label_preds"][i],
                          dets["valid"][i])
                         for i, meta in enumerate(batch["metadata"])]
        finally:
            batches.close()
        rows = rows[:cap]
        bufs = [np.full((cap,), -1, np.int64)] + [
            np.zeros((cap,) + a.shape, a.dtype) for a in rows[0][1:]]
        for r, row in enumerate(rows):
            for buf, a in zip(bufs, row):
                buf[r] = a
        gathered = mesh.all_gather_detections(
            {k: torch.from_numpy(b) for k, b in zip(_GATHER_KEYS, bufs)},
            self.group)
        if self.rank != 0:
            return None
        detections = merge_rank_detections(
            {k: v.numpy() for k, v in gathered.items()},
            {int(info["image"]["image_idx"]): i
             for i, info in enumerate(self.val_dataset.infos)},
            len(self.val_dataset), partial=max_batches is not None)
        self.val_detections = detections
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
