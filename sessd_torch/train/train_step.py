"""The SE-SSD training step (port of ``sessd_tpu/train/train_step.py``):
teacher forward, student forward and backward, every loss term, clipped
one-cycle AdamW and the EMA update (trainer_sessd.py:248-360).

The teacher is a second ``VoxelNet`` holding the EMA parameters; it runs
in training mode under ``no_grad``, so its BatchNorm layers normalize with
batch statistics and move their own running statistics, which are the
EMA batch stats (not an average of the student's). ``alpha = min(1 -
1/(step+1), cap)`` is taken before the step counter moves. The modules are
updated in place; the step returns its metrics as 0-dim tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import all_reduce_mean_
from .losses import LossConfig, consistency_loss, detection_loss
from .optim import AdamW


@dataclass
class TrainState:
    step: int
    student: torch.nn.Module      # params + batch_stats
    teacher: torch.nn.Module      # ema_params + ema_batch_stats
    optimizer: AdamW              # opt_state, over student.parameters()


def sigmoid_rampup(epoch, rampup_epochs: float = 15.0) -> float:
    """Consistency-weight ramp (trainer_sessd.py:305-312)."""
    current = np.clip(np.float32(epoch), 0.0, rampup_epochs)
    phase = np.float32(1.0) - current / np.float32(rampup_epochs)
    return float(np.exp(np.float32(-5.0) * phase * phase))


def _flat(model, batch: dict, suffix: str, saturated: list):
    """Loader layout [B, V, ...] -> the model's (voxels [B*V, P, F],
    num_points [B*V], third forward argument, B). A batch without
    ``inputs<sfx>`` carries ``coords<sfx>`` and ``voxel_mask<sfx>``
    instead, and the model builds its chain from them on the device
    (sessd_tpu/train/train_step.py:202-225 with ``rulebooks=None``); its
    saturation flags go to ``saturated``."""
    vox = batch["voxels" + suffix]
    b, v = vox.shape[:2]
    inputs = batch.get("inputs" + suffix)
    if inputs is None:
        inputs, sat = model.device_inputs(batch["coords" + suffix],
                                          batch["voxel_mask" + suffix], b)
        saturated.append(sat)
    return (vox.reshape(b * v, *vox.shape[2:]),
            batch["num_points" + suffix].reshape(b * v), inputs, b)


PACK_POS_CAP = 1024  # >> the positive anchors of a sample (~200 at 15 cars)


def pack_batch(batch: dict, pos_cap: int = PACK_POS_CAP) -> dict:
    """Host-side compression of a train batch for the copy to the device
    (numpy; a new dict, the input untouched), as
    sessd_tpu/train/train_step.py:84-136 defines it, field for field:

    - reg_targets [B, A, 7] f32 are nonzero only at positive anchors: sent
      as the indices [B, pos_cap] int32 (A marks an unused slot) and values
      [B, pos_cap, 7] of the positives, ``reg_targets<sfx>_idx`` and
      ``_val``; a chain whose positives exceed ``pos_cap`` stays dense;
    - labels [B, A] int32 in {-1, 0, 1..C} -> int8;
    - voxels f32 -> f16, the one lossy field. Its 10-bit mantissa is finer
      than the bf16 the bf16 config's backbone computes in; the f32 config
      trains on f16-rounded voxels too, as the JAX trainer does;
    - coords [B, V, 3] -> int16, num_points -> uint8.

    ``unpack_batch`` at the top of the step restores every field."""
    out = dict(batch)
    for sfx in ("", "_raw"):
        lk, rk = "labels" + sfx, "reg_targets" + sfx
        if lk not in out:
            continue
        labels = np.asarray(out[lk])
        out[lk] = labels.astype(np.int8)
        if rk in out:
            rt = np.asarray(out[rk])
            b, a = labels.shape
            n_pos = int((labels > 0).sum(axis=1).max()) if b else 0
            if n_pos > pos_cap:
                continue  # dense, still exact
            idx = np.full((b, pos_cap), a, np.int32)  # a: an unused slot
            val = np.zeros((b, pos_cap, rt.shape[-1]), np.float32)
            for i in range(b):
                pos = np.flatnonzero(labels[i] > 0)
                idx[i, :len(pos)] = pos
                val[i, :len(pos)] = rt[i, pos]
            del out[rk]
            out[rk + "_idx"] = idx
            out[rk + "_val"] = val
        for k, dt in (("voxels" + sfx, np.float16),
                      ("coords" + sfx, np.int16),
                      ("num_points" + sfx, np.uint8)):
            if k in out:
                out[k] = np.asarray(out[k]).astype(dt)
    return out


def unpack_batch(batch: dict) -> dict:
    """The inverse of ``pack_batch`` on the batch's tensors (a no-op on a
    batch that is not packed): dense reg_targets f32 with zeros off the
    positives, int32 labels, coords and num_points, f32 voxels
    (sessd_tpu/train/train_step.py:139-160)."""
    out = dict(batch)
    for sfx in ("", "_raw"):
        ik = f"reg_targets{sfx}_idx"
        if ik in out:
            idx = out.pop(ik).long()
            val = out.pop(f"reg_targets{sfx}_val").float()
            b, a = out["labels" + sfx].shape
            # one flat row per (sample, anchor) and one more that takes
            # the unused slots (idx == a), dropped
            rows = torch.arange(b, device=idx.device)[:, None] * a + idx
            rows = torch.where(idx < a, rows, b * a)
            dense = val.new_zeros(b * a + 1, val.shape[-1])
            dense[rows.reshape(-1)] = val.reshape(-1, val.shape[-1])
            out["reg_targets" + sfx] = dense[:b * a].view(b, a, -1)
        for k, dt in (("labels", torch.int32), ("voxels", torch.float32),
                      ("coords", torch.int32), ("num_points", torch.int32)):
            if k + sfx in out and out[k + sfx].dtype != dt:
                out[k + sfx] = out[k + sfx].to(dt)
    return out


def make_train_step(loss_cfg: LossConfig = LossConfig(),
                    ema_decay_cap: float = 0.999,
                    compute_teacher_metrics: bool = True,
                    enable_ssl: bool = True, process_group=None):
    """Returns ``train_step(state, batch, consistency_weight) -> metrics``.

    batch (leading dim B, on the modules' device): voxels [B, V, P, F],
    num_points [B, V], inputs (the model's third forward argument: the
    batch's host chain for VoxelNet, ``host_transform``, as tensors) or,
    for a chain built on the device in the step, coords [B, V, 3] zyx and
    voxel_mask [B, V]; the same with the ``_raw`` suffix (teacher inputs,
    un-augmented),
    anchors [B, A, 7], labels / reg_targets (+ ``_raw``) [B, A(, 7)],
    transformation: flipped / noise_rotation / noise_scale [B]. A batch
    compressed by ``pack_batch`` is unpacked first.

    ``enable_ssl=False`` is the CIA-SSD supervised step: no teacher forward
    and no consistency loss; the EMA parameters are still kept and the
    teacher's BatchNorm statistics mirror the student's.

    With a ``process_group`` (data parallel: each rank its own batch, the
    nets built with the same group) the gradients are averaged over the
    ranks between ``autograd.grad`` and the optimizer step, so the clip
    and ``grad_norm`` see the averaged gradients, and every metric is
    averaged before the step returns (``jax.lax.pmean`` of grads and
    metrics, sessd_tpu/train/train_step.py:249-252, 270-271): one bucket
    per dtype each, and no read-back to the host.

    Where the step built chains on the device, the metrics also hold
    ``saturated``: [chains, 5] bool, each chain's full stages (student
    first), this rank's own, left on the device.
    """

    def train_step(state: TrainState, batch: dict, consistency_weight):
        batch = unpack_batch(batch)  # no-op unless pack_batch compressed it
        stu, tea = state.student, state.teacher
        saturated = []
        voxels, num_points, rb, b = _flat(stu, batch, "", saturated)
        if enable_ssl:
            tea.train()
            with torch.no_grad():
                preds_tea = tea(*_flat(tea, batch, "_raw", saturated)[:3], b,
                                train=True)[0]

        stu.train()
        preds_stu = stu(voxels, num_points, rb, b, train=True)[0]
        total, metrics = detection_loss(preds_stu, batch, loss_cfg)
        if enable_ssl:
            cons, cons_dir = consistency_loss(
                preds_stu, preds_tea, batch["anchors"],
                batch["transformation"], loss_cfg.consistency)
            total = total + consistency_weight * cons
            metrics.update(consistency_loss=cons,
                           consistency_dir_loss=cons_dir)
        metrics["loss"] = total
        params = state.optimizer.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if process_group is not None:
            all_reduce_mean_(grads, process_group)
        metrics["grad_norm"] = state.optimizer.step(grads)

        # EMA teacher update (trainer_sessd.py:315-318)
        a32 = min(np.float32(1.0) - np.float32(1.0)
                  / (np.float32(state.step) + np.float32(1.0)),
                  np.float32(ema_decay_cap))
        alpha, beta = float(a32), float(np.float32(1.0) - a32)
        with torch.no_grad():
            for e, p in zip(tea.parameters(), stu.parameters()):
                e.copy_(alpha * e + beta * p)
            if not enable_ssl:
                for e, s in zip(tea.buffers(), stu.buffers()):
                    e.copy_(s)

        if enable_ssl and compute_teacher_metrics:
            with torch.no_grad():
                tea_loss, tea_metrics = detection_loss(
                    preds_tea, batch, loss_cfg, labels_key="labels_raw",
                    reg_targets_key="reg_targets_raw", include_odiou=False)
            metrics.update({k + "_ema": v for k, v in tea_metrics.items()})
            metrics["loss_ema"] = tea_loss
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if process_group is not None:
            metrics = dict(zip(metrics, all_reduce_mean_(
                [v.clone() for v in metrics.values()], process_group,
                kind="metrics")))
        if saturated:
            metrics["saturated"] = torch.stack(saturated)
        return metrics

    return train_step
