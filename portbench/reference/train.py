"""The plain reference of the SE-SSD training step, followed for the first
steps of a run: teacher forward (training-mode BatchNorm, no gradient),
student forward and backward, the supervised loss (focal, ODIoU, direction,
IoU prediction) and the consistency loss (``losses.py``), AdamW from
``torch.optim`` with the gradient's global norm clipped and the one-cycle
learning rate and beta1 set before each step, and the EMA teacher update
(trainer_sessd.py:248-360). The detector is ``model.VoxelNet``.
Everything runs in float32 with TF32 off, unless the caller turns TF32 on
or asks for the fp8 control.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .losses import consistency_loss, detection_loss
from .model import VoxelNet


def loss_config(cfg) -> dict:
    """The head's loss settings from the config (det3d's defaults where it
    names none); ODIoU's weight of 2 is odious.py:896-899's."""
    h, tc = cfg.model["bbox_head"], cfg.test_cfg
    return {"cls_weight": h["loss_cls"].get("loss_weight", 1.0),
            "alpha": h["loss_cls"].get("alpha", 0.25),
            "gamma": h["loss_cls"].get("gamma", 2.0),
            "odiou_weight": 2.0,
            "dir_weight": h["loss_aux"].get("loss_weight", 0.2),
            "dir_offset": h.get("direction_offset", 0.0),
            "score_thresh": tc.get("score_threshold", 0.3),
            "post_center_range": tuple(tc["post_center_limit_range"]),
            "iou_match": 0.7, "top_k": 256}


def one_cycle(cfg, total_steps: int):
    """fastai's one-cycle schedule as det3d's config sets it
    (learning_schedules_fastai.py:77-96): step -> (lr, beta1). Two cosine
    phases split at ``pct_start`` of the steps: lr from lr_max / div up to
    lr_max, then down to lr_max / div / 1e4; beta1 from moms[0] down to
    moms[1], then back."""
    lr = cfg.lr_config
    top, low = lr["lr_max"], lr["lr_max"] / lr["div_factor"]
    m0, m1 = lr["moms"]
    a1 = int(total_steps * lr["pct_start"])

    def cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def at(step: int):
        step = min(step, total_steps)
        if step < a1:
            pct = step / max(a1, 1)
            return cos(low, top, pct), cos(m0, m1, pct)
        pct = (step - a1) / max(total_steps - a1, 1)
        return cos(top, low / 1e4, pct), cos(m1, m0, pct)

    return at


def model_inputs(batch: dict, sfx: str, device, f16_voxels: bool):
    """(voxels [V, P, F], num_points [V], (b, z, y, x) coords [V, 4]) of a
    host batch's valid voxels. ``f16_voxels``: the voxels rounded through
    float16, as the program's packed batches carry them."""
    vox = np.asarray(batch["voxels" + sfx])
    if f16_voxels:
        vox = vox.astype(np.float16).astype(np.float32)
    mask = np.asarray(batch["voxel_mask" + sfx])
    b = np.nonzero(mask)[0]
    coords = np.concatenate([b[:, None], np.asarray(batch["coords" + sfx])
                             [mask]], 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(vox[mask]), t(np.asarray(batch["num_points" + sfx])[mask]),
            t(coords.astype(np.int64)))


def follow(cfg, state_dict: dict, batches: List[dict], anchors: np.ndarray,
           consistency_weight: float, steps_per_epoch: int, device,
           f16_voxels: bool, quant=None, drop_half: bool = False) -> dict:
    """The reference's first ``len(batches)`` SE-SSD steps from
    ``state_dict``. Returns {"loss": [total per step], "det1": step 1's
    supervised loss, "consistency": step 1's consistency loss, "grad":
    {name: the clipped gradient of step 1, as the optimizer takes it},
    "start": {name: parameter}, "student" / "teacher": {name: parameter
    after the last step}}, on ``device``.

    ``drop_half`` plants a fault for the harness's tests: each batch's
    second half of the samples left out of the loss, the mean taken over
    the rest."""
    shape = tuple(int(v) for v in _sparse_shape(cfg))
    student = VoxelNet(shape, quant).to(device)
    teacher = VoxelNet(shape, quant).to(device)
    student.load_state_dict(state_dict)
    teacher.load_state_dict(state_dict)
    teacher.requires_grad_(False)
    names = [n for n, _ in student.named_parameters()]
    params = [p for _, p in student.named_parameters()]
    start = {n: p.detach().clone() for n, p in zip(names, params)}
    opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.99), eps=1e-8,
                            weight_decay=cfg.optimizer.get("wd", 0.01))
    sched = one_cycle(cfg, cfg.total_epochs * steps_per_epoch)
    clip = float(cfg.optimizer_config["grad_clip"]["max_norm"])
    lcfg = loss_config(cfg)
    anc = torch.from_numpy(np.ascontiguousarray(anchors)).float().to(device)
    cap = float(cfg.get("ema_decay_cap", 0.999))
    out = {"loss": [], "start": start}
    for step, batch in enumerate(batches):
        if drop_half:
            half = np.asarray(batch["labels"]).shape[0] // 2
            batch = _first(batch, half)
        b = np.asarray(batch["labels"]).shape[0]
        vox_t, np_t, c_t = model_inputs(batch, "_raw", device, f16_voxels)
        teacher.train()
        with torch.no_grad():
            preds_tea = teacher(vox_t, np_t, teacher.chain(c_t, b))
        student.train()
        vox, npts, coords = model_inputs(batch, "", device, f16_voxels)
        preds = student(vox, npts, student.chain(coords, b))
        labels = _t(batch["labels"], device).long()
        targets = _t(batch["reg_targets"], device).float()
        det = detection_loss(preds, labels, targets, anc, lcfg)
        tf = {k: np.asarray(batch["transformation"][k])
              for k in ("flipped", "noise_rotation", "noise_scale")}
        cons = consistency_loss(preds, preds_tea, anc, tf, lcfg)
        total = det + consistency_weight * cons
        opt.zero_grad(set_to_none=False)
        total.backward()
        torch.nn.utils.clip_grad_norm_(params, clip)
        if step == 0:
            out["head"] = {k: v.detach().clone() for k, v in preds.items()}
            out["teacher_head"] = preds_tea
            out["det1"] = float(det.detach())
            out["consistency"] = float(cons.detach())
            out["grad"] = {n: p.grad.detach().clone()
                           for n, p in zip(names, params)}
        lr, b1 = sched(step)
        for g in opt.param_groups:
            g["lr"], g["betas"] = lr, (b1, 0.99)
        opt.step()
        alpha = min(1.0 - 1.0 / (step + 1.0), cap)
        with torch.no_grad():
            for e, p in zip(teacher.parameters(), student.parameters()):
                e.mul_(alpha).add_(p, alpha=1.0 - alpha)
        out["loss"].append(float(total.detach()))
    out["student"] = {n: p.detach().clone() for n, p in zip(names, params)}
    out["teacher"] = {n: p.detach().clone()
                      for n, p in teacher.named_parameters()}
    return out


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sparse_shape(cfg):
    vg = cfg.voxel_generator
    r, v = vg["range"], vg["voxel_size"]
    nx, ny, nz = (int(round((r[i + 3] - r[i]) / v[i])) for i in range(3))
    return (nz + 1, ny, nx)


def _first(batch: dict, n: int) -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = _first(v, n)
        elif isinstance(v, np.ndarray):
            out[k] = v[:n]
        else:
            out[k] = v
    return out


def _gaps(p: Dict[str, float], r: Dict[str, float], floor: float):
    """Per leaf, |program norm - reference norm| over the larger of the
    reference's norm and ``floor``."""
    return {k: abs(p[k] - r[k]) / max(r[k], floor, 1e-30) for k in r}


def head_gap(prog: dict, ref: dict) -> float:
    """||program - reference|| / ||reference|| of each head output, the
    worst output."""
    def gap(p, r):
        r = r[:p.shape[0]]  # a run on fewer samples: the ones it ran
        return float(torch.linalg.vector_norm(p.float().to(r.device) - r)
                     / torch.linalg.vector_norm(r))

    return max(gap(prog[k], r) for k, r in ref.items())


def compare(prog: Dict, ref: Dict, exclude_below: float = 1e-3) -> dict:
    """The numbers a training cell may be judged by, each from ``prog``
    against ``ref`` (dicts as ``follow`` returns them):

    - ``det1_gap``: |program - reference| / |reference| of step 1's
      supervised loss; ``loss1_gap``, ``loss_gap``, ``cons1_gap``: the
      same of step 1's total, of the worst step's total, and of step 1's
      consistency loss;
    - ``head_gap`` / ``teacher_head_gap``: the relative error of step 1's
      student / teacher head outputs (``head_gap`` above);
    - ``grad_gap``: of step 1's gradient as the optimizer takes it, the gap
      between the program's norm of a leaf and the reference's, over the
      larger of the reference's norm of that leaf and of the median leaf,
      the worst leaf; ``grad_med``: the median leaf's gap;
    - ``delta_gap`` / ``delta_med``: the same of each parameter's change
      over the steps followed, student and EMA teacher, leaving out the
      leaves whose reference gradient is under ``exclude_below`` of the
      median leaf's (they move by round-off alone under Adam)."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["loss"], ref["loss"])]
    gn_r = {k: float(torch.linalg.vector_norm(v)) for k, v in
            ref["grad"].items()}
    gn_p = {k: float(torch.linalg.vector_norm(prog["grad"][k].float()))
            for k in gn_r}
    med = float(np.median(list(gn_r.values())))
    g = _gaps(gn_p, gn_r, med)
    moved = [k for k in gn_r if gn_r[k] >= exclude_below * med]
    d = {}
    for net in ("student", "teacher"):
        dn_r = {k: float(torch.linalg.vector_norm(ref[net][k]
                                                  - ref["start"][k]))
                for k in moved}
        dn_p = {k: float(torch.linalg.vector_norm(
                    prog[net][k].float() - prog["start"][k].float()))
                for k in moved}
        dmed = float(np.median(list(dn_r.values())))
        d.update({f"{net} {k}": v
                  for k, v in _gaps(dn_p, dn_r, dmed).items()})
    worst_g, worst_d = max(g, key=g.get), max(d, key=d.get)
    return {"det1_gap": abs(prog["det1"] - ref["det1"])
            / max(abs(ref["det1"]), 1e-30),
            "loss1_gap": losses[0], "loss_gap": max(losses),
            "cons1_gap": abs(prog["consistency"] - ref["consistency"])
            / max(abs(ref["consistency"]), 1e-30),
            "head_gap": head_gap(prog["head"], ref["head"]),
            "teacher_head_gap": head_gap(prog["teacher_head"],
                                         ref["teacher_head"]),
            "grad_gap": g[worst_g], "grad_med": float(np.median(
                list(g.values()))),
            "delta_gap": d[worst_d], "delta_med": float(np.median(
                list(d.values()))),
            "grad_leaf": worst_g, "delta_leaf": worst_d,
            "leaves_excluded": len(gn_r) - len(moved)}
