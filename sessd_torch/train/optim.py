"""One-cycle AdamW with global-norm clipping (port of
``sessd_tpu/train/optim.py``), written out by hand so that each step is the
one optax takes, and the legacy LrUpdaterHook schedules
(``build_legacy_schedule``, for AdamW at a constant beta1 of 0.9):

- one-cycle schedule (learning_schedules_fastai.py:77-96): two cosine
  phases split at ``pct_start``; lr lr_max/div -> lr_max -> lr_max/div/1e4,
  Adam's beta1 moms[0] -> moms[1] -> moms[0]; evaluated in float32 at the
  update count, as ``optax.inject_hyperparams`` does;
- ``optax.clip_by_global_norm``: g * max_norm / ||g|| once ||g|| reaches
  max_norm (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
- ``optax.adamw``: bias correction with the *scheduled* beta1 of this step,
  eps outside the square root, then decoupled weight decay on every
  parameter (biases and BatchNorm affines included), then -lr.

Two counts, as optax keeps them: ``count`` is Adam's bias-correction count
(``ScaleByAdamState.count``), ``sched_count`` the one the lr and beta1
schedules read (``InjectHyperparamsState.count``). A warm start restarts
the schedule and keeps the moments and ``count``
(``restart_schedule``, sessd_tpu/utils/checkpoint.py:67-93).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

f32 = np.float32


@dataclass(frozen=True)
class OneCycleConfig:
    lr_max: float = 3e-3
    moms: tuple = (0.95, 0.85)
    div_factor: float = 10.0
    pct_start: float = 0.4
    total_steps: int = 1
    wd: float = 0.01
    beta2: float = 0.99
    eps: float = 1e-8
    grad_clip_norm: float = 35.0


def annealing_cos(start: float, end: float, pct) -> np.float32:
    cos_out = np.cos(f32(math.pi) * f32(pct)) + f32(1.0)
    return f32(end) + f32((start - end) / 2.0) * cos_out


def _one_cycle(cfg: OneCycleConfig, start, mid, end) -> Callable:
    a1 = int(cfg.total_steps * cfg.pct_start)

    def sched(step: int) -> float:
        step = min(int(step), cfg.total_steps)
        if step < a1:
            return float(annealing_cos(start, mid, f32(step) / f32(max(a1, 1))))
        return float(annealing_cos(
            mid, end, f32(step - a1) / f32(max(cfg.total_steps - a1, 1))))

    return sched


def one_cycle_lr(cfg: OneCycleConfig) -> Callable:
    low = cfg.lr_max / cfg.div_factor
    return _one_cycle(cfg, low, cfg.lr_max, low / 1e4)


def one_cycle_mom(cfg: OneCycleConfig) -> Callable:
    return _one_cycle(cfg, cfg.moms[0], cfg.moms[1], cfg.moms[0])


def build_legacy_schedule(policy: str, base_lr: float, steps_per_epoch: int,
                          total_steps: int, *, gamma: float = 0.1,
                          milestones=(), power: float = 1.0,
                          min_lr: float = 0.0, warmup: Optional[str] = None,
                          warmup_iters: int = 500,
                          warmup_ratio: float = 1.0 / 3.0) -> Callable:
    """The reference's legacy LrUpdaterHook policies
    (det3d/torchie/trainer/hooks/lr_updater.py; sessd_tpu/train/optim.py:
    66-118): fixed / step / exp / poly / cosine, each with the hooks'
    optional constant / linear / exp warmup ramp. The by-epoch policies
    (step, exp) change at epoch boundaries, as the hooks'
    ``before_train_epoch`` updates do. Evaluated in float32 in JAX's order
    of operations at the update count."""
    spe = max(int(steps_per_epoch), 1)
    ms = sorted(int(m) for m in milestones)
    lr0 = f32(base_lr)
    if policy not in ("fixed", "step", "exp", "poly", "cosine"):
        raise ValueError(f"unknown lr policy {policy!r}")
    if warmup not in (None, "constant", "linear", "exp"):
        raise ValueError(f"unknown warmup {warmup!r}")

    def pct_of(step: int, span: int) -> np.float32:
        return np.clip(f32(step) / f32(max(span, 1)), f32(0), f32(1))

    def base(step: int) -> np.float32:
        ep = step // spe
        if policy == "fixed":
            return lr0
        if policy == "step":
            return lr0 * f32(gamma) ** f32(sum(ep >= m for m in ms))
        if policy == "exp":
            return lr0 * f32(gamma) ** f32(ep)
        if policy == "poly":
            return lr0 * (f32(1) - pct_of(step, total_steps)) ** f32(power)
        return annealing_cos(base_lr, min_lr, pct_of(step, total_steps))

    def sched(step: int) -> float:
        step = int(step)
        lr = base(step)
        if warmup is None or step >= warmup_iters:
            return float(lr)
        pct = pct_of(step, warmup_iters)
        if warmup == "constant":
            return float(lr * f32(warmup_ratio))
        if warmup == "linear":
            return float(lr * (f32(1) - (f32(1) - pct)
                               * f32(1.0 - warmup_ratio)))
        return float(lr * f32(warmup_ratio) ** (f32(1) - pct))

    return sched


class AdamW:
    """optax.chain(clip_by_global_norm, inject_hyperparams(adamw)) over a
    list of f32 parameters. ``step(grads)`` updates the parameters in place
    and returns the gradients' global norm before clipping;
    ``hyperparams`` then holds the lr and beta1 it applied (float32 values,
    as optax's ``InjectHyperparamsState.hyperparams``)."""

    def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable,
                 b1_fn: Callable, b2: float = 0.99, eps: float = 1e-8,
                 wd: float = 0.01, grad_clip_norm: float = 35.0):
        self.params: List[torch.Tensor] = list(params)
        self.lr_fn, self.b1_fn = lr_fn, b1_fn
        self.b2, self.eps, self.wd = b2, eps, wd
        self.clip = grad_clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.sched_count = 0
        self.hyperparams: dict = {}

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        grads = [g.float() for g in grads]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # a select, not a scale by min(1, c/n): below the bound the
        # gradient passes bit for bit
        clipped = norm >= self.clip
        # the hyperparameters as float32 values, as optax holds them
        lr, b1, b2 = (f32(self.lr_fn(self.sched_count)),
                      f32(self.b1_fn(self.sched_count)), f32(self.b2))
        t = self.count + 1
        c1, c2 = float(f32(1) - b1 ** t), float(f32(1) - b2 ** t)
        d1, d2 = float(f32(1) - b1), float(f32(1) - b2)
        lr, b1, b2 = float(lr), float(b1), float(b2)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(clipped, g / norm * self.clip, g)
            mu.mul_(b1).add_(g * d1)
            nu.mul_(b2).add_(g * g * d2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p
            p.add_(u * -lr)
        self.count += 1
        self.sched_count += 1
        self.hyperparams = {"learning_rate": lr, "b1": b1}
        return norm

    def restart_schedule(self):
        """Restart the lr and beta1 schedules at step 0; the moments and
        Adam's ``count`` stay."""
        self.sched_count = 0

    def state_dict(self) -> dict:
        return {"count": self.count, "sched_count": self.sched_count,
                "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        """Restore ``state_dict()`` in place. A state without
        ``sched_count`` (written before the two counts were split) had one
        count for both."""
        self.count = int(sd["count"])
        self.sched_count = int(sd.get("sched_count", sd["count"]))
        for mine, theirs in ((self.mu, sd["mu"]), (self.nu, sd["nu"])):
            for m, t in zip(mine, theirs, strict=True):
                m.copy_(t)
