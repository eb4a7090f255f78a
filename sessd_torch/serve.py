"""Serving pipeline (port of ``sessd_tpu/serve.py:265-364``): host C++
preprocessing, then one device pass.

  host (C++):  FCFS voxelize -> per-voxel mean VFE -> the full rulebook
               chain, int16 when the capacities fit (``HostPreprocessor``,
               shared with sessd_tpu)
  device:      VFE passthrough + the all-sparse backbone (14 launches of the
               fused sparse conv kernel) + SSFA + head + decode + rotated NMS

The host arrays are copied to the device synchronously inside each call,
well before the preprocessor's ring of reusable buffers wraps (its aliasing
contract, sessd_tpu/serve.py:44-49). Rulebooks arrive as int16 at batch 1
and as int32 at batch 4, where caps x 4 exceed 2^15; the kernel takes both.

The host entry points (``HostPreprocessor``, the caps, and ``make_scene``,
the seeded ray-cast KITTI-like scan used as a synthetic request) are
re-exported from JAX-free ``sessd_tpu`` modules, so a caller of the port
imports ``sessd_torch`` alone.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from sessd_tpu.serve import SERVING_CAPS, TRAIN_CAPS
from sessd_tpu.serve import HostPreprocessor as _HostPreprocessor
from sessd_tpu.serve import saturated_stages
from sessd_tpu.utils.synth_scene import make_scene

from .models.predict import PredictConfig, predict_batch
from .utils.native import ensure_native

__all__ = ["SERVING_CAPS", "TRAIN_CAPS", "HostPreprocessor", "make_scene",
           "stage_inputs", "make_infer_fn", "ExactBatchServer"]


class HostPreprocessor(_HostPreprocessor):
    """``sessd_tpu.serve.HostPreprocessor`` on the library that
    ``ensure_native`` builds and loads under a lock shared by all processes,
    so a fresh checkout never meets a half-written library (the reference
    constructor takes ``get_native()``, which may have cached ``None``;
    ``ensure_native`` hands it the library that is now whole)."""

    def __init__(self, spec, stage_capacity=TRAIN_CAPS,
                 num_input_features: int = 4, ring: int = 4):
        ensure_native()
        super().__init__(spec, stage_capacity, num_input_features, ring)


def _to_device(a, device) -> torch.Tensor:
    """A host array (or tensor) as a tensor on ``device``; numpy inputs are
    always copied, so the caller may reuse its buffer on return."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def stage_inputs(feats, rulebooks: dict, device):
    """Host prep output -> (feats, rulebooks) tensors on ``device``."""
    rb = {k: ([_to_device(a, device) for a in v]
              if isinstance(v, (list, tuple)) else _to_device(v, device))
          for k, v in rulebooks.items()}
    return _to_device(feats, device), rb


def make_infer_fn(model, anchors, predict_cfg: PredictConfig,
                  caps: Sequence[int], batch_size: int,
                  device) -> Callable:
    """Returns ``infer(feats, rulebooks) -> (box3d_lidar, scores, valid)``.

    ``model`` is a ``VoxelNet`` already on ``device``. feats
    [batch_size*caps[0], F] and the rulebook chain come from
    ``HostPreprocessor`` (``__call__`` at batch 1, ``batch`` above), as
    numpy arrays or device tensors. The VFE is the parameter-free mean, so
    host features pass through it as one-point voxels.
    """
    device = torch.device(device)
    rows = int(caps[0]) * batch_size
    anchors = _to_device(anchors, device).float()
    num_points = torch.ones(rows, dtype=torch.int32, device=device)
    model.eval()

    @torch.inference_mode()
    def infer(feats, rulebooks):
        feats, rulebooks = stage_inputs(feats, rulebooks, device)
        if feats.shape[0] != rows:
            raise ValueError(f"feats has {feats.shape[0]} rows, want {rows} "
                             f"(caps[0]={caps[0]} x batch {batch_size})")
        preds = model(feats[:, None, :], num_points, rulebooks, batch_size)
        dets = predict_batch({k: v.float() for k, v in preds[0].items()},
                             anchors, predict_cfg)
        return dets["box3d_lidar"], dets["scores"], dets["valid"]

    return infer


class ExactBatchServer:
    """Serving front end with an exact fallback on capacity saturation
    (port of sessd_tpu/serve.py:265-332).

    The fast path preps and infers at the tight ``serving_caps``. A scene
    denser than those caps would silently truncate voxels at the saturated
    stage, so every batch's chain is checked on the host and a saturated
    batch is re-prepped and re-run at ``safe_caps``, whose stage-0 cap equals
    the reference's own 20000-voxel truncation point. ``stats`` counts both
    paths.
    """

    def __init__(self, model, anchors, predict_cfg: PredictConfig, spec,
                 device, serving_caps=SERVING_CAPS, safe_caps=TRAIN_CAPS,
                 batch_size: int = 1):
        if any(s < f for s, f in zip(safe_caps, serving_caps)):
            raise ValueError("safe_caps must dominate serving_caps "
                             "elementwise")
        self.batch_size = int(batch_size)
        self.fast_prep = HostPreprocessor(spec, serving_caps)
        self.safe_prep = HostPreprocessor(spec, safe_caps)
        self.fast_caps = [int(c) for c in serving_caps]
        self.safe_caps = [int(c) for c in safe_caps]
        self.fast_infer = make_infer_fn(model, anchors, predict_cfg,
                                        self.fast_caps, batch_size, device)
        self.safe_infer = make_infer_fn(model, anchors, predict_cfg,
                                        self.safe_caps, batch_size, device)
        # a saturated stage only warrants the fallback where the safe caps
        # add headroom: equal-cap stages saturate identically on both paths
        self._fixable = [i for i in range(len(self.fast_caps))
                         if self.safe_caps[i] > self.fast_caps[i]]
        self.stats = {"fast": 0, "exact_fallback": 0, "safe_saturated": 0}

    def _prep(self, prep, scenes):
        if len(scenes) != self.batch_size:
            raise ValueError(f"got {len(scenes)} scenes, batch size is "
                             f"{self.batch_size}")
        return prep(scenes[0]) if self.batch_size == 1 else prep.batch(scenes)

    def __call__(self, scenes):
        """scenes: list of [P, 4] point arrays (len == batch_size) ->
        (box3d_lidar, scores, valid) device tensors."""
        p = self._prep(self.fast_prep, scenes)
        caps_b = [c * self.batch_size for c in self.fast_caps]
        if not set(saturated_stages(p["rulebooks"], caps_b)).intersection(
                self._fixable):
            self.stats["fast"] += 1
            return self.fast_infer(p["feats"], p["rulebooks"])
        self.stats["exact_fallback"] += 1
        p = self._prep(self.safe_prep, scenes)
        safe_b = [c * self.batch_size for c in self.safe_caps]
        # stages 1+ full at the safe caps means denser than 2x KITTI:
        # surface it, don't hide it
        if saturated_stages(p["rulebooks"], safe_b):
            self.stats["safe_saturated"] += 1
        return self.safe_infer(p["feats"], p["rulebooks"])
