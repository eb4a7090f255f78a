"""Smoke check of the PyTorch/CUDA port (``sessd_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases, each printing its own lines; any failure exits non-zero:
1. The card (``nvidia-smi`` name and power limit) and the build of the CUDA
   kernels from ``sessd_torch/csrc`` (one nvcc per source, in parallel,
   into ``build/sessd_torch/``).
2. The fused sparse conv kernel against its plain PyTorch twin on the card,
   for every one of the 14 backbone convs on the features the previous conv
   produced, at full KITTI width (sparse shape (41, 1600, 1408), SERVING_CAPS,
   a ray-cast scene): f32 (TF32 off, bound 1e-4 of max|twin|) and bf16
   (bound 2e-2), batch 1 on int16 rulebooks and batch 4 on int32 ones.
   Per-conv times are device times (``median_ms``: CUDA-event medians of
   20 launches, each queued behind a device spin).
   The streaming kernel (K3; in bf16 the tensor-core tile of
   ``csrc/gather_mma.cuh``) against its twin and against K1 on every conv
   that streams in one bf16 batch-8 request at SERVING_CAPS (the 7 convs of
   stages 1-2), with K3, K1 (the scalar tile K3 had before) and twin times
   and the share of (tile, tap) pairs no row hits, which the tile skips,
   per conv.
3. End-to-end serving through ``sessd_torch.serve.ExactBatchServer``: the
   SE-SSD Car VoxelNet (sessd_torch/configs/se_ssd_kitti_car_bf16.py, seeded
   random weights, 70,400 anchors) serves 12 batch-1 requests and one
   batch-4 request with the cls bias at the focal prior, then one batch-1
   request without it, all through K1; then batch-8 serving, 6 requests of
   eight scans, through 7 K1 and 7 K3 launches each (p50 and scenes/s).
   Checks: finite outputs of the expected shapes, the launch counts per
   request, and the head outputs of the kernel path equal to the twin
   path's (f32, TF32 off) to 1e-3 of the max at batch 1 and batch 8.
4. The training kernels against their twins: the forward (K4), input
   gradient and weight gradient (K5) of every sparse conv of both training
   plans (student: 10 convs on the augmented chain; teacher: 14 on the raw
   chain), full width, batch 4, the loader's int32 chains from a synthetic
   KITTI root (``sessd_torch.utils.kitti_synth``). Each conv takes the
   features the previous one produced. Bounds: f32 1e-4 of max|twin| (1e-3 for the
   weight gradient, a reduction over all rows), bf16 2e-2. Kernel and twin
   device-time medians per conv (bf16, student chain); for the forward also
   the scalar tile's time on the same inputs (K1 with zero bias and no
   ReLU, the tile bf16 K4 ran before the tensor-core tile) and the share of
   (tile, tap) pairs skipped.
5. Training through ``sessd_torch.train.trainer.Trainer`` (bf16 config,
   batch 4, SSL on) for 6 steps: every loss term and the gradient norm
   finite, the student moved, the teacher equal to the EMA formula on the
   last step, and exactly 24 forward, 9 input-gradient and 10
   weight-gradient launches per step. Prints the step-time median, the
   data-time share and the peak device memory.
6. One f32 step (TF32 off) on one batch through the kernels and, from an
   identical state, through their twins: loss terms within 1e-4 relative,
   each gradient tensor within 1e-3 of its max.
7. Evaluation on that f32 trainer: K3 against its twin and K1 on the 11
   convs that stream in one batch-4 eval batch at TRAIN_CAPS (stages 1-3);
   ``Trainer.validate()`` over the val split (the same 8 frames), with 11
   K3 and 3 K1 launches per batch; ``save_checkpoint``; then
   ``python -m sessd_torch.tools.test`` in a subprocess on that checkpoint,
   which must give the same AP tables and write ``--out``.
8. Ablation: the micro-benchmark kernels through their scripts, the main
   path of these kernels: S1 (``sessd_torch.scripts.bench_sparse_conv_ablate``,
   the conv tile with one cost removed at a time, per-variant ms) and S2
   (``sessd_torch.scripts.bench_launch_overhead``, the empty launch: host
   and device us per launch, through Python and from one C call, and the
   ``sparse_conv_fwd`` wrapper against its bare launches). Then S1's
   ``full`` mode, a copy of the scalar tile, must equal K1 with zero bias
   and no ReLU bit for bit, every mode must match its plain version within
   2e-2 of max|plain|, and S2's output must be all zeros.
9. Warm start and resume on the 8-frame root: a CIA-SSD bf16 trainer runs
   one epoch (2 steps) and checkpoints; an SE-SSD bf16 trainer's
   ``load_from`` must give teacher = student = the CIA student, the CIA
   moments, a restarted schedule (``sched_count`` 0, ``count`` 2) and step
   0, then trains one epoch (2 finite steps); a third trainer's
   ``resume()`` from that work dir must restore epoch, step, both counts
   and every tensor exactly.
10. Acceptance path: ``python -m sessd_torch.scripts.acceptance_ap 8 4 1 1
   1 --out ...`` in a subprocess must write a record with the floor, each
   stage's AP trajectory and a finite AP (the path, not the AP, is
   checked).

The last lines are the kernels JSON line (each kernel's time, its plain
twin's, its launches on the main path, and its bound: the larger of the
bytes it must move over 3.35 TB/s and its 2*hits*Cin*Cout flops over the
peak for the input type, 67 TFLOP/s f32 or 989 TFLOP/s bf16), the card
line, and the result line ``{"ok": true, "device": {...}}``. The rows of K4
and K3 also carry ``old_tile_ms`` (the scalar tile on the same convs) and
``skipped_tap_share``. Without a CUDA device it raises and prints no
result.
"""
import contextlib
import copy
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sessd_torch import builder
from sessd_torch.models.backbone import PLAN, pick_conv
from sessd_torch.ops import sparse as sp
from sessd_torch.ops.cuda import ablate
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from sessd_torch.scripts import bench_launch_overhead as bench_launch
from sessd_torch.scripts import bench_sparse_conv_ablate as bench_ablate
from sessd_torch.scripts.profile_train import make_synthetic_root
from sessd_torch.serve import (SERVING_CAPS, TRAIN_CAPS, ExactBatchServer,
                               HostPreprocessor, make_scene, stage_inputs)
from sessd_torch.tools.train import load as load_train_config
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils.profiling import card_line, queued_device_ms

CONV_NAMES = ["subm0a", "subm0b", "down0", "subm1a", "subm1b", "down1",
              "subm2a", "subm2b", "subm2c", "down2", "subm3a", "subm3b",
              "subm3c", "down3"]
BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0
# the card's published rates (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
B8_REQUESTS = 6


class Bound:
    """The least time the card could take for a kernel's work summed over
    calls: each input read once and each output written once over the
    memory rate, against 2*hits*Cin*Cout flops over the input type's peak;
    the larger of the two."""

    def __init__(self):
        self.seconds = {"bytes": 0.0, "operations": 0.0}

    def add(self, tensors, hits: int, cin: int, cout: int, dtype):
        moved = sum(t.numel() * t.element_size() for t in tensors)
        self.seconds["bytes"] += moved / HBM_BYTES_PER_S
        self.seconds["operations"] += 2 * hits * cin * cout / \
            PEAK_FLOPS[dtype]

    def ms(self) -> float:
        return max(self.seconds.values()) * 1e3

    def by(self) -> str:
        return max(self.seconds, key=self.seconds.get)


def hits(rb, miss: int) -> int:
    return int((rb != miss).sum())


class TileSkips:
    """(tile, tap) pairs that no row of a 64-row tile hits, summed over
    convs: the taps the tensor-core tile neither gathers nor multiplies."""

    def __init__(self):
        self.pairs = 0
        self.skipped = 0.0

    def add(self, rb, miss: int) -> float:
        flags, share = sp.tile_tap_hits(rb, miss)
        self.pairs += flags.numel()
        self.skipped += share * flags.numel()
        return share

    def share(self) -> float:
        return self.skipped / self.pairs if self.pairs else 0.0


def median_ms(fn, reps=20) -> float:
    """Device ms of one ``fn()``: the median of ``reps`` CUDA-event pairs,
    each call queued behind a spin on the device, so the wrapper's host
    time (tens of us a call, S2) is not counted."""
    return queued_device_ms(fn, reps)


def build_model(config: str, device, prior: bool):
    """Seeded random weights; the cls bias at the focal prior (pi = 0.01)
    or, with ``prior`` off, at 0, where every anchor scores about 0.5."""
    cfg = builder.load_config(config)
    model = builder.build_detector(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    set_prior(model, prior)
    return model.to(device).eval(), cfg


def set_prior(model, on: bool):
    builder.set_cls_prior(model, 0.01 if on else None)


def phase_build():
    t0 = time.perf_counter()
    sc.build()
    secs = time.perf_counter() - t0
    log = sc.build_info["log"]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    print(f"build: {secs:.2f} s ({sc.build_info['path']}); "
          f"{len(regs)} kernel instances, max {max(regs, default=0)} "
          f"registers, {spills} bytes spill stores")


def phase_kernels(model, spec, device):
    """Every backbone conv through kernel and twin on identical inputs.
    Returns (max abs error, summed b1 bf16 kernel ms, summed twin ms, the
    bound of those convs)."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    scenes = [make_scene(seed=s)[0] for s in range(4)]
    staged = {1: stage_inputs(**prep(scenes[0]), device=device),
              4: stage_inputs(**prep.batch(scenes), device=device)}
    worst_abs, sums, bound = 0.0, [0.0, 0.0], Bound()
    for batch, dtype in ((1, torch.float32), (1, torch.bfloat16),
                         (4, torch.float32), (4, torch.bfloat16)):
        feats, rb = staged[batch]
        idx = str(rb["subm"][0].dtype).replace("torch.", "")
        tag = f"b{batch} {str(dtype).replace('torch.', '')} {idx}"
        timed = batch == 1
        step = iter(range(len(CONV_NAMES)))

        def checked(x, rbk, w2, bias, n_in):
            nonlocal worst_abs
            i = next(step)
            y = sc.fused_sparse_conv(x, rbk, w2, bias, n_in)
            want = sc.fused_sparse_conv_ref(x, rbk, w2, bias, n_in)
            torch.cuda.synchronize()
            diff = float((y.float() - want.float()).abs().max())
            peak = float(want.float().abs().max())
            if not peak > 0:  # a dead signal would make the check vacuous
                raise AssertionError(f"{CONV_NAMES[i]} {tag}: all-zero "
                                     "output")
            rel = diff / peak
            worst_abs = max(worst_abs, diff)
            line = (f"conv {i:2d} {CONV_NAMES[i]:6s} {x.shape[1]:2d}->"
                    f"{w2.shape[2]:2d} K={w2.shape[0]:2d} rows "
                    f"{rbk.shape[0]:5d} {tag}: max|twin| {peak:.3e} "
                    f"rel_err {rel:.2e}")
            if timed:
                k_ms = median_ms(lambda: sc.fused_sparse_conv(
                    x, rbk, w2, bias, n_in))
                r_ms = median_ms(lambda: sc.fused_sparse_conv_ref(
                    x, rbk, w2, bias, n_in))
                line += f" kernel {k_ms:.4f} ms twin {r_ms:.4f} ms"
                if dtype == torch.bfloat16:
                    sums[0] += k_ms
                    sums[1] += r_ms
                    bound.add((x, rbk, w2, bias, y), hits(rbk, n_in),
                              x.shape[1], w2.shape[2], dtype)
            print(line)
            if not rel <= BOUNDS[dtype]:
                raise AssertionError(f"{CONV_NAMES[i]} {tag}: rel_err "
                                     f"{rel:.3e} > {BOUNDS[dtype]}")
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"{CONV_NAMES[i]} {tag}: non-finite")
            return y

        with torch.inference_mode():
            model.backbone(feats, rb, batch, model.sparse_shape, dtype,
                           conv=checked)
        if next(step, None) is not None:
            raise AssertionError("backbone ran fewer than 14 convs")
    print(f"kernel vs twin: all 14 convs within bounds at b1/int16 and "
          f"b4/int32, f32 and bf16; b1 bf16 sum kernel {sums[0]:.4f} ms, "
          f"twin {sums[1]:.4f} ms, bound {bound.ms():.4f} ms ({bound.by()})")
    return worst_abs, sums[0], sums[1], bound


def check_stream_convs(backbone, feats, rb, batch, sparse_shape, dtype, tag,
                       want_streamed):
    """The backbone's all-sparse plan on (feats, rb) with every conv that
    streams run through K3, its twin and K1 on identical inputs: K3 within
    the bound of the twin, its difference from K1 printed; each of these
    convs timed (device-time medians of 10). The other convs run K1.
    Returns {"worst": max abs error vs twin, "vs_k1": max abs difference
    from K1, "ms", "k1_ms", "plain_ms": sums, "bound": Bound, "tiles":
    TileSkips}."""
    out = {"worst": 0.0, "vs_k1": 0.0, "ms": 0.0, "k1_ms": 0.0,
           "plain_ms": 0.0, "bound": Bound(), "tiles": TileSkips()}
    step = iter(range(len(CONV_NAMES)))
    streamed = []

    def checked(x, rbk, w2, bias, n_in):
        i = next(step)
        if pick_conv(x.shape[1], n_in, dtype) is sc.fused_sparse_conv:
            return sc.fused_sparse_conv(x, rbk, w2, bias, n_in)
        streamed.append(CONV_NAMES[i])
        args = (x, rbk, w2, bias, n_in)
        y = sc.fused_sparse_conv_stream(*args)
        want = sc.fused_sparse_conv_ref(*args)
        k1 = sc.fused_sparse_conv(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(y.float()).all():
            raise AssertionError(f"{CONV_NAMES[i]} {tag}: non-finite")
        rel, diff = _rel(y, want)
        vs_k1 = float((y.float() - k1.float()).abs().max())
        out["worst"] = max(out["worst"], diff)
        out["vs_k1"] = max(out["vs_k1"], vs_k1)
        times = [median_ms(lambda f=f: f(*args), 10) for f in (
            sc.fused_sparse_conv_stream, sc.fused_sparse_conv,
            sc.fused_sparse_conv_ref)]
        for key, t in zip(("ms", "k1_ms", "plain_ms"), times):
            out[key] += t
        out["bound"].add((x, rbk, w2, bias, y), hits(rbk, n_in), x.shape[1],
                         w2.shape[2], dtype)
        skipped = out["tiles"].add(rbk, n_in)
        print(f"stream conv {i:2d} {CONV_NAMES[i]:6s} {x.shape[1]:2d}->"
              f"{w2.shape[2]:2d} K={w2.shape[0]:2d} rows {rbk.shape[0]:6d} "
              f"{tag}: rel_err vs twin {rel:.2e}, max|K3-K1| {vs_k1:.3e}; "
              f"K3 {times[0]:.4f} ms, old tile (K1) {times[1]:.4f} ms, twin "
              f"{times[2]:.4f} ms; taps skipped {skipped:.3f}")
        if not rel <= BOUNDS[dtype]:
            raise AssertionError(f"{CONV_NAMES[i]} {tag}: K3 rel_err "
                                 f"{rel:.3e} > {BOUNDS[dtype]}")
        return y

    with torch.inference_mode():
        backbone(feats, rb, batch, sparse_shape, dtype, conv=checked)
    if next(step, None) is not None:
        raise AssertionError("backbone ran fewer than 14 convs")
    if streamed != want_streamed:
        raise AssertionError(f"{tag}: streamed {streamed}, want "
                             f"{want_streamed}")
    print(f"stream kernel {tag}: {len(streamed)} convs within bounds; max "
          f"abs error vs twin {out['worst']:.3e}, max|K3-K1| "
          f"{out['vs_k1']:.3e}; sums K3 {out['ms']:.4f} ms, old tile (K1) "
          f"{out['k1_ms']:.4f} ms, twin {out['plain_ms']:.4f} ms, bound "
          f"{out['bound'].ms():.4f} ms ({out['bound'].by()}); taps skipped "
          f"{out['tiles'].share():.3f} of {out['tiles'].pairs} (tile, tap) "
          "pairs")
    return out


B8_STREAMED = CONV_NAMES[3:10]     # stages 1-2: bf16, b8, SERVING_CAPS
EVAL_STREAMED = CONV_NAMES[3:]     # stages 1-3: f32, b4, TRAIN_CAPS


def phase_stream_serving(model, spec, device):
    """K3 on the streamed convs of one bf16 batch-8 request."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    feats, rb = stage_inputs(**prep.batch(
        [make_scene(seed=s)[0] for s in range(8)]), device=device)
    return check_stream_convs(model.backbone, feats, rb, 8,
                              model.sparse_shape, torch.bfloat16,
                              "b8 bf16 int32", B8_STREAMED)


def phase_serving(model, cfg, spec, device):
    """The main path; returns the kernel launches it made."""
    anchors = builder.build_anchors(cfg)
    pcfg = builder.build_predict_config(cfg)
    scenes = [make_scene(seed=s)[0] for s in range(4)]
    server1 = ExactBatchServer(model, anchors, pcfg, spec, batch_size=1,
                               device=device)
    server4 = ExactBatchServer(model, anchors, pcfg, spec, batch_size=4,
                               device=device)

    # host prep alone, steady state (its buffer ring filled first)
    for pts in scenes:
        server1.fast_prep(pts)
    t0 = time.perf_counter()
    for pts in scenes:
        server1.fast_prep(pts)
    prep_ms = (time.perf_counter() - t0) / len(scenes) * 1e3

    requests = [("b1 prior", server1, [scenes[i % 4]]) for i in range(12)]
    requests += [("b4 prior", server4, scenes), ("b1 no prior", server1,
                                                 scenes[:1])]
    results, lat = [], []
    _reset_counts()
    for n, (name, server, batch) in enumerate(requests):
        if name == "b1 no prior":
            set_prior(model, False)
        before = sc.fused_sparse_conv.launches
        t0 = time.perf_counter()
        out = server(batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        launched = sc.fused_sparse_conv.launches - before
        if sc.fused_sparse_conv_stream.launches:
            raise AssertionError(f"{name}: the stream kernel ran at batch "
                                 f"{len(batch)}")
        results.append((name, out, launched))
        if name == "b1 prior" and n > 0:  # request 0 is the warm-up
            lat.append(dt)
        print(f"request {n:2d} {name:11s}: {dt:8.3f} ms, {launched} kernel "
              f"launches, valid detections "
              f"{out[2].sum(dim=1).tolist()}")
    launches = sc.fused_sparse_conv.launches
    set_prior(model, True)

    for name, (boxes, scores, valid), launched in results:
        b = 4 if name.startswith("b4") else 1
        if launched != 14:
            raise AssertionError(f"{name}: {launched} launches, want 14")
        post = pcfg.nms_post_max_size
        if (boxes.shape != (b, post, 7) or scores.shape != (b, post)
                or valid.shape != (b, post)):
            raise AssertionError(f"{name}: shapes {boxes.shape} "
                                 f"{scores.shape} {valid.shape}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError(f"{name}: non-finite outputs")
    if launches != 14 * len(requests):
        raise AssertionError(f"{launches} launches for {len(requests)} "
                             "requests")
    print(f"serving: {len(requests)} requests over {len(anchors)} anchors, "
          f"stats b1 {server1.stats} b4 {server4.stats}; batch-1 latency p50 "
          f"{np.percentile(lat, 50):.3f} ms p90 {np.percentile(lat, 90):.3f}"
          f" ms over {len(lat)} requests; host prep {prep_ms:.3f} ms/scene")
    return launches, pcfg


def _want_launches(caps, batch, dtype):
    """(K1, K3) launches of one request at these caps."""
    cin = [4, 16, 16, 32, 32, 32, 64, 64, 64, 64, 64, 64, 64, 64]
    stage = [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3]
    k3 = sum(pick_conv(c, caps[s] * batch, dtype)
             is sc.fused_sparse_conv_stream for c, s in zip(cin, stage))
    return 14 - k3, k3


def phase_serving_b8(model, cfg, spec, device):
    """Batch-8 serving, the main path at throughput: one warm-up request,
    then B8_REQUESTS requests of eight ray-cast scans. Returns the launches
    {K1, K3} of the timed requests."""
    anchors = builder.build_anchors(cfg)
    pcfg = builder.build_predict_config(cfg)
    server = ExactBatchServer(model, anchors, pcfg, spec, batch_size=8,
                              device=device)
    scenes = [make_scene(seed=s)[0] for s in range(8)]
    server(scenes)  # warm-up: first-call allocations
    torch.cuda.synchronize()
    preps = []
    for _ in range(3):  # host prep alone, its buffer ring already filled
        t0 = time.perf_counter()
        server.fast_prep.batch(scenes)
        preps.append((time.perf_counter() - t0) * 1e3)
    _reset_counts()
    lat = []
    for n in range(B8_REQUESTS):
        k1, k3 = (sc.fused_sparse_conv.launches,
                  sc.fused_sparse_conv_stream.launches)
        fast = server.stats["fast"]
        t0 = time.perf_counter()
        boxes, scores, valid = server(scenes)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        got = (sc.fused_sparse_conv.launches - k1,
               sc.fused_sparse_conv_stream.launches - k3)
        caps = SERVING_CAPS if server.stats["fast"] > fast else TRAIN_CAPS
        want = _want_launches(caps, 8, torch.bfloat16)
        print(f"request b8 {n}: {lat[-1]:8.3f} ms, K1 {got[0]} K3 {got[1]} "
              f"launches, valid detections {valid.sum(dim=1).tolist()}")
        if got != want:
            raise AssertionError(f"b8 request {n}: launches {got}, want "
                                 f"{want}")
        post = pcfg.nms_post_max_size
        if boxes.shape != (8, post, 7) or scores.shape != (8, post):
            raise AssertionError(f"b8: shapes {boxes.shape} {scores.shape}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError("b8: non-finite outputs")
    counts = {"fused_sparse_conv": sc.fused_sparse_conv.launches,
              "fused_sparse_conv_stream":
                  sc.fused_sparse_conv_stream.launches}
    p50 = float(np.percentile(lat, 50))
    print(f"serving b8: {B8_REQUESTS} requests, stats {server.stats}, p50 "
          f"{p50:.3f} ms, p90 {np.percentile(lat, 90):.3f} ms, "
          f"{8e3 / p50:.1f} scenes/s, host prep of the 8 scans "
          f"{np.median(preps):.3f} ms; launches per request K1 "
          f"{counts['fused_sparse_conv'] // B8_REQUESTS} K3 "
          f"{counts['fused_sparse_conv_stream'] // B8_REQUESTS}")
    return counts


def phase_head_parity(spec, device, pcfg):
    """f32 model, TF32 off: head outputs of the kernel path vs the twin
    path on one batch-1 request (K1 only) and one batch-8 request (K1 and
    K3); also reports which NMS capacity each score regime takes."""
    model, _ = build_model("se_ssd_kitti_car.py", device, prior=True)
    prep = HostPreprocessor(spec, SERVING_CAPS)
    scenes = [make_scene(seed=s)[0] for s in range(8)]
    for batch, prior in ((1, True), (1, False), (8, True)):
        p = prep(scenes[0]) if batch == 1 else prep.batch(scenes)
        feats, rb = stage_inputs(**p, device=device)
        ones = torch.ones(feats.shape[0], dtype=torch.int32, device=device)
        with torch.inference_mode():
            set_prior(model, prior)
            k3 = sc.fused_sparse_conv_stream.launches
            k = model(feats[:, None, :], ones, rb, batch)[0]
            k3 = sc.fused_sparse_conv_stream.launches - k3
            if k3 != _want_launches(SERVING_CAPS, batch, torch.float32)[1]:
                raise AssertionError(f"b{batch} f32: {k3} K3 launches")
            r = model(feats[:, None, :], ones, rb, batch,
                      conv=sc.fused_sparse_conv_ref)[0]
            for name in k:
                err = float((k[name] - r[name]).abs().max()
                            / r[name].abs().max())
                if not err <= 1e-3:
                    raise AssertionError(f"head {name}: rel_err {err:.3e}")
            n_above = int((torch.sigmoid(k["cls_preds"]).amax(-1)
                           >= pcfg.score_threshold).sum())
            branch = "small" if n_above <= pcfg.nms_pre_small else "full"
            print(f"head parity f32 b{batch} (prior "
                  f"{'on' if prior else 'off'}, {k3} K3 launches): kernel "
                  f"vs twin within 1e-3; {n_above} anchors above "
                  f"{pcfg.score_threshold} -> {branch} NMS capacity")


# (rulebook kind, chain index, output stage) of each backbone conv in order
CONV_CHAIN = [c for stage, (_, n_subm, dk, _, _) in enumerate(PLAN)
              for c in ([("down", stage - 1, stage)] if dk else [])
              + [("subm", stage, stage)] * n_subm]
TRAIN_BOUNDS = {torch.float32: (1e-4, 1e-4, 1e-3),
                torch.bfloat16: (2e-2, 2e-2, 2e-2)}  # fwd, dfeat, dw
TRAIN_STEPS = 6


def first_batch(trainer):
    batches = iter(trainer.train_loader)
    try:
        return trainer._device_batch(next(batches))
    finally:
        batches.close()


def _rel(got, want):
    peak = float(want.float().abs().max())
    if not peak > 0:
        raise AssertionError("all-zero twin output: a vacuous check")
    return float((got.float() - want.float()).abs().max()) / peak, \
        float((got.float() - want.float()).abs().max())


@torch.no_grad()
def phase_train_kernels(trainer, db):
    """K4 / K5 against their twins on every sparse conv of both plans.
    Returns (max abs error per kernel, [summed kernel ms, summed twin ms]
    per kernel, Bound per kernel, {"old_ms": the scalar tile's summed ms,
    "tiles": TileSkips} of the forward) with the times and bounds of the
    bf16 student chain."""
    model = trainer.state.student
    blocks = model.backbone.blocks()
    worst = {"fwd": 0.0, "dfeat": 0.0, "dw": 0.0}
    ms = {k: [0.0, 0.0] for k in worst}
    bounds = {k: Bound() for k in worst}
    fwd_tile = {"old_ms": 0.0, "tiles": TileSkips()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for plan, sfx, n in (("student", "", 10), ("teacher", "_raw", 14)):
            rb = db["rulebooks" + sfx]
            vox = db["voxels" + sfx]
            b, v = vox.shape[:2]
            feats = model.reader(vox.reshape(b * v, *vox.shape[2:]),
                                 db["num_points" + sfx].reshape(b * v))
            x = feats[rb["perm"].long()]
            x = torch.where((rb["ids"][0] < sp.SENTINEL)[:, None], x,
                            0.0).to(dtype)
            timed = dtype == torch.bfloat16 and plan == "student"
            tag = f"{plan} {str(dtype).replace('torch.', '')} " \
                  f"{str(rb['subm'][0].dtype).replace('torch.', '')}"
            for i in range(n):
                conv = blocks[i][0]
                kind, idx, out_stage = CONV_CHAIN[i]
                rbk = rb[kind][idx]
                mask = rb["ids"][out_stage] < sp.SENTINEL
                w = conv.weight.detach().reshape(
                    -1, *conv.weight.shape[-2:]).to(dtype).contiguous()
                inv = sp.inverse_rulebook(rbk, x.shape[0])
                dout = torch.randn(rbk.shape[0], w.shape[2], device="cuda",
                                   generator=gen)
                dout = torch.where(mask[:, None], dout, 0.0).to(dtype)
                zero_bias = torch.zeros(w.shape[2], device="cuda")
                runs = {"fwd": (lambda: kt.sparse_conv_fwd(x, rbk, w, mask),
                                lambda: kt.sparse_conv_fwd_ref(x, rbk, w,
                                                               mask)),
                        "dw": (lambda: kt.sparse_conv_dw(x, rbk, dout),
                               lambda: kt.sparse_conv_dw_ref(x, rbk, dout))}
                if i > 0:  # the first conv's input needs no gradient
                    runs["dfeat"] = (
                        lambda: kt.sparse_conv_dfeat(dout, inv, w),
                        lambda: kt.sparse_conv_dfeat_ref(dout, inv, w))
                line = (f"train conv {i:2d} {CONV_NAMES[i]:6s} "
                        f"{w.shape[1]:2d}->{w.shape[2]:2d} K={w.shape[0]:2d} "
                        f"rows {rbk.shape[0]:5d} {tag}:")
                y = None
                for name, (kern, twin) in runs.items():
                    got, want = kern(), twin()
                    torch.cuda.synchronize()
                    if not torch.isfinite(got.float()).all():
                        raise AssertionError(f"{CONV_NAMES[i]} {name} {tag}:"
                                             " non-finite")
                    rel, diff = _rel(got, want)
                    worst[name] = max(worst[name], diff)
                    line += f" {name} {rel:.1e}"
                    bound = TRAIN_BOUNDS[dtype][("fwd", "dfeat",
                                                 "dw").index(name)]
                    if not rel <= bound:
                        raise AssertionError(f"{CONV_NAMES[i]} {name} {tag}"
                                             f": rel_err {rel:.3e} > {bound}")
                    if timed:
                        k_ms, r_ms = median_ms(kern, 10), median_ms(twin, 10)
                        ms[name][0] += k_ms
                        ms[name][1] += r_ms
                        moved = {"fwd": (x, rbk, w, mask),
                                 "dw": (x, rbk, dout),
                                 "dfeat": (dout, inv, w)}[name]
                        bounds[name].add(moved + (got,),
                                         hits(rbk, x.shape[0]), w.shape[1],
                                         w.shape[2], dtype)
                        line += f" ({k_ms:.4f} vs twin {r_ms:.4f} ms"
                        if name == "fwd":
                            old_ms = median_ms(lambda: sc.fused_sparse_conv(
                                x, rbk, w, zero_bias, x.shape[0],
                                relu=False), 10)
                            fwd_tile["old_ms"] += old_ms
                            skipped = fwd_tile["tiles"].add(rbk, x.shape[0])
                            line += (f", old tile {old_ms:.4f} ms, taps "
                                     f"skipped {skipped:.3f}")
                        line += ")"
                    if name == "fwd":
                        y = got
                print(line)
                x = torch.relu(y)
    print("train kernels vs twin: all convs of both plans within bounds; "
          "bf16 student chain sums " + ", ".join(
              f"{k} kernel {v[0]:.4f} ms twin {v[1]:.4f} ms bound "
              f"{bounds[k].ms():.4f} ms ({bounds[k].by()})"
              for k, v in ms.items())
          + f"; fwd old tile {fwd_tile['old_ms']:.4f} ms, taps skipped "
          f"{fwd_tile['tiles'].share():.3f} of {fwd_tile['tiles'].pairs} "
          "(tile, tap) pairs")
    return worst, ms, bounds, fwd_tile


KERNEL_FNS = (sc.fused_sparse_conv, sc.fused_sparse_conv_stream,
              kt.sparse_conv_fwd, kt.sparse_conv_dfeat, kt.sparse_conv_dw,
              ablate.sparse_conv_ablate, ablate.empty_launch)


def _reset_counts():
    for fn in KERNEL_FNS:
        fn.launches = 0


def _counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_FNS}


def phase_train(trainer):
    """The main training path; returns its launch counts."""
    state = trainer.state
    start = [p.detach().clone() for p in state.student.parameters()]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(max_steps=TRAIN_STEPS - 1)
    tea0 = [p.detach().clone() for p in state.teacher.parameters()]
    s = state.step
    trainer.run(max_steps=TRAIN_STEPS)
    hist = trainer.history
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()

    for h in hist:
        bad = [k for k, v in h.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {h['step']}: non-finite {bad}")
        print(f"train step {h['step']}: {h['step_time'] * 1e3:9.3f} ms, "
              f"data {h['data_time'] * 1e3:9.3f} ms, loss {h['loss']:.5g} "
              f"(cls {h['cls_loss_reduced']:.4g}, ious {h['ious_loss']:.4g}"
              f", dir {h['dir_loss_reduced']:.4g}, iou_pred "
              f"{h['iou_pred_loss']:.4g}, consistency "
              f"{h['consistency_loss']:.4g}), grad_norm "
              f"{h['grad_norm']:.4g}, num_pos {h['num_pos']:.1f}")
    want = {"fused_sparse_conv": 0, "fused_sparse_conv_stream": 0,
            "sparse_conv_fwd": 24 * TRAIN_STEPS,
            "sparse_conv_dfeat": 9 * TRAIN_STEPS,
            "sparse_conv_dw": 10 * TRAIN_STEPS,
            "sparse_conv_ablate": 0, "empty_launch": 0}
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    moved = max(float((p.detach() - p0).abs().max()) for p, p0 in
                zip(state.student.parameters(), start))
    if not moved > 0:
        raise AssertionError("the student did not move")
    alpha = min(1 - 1 / (s + 1), trainer.cfg.get("ema_decay_cap", 0.999))
    ema_err = max(float((e - (alpha * e0 + (1 - alpha) * p.detach()))
                        .abs().max())
                  for e, e0, p in zip(state.teacher.parameters(), tea0,
                                      state.student.parameters()))
    if not ema_err <= 1e-5:
        raise AssertionError(f"teacher off the EMA formula by {ema_err}")
    steady = hist[1:]
    step_ms = float(np.median([h["step_time"] for h in steady])) * 1e3
    data = sum(h["data_time"] for h in steady)
    share = data / (data + sum(h["step_time"] for h in steady))
    # the loop reads the device back only at log points and epoch ends, so
    # a step's step_time is the mean of the steps read back with it
    print(f"training: {len(hist)} steps at batch 4, step median "
          f"{step_ms:.3f} ms (steps 2-{len(hist)}, means over each "
          f"read-back), data-time share "
          f"{share:.3f}, peak device memory {peak / 2 ** 30:.3f} GiB, "
          f"launches per step fwd {counts['sparse_conv_fwd'] // len(hist)}"
          f" dfeat {counts['sparse_conv_dfeat'] // len(hist)} dw "
          f"{counts['sparse_conv_dw'] // len(hist)}; student moved "
          f"{moved:.3e}, teacher vs EMA formula {ema_err:.1e}")
    return counts


@contextlib.contextmanager
def twins():
    """SparseConvFunction through the kernels' plain twins (it looks its
    kernels up in ``kt`` at each call): the reference side of phase 6."""
    names = ("sparse_conv_fwd", "sparse_conv_dfeat", "sparse_conv_dw")
    saved = {n: getattr(kt, n) for n in names}
    try:
        for n in names:
            setattr(kt, n, getattr(kt, n + "_ref"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kt, n, fn)


def phase_step_parity(trainer):
    """One f32 step through the kernels and through the twins from the
    same state on the same batch."""
    db = first_batch(trainer)
    states, grads, metrics = [trainer.state], [], []
    twin_state = copy.deepcopy(trainer.state)
    twin_state.optimizer.params = list(twin_state.student.parameters())
    states.append(twin_state)
    for state, ctx in zip(states, (contextlib.nullcontext(), twins())):
        step = state.optimizer.step
        got = {}

        def capture(gs, step=step, got=got):
            got.update(zip([n for n, _ in
                            state.student.named_parameters()],
                           [g.detach().clone() for g in gs]))
            return step(gs)

        state.optimizer.step = capture
        with ctx:
            m = trainer.train_step(state, db, 0.5)
        torch.cuda.synchronize()
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(got)
    worst_m = max(abs(metrics[0][k] - v) / (abs(v) + 1e-6)
                  for k, v in metrics[1].items())
    worst_g, worst_name = 0.0, ""
    for name, g in grads[1].items():
        peak = float(g.abs().max())
        if peak == 0:
            if grads[0][name].abs().max() != 0:
                raise AssertionError(f"{name}: kernel gradient nonzero")
            continue
        err = float((grads[0][name] - g).abs().max()) / peak
        if err > worst_g:
            worst_g, worst_name = err, name
    print(f"step parity f32: loss {metrics[0]['loss']:.6g} vs twin "
          f"{metrics[1]['loss']:.6g}; worst loss term rel {worst_m:.2e}; "
          f"worst gradient {worst_g:.2e} of its max ({worst_name})")
    if not worst_m <= 1e-4:
        raise AssertionError(f"loss terms differ by {worst_m:.3e}")
    if not worst_g <= 1e-3:
        raise AssertionError(f"gradient {worst_name} differs by {worst_g}")


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def phase_eval_kernels(trainer):
    """K3 on the 11 streamed convs of the first batch-4 eval batch."""
    batches = iter(trainer.val_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    dev = trainer.device
    rb = {k: ([_put(a, dev) for a in v] if isinstance(v, list)
              else _put(v, dev))
          for k, v in trainer._batch_rulebooks(batch).items()}
    model = trainer.state.student
    vox = batch["voxels"]
    b, v = vox.shape[:2]
    with torch.inference_mode():
        feats = model.reader(_put(vox, dev).reshape(b * v, *vox.shape[2:]),
                             _put(batch["num_points"], dev).reshape(b * v))
    return check_stream_convs(model.backbone, feats, rb, b,
                              model.sparse_shape, torch.float32,
                              "eval b4 f32 int32", EVAL_STREAMED)


def _table_diff(a, b) -> list:
    """The entries in which two AP tables differ, NaN equal to NaN."""
    def flat(r):
        return {(c, m, d, k): float(v) for c, t in r.items()
                for m, ds in t.items() for d, ks in ds.items()
                for k, v in ks.items()}

    fa, fb = flat(a), flat(b)
    if fa.keys() != fb.keys():
        return sorted(set(fa) ^ set(fb))
    return [(k, fa[k], fb[k]) for k in fa
            if not (fa[k] == fb[k] or (math.isnan(fa[k])
                                       and math.isnan(fb[k])))]


def _ap_line(results) -> str:
    car = results["Car"]
    return ", ".join(f"{m} AP40 moderate {car[m][1]['AP40']:.4f}"
                     for m in ("bbox", "bev", "3d"))


def phase_eval(trainer, root, tmp):
    """The evaluation path: validate() over the val split, then the saved
    checkpoint through ``python -m sessd_torch.tools.test``. Both run with
    PyTorch's default TF32 settings (the tool's), so the neck's cuDNN convs
    compute the same bits in both processes. Returns the launches {K1, K3}
    of validate()."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _reset_counts()
        t0 = time.perf_counter()
        results = trainer.validate()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    n = -(-len(trainer.val_dataset) // trainer.cfg.data["samples_per_gpu"])
    want = {"fused_sparse_conv": 3 * n, "fused_sparse_conv_stream": 11 * n,
            "sparse_conv_fwd": 0, "sparse_conv_dfeat": 0,
            "sparse_conv_dw": 0, "sparse_conv_ablate": 0, "empty_launch": 0}
    if counts != want:
        raise AssertionError(f"validate launches {counts}, want {want}")
    if results is None or set(results) != {"Car"}:
        raise AssertionError(f"validate gave {results}")
    aps = [x for m in results["Car"].values() for d in m.values()
           for x in d.values()]
    if not all(math.isfinite(x) for x in aps):
        raise AssertionError("non-finite AP")
    print(f"eval: validate() over {len(trainer.val_dataset)} frames in "
          f"{n} batches of 4, {secs:.3f} s ({secs / n * 1e3:.1f} ms/batch "
          f"with the loader), launches per batch K1 "
          f"{counts['fused_sparse_conv'] // n} K3 "
          f"{counts['fused_sparse_conv_stream'] // n}; {_ap_line(results)}")

    trainer.save_checkpoint()
    out = os.path.join(tmp, "eval_results.pkl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sessd_torch.tools.test", "se_ssd_kitti_car.py",
         "--work_dir", trainer.work_dir, "--data-root", root, "--out", out],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"tools.test exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    with open(out, "rb") as f:
        theirs = pickle.load(f)
    diff = _table_diff(theirs, results)
    if diff:
        raise AssertionError(f"tools.test AP differs from validate(): {diff}")
    print(f"eval: tools.test on the epoch-{trainer.epoch} checkpoint in "
          f"{time.perf_counter() - t0:.1f} s gave the same AP tables and "
          f"wrote {os.path.basename(out)}")
    return counts


ABLATE_BOUND = 2e-2  # bf16 inputs and outputs, f32 sums


def phase_ablation(device):
    """S1 and S2 through their scripts, then each against its plain
    version. Returns the launches of the scripts' run (the main path of
    these kernels), the times, errors and bounds."""
    inputs = bench_ablate.make_inputs(device)
    _reset_counts()
    s1_ms = bench_ablate.run(inputs)
    s2 = bench_launch.run()
    counts = _counts()
    for name in ("sparse_conv_ablate", "empty_launch"):
        if not counts[name]:
            raise AssertionError(f"the scripts launched no {name}")

    feats, rb, w2, _ = bench_ablate.variant_args(inputs, "full")
    full = ablate.sparse_conv_ablate(feats, rb, w2, "full")
    zero = torch.zeros(w2.shape[2], device=device)
    k1 = sc.fused_sparse_conv(feats, rb, w2, zero, feats.shape[0], relu=False)
    torch.cuda.synchronize()
    if not torch.equal(full.view(torch.int16), k1.view(torch.int16)):
        raise AssertionError("S1 full differs from K1 with zero bias and no "
                             "ReLU")
    worst, plain_ms = 0.0, None
    for name in bench_ablate.VARIANTS:
        args = bench_ablate.variant_args(inputs, name)
        got = ablate.sparse_conv_ablate(*args)
        want = ablate.sparse_conv_ablate_ref(*args)
        torch.cuda.synchronize()
        rel, diff = _rel(got, want)
        worst = max(worst, diff)
        print(f"S1 {name:10s}: {s1_ms[name]:.4f} ms, rel_err vs plain "
              f"{rel:.2e}")
        if not (rel <= ABLATE_BOUND and torch.isfinite(got.float()).all()):
            raise AssertionError(f"S1 {name}: rel_err {rel:.3e}")
        if name == "full":
            plain_ms = queued_device_ms(
                lambda a=args: ablate.sparse_conv_ablate_ref(*a), 10)
    bound = Bound()
    bound.add((feats, rb, w2, full), hits(rb, feats.shape[0]), 16, 16,
              torch.bfloat16)
    for label, d in bench_ablate.differences(s1_ms).items():
        print(f"S1 {label}: {d:.4f} ms")

    out = torch.ones((bench_launch.NPAD, bench_launch.COUT),
                     dtype=torch.bfloat16, device=device)
    ablate.empty_launch(out, 256)
    torch.cuda.synchronize()
    s2_worst = float(out.float().abs().max())
    if s2_worst != 0:
        raise AssertionError(f"S2 left {s2_worst} in its output")
    s2_bound = Bound()
    s2_bound.add((out,), 0, 16, 16, torch.bfloat16)
    for block, r in s2["empty"].items():
        print(f"S2 {block:4d} rows/block: (a) host {r['a_host']['issue_us']:.2f}"
              f" us/call issued, {r['a_host']['synced_us']:.2f} synced; (b) "
              f"device {r['b_device_us']:.2f} us/launch; (c) one C call: host"
              f" {r['c_host']['issue_us']:.2f} us/launch, device "
              f"{r['c_device_us']:.2f} us/launch")
    g = s2["glue"]
    print(f"S2 (d) sparse_conv_fwd N={bench_launch.GLUE_N}: wrapper host "
          f"{g['wrapper_host']['issue_us']:.2f} us/call issued, device "
          f"{g['wrapper_device_us']:.2f} us; bare C launches host "
          f"{g['bare_host']['issue_us']:.2f} us/launch, device "
          f"{g['bare_device_us']:.2f} us")
    res = {"counts": counts, "s1_ms": s1_ms, "s1_worst": worst,
           "s1_plain_ms": plain_ms, "s1_bound": bound,
           "s2_ms": s2["empty"][256]["b_device_us"] / 1e3,
           "s2_worst": s2_worst,
           "s2_plain_ms": queued_device_ms(
               lambda: ablate.empty_launch_ref(out), 10),
           "s2_library_ms": queued_device_ms(lambda: out.zero_(), 10),
           "s2_bound": s2_bound}
    print(f"ablation: S1 full equals K1 (zero bias, no ReLU) bit for bit, "
          f"every "
          f"mode within {ABLATE_BOUND} of its plain version (full plain "
          f"{plain_ms:.4f} ms, bound {bound.ms():.4f} ms ({bound.by()})); "
          f"S2 wrote zeros, {res['s2_ms'] * 1e3:.2f} us/launch on the "
          f"device (plain {res['s2_plain_ms'] * 1e3:.2f} us, out.zero_() "
          f"{res['s2_library_ms'] * 1e3:.2f} us, bound "
          f"{s2_bound.ms() * 1e3:.3f} us); launches S1 "
          f"{counts['sparse_conv_ablate']} S2 {counts['empty_launch']}")
    return res


def _state_tensors(state) -> dict:
    opt = state.optimizer
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    out.update({f"mu.{i}": t for i, t in enumerate(opt.mu)})
    out.update({f"nu.{i}": t for i, t in enumerate(opt.nu)})
    return out


def _bf16_trainer(config, root, work, epochs, device):
    cfg = load_train_config(config, root)
    cfg.precision = "bfloat16"
    cfg.total_epochs = epochs
    return Trainer(cfg, work_dir=work, seed=SEED, device=device)


def phase_warm_start(root, tmp, device="cuda"):
    """CIA-SSD -> SE-SSD ``load_from``, then ``resume`` of the SE-SSD run.
    Returns the launches of the two training runs."""
    _reset_counts()
    cia = _bf16_trainer("cia_ssd_kitti_car.py", root, f"{tmp}/work_cia", 1,
                        device)
    cia.run()
    cia_state = {k: v.detach().clone()
                 for k, v in _state_tensors(cia.state).items()}
    cia_counts = (cia.state.optimizer.count, cia.state.optimizer.sched_count)
    del cia

    se = _bf16_trainer("se_ssd_kitti_car_bf16.py", root, f"{tmp}/work_se", 1,
                       device)
    se.load_from(f"{tmp}/work_cia")
    opt = se.state.optimizer
    got = _state_tensors(se.state)
    for k, v in got.items():
        src = "student." + k.split(".", 1)[1] if k.startswith("teacher.") \
            else k
        if not torch.equal(v.cpu(), cia_state[src].cpu()):
            raise AssertionError(f"load_from: {k} differs from the CIA {src}")
    if (opt.sched_count, opt.count, se.state.step) != (0, 2, 0) \
            or cia_counts != (2, 2):
        raise AssertionError(f"load_from: sched_count {opt.sched_count}, "
                             f"count {opt.count}, step {se.state.step} "
                             f"(CIA counts {cia_counts})")
    se.run()
    hist = se.history
    bad = [(h["step"], k) for h in hist for k, v in h.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if len(hist) != 2 or bad:
        raise AssertionError(f"SE-SSD after load_from: {len(hist)} steps, "
                             f"non-finite {bad}")
    counts = _counts()
    lr0 = hist[0]["lr"]
    if lr0 != se.lr_fn(0):
        raise AssertionError(f"first SE-SSD step applied lr {lr0}, want the "
                             f"restarted schedule's {se.lr_fn(0)}")

    again = _bf16_trainer("se_ssd_kitti_car_bf16.py", root,
                          f"{tmp}/work_se", 1, device)
    again.resume()
    o1, o2 = se.state.optimizer, again.state.optimizer
    want = (se.epoch, se.state.step, o1.count, o1.sched_count)
    have = (again.epoch, again.state.step, o2.count, o2.sched_count)
    if have != want:
        raise AssertionError(f"resume: (epoch, step, count, sched_count) "
                             f"{have}, want {want}")
    mine, theirs = _state_tensors(se.state), _state_tensors(again.state)
    diff = [k for k in mine if not torch.equal(mine[k], theirs[k])]
    if diff:
        raise AssertionError(f"resume: {len(diff)} tensors differ, e.g. "
                             f"{diff[:3]}")
    print(f"warm start: CIA-SSD 1 epoch (2 steps) -> load_from: teacher = "
          f"student = CIA student, moments equal, sched_count 0, count 2, "
          f"step 0; SE-SSD 2 steps (lr {lr0:.3g} = schedule(0), loss "
          f"{hist[-1]['loss']:.5g}); resume: epoch {have[0]}, step "
          f"{have[1]}, counts {have[2]}/{have[3]}, {len(mine)} tensors "
          f"equal; launches {counts}")
    return counts


ACCEPT_ARGS = ("8", "4", "1", "1", "1")


def phase_acceptance(tmp):
    """The acceptance script's path at a tiny recipe, in a subprocess."""
    out = os.path.join(tmp, "acceptance.json")
    proc = subprocess.run(
        [sys.executable, "-m", "sessd_torch.scripts.acceptance_ap",
         *ACCEPT_ARGS, "--out", out], capture_output=True, text=True,
        timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"acceptance_ap exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    with open(out) as f:
        rec = json.load(f)
    floor = rec["floor"]
    traj = {s: rec[s]["ap_trajectory"] for s in ("stage_cia", "stage_sessd")}
    # stage A: its final val; stage B: final val + the teacher's
    if [len(t) for t in traj.values()] != [1, 2] or not math.isfinite(
            floor["value"]) or floor["required"] != 70.0:
        raise AssertionError(f"acceptance record: floor {floor}, "
                             f"trajectories {traj}")
    print(f"acceptance path ({' '.join(ACCEPT_ARGS)}): {rec['total_steps']} "
          f"steps, floor {floor['metric']} {floor['value']} (required "
          f"{floor['required']}), trajectory rows "
          f"{[len(t) for t in traj.values()]}, timing "
          f"{rec['stage_sessd']['timing']}, wall {rec['wall_s']} s")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")


WCONV = "sessd_tpu/ops/pallas/wconv.py"


def _entry(name, source, replaces, launches, max_abs, ms, plain_ms, bound,
           library_ms=None):
    """One row of the kernels line; ``replaces`` is the TPU kernel's
    file:line. ``library_ms`` stays None where no one PyTorch call computes
    the kernel's function (a rulebook gather-GEMM)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound.ms(), "bound_by": bound.by(),
            "library_ms": library_ms}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    with phase("build"):
        phase_build()
    model, cfg = build_model("se_ssd_kitti_car_bf16.py", device, prior=True)
    spec = builder.build_voxelizer(cfg.voxel_generator)
    with phase("kernels"):
        max_abs, ms, plain_ms, k1_bound = phase_kernels(model, spec, device)
        b8 = phase_stream_serving(model, spec, device)
    with phase("serving b1/b4"):
        launches, pcfg = phase_serving(model, cfg, spec, device)
    with phase("serving b8"):
        b8_counts = phase_serving_b8(model, cfg, spec, device)
    with phase("head parity"):
        phase_head_parity(spec, device, pcfg)
    del model
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="sessd_smoke_")
    try:
        root = f"{tmp}/kitti"
        t0 = time.perf_counter()
        make_synthetic_root(root, num_frames=8, num_cars=10)
        print(f"synthetic KITTI root: 8 frames in "
              f"{time.perf_counter() - t0:.1f} s")
        with phase("training"):
            trainer = Trainer(load_train_config("se_ssd_kitti_car_bf16.py",
                                                root),
                              work_dir=f"{tmp}/work_bf16", seed=SEED,
                              device=device)
            worst, train_ms, train_bounds, fwd_tile = phase_train_kernels(
                trainer, first_batch(trainer))
            counts = phase_train(trainer)
            del trainer
            torch.cuda.empty_cache()
        with phase("step parity"):
            trainer = Trainer(load_train_config("se_ssd_kitti_car.py", root),
                              work_dir=f"{tmp}/work_f32", seed=SEED,
                              device=device)
            phase_step_parity(trainer)
        with phase("eval"):
            ev = phase_eval_kernels(trainer)
            eval_counts = phase_eval(trainer, root, tmp)
            del trainer
            torch.cuda.empty_cache()
        with phase("ablation"):
            abl = phase_ablation(device)
        with phase("warm start / resume"):
            phase_warm_start(root, tmp)
        with phase("acceptance"):
            phase_acceptance(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    k1_launches = (launches + b8_counts["fused_sparse_conv"]
                   + eval_counts["fused_sparse_conv"])
    k3_launches = (b8_counts["fused_sparse_conv_stream"]
                   + eval_counts["fused_sparse_conv_stream"])
    print(f"main-path launches: K1 {launches} (b1/b4) + "
          f"{b8_counts['fused_sparse_conv']} (b8) + "
          f"{eval_counts['fused_sparse_conv']} (eval); K3 "
          f"{b8_counts['fused_sparse_conv_stream']} (b8) + "
          f"{eval_counts['fused_sparse_conv_stream']} (eval); eval K3 sums "
          f"K3 {ev['ms']:.4f} ms K1 {ev['k1_ms']:.4f} ms twin "
          f"{ev['plain_ms']:.4f} ms bound {ev['bound'].ms():.4f} ms")
    # times: K1 the 14 b1 bf16 convs, K3 the 7 streamed convs of a b8 bf16
    # request, K4/K5 the bf16 student chain at b4
    kernels = [
        _entry("fused_sparse_conv", "sessd_torch/csrc/sparse_conv.cu",
               f"{WCONV}:253", k1_launches, max_abs, ms, plain_ms, k1_bound),
        _entry("fused_sparse_conv_stream",
               "sessd_torch/csrc/sparse_conv_stream.cu", f"{WCONV}:277",
               k3_launches, max(b8["worst"], ev["worst"]), b8["ms"],
               b8["plain_ms"], b8["bound"])]
    kernels[-1].update(covers=f"{WCONV}:350", old_tile_ms=b8["k1_ms"],
                       skipped_tap_share=b8["tiles"].share())
    for name, key, line in (("sparse_conv_fwd", "fwd", 51),
                            ("sparse_conv_dfeat", "dfeat", 67),
                            ("sparse_conv_dw", "dw", 67)):
        kernels.append(_entry(
            name, "sessd_torch/csrc/sparse_conv_train.cu", f"{WCONV}:{line}",
            counts[name], worst[key], train_ms[key][0], train_ms[key][1],
            train_bounds[key]))
    kernels[2].update(old_tile_ms=fwd_tile["old_ms"],
                      skipped_tap_share=fwd_tile["tiles"].share())
    # S1: the full mode's time; S2: device time per launch at 256 rows
    kernels += [
        _entry("sparse_conv_ablate", "sessd_torch/csrc/sparse_conv_ablate.cu",
               "scripts/bench_wconv_ablate.py:51",
               abl["counts"]["sparse_conv_ablate"], abl["s1_worst"],
               abl["s1_ms"]["full"], abl["s1_plain_ms"], abl["s1_bound"]),
        _entry("empty_launch", "sessd_torch/csrc/sparse_conv_ablate.cu",
               "scripts/bench_wconv_ablate2.py:72",
               abl["counts"]["empty_launch"], abl["s2_worst"],
               abl["s2_ms"], abl["s2_plain_ms"], abl["s2_bound"],
               library_ms=abl["s2_library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
