"""Smoke check of the PyTorch/CUDA port (``sessd_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases, each printing its own lines; any failure exits non-zero:
1. The card (``nvidia-smi`` name and power limit) and the build of the CUDA
   kernels from ``sessd_torch/csrc`` (nvcc, into ``build/sessd_torch/``).
2. The fused sparse conv kernel against its plain PyTorch twin on the card,
   for every one of the 14 backbone convs on the features the previous conv
   produced, at full KITTI width (sparse shape (41, 1600, 1408), SERVING_CAPS,
   a ray-cast scene): f32 (TF32 off, bound 1e-4 of max|twin|) and bf16
   (bound 2e-2), batch 1 on int16 rulebooks and batch 4 on int32 ones.
   Per-conv times are CUDA-event medians of 20 launches.
3. End-to-end serving through ``sessd_torch.serve.ExactBatchServer``: the
   SE-SSD Car VoxelNet (sessd_tpu/configs/se_ssd_kitti_car_bf16.py, seeded
   random weights, 70,400 anchors) serves 12 batch-1 requests and one
   batch-4 request with the cls bias at the focal prior, then one batch-1
   request without it. Checks: finite outputs of the expected shapes,
   exactly 14 kernel launches per request, and the head outputs of the
   kernel path equal to the twin path's (f32, TF32 off) to 1e-3 of the max.

The last lines are the kernels JSON line, the card line, and the result
line ``{"ok": true, "device": {...}}``. Without a CUDA device it raises and
prints no result.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from sessd_torch import builder
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.serve import (SERVING_CAPS, ExactBatchServer,
                               HostPreprocessor, make_scene, stage_inputs)

CONV_NAMES = ["subm0a", "subm0b", "down0", "subm1a", "subm1b", "down1",
              "subm2a", "subm2b", "subm2c", "down2", "subm3a", "subm3b",
              "subm3c", "down3"]
BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps=20) -> float:
    fn()  # warm
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
    Returns (max abs error, summed b1 bf16 kernel ms, summed twin ms)."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    scenes = [make_scene(seed=s)[0] for s in range(4)]
    staged = {1: stage_inputs(**prep(scenes[0]), device=device),
              4: stage_inputs(**prep.batch(scenes), device=device)}
    worst_abs, sums = 0.0, [0.0, 0.0]
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
          f"twin {sums[1]:.4f} ms")
    return worst_abs, sums[0], sums[1]


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
    sc.fused_sparse_conv.launches = 0
    for n, (name, server, batch) in enumerate(requests):
        if name == "b1 no prior":
            set_prior(model, False)
        before = sc.fused_sparse_conv.launches
        t0 = time.perf_counter()
        out = server(batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        launched = sc.fused_sparse_conv.launches - before
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


def phase_head_parity(spec, device, pcfg):
    """f32 model, TF32 off: head outputs of the kernel path vs the twin
    path on one request; also reports which NMS capacity each score
    regime takes."""
    model, _ = build_model("se_ssd_kitti_car.py", device, prior=True)
    prep = HostPreprocessor(spec, SERVING_CAPS)
    feats, rb = stage_inputs(**prep(make_scene(seed=0)[0]), device=device)
    ones = torch.ones(feats.shape[0], dtype=torch.int32, device=device)
    with torch.inference_mode():
        for prior in (True, False):
            set_prior(model, prior)
            k = model(feats[:, None, :], ones, rb, 1)[0]
            r = model(feats[:, None, :], ones, rb, 1,
                      conv=sc.fused_sparse_conv_ref)[0]
            for name in k:
                err = float((k[name] - r[name]).abs().max()
                            / r[name].abs().max())
                if not err <= 1e-3:
                    raise AssertionError(f"head {name}: rel_err {err:.3e}")
            n_above = int((torch.sigmoid(k["cls_preds"]).amax(-1)
                           >= pcfg.score_threshold).sum())
            branch = "small" if n_above <= pcfg.nms_pre_small else "full"
            print(f"head parity f32 (prior {'on' if prior else 'off'}): "
                  f"kernel vs twin within 1e-3; {n_above} anchors above "
                  f"{pcfg.score_threshold} -> {branch} NMS capacity")


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

    phase_build()
    model, cfg = build_model("se_ssd_kitti_car_bf16.py", device, prior=True)
    spec = builder.build_voxelizer(cfg.voxel_generator)
    max_abs, ms, plain_ms = phase_kernels(model, spec, device)
    launches, pcfg = phase_serving(model, cfg, spec, device)
    phase_head_parity(spec, device, pcfg)

    print(json.dumps({"kernels": [{
        "name": "fused_sparse_conv", "route": "cuda",
        "source": "sessd_torch/csrc/sparse_conv.cu",
        "replaces": "sessd_tpu/ops/pallas/wconv.py:253",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
