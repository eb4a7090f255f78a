"""Serving cells at throughput: ``serve.make_infer_fn`` of ``sessd_torch``
(the all-sparse backbone's K1/K3 convs, SSFA, head, decode, rotated NMS)
on batches of scans already prepared on the host, a closed loop with two
batches in flight.

Set-up: ``pool`` batches of ``batch`` ``make_scene`` scans from the seed;
each prepared as ``ExactBatchServer`` prepares it (``HostPreprocessor`` at
the serving caps, or at the training caps where a stage the fallback can
fix saturates) and staged on the device. The weights are seeded; the
BatchNorm running statistics are those of the first batch
(``reference.model.calibrate_bn``), the cls bias puts ``candidate_share``
of that batch's anchors above the score threshold, and the box regression
is scaled so that its center and size codes have the root mean square
``box_code_rms`` over that batch.
Every batch of the pool is run once to warm up.

Window: the client issues batch n + 1 before it waits for batch n's
detections on the host; ``infer_batch_p95_ms`` is the 95th percentile of
every batch's issue-to-host time. ``--trace 1`` profiles ``trace_batches``
batches instead, then runs as many again unprofiled for
``scenes_per_s.infer``: every scene whose detections reached the host over
that stretch (the pace of a host-paced loop, which varies from process to
process by more than an end-to-end bound may).

Checked after the window, for a sample of the batches drawn from the seed
(one occurrence of each batch of the pool): the head's outputs against the
reference's forward over the same scans (``head_gap``), and the program's
detections against the reference's decode and NMS of the program's own
head outputs (``det_gap``, ``det_valid_mismatch``).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import harness
from . import common
from .data import build_anchors, load_config, make_scans

KERNELS = ("fused_sparse_conv_kernel", "fused_sparse_conv_stream_kernel")


def _reference_voxelize(spec, cap0: int):
    """scans -> the reference's (voxels, num_points, (b, z, y, x) coords)
    on the card and the batch's row count: the frozen host voxelizer at
    the program's per-scene voxel cap (first points seen survive)."""
    import dataclasses

    from ..hostpath.ops.voxelize import voxelize_np

    spec = dataclasses.replace(spec, max_voxels=min(spec.max_voxels, cap0))

    def voxelize(scans):
        vs, ns, cs = [], [], []
        for b, pts in enumerate(scans):
            v, c, n = voxelize_np(pts, spec)
            vs.append(v)
            ns.append(n)
            cs.append(np.concatenate([np.full((len(c), 1), b), c], 1))
        dev = common.DEVICE
        vox = torch.from_numpy(np.concatenate(vs)).to(dev)
        npts = torch.from_numpy(np.concatenate(ns)).to(dev)
        coords = torch.from_numpy(np.concatenate(cs).astype(np.int64)).to(dev)
        return vox, npts, coords, cap0 * len(scans)

    return voxelize


def inputs(c: dict, seed: int) -> dict:
    """Everything a run of the cell is made of, from the seed: the config,
    the pool's scans, the weights on the device with the BatchNorm running
    statistics of the first batch and the cls bias set from it, and the
    reference's voxelizer."""
    from sessd_torch.serve import SERVING_CAPS

    from ..reference.model import VoxelNet, calibrate_bn
    from .data import build_voxelizer

    cfgj, tr = c["config"], c["traffic"]
    cfg = load_config(cfgj, tr)
    bsz, npool = int(tr["batch"]), int(tr["pool"])
    s_scenes, s_weights, s_sample = harness.seeds(seed, 3)
    scans = make_scans(harness.seeds(s_scenes, bsz * npool),
                       tr["scene_workers"])
    groups = [scans[i * bsz:(i + 1) * bsz] for i in range(npool)]
    spec = build_voxelizer(cfg.voxel_generator)
    ref_vox = _reference_voxelize(spec, SERVING_CAPS[0])
    ref = VoxelNet().to(common.DEVICE)
    ref.load_state_dict(common.weights(s_weights))
    vox, npts, coords, _ = ref_vox(groups[0])
    chain = ref.chain(coords, bsz)
    sd = calibrate_bn(ref, vox, npts, chain)
    # the cls bias at which ``candidate_share`` of the first batch's
    # anchors score above the threshold: every seed's NMS has about as many
    # candidates, and all of them take its small path
    ref.load_state_dict(sd)
    ref.eval()
    with torch.no_grad():
        head = ref(vox, npts, chain)
    logits = head["cls_preds"].flatten()
    key = "bbox_head.tasks.0.conv_cls.bias"
    p = float(cfg.test_cfg["score_threshold"])
    q = torch.quantile(logits - sd[key][0], 1.0 - tr["candidate_share"])
    sd[key] = torch.full_like(sd[key], math.log(p / (1.0 - p))) - q
    # the box codes at the scale of a trained detector's: the root mean
    # square of the center and size codes ``box_code_rms`` (random weights
    # give codes of tens, boxes of 1e-10 by 1e10 m)
    rms = head["box_preds"][..., :6].float().pow(2).mean().sqrt()
    for k in ("weight", "bias"):
        sd[f"bbox_head.tasks.0.conv_box.{k}"] *= tr["box_code_rms"] / rms
    return {"cfg": cfg, "groups": groups, "batch": bsz, "pool": npool,
            "spec": spec, "voxelize": ref_vox, "sd": sd,
            "sample_seed": s_sample}


def reference_heads(x: dict, quant=None) -> list:
    """The reference's head outputs of every batch of the pool."""
    from ..reference.model import VoxelNet

    model = VoxelNet(quant=quant).to(common.DEVICE).eval()
    model.load_state_dict(x["sd"])
    out = []
    with torch.no_grad():
        for g in x["groups"]:
            vox, npts, coords, _ = x["voxelize"](g)
            out.append(model(vox, npts, model.chain(coords, len(g))))
    return out


def predict_config(cfg) -> dict:
    """The reference's decode and NMS settings from the config."""
    tc, h = cfg.test_cfg, cfg.model["bbox_head"]
    return {"score_threshold": tc["score_threshold"],
            "pre": tc["nms"]["nms_pre_max_size"],
            "post": tc["nms"]["nms_post_max_size"],
            "iou_threshold": tc["nms"]["nms_iou_threshold"],
            "post_center_range": tuple(tc["post_center_limit_range"]),
            "use_dir": h.get("loss_aux") is not None,
            "dir_offset": h.get("direction_offset", 0.0)}


def run(c: dict, seed: int, seconds: float, trace: bool,
        t_start: float) -> dict:
    from sessd_torch import builder
    from sessd_torch.serve import (SERVING_CAPS, TRAIN_CAPS,
                                   HostPreprocessor, make_infer_fn,
                                   saturated_stages, stage_inputs)

    tr = c["traffic"]
    limits = c["config"]["limits"][c["workload"]["traffic"]]
    x = inputs(c, seed)
    cfg, groups, bsz, npool, sd = (x[k] for k in ("cfg", "groups", "batch",
                                                  "pool", "sd"))

    # host prep as ExactBatchServer does it, then staged on the card
    spec = x["spec"]
    fast, safe = list(SERVING_CAPS), list(TRAIN_CAPS)
    fixable = {i for i in range(len(fast)) if safe[i] > fast[i]}
    preps = {"fast": HostPreprocessor(spec, fast),
             "safe": HostPreprocessor(spec, safe)}
    staged, kinds, still_full = [], [], 0
    for g in groups:
        p = preps["fast"].batch(g)
        kind = "fast"
        if set(saturated_stages(p["rulebooks"],
                                [cap * bsz for cap in fast])) & fixable:
            kind = "safe"
            p = preps["safe"].batch(g)
            still_full += bool(saturated_stages(p["rulebooks"],
                                                [cap * bsz for cap in safe]))
        staged.append(stage_inputs(p["feats"], p["rulebooks"],
                                   common.DEVICE))
        kinds.append(kind)

    ref_vox = x["voxelize"]
    model = builder.build_detector(cfg).to(common.DEVICE)
    model.load_state_dict(sd)
    model.eval()
    anchors = build_anchors(cfg)
    pcfg = builder.build_predict_config(cfg)
    infer = {k: make_infer_fn(model, anchors, pcfg, caps, bsz,
                                common.DEVICE)
             for k, caps in (("fast", fast), ("safe", safe))}

    captured, want = {}, {}
    rng = np.random.default_rng(x["sample_seed"])
    cycles = int(tr["sample_cycles"])
    for j in range(npool):
        want[j] = int(rng.integers(cycles))
    seen = [0] * npool
    state = {"key": None, "head_ev": None}

    def hook(_m, _i, out):
        if state["key"] is not None:
            captured[state["key"]] = {"head": out[0]}
        if state["head_ev"] is not None:
            state["head_ev"].record()

    handle = model.bbox_head.register_forward_hook(hook)
    pin = common.DEVICE == "cuda"
    post = pcfg.nms_post_max_size
    slots = [tuple(torch.empty(s, dtype=d, pin_memory=pin)
                   for s, d in (((bsz, post, 7), torch.float32),
                                ((bsz, post), torch.float32),
                                ((bsz, post), torch.bool)))
             for _ in range(2)]
    events = []

    def issue(k: int, in_window: bool):
        j = k % npool
        occ = seen[j]
        seen[j] += 1
        state["key"] = j if (in_window and occ == want[j]) else None
        t0 = time.perf_counter()
        out = infer[kinds[j]](*staged[j])
        if state["key"] is not None:
            captured[j]["dets"] = out
        slot = slots[k % 2]
        for dst, src in zip(slot, out):
            dst.copy_(src, non_blocking=True)
        ev = common.event()
        ev.record()
        return t0, ev

    for k in range(npool):  # warm-up: every batch, every plan
        issue(k, False)
    common.sync()
    seen = [0] * npool
    setup_s = time.perf_counter() - t_start
    before = common.entry_launches()

    lat = []
    predict_ms = []
    res = {"notes": [], "end_to_end": {}}

    def loop(stop, marks=None, timing=trace):
        prev = None
        k = 0
        t_first = time.perf_counter()
        if marks is not None:
            marks.append(t_first)
        while True:
            if timing:
                state["head_ev"] = common.event(timing=True)
            cur = issue(k, True)
            if timing:
                end = common.event(timing=True)
                end.record()
                events.append((state["head_ev"], end))
            k += 1
            if prev is not None:
                prev[1].synchronize()
                lat.append((time.perf_counter() - prev[0]) * 1e3)
                if marks is not None:
                    marks.append(time.perf_counter())
            prev = cur
            if stop(k, t_first):
                break
        prev[1].synchronize()
        lat.append((time.perf_counter() - prev[0]) * 1e3)
        return k, time.perf_counter() - t_first

    if trace:
        n = int(tr["trace_batches"])
        with torch.profiler.profile(
                activities=common.device_activity()) as prof:
            n, window = loop(lambda k, t0: k >= n)
        common.sync()
        predict_ms = [a.elapsed_time(b) for a, b in events]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as host:
            loop(lambda k, t0: k >= common.HOST_STEPS)
        common.sync()
        state["head_ev"] = None
        n_fast, w_fast = loop(lambda k, t0: k >= n, timing=False)
    else:
        marks, probe = [], common.host_probe()
        n, window = loop(lambda k, t0: time.perf_counter() - t0 >= seconds,
                         marks)
        res["notes"].append(common.host_note(probe, marks))
        res["end_to_end"] = {
            "infer_batch_p95_ms": harness.percentile(lat, 95),
            "setup_s": setup_s}
        res["notes"].append(f"{n * bsz / window:.3f} scenes/s")
    handle.remove()
    memory_peak = common.memory_peak()
    comparison = common.entry_launches() - before
    res.update(attempted=n * bsz, failed=0, memory_peak=memory_peak)
    res["notes"].append(
        f"window {window:.3f} s, {n} batches of {bsz}, setup "
        f"{setup_s:.3f} s, p50 {harness.percentile(lat, 50):.3f} ms, "
        f"{kinds.count('safe')} of {npool} batches at the training caps, "
        f"{len(captured)} checked")
    # the sample, then the program's state freed before the reference
    sample = {j: ({k: v.float() for k, v in d["head"].items()},
                  tuple(x.clone() for x in d["dets"]))
              for j, d in captured.items()}
    del model, infer, staged, captured, slots, events, hook, issue, loop
    common.free()

    nums = check(sample, groups, sd, ref_vox, cfg, anchors, bsz)
    res["readings"] = nums
    res["checks"] = [(k, nums[k], lim) for k, lim in limits.items()]
    res["checks"] += [("unchecked_batches", npool - len(sample), 0),
                      ("saturated_at_training_caps", still_full, 0),
                      ("comparison_entry_launches", comparison, 0)]
    res["notes"].append(f"{nums['detections']} detections checked")
    if trace:
        res["trace"] = common.trace_infer(
            prof, window, host, [k % npool for k in range(n)],
            cfg.get("precision", "float32"), sd, groups, ref_vox, KERNELS,
            float(np.mean(predict_ms)))
        res["trace"].extra["scenes_per_s"] = n_fast * bsz / w_fast
    return res


def check(sample: dict, groups, sd, ref_vox, cfg, anchors, bsz) -> dict:
    """The serving comparison over the sampled batches:

    - ``head_gap``: the relative error of the program's head outputs
      against the reference's (float32, the same scans and weights),
      ||program - reference|| / ||reference|| over each output of a
      batch, the worst of the outputs and batches;
    - ``det_valid_mismatch``: detection slots whose validity differs
      between the program and the reference's own decode and NMS
      (``reference/predict.py``) of the program's head outputs, slot by
      slot in NMS order, over the detections with a score above 0 (those
      whose IoU prediction rectifies the score to 0 tie, follow the
      others on both sides, and may come in any order);
    - ``det_gap``: on the slots valid in both, the widest gap of a score or
      a box coordinate, over max(1, its magnitude)."""
    from ..reference.model import VoxelNet
    from ..reference.predict import detections

    model = VoxelNet().to(common.DEVICE).eval()
    model.load_state_dict(sd)
    pcfg = predict_config(cfg)
    anc = torch.from_numpy(anchors).float().to(common.DEVICE)
    head_gap = det_gap = 0.0
    mismatch = dets = 0
    with torch.no_grad():
        for j, (head, (boxes, scores, valid)) in sorted(sample.items()):
            vox, npts, coords, _ = ref_vox(groups[j])
            out = model(vox, npts, model.chain(coords, bsz))
            for k, r in out.items():
                head_gap = max(head_gap, float(torch.linalg.vector_norm(
                    head[k] - r) / torch.linalg.vector_norm(r)))
            for i in range(valid.shape[0]):
                d = detections({k: v[i] for k, v in head.items()}, anc, pcfg)
                mine = torch.zeros_like(valid[i])
                mine[:len(d["valid"])] = d["valid"] & (d["scores"] > 0)
                prog = valid[i] & (scores[i] > 0)
                mismatch += int((mine != prog).sum())
                dets += int(prog.sum())
                both = torch.nonzero(mine & prog)[:, 0]
                if len(both):
                    for a, b in ((scores[i, both], d["scores"][both]),
                                 (boxes[i, both], d["boxes"][both])):
                        det_gap = max(det_gap, float(
                            ((a.float() - b).abs() / b.abs().clamp_min(1.0))
                            .max()))
    return {"head_gap": head_gap, "det_gap": det_gap,
            "det_valid_mismatch": mismatch, "detections": dets}
