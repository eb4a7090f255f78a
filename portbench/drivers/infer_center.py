"""The CenterPoint-Voxel serving cell at throughput: ``serve.make_infer_fn``
of ``sessd_torch`` with no anchors (SpMiddleResNetFHD's 21 K1/K3 convs,
the RPN, the center head, the center decode and the rotated NMS pair at
pre 4096) on batches of Waymo-like scans already prepared on the host, a
closed loop with two batches in flight, as ``infer.py`` runs SE-SSD.

Set-up: ``pool`` batches of ``batch`` scans from the seed
(``waymo_scenes``), each prepared by ``HostPreprocessor`` at the
configuration's stage capacities (the mean of each voxel's 5 features, the
rulebook chain) and staged on the device. The weights are seeded
(``weights``); the BatchNorm running statistics are those of the first
batch (``reference.centerpoint.calibrate_bn``); the heatmap's bias puts
``candidate_share`` of that batch's BEV positions at a best-class score of
0.1 or more; the offset, height and heading codes are scaled to the root
mean square ``box_code_rms`` over that batch, and the size code likewise
about the bias log(4.7, 2.1, 1.7), so that boxes are car-sized. Every batch
of the pool is run once to warm up.

Window: as ``infer.py``'s: ``infer_batch_p95_ms`` is the 95th percentile of
every batch's issue-to-host time. ``--trace 1`` first runs ``span_batches``
batches with the program's span recorder on (``predict_host_ms``), then
profiles ``trace_batches`` batches (device activity only), then a few with
the host's ops, then as many batches as the profiled window ran with
nothing on (``scenes_per_s.center_infer``: their scenes over their
host-clock time). ``memory_peak`` is the program's: the peak is reset once
the reference's set-up is done, before the scans are staged.

Checked after the window for one occurrence of each batch of the pool:
``head_gap`` (the program's head outputs against the float32 reference's
forward over the same scans, ||program - reference|| / ||reference|| per
output and batch, the worst), and the program's detections against the
reference's decode and NMS of the program's own head outputs, matched by
box center: ``det_valid_mismatch`` counts the detections either side has
alone, ``det_gap`` is the widest gap of a score or a box coordinate over
max(1, its magnitude) among the matched; ``saturated_chains`` counts pool
batches with a full stage. The controls' readings (the reference in
float8 e4m3 on one batch, half of a batch's scans dropped, one score
altered by 0.01) go into the notes; ``portbench/tests/
test_portbench_center_faults.py`` plants each on the card and sees the
limits fail.
"""
from __future__ import annotations

import collections
import math
import re
import time

import numpy as np
import torch

from .. import harness
from . import common
from .waymo_scenes import make_scans

KERNELS = ("fused_sparse_conv_kernel", "fused_sparse_conv_stream_kernel")
# the 128-channel instances, (64, 128) and (128, 128), by the template
# arguments in the kernels' names (a residual-store flag may follow)
WIDE = re.compile(r"fused_sparse_conv(?:_stream)?_kernel<[^>]*\b(?:64|128), "
                  r"128(?:, (?:true|false))?>")
DIM_PRIOR = (4.7, 2.1, 1.7)  # m: a car's size, the size code's bias


def load_config(config: dict, traffic: dict):
    """The program's config (the frozen copy) with the configuration's and
    the traffic's overrides; fails where it has drifted from the sizes
    the configuration file publishes."""
    from ..hostpath.config import Config
    from .data import _merge

    cfg = Config.fromfile(harness.PKG / "hostpath" / "configs"
                          / config["program_config"])
    _merge(cfg._cfg, config.get("overrides", {}))
    _merge(cfg._cfg, traffic.get("overrides", {}))
    cfg._cfg = type(cfg._cfg)._wrap(dict(cfg._cfg))
    vg, tc = cfg.voxel_generator, cfg.test_cfg
    got = {"voxel_size": list(vg["voxel_size"]),
           "point_cloud_range": list(vg["range"]),
           "max_points_in_voxel": vg["max_points_in_voxel"],
           "max_voxel_num": list(vg["max_voxel_num"]),
           "precision": cfg.get("precision", "float32"),
           "batch_size": int(traffic["batch"]),
           "stage_capacity": list(cfg["stage_capacity"]),
           "nms_pre_max_size": tc["nms"]["nms_pre_max_size"],
           "nms_post_max_size": tc["nms"]["nms_post_max_size"],
           "nms_iou_threshold": tc["nms"]["nms_iou_threshold"],
           "score_threshold": tc["score_threshold"]}
    for k, v in config["sizes"].items():
        if k in got and got[k] != v:
            raise SystemExit(f"config size {k}: the file says {v}, the "
                             f"config runs {got[k]}")
    return cfg


def spec_of(cfg):
    from ..hostpath.ops.voxelize import VoxelizerSpec

    vg = cfg.voxel_generator
    return VoxelizerSpec(point_cloud_range=tuple(vg["range"]),
                         voxel_size=tuple(vg["voxel_size"]),
                         max_points=vg["max_points_in_voxel"],
                         max_voxels=vg["max_voxel_num"][-1])


def weights(template: dict, seed: int, device) -> dict:
    """Seeded weights of every entry of ``template`` (the detector's state
    dict names and shapes), drawn at once on ``device``: the sparse
    kernels He-uniform over K x Cin, the RPN's convs Xavier-uniform, the
    head's convs uniform over sqrt(6 / Cin) (the port's
    ``reset_parameters``), biases 0, BatchNorm at identity."""
    def bound(name, shape):
        if len(shape) == 5:
            return math.sqrt(6.0 / (math.prod(shape[:3]) * shape[3]))
        if name.startswith("neck.") and len(shape) == 4:
            s0, s1 = shape[:2]
            return math.sqrt(6.0 / (math.prod(shape) // (s0 * s1)
                                    * (s0 + s1)))
        if name.startswith("bbox_head.") and len(shape) == 4:
            return math.sqrt(6.0 / shape[1])
        return None

    drawn = [(k, v.shape) for k, v in template.items()
             if bound(k, v.shape) is not None]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(sum(math.prod(s) for _, s in drawn), generator=gen,
                      device=device) * 2.0 - 1.0
    out, at = {}, 0
    for k, s in drawn:
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s) * bound(k, s)
        at += n
    for k, v in template.items():
        if k not in out:
            one = k.endswith("running_var") or (k.endswith(".weight")
                                                and v.dim() == 1)
            out[k] = (torch.ones if one else torch.zeros)(v.shape,
                                                          device=device)
    return out


def _reference_voxelize(spec):
    """scans -> the reference's (voxels, num_points, (b, z, y, x) coords)
    on the device, in the chain's key order: the frozen host voxelizer
    (the program's; first points seen survive)."""
    from ..hostpath.ops.voxelize import voxelize_np
    from ..reference.centerpoint import sort_voxels

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
        return sort_voxels(vox, npts, coords,
                           (len(scans),) + tuple(spec.sparse_shape))

    return voxelize


def inputs(c: dict, seed: int) -> dict:
    """Everything a run of the cell is made of, from the seed: the config,
    the pool's scans, and the weights on the device with the BatchNorm
    statistics, heatmap bias and code scales set from the first batch."""
    from ..reference.centerpoint import CenterPoint, calibrate_bn

    cfgj, tr = c["config"], c["traffic"]
    cfg = load_config(cfgj, tr)
    bsz, npool = int(tr["batch"]), int(tr["pool"])
    s_scenes, s_weights, s_sample = harness.seeds(seed, 3)
    scans = make_scans(harness.seeds(s_scenes, bsz * npool),
                       tr["scene_workers"])
    groups = [scans[i * bsz:(i + 1) * bsz] for i in range(npool)]
    spec = spec_of(cfg)
    ref_vox = _reference_voxelize(spec)
    ref = CenterPoint(spec.sparse_shape).to(common.DEVICE)
    ref.load_state_dict(weights(ref.state_dict(), s_weights, common.DEVICE))
    vox, npts, coords = ref_vox(groups[0])
    chain = ref.chain(coords, bsz)
    sd = calibrate_bn(ref, vox, npts, chain)
    ref.load_state_dict(sd)
    with torch.no_grad():
        head = ref(vox, npts, chain)
    task = "bbox_head.tasks.0"
    # the heatmap bias at which candidate_share of the first batch's
    # positions have a best-class score of score_threshold or more
    hm_b = sd[f"{task}.hm.3.bias"]
    best = (head["hm"] - hm_b).amax(-1).flatten()
    p = float(cfg.test_cfg["score_threshold"])
    q = torch.quantile(best.float(), 1.0 - tr["candidate_share"])
    sd[f"{task}.hm.3.bias"] = torch.full_like(hm_b, math.log(p / (1 - p))) - q
    # the codes at a trained detector's scale: offsets, height and heading
    # of root mean square box_code_rms, sizes about a car's
    rms = tr["box_code_rms"]
    for name in ("reg", "height", "rot", "dim"):
        w, b = f"{task}.{name}.3.weight", f"{task}.{name}.3.bias"
        code = head[name] - sd[b]
        scale = rms / code.float().pow(2).mean().sqrt()
        sd[w] = sd[w] * scale
        sd[b] = (torch.log(torch.tensor(DIM_PRIOR, device=sd[b].device))
                 if name == "dim" else sd[b] * scale)
    return {"cfg": cfg, "groups": groups, "batch": bsz, "pool": npool,
            "spec": spec, "voxelize": ref_vox, "sd": sd,
            "sample_seed": s_sample}


def decode_config(pcfg) -> dict:
    """The reference's decode and NMS settings from the program's."""
    return {"grid": tuple(pcfg.center),
            "score_threshold": pcfg.score_threshold,
            "post_center_range": tuple(pcfg.post_center_range),
            "pre": pcfg.nms_pre_max_size, "post": pcfg.nms_post_max_size,
            "iou_threshold": pcfg.nms_iou_threshold}


def run(c: dict, seed: int, seconds: float, trace: bool,
        t_start: float) -> dict:
    # the program's CenterPoint entry points first: a program without them
    # fails here, before any set-up
    from sessd_torch import builder
    from sessd_torch.models.backbone import SpMiddleResNetFHD  # noqa: F401
    from sessd_torch.models.head import CenterHead  # noqa: F401
    from sessd_torch.models.predict import predict_center_batch  # noqa: F401
    from sessd_torch.serve import (HostPreprocessor, make_infer_fn,
                                   saturated_stages, stage_inputs)
    from sessd_torch.utils import profiling

    from . import spans as sp

    tr = c["traffic"]
    limits = c["config"]["limits"][c["workload"]["traffic"]]
    x = inputs(c, seed)
    # the peak counts the program's own memory from here, not the float32
    # reference's set-up
    common.free()
    if common.DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cfg, groups, bsz, npool, sd = (x[k] for k in ("cfg", "groups", "batch",
                                                  "pool", "sd"))
    caps = [int(v) for v in cfg["stage_capacity"]]
    prep = HostPreprocessor(x["spec"], caps, num_input_features=5)
    staged, full, voxels = [], 0, []
    for g in groups:
        p = prep.batch(g)
        full += bool(saturated_stages(p["rulebooks"],
                                      [cap * bsz for cap in caps]))
        ids = p["rulebooks"]["ids"]
        voxels.append([int((np.asarray(i) < np.iinfo(np.int32).max).sum())
                       for i in ids])
        staged.append(stage_inputs(p["feats"], p["rulebooks"],
                                   common.DEVICE))
    del prep

    model = builder.build_detector(cfg).to(common.DEVICE)
    model.load_state_dict(sd)
    model.eval()
    pcfg = builder.build_predict_config(cfg)
    infer = make_infer_fn(model, None, pcfg, caps, bsz, common.DEVICE)

    captured = {}
    rng = np.random.default_rng(x["sample_seed"])
    want = {j: int(rng.integers(int(tr["sample_cycles"])))
            for j in range(npool)}
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
        out = infer(*staged[j])
        if state["key"] is not None:
            captured[j]["dets"] = out
        for dst, src in zip(slots[k % 2], out):
            dst.copy_(src, non_blocking=True)
        ev = common.event()
        ev.record()
        return t0, ev

    for k in range(npool):  # warm-up: every batch
        issue(k, False)
    common.sync()
    seen = [0] * npool
    setup_s = time.perf_counter() - t_start
    before = common.entry_launches()
    lat = []
    res = {"notes": [], "end_to_end": {}}

    def loop(stop, marks=None, timing=False):
        prev, k = None, 0
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
        state["head_ev"] = None
        return k, time.perf_counter() - t_first

    if trace:
        profiling.reset()
        profiling.enable()
        try:
            n_span, w_span = loop(lambda k, t0: k >= int(tr["span_batches"]))
            records = profiling.records()
        finally:
            profiling.disable()
            profiling.reset()
        n = int(tr["trace_batches"])
        with torch.profiler.profile(
                activities=common.device_activity()) as prof:
            n, window = loop(lambda k, t0: k >= n, timing=True)
        common.sync()
        predict_ms = float(np.mean([a.elapsed_time(b) for a, b in events]))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as host:
            loop(lambda k, t0: k >= common.HOST_STEPS)
        common.sync()
        n_fast, w_fast = loop(lambda k, t0: k >= n)
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
    stage0 = [v[0] for v in voxels]
    res["notes"].append(
        f"window {window:.3f} s, {n} batches of {bsz}, setup {setup_s:.3f} "
        f"s, p50 {harness.percentile(lat, 50):.3f} ms, {len(captured)} "
        f"checked; stage rows a batch (min/max over the pool) "
        + ", ".join(f"{min(v[i] for v in voxels)}/"
                    f"{max(v[i] for v in voxels)} of {caps[i] * bsz}"
                    for i in range(len(caps)))
        + f"; stage-0 voxels a scan {min(stage0) / bsz:.0f}-"
        f"{max(stage0) / bsz:.0f} (mean a batch)")
    sample = {j: ({k: v.float() for k, v in d["head"].items()},
                  tuple(t.clone() for t in d["dets"]))
              for j, d in captured.items()}
    del model, infer, staged, captured, slots, hook, issue, loop
    common.free()

    nums = check(sample, x, pcfg)
    nums["saturated_chains"] = full
    res["readings"] = nums
    res["checks"] = [(k, nums[k], lim) for k, lim in limits.items()]
    res["checks"] += [("unchecked_batches", npool - len(sample), 0),
                      ("comparison_entry_launches", comparison, 0)]
    res["notes"].append(
        f"{nums['detections']} detections checked; candidates a scan "
        f"{nums['candidates_min']}-{nums['candidates_max']} (mean "
        f"{nums['candidates_mean']:.0f}); NMS capacity "
        f"{nums['nms_capacity']} in every checked batch")
    res["notes"].append("controls (no check): " + ", ".join(
        f"{k} {v!r}" for k, v in controls(sample, x, pcfg, nums).items()))
    if trace:
        t = trace_center(prof, window, host, [k % npool for k in range(n)],
                         cfg.get("precision", "float32"), x, predict_ms)
        ms = sp.host_ms(records[0], "infer.batch")
        t.extra["spans"] = {
            "host_ms": ms, "batches": n_span, "wall_s": w_span,
            "counts": sp.counts_per_root(*records, "infer.batch")}
        t.extra["scenes_per_s"] = n_fast * bsz / w_fast
        t.extra["predict_host_ms"] = (ms.get("infer.predict", 0.0)
                                      - ms.get("predict.sync", 0.0)
                                      if ms else None)
        res["trace"] = t
    return res


def _head_gap(heads: dict, want: dict) -> float:
    return max(float(torch.linalg.vector_norm(heads[k].float() - r)
                     / torch.linalg.vector_norm(r)) for k, r in want.items())


def _match(prog_boxes, prog_scores, want) -> tuple:
    """(detections either side has alone, widest gap among the matched):
    the program's valid detections and the reference's, matched by box
    center within 1 mm."""
    ref_boxes, ref_scores = want["boxes"], want["scores"]
    if len(prog_boxes) == 0 or len(ref_boxes) == 0:
        return len(prog_boxes) + len(ref_boxes), 0.0
    dist = torch.cdist(prog_boxes[:, :2].double(), ref_boxes[:, :2].double())
    near, j = dist.min(1)
    hit = near < 1e-3
    pairs = int(hit.sum())
    alone = (len(prog_boxes) - pairs) + (len(ref_boxes) - pairs)
    if not pairs:
        return alone, 0.0
    gap = 0.0
    for a, b in ((prog_scores[hit], ref_scores[j[hit]]),
                 (prog_boxes[hit], ref_boxes[j[hit]])):
        gap = max(gap, float(((a.float() - b.float()).abs()
                              / b.float().abs().clamp_min(1.0)).max()))
    return alone, gap


def check(sample: dict, x: dict, pcfg) -> dict:
    """The serving comparison over the sampled batches (the module's
    docstring): the float32 reference forward over each batch's scans,
    and its decode and NMS of each scan's program head outputs."""
    from ..reference.centerpoint import CenterPoint, detections

    model = CenterPoint(x["spec"].sparse_shape).to(common.DEVICE).eval()
    model.load_state_dict(x["sd"])
    dcfg = decode_config(pcfg)
    head_gap = det_gap = 0.0
    mismatch = dets = 0
    cands = []
    with torch.no_grad():
        for j, (head, (boxes, scores, valid)) in sorted(sample.items()):
            vox, npts, coords = x["voxelize"](x["groups"][j])
            want = model(vox, npts, model.chain(coords, x["batch"]))
            head_gap = max(head_gap, _head_gap(head, want))
            for i in range(valid.shape[0]):
                one = {k: v[i] for k, v in head.items()}
                d = detections(one, dcfg)
                v = valid[i]
                alone, gap = _match(boxes[i][v], scores[i][v], d)
                mismatch += alone
                det_gap = max(det_gap, gap)
                dets += int(v.sum())
                score = torch.sigmoid(one["hm"]).amax(-1)
                cands.append(int((score > dcfg["score_threshold"]).sum()))
    return {"head_gap": head_gap, "det_gap": det_gap,
            "det_valid_mismatch": mismatch, "detections": dets,
            "candidates_min": min(cands), "candidates_max": max(cands),
            "candidates_mean": float(np.mean(cands)),
            "nms_capacity": pcfg.nms_pre_max_size}


def controls(sample: dict, x: dict, pcfg, nums: dict) -> dict:
    """The readings the limits are set against, on the first sampled
    batch: ``control_fp8`` the reference in float8 e4m3 (every weight,
    conv input and output and BatchNorm output rounded) against the
    float32 reference (``head_gap``); ``fault_half_batch`` the program's
    detections with the batch's second half of scans dropped
    (``det_valid_mismatch``); ``fault_altered_score`` one detection's score
    moved by 0.01 (``det_gap``)."""
    from ..reference.centerpoint import CenterPoint, detections, quantized

    j = min(sample)
    head, (boxes, scores, valid) = sample[j]
    model = CenterPoint(x["spec"].sparse_shape).to(common.DEVICE).eval()
    model.load_state_dict(x["sd"])
    low = quantized(model, "fp8")
    dcfg = decode_config(pcfg)
    with torch.no_grad():
        vox, npts, coords = x["voxelize"](x["groups"][j])
        chain = model.chain(coords, x["batch"])
        fp8 = _head_gap(low(vox, npts, chain), model(vox, npts, chain))
    half = 0
    for i in range(valid.shape[0]):
        d = detections({k: v[i] for k, v in head.items()}, dcfg)
        keep = valid[i] if i < valid.shape[0] // 2 else valid[i] & False
        half += _match(boxes[i][keep], scores[i][keep], d)[0]
        if i == 0:
            altered = scores[i][valid[i]].clone()
            altered[len(altered) // 2] += 0.01
            gap = _match(boxes[i][valid[i]], altered, d)[1]
    return {"control_fp8 head_gap": fp8,
            "fault_half_batch det_valid_mismatch": half,
            "fault_altered_score det_gap": gap}


def trace_center(prof, window: float, host, ran, dtype: str, x: dict,
                 predict_ms: float) -> harness.Trace:
    """The per-layer numbers of a traced window that ran the pool's
    batches ``ran``: the forward's operations (the reference's, counted by
    ``FlopCounterMode``: 2 x hits x Cin x Cout for each sparse conv on its
    own rulebooks, the dense RPN and head as they are) and each of the 21
    convs' bound (``common.fwd_bound``: 2 x hits x Cin x Cout over the
    peak, or its inputs, weights and rulebook read once and its output
    written once over 3.35 TB/s, whichever is longer), all of them and
    the 128-channel ones apart."""
    from ..reference.centerpoint import (CenterPoint, model_flops,
                                         sparse_conv_shapes)

    t = harness.Trace(prof, window, host)
    model = CenterPoint(x["spec"].sparse_shape).to(common.DEVICE).eval()
    model.load_state_dict(x["sd"])
    elt = 2 if dtype == "bfloat16" else 4
    caps = [int(v) * x["batch"] for v in x["cfg"]["stage_capacity"]]
    ib = common.idx_bytes(max(caps))
    flops = bound = wide = 0.0
    for j, times in collections.Counter(ran).items():
        vox, npts, coords = x["voxelize"](x["groups"][j])
        chain = model.chain(coords, x["batch"])
        flops += times * model_flops(model, vox, npts, chain)
        for conv in sparse_conv_shapes(model, chain):
            b = times * common.fwd_bound(conv, elt, ib, dtype)
            bound += b
            wide += b if conv[1] == 128 else 0.0
    t.steps = len(ran)
    t.extra.update(kind="center_infer", model_flops=flops,
                   peak_flops=harness.PEAK_FLOPS[dtype],
                   sparse_bound_s=bound, sparse_s=t.kernel_s(*KERNELS),
                   wide_bound_s=wide,
                   wide_s=sum(s for n, s in t.by_name.items()
                              if WIDE.search(n)),
                   predict_ms=predict_ms)
    return t
