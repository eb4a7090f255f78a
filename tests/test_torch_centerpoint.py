"""CenterPoint-Voxel (Waymo) on the port, on the CPU at a small grid
((41, 64, 64), 5 features, a few hundred voxels a scan, batch 2, the
kernels' plain twins) against the plain reference the benchmark runs,
``portbench/reference/centerpoint.py``, on seeded weights: a residual
block, the whole SpMiddleResNetFHD, RPN + CenterHead, the center decode
and NMS, ``build_detector`` on both configs, the NMS twin at pre 4096
against the reference's greedy loop, the box layout's IoU on a hand-made
pair, and the serving pass's spans and ``sparse_residual`` counter. On
the card (``-m cuda``, skipped without one): a bf16 serving batch at the
published grid with the RPN's and head's 20 conv + BatchNorm pairs folded
on channels-last maps, against the unfolded NCHW path and an f32
reference of the neck and head (``test_torch_bn_fold.check_serving``).

    python -m pytest tests/test_torch_centerpoint.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_centerpoint.py
"""
import math

import numpy as np
import pytest
import torch

from sessd_torch import builder
from sessd_torch.core.box_torch import BEV5_COLUMNS
from sessd_torch.core.rotated_iou import iou_bev_matrix
from sessd_torch.models import backbone as bb
from sessd_torch.models.predict import predict_batch
from sessd_torch.ops.cuda import nms as nms_cuda
from sessd_torch.ops.cuda.sparse_conv import fused_sparse_conv_ref
from portbench.reference import centerpoint as ref
from sessd_torch.serve import make_infer_fn
from sessd_torch.utils import profiling
import test_torch_threads  # noqa: F401 (torch's threads under xdist)
from test_torch_bn_fold import check_serving, cuda, randomize  # noqa: F401

SHAPE = (41, 64, 64)  # the smallest (D, H, W) whose last stage keeps D = 2
B, V = 2, 400
CAPS = (V, 3000, 2500, 1200, 600)
CONFIGS = ("centerpoint_waymo.py", "centerpoint_waymo_bf16.py")


def _scans(seed, n=300):
    """[B, V, 3] unique (z, y, x) coords (n a scan) and valid [B, V]."""
    rng = np.random.RandomState(seed)
    coords = np.zeros((B, V, 3), np.int64)
    valid = np.zeros((B, V), bool)
    for b in range(B):
        flat = rng.choice(math.prod(SHAPE), n, replace=False)
        coords[b, :n] = np.stack(np.unravel_index(flat, SHAPE), 1)
        valid[b, :n] = True
    return torch.from_numpy(coords), torch.from_numpy(valid)


def _model(name="centerpoint_waymo.py", seed=0):
    """The program's detector of the config at the small grid, with seeded
    weights, random conv biases and BatchNorm statistics."""
    cfg = builder.load_config(name)
    model = builder.build_detector(cfg)
    model.sparse_shape = SHAPE
    model.stage_capacity = CAPS
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean") or (k.endswith("bias")
                                              and v.dim() == 1):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    return model.eval(), cfg


def _reference(model):
    r = ref.CenterPoint(SHAPE).eval()
    r.load_state_dict(model.state_dict())
    return r


def _inputs(model, seed=1):
    """The program's (feats [B*V, 5], chain) and the reference's
    (voxels, num_points, chain) of the same scans."""
    coords, valid = _scans(seed)
    rng = torch.Generator().manual_seed(seed)
    feats = torch.randn(B * V, 5, generator=rng)
    chain, sat = model.device_inputs(coords, valid, B)
    assert not sat.any()
    bz = torch.cat([torch.arange(B).repeat_interleave(V)[:, None],
                    coords.reshape(-1, 3)], 1)[valid.reshape(-1)]
    f = feats[valid.reshape(-1)]
    shape = (B,) + SHAPE
    vox, npts, c = ref.sort_voxels(f[:, None, :], torch.ones(len(f)), bz,
                                   shape)
    return feats, chain, (vox, npts, ref.build_chain(c, shape))


def _gap(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_residual_block_matches_the_reference():
    """One block of stage 0 on the program's folded weights and twin
    against the reference's block on the same rows."""
    model, _ = _model()
    r = _reference(model)
    feats, chain, (vox, npts, rchain) = _inputs(model)
    ids0 = chain["ids"][0]
    rows = ids0 < bb.sp.SENTINEL
    x = torch.randn(int(rows.sum()), 16, generator=torch.Generator()
                    .manual_seed(3))
    xp = torch.zeros(len(ids0), 16)
    xp[rows] = x
    w = model.backbone.folded(torch.float32)
    rb = chain["subm"][0]
    before = dict(profiling.RECORDER.counts)
    with torch.no_grad():
        y = fused_sparse_conv_ref(xp, rb, *w[1], len(ids0))
        got = fused_sparse_conv_ref(y, rb, *w[2], len(ids0),
                                    residual=xp)[rows]
    # the program's rows are in z-minor id order, the reference's in
    # (b, z, y, x) key order: match them by coords
    b_, z, yy, xx = bb.sp.delinearize(ids0[rows].long(), (B,) + SHAPE)
    prog_keys = ref._keys(torch.stack([b_, z, yy, xx], 1), (B,) + SHAPE)
    ref_keys = ref._keys(rchain["coords"][0], (B,) + SHAPE)
    order = torch.argsort(prog_keys)
    assert torch.equal(prog_keys[order], ref_keys)
    with torch.no_grad():
        want = r.backbone.conv1[0](x[order], rchain["subm"][0])
    assert _gap(got[order], want) < 1e-5
    assert dict(profiling.RECORDER.counts) == before


def test_backbone_matches_the_reference():
    model, _ = _model()
    r = _reference(model)
    feats, chain, (vox, npts, rchain) = _inputs(model)
    with torch.no_grad():
        got = model.backbone(feats, chain, B, SHAPE, torch.float32)
        f = vox[:, 0, :]
        want = r.backbone(f, rchain)
    assert got.shape == want.shape == (B, 256, 8, 8)
    assert _gap(got, want) < 1e-5


def test_rpn_and_head_match_the_reference():
    model, _ = _model()
    r = _reference(model)
    bev = torch.randn(B, 256, 8, 8, generator=torch.Generator()
                      .manual_seed(4))
    with torch.no_grad():
        got = model.bbox_head(model.neck(bev))[0]
        want = r.bbox_head(r.neck(bev))
    assert set(got) == {"reg", "height", "dim", "rot", "hm"}
    assert model.neck(bev).shape == (B, 512, 8, 8)
    for k, v in want.items():
        assert got[k].shape == v.shape == (B, 64, v.shape[-1])
        assert _gap(got[k], v) < 1e-5, k


def test_whole_forward_matches_the_reference():
    model, _ = _model(seed=5)
    r = _reference(model)
    feats, chain, (vox, npts, rchain) = _inputs(model, seed=6)
    with torch.no_grad():
        got = model(feats[:, None, :], torch.ones(B * V, dtype=torch.int32),
                    chain, B)[0]
        want = r(vox, npts, rchain)
    for k, v in want.items():
        assert _gap(got[k], v) < 1e-4, k


def _heads(seed, n=64 * 64, hot=300):
    """Center-head outputs [B, n, .] of the full-size grid's decode at a
    64 x 64 grid: ``hot`` positions a scene over the threshold in small
    clusters, car-sized boxes."""
    g = torch.Generator().manual_seed(seed)
    hm = torch.randn(B, n, 3, generator=g) - 5.0
    for b in range(B):
        seeds = torch.randint(0, n, (hot // 6,), generator=g)
        idx = (seeds[:, None] + torch.tensor([0, 1, 2, 64, 65, 66])).clamp(
            max=n - 1).reshape(-1)
        hm[b, idx] = torch.rand(len(idx), 3, generator=g) * 4 - 1
    return {"hm": hm, "reg": torch.rand(B, n, 2, generator=g),
            "height": torch.randn(B, n, 1, generator=g) * 0.3,
            "dim": torch.log(torch.tensor([4.7, 2.1, 1.7]))
            + torch.randn(B, n, 3, generator=g) * 0.1,
            "rot": torch.randn(B, n, 2, generator=g)}


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_nms_match_the_reference(seed):
    """The program's center predict (its stable sort and the NMS twin) on
    hand-made heads against the reference's decode and greedy NMS."""
    cfg = builder.load_config("centerpoint_waymo.py")
    pcfg = builder.build_predict_config(cfg)
    pcfg = pcfg._replace(center=(64, 64) + pcfg.center[2:])
    heads = _heads(seed)
    profiling.reset()
    profiling.enable()
    try:
        got = predict_batch(heads, None, pcfg)
        _, counts = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    names = {n: v for _, n, v in counts}
    # the published capacity, with no host read to choose one
    assert names["nms_full"] == 1 and "host_sync" not in names
    rcfg = {"grid": pcfg.center, "score_threshold": pcfg.score_threshold,
            "post_center_range": pcfg.post_center_range,
            "pre": pcfg.nms_pre_max_size, "post": pcfg.nms_post_max_size,
            "iou_threshold": pcfg.nms_iou_threshold}
    for b in range(B):
        want = ref.detections({k: v[b] for k, v in heads.items()}, rcfg)
        n = len(want["scores"])
        assert 20 < n < int(got["valid"][b].sum()) + 1
        assert int(got["valid"][b].sum()) == n
        assert not got["valid"][b, n:].any()
        assert torch.allclose(got["box3d_lidar"][b, :n], want["boxes"],
                              atol=1e-5)
        assert torch.equal(got["scores"][b, :n], want["scores"])
        assert torch.equal(got["label_preds"][b, :n], want["labels"])


def test_box_layout_gives_the_polygon_iou():
    """Two CenterPoint boxes (x, y, z, dx, dy, dz, heading) along the
    diagonal y = x, the second sqrt(2) m further along it: their BEV IoU
    is (4 - sqrt 2) / (8 - (4 - sqrt 2)). The port's IoU on the columns
    the center predict hands its NMS (the heading negated) and the
    reference's clipped polygon both give it; the heading unturned would
    put the second box beside the first, at IoU 0."""
    a = torch.tensor([[0.0, 0.0, 0.0, 4.0, 1.0, 1.5, math.pi / 4]])
    b = torch.tensor([[1.0, 1.0, 0.0, 4.0, 1.0, 1.5, math.pi / 4]])
    inter = 4.0 - math.sqrt(2.0)
    want = inter / (8.0 - inter)
    port = lambda x: torch.cat([x[:, :6], -x[:, 6:]], 1)[:, BEV5_COLUMNS]
    assert float(iou_bev_matrix(port(a), port(b))) == pytest.approx(
        want, abs=1e-5)
    assert float(ref.iou_bev(a, b)) == pytest.approx(want, abs=1e-5)
    unturned = lambda x: x[:, BEV5_COLUMNS]
    assert float(iou_bev_matrix(unturned(a), unturned(b))) == 0.0


def test_nms_twin_at_pre_4096_equals_the_greedy_reference():
    """``rotated_nms``'s CPU twin at the published capacity: 4096 rows a
    scene, the first 900 live (car-sized boxes in clusters), the rest
    padding, against the reference's greedy loop over its own IoU."""
    g = np.random.RandomState(7)
    pre, live = nms_cuda.MAX_PRE, 900
    assert pre == 4096
    boxes = np.zeros((1, pre, 7), np.float32)
    k = g.randint(0, 150, live)
    cx, cy = g.uniform(-70, 70, 150)[k], g.uniform(-70, 70, 150)[k]
    boxes[0, :live] = np.stack([cx + g.normal(0, 0.8, live),
                                cy + g.normal(0, 0.8, live),
                                np.zeros(live), np.full(live, 4.7),
                                np.full(live, 2.1), np.full(live, 1.7),
                                g.uniform(-np.pi, np.pi, live)], 1)
    scores = np.full((1, pre), -np.inf, np.float32)
    scores[0, :live] = np.sort(g.rand(live))[::-1]
    boxes_t, scores_t = torch.from_numpy(boxes), torch.from_numpy(scores)
    keep, valid = nms_cuda.rotated_nms(
        torch.cat([boxes_t[..., :6], -boxes_t[..., 6:]], -1), scores_t,
        500, 0.7)
    want = ref.greedy_nms(boxes_t[0, :live], 0.7, 500)
    n = len(want)
    assert 100 < n < live
    assert keep.shape == (1, 500)
    assert keep[0, :n].tolist() == want
    assert valid[0, :n].all() and not valid[0, n:].any()


@pytest.mark.parametrize("name", CONFIGS)
def test_build_detector_on_the_configs(name):
    """The published widths: 21 sparse convs at 16-128 channels (the
    first taking 5 features, padded to 16 exactly), the RPN's 512-channel
    output, a center head of 3 classes; f32 or bf16 compute; the serving
    decode at 188 x 188, pre 4096, post 500, IoU 0.7."""
    cfg = builder.load_config(name)
    model = builder.build_detector(cfg)
    assert isinstance(model.backbone, bb.SpMiddleResNetFHD)
    assert model.sparse_shape == (41, 1504, 1504)
    assert model.dtype == (torch.bfloat16 if "bf16" in name
                           else torch.float32)
    convs = model.backbone.convs()
    assert len(convs) == 21
    assert sorted({int(c.weight.shape[-1]) for c, _ in convs}) == [
        16, 32, 64, 128]
    assert convs[0][0].weight.shape == (3, 3, 3, 5, 16)
    w0 = model.backbone.folded(torch.float32)[0][0]
    assert w0.shape == (27, 16, 16) and not w0[:, 5:].any()
    blocks = sum(len(b) for _, b in model.backbone.stages())
    assert blocks == 8
    assert sum(d[0].out_channels for d in model.neck.deblocks) == 512
    assert model.bbox_head.tasks[0].hm[-1].out_channels == 3
    r = ref.CenterPoint()
    assert set(r.state_dict()) == set(model.state_dict())
    pcfg = builder.build_predict_config(cfg)
    assert pcfg.center == (188, 188, 0.8, 0.8, -75.2, -75.2)
    assert (pcfg.nms_pre_max_size, pcfg.nms_post_max_size,
            pcfg.nms_iou_threshold) == (4096, 500, 0.7)
    assert builder.build_voxelizer(cfg.voxel_generator).max_voxels == 200000


def test_serving_spans_and_the_residual_counter():
    """``make_infer_fn`` with no anchors: the ``infer.*`` and ``model.*``
    spans, the center predict's ``predict.*`` spans, one
    ``sparse_residual`` per block (8) and one NMS path."""
    model, cfg = _model()
    pcfg = builder.build_predict_config(cfg)
    pcfg = pcfg._replace(center=(8, 8) + pcfg.center[2:])
    feats, chain, _ = _inputs(model)
    infer = make_infer_fn(model, None, pcfg, CAPS, B, "cpu")
    profiling.reset()
    profiling.enable()
    try:
        boxes, scores, valid = infer(feats, chain)
        spans, counts = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    names = [s[0] for s in spans]
    for n in ("infer.batch", "infer.stage", "infer.forward", "infer.predict",
              "model.backbone", "model.neck", "model.head", "predict.decode",
              "predict.nms", "predict.finish"):
        assert n in names, n
    got = {n: v for _, n, v in counts}
    assert got["sparse_residual"] == 8
    assert got["nms_full"] == 1 and "host_sync" not in got
    assert boxes.shape == (B, 64, 7) and valid.shape == (B, 64)
    # off, nothing is counted
    with torch.no_grad():
        model(feats[:, None, :], torch.ones(B * V, dtype=torch.int32), chain,
              B)
    assert profiling.records() == ([], [])


@pytest.mark.parametrize("copy,origin", [
    ("portbench/hostpath/configs/centerpoint_waymo.py",
     "sessd_torch/configs/centerpoint_waymo.py"),
    ("portbench/hostpath/configs/centerpoint_waymo_bf16.py",
     "sessd_torch/configs/centerpoint_waymo_bf16.py")])
def test_benchmark_copies_equal_their_origins(copy, origin):
    """The benchmark runs byte copies of the configs: change the origin and
    the copy together."""
    root = builder.CONFIG_DIR.parents[1]
    assert (root / copy).read_bytes() == (root / origin).read_bytes()


def test_reference_imports_nothing_of_the_program():
    import ast

    path = builder.CONFIG_DIR.parents[1] / "portbench" / "reference" / \
        "centerpoint.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "no relative import"
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "itertools", "typing", "numpy", "torch",
                    "copy"}


def _surface(batch: int, shape, side: int = 240, seed: int = 0):
    """coords [batch, V, 3] (z, y, x) and valid [batch, V], V = shape's
    voxels a scan at most: a ground surface of side x side sites a scan
    at a random place of the grid, each at a height from a smooth ramp
    plus one voxel of noise (~2 voxels a site)."""
    rng = np.random.RandomState(seed)
    d, h, w = shape
    per = []
    for _ in range(batch):
        y0, x0 = rng.randint(0, h - side), rng.randint(0, w - side)
        yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        z = (d // 3 + (yy + xx) * 4 // (2 * side)).reshape(-1)
        yx = np.stack([yy.reshape(-1) + y0, xx.reshape(-1) + x0], 1)
        zyx = np.concatenate([
            np.concatenate([z[:, None], yx], 1),
            np.concatenate([(z + rng.randint(1, 3, z.shape))[:, None], yx],
                           1)])
        per.append(np.unique(zyx, axis=0))
    v = max(len(p) for p in per)
    coords = np.zeros((batch, v, 3), np.int64)
    valid = np.zeros((batch, v), bool)
    for b, p in enumerate(per):
        coords[b, :len(p)] = p
        valid[b, :len(p)] = True
    return torch.from_numpy(coords), torch.from_numpy(valid)


@pytest.mark.cuda
def test_card_serving_batch_folds_in_nhwc(cuda):
    """A bf16 serving batch of 2 at the published grid (41, 1504, 1504)
    and stage caps, on a synthetic ground surface: the neck's and head's
    20 pairs (the RPN's 12 convs and 2 deblocks, the shared conv, 5
    hidden convs) fold, with no cuDNN transpose and their BatchNorm passes
    gone from the profile."""
    cfg = builder.load_config("centerpoint_waymo_bf16.py")
    model = randomize(builder.build_detector(cfg), seed=12).to(cuda).eval()
    b, caps = 2, model.stage_capacity
    coords, valid = _surface(b, model.sparse_shape)
    pad = caps[0] - coords.shape[1]
    coords = torch.nn.functional.pad(coords, (0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))
    chain, sat = model.device_inputs(coords.to(cuda), valid.to(cuda), b)
    assert not sat.any()
    feats = torch.randn(b * caps[0], 5, device=cuda)
    infer = make_infer_fn(model, None, builder.build_predict_config(cfg),
                          caps, b, cuda)
    check_serving(model, infer, (feats, chain), pairs=20)
