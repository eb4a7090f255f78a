"""The rotated-NMS kernel pair of sessd_torch (``ops/cuda/nms.py``,
``csrc/rotated_nms.cu``) against its plain PyTorch twin, on the card: the
mask kernel's bits (the pair's scratch, passed in) equal to
``iou_bev_matrix(...) > threshold`` on the upper triangle between valid
rows, and the pair's kept ranks and validity equal to the twin's
(``core.nms.nms_sorted`` scene by scene), at batch 8 and pre 256 and
1000, thresholds 0.01 and 0.3, with -inf padding, an all-padding scene, a
one-box scene, tied scores and more kept boxes than post = 100 (and at
pre 4096, CenterPoint's capacity: the scan's 64 words); then the
whole ``predict_batch`` on the card, which takes the pair, against
``predict_single`` scene by scene at the serving cell's density (~70
candidates a scene over 70,400 anchors), with and without the frustum
cull, and with one NMS capacity free of host syncs. Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_nms_cuda.py

Without a CUDA device the ``cuda`` tests skip. Every comparison is exact:
the kernel rounds each operation where the twin's elementwise kernels do.
"""
import numpy as np
import pytest
import torch

from sessd_torch.core import box_np, nms
from sessd_torch.core.anchors import create_anchors_3d_range
from sessd_torch.core.rotated_iou import iou_bev_matrix
from sessd_torch.models import predict
from sessd_torch.ops.cuda import nms as nms_cuda
from sessd_torch.utils import kitti_synth, profiling
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

B = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(rng, n, spread):
    """n car-sized [7] boxes around n // 6 centers, within ``spread`` m."""
    k = max(1, n // 6)
    at = rng.randint(0, k, n)
    cx, cy = rng.uniform(0, 70, k)[at], rng.uniform(-35, 35, k)[at]
    return np.stack([cx + rng.normal(0, spread, n),
                     cy + rng.normal(0, spread, n),
                     rng.uniform(-1.2, -0.8, n),
                     1.6 + rng.normal(0, 0.05, n), 3.9 + rng.normal(0, 0.1, n),
                     np.full(n, 1.5), rng.uniform(-np.pi, np.pi, n)],
                    1).astype(np.float32)


def _batch(pre, seed=0):
    """[B, pre, 7] boxes and [B, pre] scores in each scene's stable
    descending order: scene 0 dense clusters, 1 all padding, 2 one box,
    3 tied scores (four levels), 4 sparse (more kept than post), the rest
    half padding."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([_scene(rng, pre, 4.0 if i == 4 else 0.6)
                      for i in range(B)])
    if pre >= 1000:
        boxes[4, :, :2] = np.stack([rng.uniform(0, 70, pre),
                                    rng.uniform(-35, 35, pre)], 1)
    scores = rng.rand(B, pre).astype(np.float32)
    scores[1] = -np.inf
    scores[2, 1:] = -np.inf
    scores[3] = rng.randint(0, 4, pre) / 4.0
    scores[5:, pre // 2:] = -np.inf
    scores = torch.from_numpy(scores)
    top, order = nms.score_order(scores, pre)
    b = torch.from_numpy(boxes).gather(1, order[..., None].expand(-1, -1, 7))
    return b.contiguous(), top.contiguous()


def _unpack(mask, pre):
    """[B, pre, words] int64 -> [B, pre, pre] bool, bit j % 64 of word
    j // 64."""
    bit = torch.arange(pre, device=mask.device)
    words = mask[..., bit // 64]
    return ((words >> (bit % 64)) & 1).bool()


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [0.01, 0.3])
@pytest.mark.parametrize("pre", [256, 1000, 4096])
def test_mask_bits_equal_the_twins_iou_over_threshold(cuda, pre, thresh):
    boxes, scores = (t.to(cuda) for t in _batch(pre))
    mask = torch.full((B, pre, (pre + 63) // 64), -1, dtype=torch.int64,
                      device=cuda)
    before = nms_cuda.rotated_nms.launches
    nms_cuda.rotated_nms(boxes, scores, 100, thresh, mask=mask)
    torch.cuda.synchronize()
    assert nms_cuda.rotated_nms.launches == before + 2
    got = _unpack(mask, pre)
    rank = torch.arange(pre, device=cuda)
    upper = rank[:, None] < rank[None, :]
    for i in range(B):
        b5 = boxes[i][:, [0, 1, 3, 4, 6]]
        iou = iou_bev_matrix(b5, b5)
        live = scores[i] > -torch.inf
        want = (iou > thresh) & upper & live[:, None] & live[None, :]
        diff = torch.nonzero(got[i] != want)
        assert len(diff) == 0, (i, diff[:8].tolist(),
                                iou[diff[:8, 0], diff[:8, 1]].tolist())
    assert got[0].sum() > pre  # clusters overlap
    # padding rows and columns set no bit: the all-padding and one-box
    # scenes none at all
    assert got[1].sum() == 0 and got[2].sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [0.01, 0.3])
@pytest.mark.parametrize("pre", [256, 1000, 4096])
def test_pair_equals_twin(cuda, pre, thresh):
    boxes, scores = (t.to(cuda) for t in _batch(pre, seed=1))
    before = nms_cuda.rotated_nms.launches
    keep, valid = nms_cuda.rotated_nms(boxes, scores, 100, thresh)
    torch.cuda.synchronize()
    assert nms_cuda.rotated_nms.launches == before + 2
    want_keep, want_valid = nms_cuda.rotated_nms_ref(boxes, scores, 100,
                                                     thresh)
    assert torch.equal(valid, want_valid)
    assert torch.equal(keep, want_keep)
    kept = valid.sum(dim=1).tolist()
    assert kept[1] == 0 and kept[2] == 1 and kept[0] > 1
    if pre == 1000:
        assert kept[4] == 100  # more kept than post: the first 100


@pytest.mark.cuda
def test_pair_rejects_what_it_does_not_take(cuda):
    boxes, scores = (t.to(cuda) for t in _batch(256))
    before = nms_cuda.rotated_nms.launches
    for args, what in (((boxes.double(), scores), "float32"),
                       ((boxes[..., :5].contiguous(), scores), "7\\]"),
                       ((boxes.transpose(0, 1).contiguous().transpose(0, 1),
                         scores), "contiguous"),
                       ((boxes, scores.cpu()), "scores on"),
                       ((torch.zeros(1, 4200, 7, device=cuda),
                         torch.zeros(1, 4200, device=cuda)), "outside")):
        with pytest.raises(ValueError, match=what):
            nms_cuda.rotated_nms(*args, 100, 0.01)
    with pytest.raises(ValueError, match="mask"):
        nms_cuda.rotated_nms(boxes, scores, 100, 0.01, mask=torch.zeros(
            B, 256, 4, dtype=torch.int32, device=cuda))
    assert nms_cuda.rotated_nms.launches == before


def _heads(rng, anchors, per_scene=70):
    """[B, A, .] head outputs: ``per_scene`` anchors over the score
    threshold, in tight groups as a detector's are, the rest far under."""
    a = len(anchors)
    cls = rng.randn(B, a, 1).astype(np.float32) - 6.0
    for i in range(B):
        seeds = rng.choice(a, per_scene // 7, replace=False)
        hot = (seeds[:, None] + rng.randint(-3, 4, (len(seeds), 7)))
        hot = np.clip(hot, 0, a - 1).ravel()
        cls[i, hot, 0] = rng.uniform(0, 3, len(hot))
    return {"cls_preds": cls,
            "box_preds": (rng.randn(B, a, 7) * 0.1).astype(np.float32),
            "dir_cls_preds": rng.randn(B, a, 2).astype(np.float32),
            "iou_preds": rng.uniform(-1, 1, (B, a, 1)).astype(np.float32)}


def _frustums(device):
    """[B, 6, 4, 3] camera frustums of the synthetic KITTI calibration, the
    image narrowing scene by scene (evaluation's cull)."""
    return torch.from_numpy(np.stack([box_np.get_valid_frustum(
        kitti_synth.R0, kitti_synth.TR, (375, w), kitti_synth.P2)[0]
        for w in np.linspace(1242, 400, B).astype(int)])).float().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("frustum", [False, True], ids=["serving", "eval"])
def test_predict_batch_on_the_card_equals_predict_single(cuda, frustum):
    """The serving cell's shapes: 70,400 anchors, ~70 candidates a scene,
    the small path (pre 256, post 100); one ``nms_kernel`` a batch. With
    the frustum cull as ``Trainer.validate`` runs it too."""
    anchors = torch.from_numpy(create_anchors_3d_range(
        [1, 200, 176], [0, -40.0, -1.0, 70.4, 40.0, -1.0]).reshape(-1, 7))
    anchors = anchors.float().to(cuda)
    preds = {k: torch.from_numpy(v).to(cuda)
             for k, v in _heads(np.random.RandomState(3), anchors).items()}
    cfg = predict.PredictConfig()
    surf = _frustums(cuda) if frustum else None
    profiling.reset()
    profiling.enable()
    try:
        before = nms_cuda.rotated_nms.launches
        got = predict.predict_batch(preds, anchors, cfg, surf)
        torch.cuda.synchronize()
        _, counts = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    mine = {n: v for _, n, v in counts}
    assert mine["nms_kernel"] == 1 and mine["nms_small"] == 1
    assert nms_cuda.rotated_nms.launches == before + 2
    small = cfg._replace(nms_pre_max_size=cfg.nms_pre_small)
    want = [predict.predict_single({k: v[i] for k, v in preds.items()},
                                   anchors, small,
                                   None if surf is None else surf[i])
            for i in range(B)]
    for k, v in got.items():
        assert torch.equal(v, torch.stack([w[k] for w in want])), k
    assert (got["valid"].sum(dim=1) > (0 if frustum else 3)).all()


@pytest.mark.cuda
def test_predict_batch_reads_nothing_back_past_the_two_level_choice(cuda):
    """With one NMS capacity (no two-level choice, whose ``predict.sync``
    reads the batch's candidate count), decode, NMS and finish issue no
    host sync: torch's sync debug mode raises on any."""
    anchors = torch.from_numpy(create_anchors_3d_range(
        [1, 200, 176], [0, -40.0, -1.0, 70.4, 40.0, -1.0]).reshape(-1, 7))
    anchors = anchors.float().to(cuda)
    preds = {k: torch.from_numpy(v).to(cuda)
             for k, v in _heads(np.random.RandomState(4), anchors).items()}
    cfg = predict.PredictConfig(nms_pre_small=0)
    want = predict.predict_batch(preds, anchors, cfg)  # caches the bounds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = predict.predict_batch(preds, anchors, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
