"""The reduction of the program's spans (``portbench/drivers/spans.py``) on
hand-made device intervals and spans: phases by path, the innermost span's
pieces, each idle gap split by phase with the rest under ``between``, and
each metric's arithmetic. Then ``portbench/phases.py``'s stretches on a
small serving pass on the CPU.

    python -m pytest portbench/tests -q
"""
import numpy as np
import pytest
import torch

from portbench import phases
from portbench.drivers import common, spans

T0 = 1_000_000  # the profile's start, ns

# one step on the host, in ns after T0 (us on the profile's time line):
# step 0-100 us, inputs 0-10, student_fwd 10-60 with backbone 15-40 and
# head 45-55, loss 60-70, optim 75-95; the next step starts at 110
HAND = [("train.step", 0, 100, -1, 0), ("train.inputs", 0, 10, 0, 0),
        ("train.student_fwd", 10, 60, 0, 0),
        ("model.backbone", 15, 40, 2, 0), ("model.head", 45, 55, 2, 0),
        ("train.loss", 60, 70, 0, 0), ("train.optim", 75, 95, 0, 0),
        ("train.step", 110, 130, -1, 7)]
SPANS = [(n, T0 + 1000 * a, T0 + 1000 * b, p, r) for n, a, b, p, r in HAND]


def test_phase_names_are_paths_below_the_root():
    assert spans.phase_names(SPANS) == [
        "train.step", "train.inputs", "train.student_fwd",
        "train.student_fwd/model.backbone", "train.student_fwd/model.head",
        "train.loss", "train.optim", "train.step"]


def test_timeline_takes_the_innermost_span():
    assert spans.timeline(SPANS, T0) == [
        (0.0, 10.0, "train.inputs"),
        (10.0, 15.0, "train.student_fwd"),
        (15.0, 40.0, "train.student_fwd/model.backbone"),
        (40.0, 45.0, "train.student_fwd"),
        (45.0, 55.0, "train.student_fwd/model.head"),
        (55.0, 60.0, "train.student_fwd"),
        (60.0, 70.0, "train.loss"),
        (70.0, 75.0, "train.step"),
        (75.0, 95.0, "train.optim"),
        (95.0, 100.0, "train.step"),
        (110.0, 130.0, "train.step")]


def test_idle_split_by_phase_and_between():
    # device busy 5-12, 20-30, 50-72, 80-90 and 120-125 us: gaps 12-20
    # (student_fwd 12-15, backbone 15-20), 30-50 (backbone 30-40,
    # student_fwd 40-45, head 45-50), 72-80 (step 72-75, optim 75-80) and
    # 90-120 (optim 90-95, step 95-100, no span 100-110, step 110-120)
    device = [(20.0, 30.0), (5.0, 12.0), (50.0, 72.0), (80.0, 90.0),
              (120.0, 125.0)]
    idle = spans.idle_by_phase(device, SPANS, T0)
    assert idle == pytest.approx({
        "train.student_fwd": 3.0 + 5.0,
        "train.student_fwd/model.backbone": 5.0 + 10.0,
        "train.student_fwd/model.head": 5.0,
        "train.step": 3.0 + 5.0 + 10.0,
        "train.optim": 5.0 + 5.0,
        spans.BETWEEN: 10.0})
    gaps = (20 - 12) + (50 - 30) + (80 - 72) + (120 - 90)
    assert sum(idle.values()) == pytest.approx(gaps)
    assert spans.idle_by_phase([], SPANS, T0) == {}


def test_host_metrics_arithmetic():
    ms = spans.host_ms(SPANS, "train.step")
    # two roots: each name's milliseconds over two
    assert ms["train.step"] == pytest.approx((0.100 + 0.020) / 2)
    assert ms["train.student_fwd"] == pytest.approx(0.050 / 2)
    got = spans.metrics("train", ms, busy_s=0.025, wall_s=0.1)
    assert got == pytest.approx({
        "forward_host_ms.train": (0.010 + 0.050) / 2,
        "loss_host_ms.train": 0.010 / 2,
        "backward_host_ms.train": 0.0,
        "optim_ema_host_ms.train": 0.020 / 2,
        "device_idle_untraced.train": 75.0})
    serve = {"infer.batch": 50.0, "infer.stage": 1.0, "infer.forward": 20.0,
             "infer.predict": 28.0, "predict.sync": 9.0}
    assert spans.metrics("infer", serve, 0.01, 0.04) == pytest.approx({
        "forward_host_ms.infer": 21.0, "predict_host_ms.infer": 19.0,
        "sync_wait_ms.infer": 9.0, "device_idle_untraced.infer": 75.0})
    assert spans.metrics("train", {}, 0.01, 0.04) == {}
    counts = [(0, "host_sync", 1), (7, "host_sync", 1), (0, "nms_small", 1),
              (7, "nms_full", 1)]
    assert spans.counts_per_root(SPANS, counts, "train.step") == {
        "host_sync": 1.0, "nms_small": 0.5, "nms_full": 0.5}


def test_stretches_on_a_small_serving_pass(monkeypatch):
    """``phases.measure`` on the CPU, where its profiles hold no device
    interval: every stretch runs, the on/off pairs before the first
    profile, the spans are off again after it, and each batch holds one
    host read."""
    from sessd_torch.core.anchors import create_anchors_3d_range
    from sessd_torch.models.detector import VoxelNet
    from sessd_torch.models.predict import PredictConfig
    from sessd_torch.ops.voxelize import VoxelizerSpec
    from sessd_torch.serve import HostPreprocessor, make_infer_fn
    from sessd_torch.utils import profiling

    monkeypatch.setattr(common, "DEVICE", "cpu")
    spec = VoxelizerSpec((0.0, -1.6, -3.0, 3.2, 1.6, 1.0),
                         (0.05, 0.05, 0.1), max_points=5, max_voxels=20000)
    caps = (2048, 6144, 4096, 1024, 512)
    model = VoxelNet(sparse_shape=spec.sparse_shape)
    model.reset_parameters(torch.Generator().manual_seed(0))
    anchors = create_anchors_3d_range(
        [1, 8, 8], [0.0, -1.6, -1.0, 3.2, 1.6, -1.0]).reshape(-1, 7)
    cfg = PredictConfig(nms_pre_small=64, post_center_range=(
        -10.0, -10.0, -10.0, 10.0, 10.0, 10.0))
    infer = make_infer_fn(model.eval(), anchors, cfg, caps, 1, "cpu")
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.rand(1500, 3) * [3.2, 3.2, 4.0]
                          + [0.0, -1.6, -3.0], rng.rand(1500, 1)], 1)
    batch = HostPreprocessor(spec, caps)(pts.astype(np.float32))

    order = []
    profile = phases._profile

    def profiled(*args):
        order.append("profile")
        return profile(*args)

    def run(k):
        order.append("run")
        for _ in range(k):
            infer(**batch)

    monkeypatch.setattr(phases, "_profile", profiled)
    out = phases.measure("infer", run, 2, rounds=2)
    # the on/off stretches run before any profile, one more after them
    assert order == ["run"] * 4 + ["profile", "run", "profile", "run",
                                   "run"]
    assert not profiling.RECORDER.on
    assert profiling.records() == ([], [])
    assert len(out["spans_on_s"]) == len(out["spans_off_s"]) == 2
    assert out["off_after_profiles_s"] > 0
    assert out["counts"]["host_sync"] == 1.0
    assert set(out["metrics"]) == {
        "forward_host_ms.infer", "predict_host_ms.infer",
        "sync_wait_ms.infer", "device_idle_untraced.infer"}
    assert "infer.predict/predict.sync" in out["self_ms"]
