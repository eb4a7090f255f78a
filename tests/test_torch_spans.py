"""The host span and counter recorder of ``sessd_torch/utils/profiling.py``
on the CPU: off, it records nothing and reads no clock; on, it nests spans,
roots them in the outermost span and counts under the root; self time is
a span's duration less what its children cover. The training step (the
small SE-SSD step of ``tests/test_torch_train_step.py``) and the serving
pass (``make_infer_fn`` on the cropped grid of ``tests/test_torch_serve.py``)
record their phases, and a ``torch.profiler`` trace taken with the
recorder on holds no event named after a span. A serving batch counts
SE-SSD's 14 folded conv + BatchNorm pairs (``conv_bn_folded``), a train
step none."""
import copy
import time

import numpy as np
import pytest
import torch

from sessd_torch.core.anchors import create_anchors_3d_range
from sessd_torch.models.detector import VoxelNet
from sessd_torch.models.predict import PredictConfig
from sessd_torch.ops.voxelize import VoxelizerSpec
from sessd_torch.serve import HostPreprocessor, make_infer_fn
from sessd_torch.train import optim as to
from sessd_torch.train.train_step import TrainState, make_train_step
from sessd_torch.utils import profiling
from tests.test_torch_common import SPARSE_SHAPE
from tests.test_torch_train_step import (OCFG, STEP, _loss_cfgs, make_batch,
                                         port_batch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

TRAIN_PHASES = ["train.inputs", "train.teacher_fwd", "train.student_fwd",
                "train.loss", "train.backward", "train.optim", "train.ema",
                "train.teacher_metrics"]
MODEL = ["model.backbone", "model.neck", "model.head"]


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty afterwards."""
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def _children(spans, parent):
    return [i for i, s in enumerate(spans) if s[3] == parent]


def _covered(spans, root):
    """The root's duration and what its children leave uncovered, in ns."""
    _, a, b, _, _ = spans[root]
    return b - a, profiling.self_ns(spans)[root]


def test_recorder_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    profiling.disable()
    profiling.reset()
    monkeypatch.setattr(time, "time_ns", no_clock)
    first = profiling.span("a")
    with first:
        with profiling.span("b"):
            profiling.count("c", 3)
    assert profiling.span("d") is first is profiling.NO_SPAN
    assert profiling.records() == ([], [])


def test_recorder_nests_roots_counts_and_self_time(recorder, monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(time, "time_ns", lambda: next(ticks))
    profiling.count("outside")
    with profiling.span("step"):            # 0 .. 70
        with profiling.span("fwd"):         # 10 .. 40
            with profiling.span("conv"):    # 20 .. 30
                profiling.count("launch", 2)
        with profiling.span("bwd"):         # 50 .. 60
            profiling.count("launch")
    with profiling.span("step"):            # 80 .. 90
        profiling.count("launch")
    spans, counts = profiling.records()
    assert spans == [("step", 0, 70, -1, 0), ("fwd", 10, 40, 0, 0),
                     ("conv", 20, 30, 1, 0), ("bwd", 50, 60, 0, 0),
                     ("step", 80, 90, -1, 4)]
    assert sorted(counts) == [(-1, "outside", 1), (0, "launch", 3),
                              (4, "launch", 1)]
    assert profiling.self_ns(spans) == [30, 20, 10, 10, 10]
    # hand-built: overlapping and overhanging children count once, within
    # their parent
    built = [("r", 0, 100, -1, 0), ("x", 10, 50, 0, 0), ("y", 40, 60, 0, 0),
             ("z", 90, 130, 0, 0), ("w", 20, 30, 1, 0)]
    assert profiling.self_ns(built) == [40, 30, 20, 40, 10]
    profiling.reset()
    assert profiling.records() == ([], [])


def test_span_open_across_reset_closes_quietly(recorder):
    """``reset()`` while a span is open: the span's close neither raises
    nor takes the new records' open span off their stack."""
    old = profiling.span("old")
    old.__enter__()
    profiling.reset()
    with profiling.span("new"):
        old.__exit__(None, None, None)
        with profiling.span("inner"):
            pass
    with profiling.span("next"):
        pass
    spans, _ = profiling.records()
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("new", -1, 0), ("inner", 0, 0), ("next", -1, 2)]
    # closed on an empty stack
    older = profiling.span("older")
    older.__enter__()
    profiling.reset()
    older.__exit__(None, None, None)
    assert profiling.records() == ([], [])
    assert profiling.RECORDER.stack == []


def _train_state():
    student = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=3)
    student.reset_parameters(torch.Generator().manual_seed(0))
    teacher = copy.deepcopy(student)
    teacher.dense_from_stage = 5
    ocfg = to.OneCycleConfig(**OCFG)
    opt = to.AdamW(list(student.parameters()), to.one_cycle_lr(ocfg),
                   to.one_cycle_mom(ocfg))
    return TrainState(STEP, student, teacher, opt)


def test_train_step_records_its_phases(recorder):
    step = make_train_step(_loss_cfgs()[1])
    step(_train_state(), port_batch(make_batch()), 0.7)
    spans, _ = profiling.records()
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in roots] == ["train.step"]
    phases = _children(spans, roots[0])
    assert [spans[i][0] for i in phases] == TRAIN_PHASES
    assert all(s[4] == roots[0] for s in spans)
    for name in ("train.teacher_fwd", "train.student_fwd"):
        fwd = phases[TRAIN_PHASES.index(name)]
        assert [spans[i][0] for i in _children(spans, fwd)] == MODEL
    total, uncovered = _covered(spans, roots[0])
    assert uncovered <= max(0.05 * total, 1e6)


SPEC = VoxelizerSpec((0.0, -1.6, -3.0, 3.2, 1.6, 1.0), (0.05, 0.05, 0.1),
                     max_points=5, max_voxels=20000)
CAPS = (2048, 6144, 4096, 1024, 512)


def test_serving_pass_records_its_phases(recorder):
    model = VoxelNet(sparse_shape=SPEC.sparse_shape)
    model.reset_parameters(torch.Generator().manual_seed(0))
    anchors = create_anchors_3d_range(
        [1, 8, 8], [0.0, -1.6, -1.0, 3.2, 1.6, -1.0]).reshape(-1, 7)
    # 128 anchors: a small NMS capacity under them takes the two-level
    # path, whose one host read per batch is ``predict.sync``
    cfg = PredictConfig(nms_pre_small=64, post_center_range=(
        -10.0, -10.0, -10.0, 10.0, 10.0, 10.0))
    infer = make_infer_fn(model.eval(), anchors, cfg, CAPS, 1, "cpu")
    prep = HostPreprocessor(SPEC, CAPS)
    rng = np.random.RandomState(0)
    for _ in range(2):
        pts = np.concatenate([rng.rand(1500, 3) * [3.2, 3.2, 4.0]
                              + [0.0, -1.6, -3.0], rng.rand(1500, 1)], 1)
        infer(**prep(pts.astype(np.float32)))
    spans, counts = profiling.records()
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in roots] == ["infer.batch"] * 2
    for r in roots:
        phases = _children(spans, r)
        assert [spans[i][0] for i in phases] == [
            "infer.stage", "infer.forward", "infer.predict"]
        assert [spans[i][0] for i in _children(spans, phases[1])] == MODEL
        assert [spans[i][0] for i in _children(spans, phases[2])] == [
            "predict.sync", "predict.decode", "predict.nms",
            "predict.finish"]
        mine = {n: v for root, n, v in counts if root == r}
        assert mine["host_sync"] == 1
        assert "nms_kernel" not in mine  # the CPU twin, not the kernel pair
        assert mine.get("nms_small", 0) + mine.get("nms_full", 0) == 1
        total, uncovered = _covered(spans, r)
        assert uncovered <= max(0.05 * total, 1e6)
    assert sum(s[0] == "predict.sync" for s in spans) == 2


def _serving_model():
    model = VoxelNet(sparse_shape=SPEC.sparse_shape)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.eval()


@pytest.mark.parametrize("path", ["serving", "train"])
def test_folded_convs_are_counted_a_serving_batch_not_a_train_step(
        recorder, path):
    """``conv_bn_folded``: SE-SSD's 14 SSFA conv + BatchNorm pairs in a
    serving batch; none in a train step (training mode and autograd take
    the unfolded path)."""
    if path == "serving":
        anchors = create_anchors_3d_range(
            [1, 8, 8], [0.0, -1.6, -1.0, 3.2, 1.6, -1.0]).reshape(-1, 7)
        cfg = PredictConfig(post_center_range=(-10.0, -10.0, -10.0, 10.0,
                                               10.0, 10.0))
        infer = make_infer_fn(_serving_model(), anchors, cfg, CAPS, 1, "cpu")
        rng = np.random.RandomState(1)
        pts = np.concatenate([rng.rand(1500, 3) * [3.2, 3.2, 4.0]
                              + [0.0, -1.6, -3.0], rng.rand(1500, 1)], 1)
        infer(**HostPreprocessor(SPEC, CAPS)(pts.astype(np.float32)))
        root, want = "infer.batch", 14
    else:
        step = make_train_step(_loss_cfgs()[1])
        step(_train_state(), port_batch(make_batch()), 0.7)
        root, want = "train.step", 0
    spans, counts = profiling.records()
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in roots] == [root]
    got = sum(v for r, n, v in counts if n == "conv_bn_folded")
    assert got == want
    assert all(r == roots[0] for r, n, _ in counts if n == "conv_bn_folded")


def test_profile_with_recorder_on_holds_no_span(recorder):
    names = ["train.step", "model.backbone", "predict.sync"]
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span(names[0]):
            with profiling.span(names[1]):
                x = torch.ones(64) * 2
            with profiling.span(names[2]):
                profiling.count("host_sync")
                float(x.sum())
    events = {e.name for e in prof.events()}
    assert "aten::mul" in events
    assert not events & set(names)
    spans, _ = profiling.records()
    assert [s[0] for s in spans] == names
    # the spans share the profile's clock: the product's op lies inside
    # the span around it, once both are on the profile's time line
    start = prof.profiler.kineto_results.trace_start_ns()
    mul = next(e for e in prof.events() if e.name == "aten::mul")
    _, a, b, _, _ = spans[1]
    assert (a - start) / 1e3 <= mul.time_range.start
    assert mul.time_range.end <= (b - start) / 1e3
