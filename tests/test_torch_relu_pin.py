"""``StepPins`` (sessd_torch/scripts/probe_step_parity.py), the record and
replay of a training step's ReLU masks that the pinned step-parity gate of
``chip_smoke.py`` runs, on one f32 SE-SSD step of the port on the CPU at
the small config of ``tests/test_torch_train_step.py``: sparse shape (41,
32, 32), batch 2, host rulebook chains, student plan dense_from_stage=3
and teacher plan 5, seeded random weights, the teacher 0.2% off the
student.

- Masks recorded from a step and replayed into the same step change
  nothing: metrics and gradients bit for bit; so do the choices the
  pinned gate replays (``PINNED``: the ReLU masks and the rectangle
  ODIoU's diagonal takes).
- A step that makes more, fewer or other-shaped ReLU calls than the
  recorded one raises.
- A step whose sparse forward (K4) is the f64 twin rounded once to f32 (the
  exact conv), with the f32 twin step's masks replayed, holds the gate's
  tolerances against the twin step: loss terms within 1e-4 relative, each
  gradient within 1e-3 of its max. The free reading (no replay) and the
  flipped elements per ReLU call are printed.
"""
import contextlib
import copy

import numpy as np
import pytest
import torch

from sessd_torch.models.detector import VoxelNet
from sessd_torch.ops.cuda import sparse_conv_train as kt
from sessd_torch.scripts.probe_step_parity import (PINNED, STEP_BOUNDS,
                                                   StepPins, compare, swapped)
from sessd_torch.train import optim as to
from sessd_torch.train.train_step import TrainState, make_train_step
from tests.test_torch_common import SPARSE_SHAPE
from tests.test_torch_train_step import (OCFG, STEP, _loss_cfgs, make_batch,
                                         port_batch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

# ReLU calls of one step: 14 backbone convs and 12 SSFA ReLUs per net, the
# teacher's and the student's
RELU_CALLS = 52


def _state():
    student = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=3)
    student.reset_parameters(torch.Generator().manual_seed(0))
    teacher = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=5)
    rng = np.random.RandomState(4)
    teacher.load_state_dict({
        k: v * (1 + 0.002 * torch.from_numpy(rng.randn(*v.shape)).float())
        if v.is_floating_point() else v
        for k, v in student.state_dict().items()})
    ocfg = to.OneCycleConfig(**OCFG)
    opt = to.AdamW(list(student.parameters()), to.one_cycle_lr(ocfg),
                   to.one_cycle_mom(ocfg))
    return TrainState(STEP, student, teacher, opt)


@pytest.fixture(scope="module")
def setup():
    return _state(), port_batch(make_batch())


def _step(setup, *ctxs):
    """(metrics, {parameter: gradient}) of one step from a copy of the
    state under ``ctxs``."""
    state, batch = setup
    state = copy.deepcopy(state)
    state.optimizer.params = list(state.student.parameters())
    names = [n for n, _ in state.student.named_parameters()]
    grads = {}
    apply = state.optimizer.step

    def capture(gs):
        grads.update(zip(names, [g.detach().clone() for g in gs]))
        return apply(gs)

    state.optimizer.step = capture
    with contextlib.ExitStack() as stack:
        for ctx in ctxs:
            stack.enter_context(ctx)
        metrics = make_train_step(_loss_cfgs()[1])(state, batch, 0.7)
    return {k: float(v) for k, v in metrics.items()}, grads


def _f64(x, rb, w, mask=None):
    """K4 computed in f64 and rounded once: the exact conv."""
    return kt.sparse_conv_fwd_ref(x.double(), rb, w.double(), mask).float()


@pytest.mark.parametrize("kinds", [("relu",), PINNED],
                         ids=["relu", "pinned"])
def test_replay_of_the_same_step_changes_nothing(setup, kinds):
    pins = StepPins(kinds)
    with pins.record():
        want = _step(setup)
    assert sum(k == "relu" for k, _, _ in pins.records) == RELU_CALLS
    assert {k for k, _, _ in pins.records} == set(kinds)
    got = _step(setup, pins.replay())
    assert sum(f for _, _, f, _ in pins.flips) == 0
    assert got[0] == want[0]
    assert set(got[1]) == set(want[1])
    for name, g in want[1].items():
        assert torch.equal(got[1][name], g), name


@pytest.mark.parametrize("change", ["fewer", "more", "shape"])
def test_replay_raises_on_other_calls(setup, change):
    pins = StepPins()
    with pins.record():
        _step(setup)
    if change == "fewer":
        pins.records.pop()
        match = "more calls than the recorded"
    elif change == "more":
        pins.records.append(pins.records[-1])
        match = "of the recorded"
    else:
        kind, name, mask = pins.records[7]
        pins.records[7] = (kind, name, mask[:-1])
        match = "call 7"
    with pytest.raises(ValueError, match=match):
        _step(setup, pins.replay())


def test_f64_forward_with_the_twin_masks_holds_the_gate(setup):
    pins = StepPins()
    with pins.record():
        twin = _step(setup)
    free = compare(_step(setup, swapped(sparse_conv_fwd=_f64),
                         pins.replay(pin=())), twin)
    free_flips = pins.summary()["relu"]
    pinned = compare(_step(setup, swapped(sparse_conv_fwd=_f64),
                           pins.replay()), twin)
    print(f"f64 forward, free: loss terms {free['loss_term_rel']:.2e}, "
          f"gradients {free['gradient_rel']:.2e} of their max "
          f"({free['gradient']}); ReLU flips per call "
          f"{free_flips['per_call']}; pinned: loss terms "
          f"{pinned['loss_term_rel']:.2e}, gradients "
          f"{pinned['gradient_rel']:.2e} ({pinned['gradient']})")
    assert pinned["loss_term_rel"] <= STEP_BOUNDS[0] == 1e-4
    assert pinned["gradient_rel"] <= STEP_BOUNDS[1] == 1e-3
    assert pinned["ok"]
