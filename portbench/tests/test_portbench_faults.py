"""On the card: each cell's comparison fails a broken timed path, and its
control. Each test drives a whole run of the cell (``driver.run``, past
the harness's look for a card) with the program broken underneath, at the
cell's own size, and sees ``correct`` come out false.

    python -m pytest --noconftest -m cuda portbench/tests -q

Faults: a training step that returns its state unchanged; a training step
on half of each batch, the mean taken over the rest; a serving batch whose
second half of the scenes is left out of the detections; a detection's
score altered where the batch's detections are produced.
"""
import time

import pytest
import torch

from portbench import harness

SEED = 3141592653
TRAIN = ["sessd_car_bf16.train_b4", "sessd_car_f32.train_b4"]
INFER = ["sessd_car_bf16.infer_b8"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's CUDA kernels)")


def judged(res) -> bool:
    return all(v <= lim for _, v, lim in res["checks"])


def _run(name):
    c = harness.cell(name)
    return harness.driver(c["traffic"]["driver"]).run(
        c, seed=SEED, seconds=2.0, trace=False, t_start=time.perf_counter())


def _break_trainer(monkeypatch, fault):
    from sessd_torch.train import trainer as trainer_mod

    base = trainer_mod.Trainer

    class Broken(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            step = self.train_step

            def unchanged(state, batch, cw):
                keep = [t.detach().clone() for t in _state(state)]
                m = step(state, batch, cw)
                with torch.no_grad():
                    for t, k in zip(_state(state), keep):
                        t.copy_(k)
                return m

            def half(state, batch, cw):
                return step(state, _first_half(batch), cw)

            self.train_step = {"unchanged": unchanged, "half": half}[fault]

    monkeypatch.setattr(trainer_mod, "Trainer", Broken)


def _state(state):
    return (list(state.student.parameters())
            + list(state.teacher.parameters())
            + list(state.optimizer.mu) + list(state.optimizer.nu))


def _first_half(batch):
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = _first_half(v)
        else:
            out[k] = v[:v.shape[0] // 2]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_training_fault_is_not_correct(card, monkeypatch, name, fault):
    _break_trainer(monkeypatch, fault)
    assert not judged(_run(name))


def _break_serving(monkeypatch, fault):
    from sessd_torch import serve

    base = serve.make_infer_fn

    def make(*a, **kw):
        infer = base(*a, **kw)

        def broken(feats, rulebooks):
            boxes, scores, valid = infer(feats, rulebooks)
            if fault == "half":
                valid = valid.clone()
                valid[valid.shape[0] // 2:] = False
            else:  # the batch's first detection
                scores = scores.clone()
                b, i = torch.nonzero(valid)[0].tolist()
                scores[b, i] += 0.1
            return boxes, scores, valid

        return broken

    monkeypatch.setattr(serve, "make_infer_fn", make)


@pytest.mark.cuda
@pytest.mark.parametrize("name", INFER)
@pytest.mark.parametrize("fault", ["half", "altered"])
def test_serving_fault_is_not_correct(card, monkeypatch, name, fault):
    _break_serving(monkeypatch, fault)
    assert not judged(_run(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + INFER)
def test_control_is_not_correct(card, name):
    """The reference in the next precision below the configuration's fails
    at least one of the cell's limits."""
    from portbench import controls

    c = harness.cell(name)
    limits = c["config"]["limits"][c["workload"]["traffic"]]
    gen = {"train": controls._train, "infer": controls._infer}[
        c["traffic"]["driver"]](c, SEED)
    _, nums = next(gen)
    gen.close()
    assert any(nums[k] > lim for k, lim in limits.items() if k in nums)
