"""On the card: the CenterPoint serving cell's comparison fails each of its
controls, through the cell's own ``check`` and limits.

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_center_faults.py -q

Controls: the float32 reference's forward in float8 e4m3 in the
program's place (its head outputs, and the program's decode and NMS of
them); a serving batch whose second half of the scans is left out of the
detections; one detection's score altered by 0.01. The two faults run the
whole cell (``driver.run``) with the program broken underneath.
"""
import time

import pytest
import torch

from portbench import harness

SEED = 3141592653
NAME = "centerpoint_waymo_bf16.waymo_b4"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's CUDA kernels)")


def _limits():
    c = harness.cell(NAME)
    return c, c["config"]["limits"][c["workload"]["traffic"]]


def _failed(nums: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if k in nums and nums[k] > lim]


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
                scores[b, i] += 0.01
            return boxes, scores, valid

        return broken

    monkeypatch.setattr(serve, "make_infer_fn", make)


@pytest.mark.cuda
@pytest.mark.parametrize("fault,limit", [("half", "det_valid_mismatch"),
                                         ("altered", "det_gap")])
def test_serving_fault_is_not_correct(card, monkeypatch, fault, limit):
    c, _ = _limits()
    _break_serving(monkeypatch, fault)
    res = harness.driver(c["traffic"]["driver"]).run(
        c, seed=SEED, seconds=2.0, trace=False, t_start=time.perf_counter())
    failed = [k for k, v, lim in res["checks"] if v > lim]
    assert limit in failed, res["checks"]


@pytest.mark.cuda
def test_control_fp8_is_not_correct(card):
    """The reference in float8 e4m3 as the program: its head outputs on
    the pool's first batch, decoded by the program's center predict, held
    to the cell's limits by ``check``."""
    from portbench.drivers import common, infer_center
    from portbench.reference.centerpoint import CenterPoint, quantized
    from sessd_torch import builder
    from sessd_torch.models.predict import predict_batch

    c, limits = _limits()
    x = infer_center.inputs(c, SEED)
    pcfg = builder.build_predict_config(x["cfg"])
    model = CenterPoint(x["spec"].sparse_shape).to(common.DEVICE).eval()
    model.load_state_dict(x["sd"])
    low = quantized(model, "fp8")
    vox, npts, coords = x["voxelize"](x["groups"][0])
    with torch.no_grad():
        heads = low(vox, npts, model.chain(coords, x["batch"]))
        out = predict_batch(heads, None, pcfg)
    del model, low
    sample = {0: (heads, (out["box3d_lidar"], out["scores"], out["valid"]))}
    nums = infer_center.check(sample, x, pcfg)
    assert "head_gap" in _failed(nums, limits), nums
