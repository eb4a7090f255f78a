"""The benchmark's plain reference against the program's own modules, on
the CPU: the reference is written apart from the program, so the two
agreeing on random inputs shows that both compute what det3d defines
(geometry, losses and their gradients, the optimizer, the detections).

    python -m pytest portbench/tests -q
"""
import math

import numpy as np
import pytest
import torch

from portbench.reference import boxes as bx
from portbench.reference import losses as ref_losses
from portbench.reference import predict as ref_predict
from portbench.reference import train as ref_train

B, A = 3, 4000
PCR = (0.0, -40.0, -5.0, 70.4, 40.0, 5.0)
CFG = {"cls_weight": 1.0, "alpha": 0.25, "gamma": 2.0, "odiou_weight": 2.0,
       "dir_weight": 0.2, "dir_offset": 0.0, "score_thresh": 0.3,
       "post_center_range": PCR, "iou_match": 0.7, "top_k": 256}


def _boxes(gen, n):
    u = torch.rand(n, 7, generator=gen)
    lo = torch.tensor([0.0, -20.0, -1.5, 1.4, 3.0, 1.3, -math.pi])
    span = torch.tensor([40.0, 40.0, 2.0, 1.0, 2.0, 0.5, 2 * math.pi])
    return lo + u * span


def _pairs(seed=0, n=1500):
    gen = torch.Generator().manual_seed(seed)
    a = _boxes(gen, n)
    b = a.clone()
    b[:, :2] += torch.randn(n, 2, generator=gen)
    b[:, 6] += 0.5 * torch.randn(n, generator=gen)
    b[:, 3:6] *= (1 + 0.2 * torch.randn(n, 3, generator=gen)).abs()
    # a few exact cases: the same box, one inside another, aligned boxes
    b[:5] = a[:5]
    b[5:10, 3:5] = a[5:10, 3:5] * 0.5
    a[10:15, 6] = b[10:15, 6] = 0.0
    return a, b


@pytest.mark.parametrize("name", ["overlap_bev", "iou_3d", "odiou_3d"])
def test_geometry_matches_the_program(name):
    from sessd_torch.core import odiou, rotated_iou

    prog = {"overlap_bev": rotated_iou.overlap_bev,
            "iou_3d": rotated_iou.iou_3d, "odiou_3d": odiou.odiou_3d}[name]
    mine = {"overlap_bev": bx.bev_overlap, "iou_3d": bx.iou_3d,
            "odiou_3d": bx.odiou}[name]
    a, b = _pairs()
    ga, gb = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = prog(ga, gb)
    want.sum().backward()
    wa, wb = ga.grad, gb.grad
    ga, gb = a.clone().requires_grad_(), b.clone().requires_grad_()
    got = mine(ga, gb)
    got.sum().backward()
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    # the gradients where the area is differentiable: not at two equal
    # boxes (the overlap's peak); float32 round-off apart
    assert torch.allclose(ga.grad[5:], wa[5:], atol=5e-3)
    assert torch.allclose(gb.grad[5:], wb[5:], atol=5e-3)


def _anchors(gen):
    xy = torch.rand(A, 2, generator=gen) * torch.tensor([70.0, 80.0]) \
        - torch.tensor([0.0, 40.0])
    rot = torch.randint(0, 2, (A, 1), generator=gen).float() * math.pi / 2
    return torch.cat([xy, torch.full((A, 1), -1.0),
                      torch.tensor([[1.6, 3.9, 1.56]]).expand(A, 3), rot], 1)


def _heads(gen, bias=0.0):
    return {"box_preds": 0.1 * torch.randn(B, A, 7, generator=gen),
            "cls_preds": torch.randn(B, A, 1, generator=gen) + bias,
            "dir_cls_preds": torch.randn(B, A, 2, generator=gen),
            "iou_preds": 0.5 * torch.randn(B, A, 1, generator=gen)}


def _grads(loss_fn, heads):
    leaves = {k: v.clone().requires_grad_() for k, v in heads.items()}
    loss = loss_fn(leaves)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in leaves.items()}


def test_detection_loss_matches_the_program():
    from sessd_torch.train import losses

    gen = torch.Generator().manual_seed(1)
    anc, heads = _anchors(gen), _heads(gen)
    labels = torch.zeros(B, A, dtype=torch.long)
    labels[torch.rand(B, A, generator=gen) < 0.03] = 1
    labels[torch.rand(B, A, generator=gen) < 0.05] = -1
    targets = 0.1 * torch.randn(B, A, 7, generator=gen)
    batch = {"anchors": anc.expand(B, A, 7), "labels": labels.int(),
             "reg_targets": targets}
    want, gw = _grads(lambda h: losses.detection_loss(
        h, batch, losses.LossConfig())[0], heads)
    got, gg = _grads(lambda h: ref_losses.detection_loss(
        h, labels, targets, anc, CFG), heads)
    assert got == pytest.approx(want, rel=1e-5)
    for k in gw:  # float32 round-off of the rotated geometry apart
        assert torch.allclose(gg[k], gw[k], atol=1e-3 * gw[k].abs().max()), k


@pytest.mark.parametrize("bias", [0.0, -3.0])
@pytest.mark.parametrize("augmented", [False, True])
def test_consistency_loss_matches_the_program(bias, augmented):
    from sessd_torch.train import losses

    gen = torch.Generator().manual_seed(2)
    anc, stu = _anchors(gen), _heads(gen, bias)
    tea = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
           for k, v in stu.items()}
    tf = {"flipped": np.array([augmented, False, augmented]),
          "noise_rotation": np.array([0.3, -0.5, 0.1], np.float32)
          * augmented,
          "noise_scale": np.array([1.02, 0.97, 1.0], np.float32)
          if augmented else np.ones(3, np.float32)}
    ccfg = losses.ConsistencyConfig(post_center_range=PCR)
    want, gw = _grads(lambda h: losses.consistency_loss(
        h, tea, anc.expand(B, A, 7),
        {k: torch.from_numpy(v) for k, v in tf.items()}, ccfg)[0], stu)
    got, gg = _grads(lambda h: ref_losses.consistency_loss(
        h, tea, anc, tf, CFG), stu)
    assert want > 0
    assert got == pytest.approx(want, rel=1e-5)
    for k in ("box_preds", "cls_preds", "iou_preds"):
        assert torch.allclose(gg[k], gw[k], atol=1e-7), k


@pytest.mark.parametrize("bias", [-2.0, -3.0])
def test_detections_match_the_program(bias):
    from sessd_torch.models import predict

    gen = torch.Generator().manual_seed(3)
    anc, heads = _anchors(gen), _heads(gen, bias)
    want = predict.predict_batch(heads, anc,
                                 predict.PredictConfig(post_center_range=PCR))
    pcfg = {"score_threshold": 0.3, "pre": 1000, "post": 100,
            "iou_threshold": 0.01, "post_center_range": PCR,
            "use_dir": True, "dir_offset": 0.0}
    for i in range(B):
        d = ref_predict.detections({k: v[i] for k, v in heads.items()}, anc,
                                   pcfg)
        n = len(d["valid"])
        assert n > 10
        # boxes whose IoU prediction rectifies their score to 0 tie, and
        # any order of them is NMS's: the scored ones lead on both sides
        mine = d["valid"] & (d["scores"] > 0)
        theirs = want["valid"][i] & (want["scores"][i] > 0)
        assert mine.sum() > 10
        assert torch.equal(theirs[:n], mine)
        assert not theirs[n:].any()
        assert torch.allclose(want["scores"][i][:n][mine], d["scores"][mine],
                              rtol=1e-6)
        assert torch.allclose(want["box3d_lidar"][i][:n][mine],
                              d["boxes"][mine], atol=1e-5)


def test_optimizer_matches_the_program():
    """Three clipped one-cycle AdamW steps: ``torch.optim.AdamW`` with the
    reference's schedule against the program's optimizer."""
    from sessd_torch import builder

    cfg = builder.load_config("se_ssd_kitti_car.py")
    gen = torch.Generator().manual_seed(4)
    start = [torch.randn(5, 7, generator=gen), torch.randn(3, generator=gen)]
    grads = [[40 * torch.randn(p.shape, generator=gen) for p in start]
             for _ in range(3)]
    mine = [p.clone().requires_grad_() for p in start]
    theirs = [p.clone() for p in start]
    opt, _ = builder.build_optimizer_from_cfg(cfg, 4, theirs)
    ref = torch.optim.AdamW(mine, lr=0.0, betas=(0.9, 0.99), eps=1e-8,
                            weight_decay=cfg.optimizer["wd"])
    sched = ref_train.one_cycle(cfg, cfg.total_epochs * 4)
    for step, g in enumerate(grads):
        opt.step([x.clone() for x in g])
        for p, x in zip(mine, g):
            p.grad = x.clone()
        torch.nn.utils.clip_grad_norm_(mine, 35.0)
        lr, b1 = sched(step)
        assert lr == pytest.approx(opt.hyperparams["learning_rate"],
                                   rel=1e-6)
        assert b1 == pytest.approx(opt.hyperparams["b1"], rel=1e-6)
        for group in ref.param_groups:
            group["lr"], group["betas"] = lr, (b1, 0.99)
        ref.step()
    for p, q in zip(mine, theirs):
        assert torch.allclose(p.detach(), q, rtol=1e-5, atol=1e-7)
