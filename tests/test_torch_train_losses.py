"""The port's loss terms and box geometry (sessd_torch/train/losses.py,
core/odiou.py, core/rotated_iou.py, core/box_torch.py) against the JAX
package on the same numpy inputs, values and gradients, and against the
reference's own goldens (tests/goldens/ref_sessd_loss.npz, ref_odiou.npz)
at the bounds the JAX package's golden tests use.

Tolerances against JAX: 1e-5 relative on values and 1e-4 of each
gradient's max (f32, the same formulas; sums in another order). Against the
goldens: the JAX tests' own bounds, which allow for the reference's
qhull-order and argmin-tie noise."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.core import box_jax
from sessd_tpu.core import odiou as jodiou
from sessd_tpu.core import rotated_iou as jiou
from sessd_tpu.train import losses as jl
from sessd_torch.core import box_torch
from sessd_torch.core import odiou as todiou
from sessd_torch.core import rotated_iou as tiou
from sessd_torch.train import losses as tl
from tests.test_odiou_ref_goldens import (GRAD_ATOL, GRAD_RTOL, VAL_RTOL)
from tests.test_torch_common import rel_err, to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return to_torch(np.asarray(tree))


def _boxes(rng, n, jitter=None):
    b = np.stack([rng.uniform(0, 60, n), rng.uniform(-30, 30, n),
                  rng.uniform(-2, 0, n), rng.uniform(1.4, 2.0, n),
                  rng.uniform(3.5, 4.5, n), rng.uniform(1.3, 1.8, n),
                  rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    if jitter is not None:
        b = b + (rng.randn(*b.shape) * jitter).astype(np.float32)
    return b


def test_box_functions_match_jax():
    rng = np.random.RandomState(0)
    boxes, anchors = _boxes(rng, 50), _boxes(rng, 50)
    pts = rng.randn(50, 3).astype(np.float32)
    ang = rng.uniform(-1, 1, 50).astype(np.float32)
    pairs = [
        (box_torch.second_box_encode(_t(boxes), _t(anchors)),
         box_jax.second_box_encode(boxes, anchors)),
        (box_torch.rotation_points_z(_t(pts), _t(ang)),
         jax.vmap(box_jax.rotation_points_z)(pts, ang)),
        (box_torch.corner_to_standup_bev(box_torch.bev_corners(_t(boxes))),
         box_jax.corner_to_standup_bev(box_jax.bev_corners(boxes))),
        *zip(box_torch.add_sin_difference(_t(boxes), _t(anchors)),
             box_jax.add_sin_difference(boxes, anchors)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_iou_3d_matches_jax():
    rng = np.random.RandomState(1)
    a = _boxes(rng, 40)
    b = np.concatenate([a[:20] + rng.randn(20, 7).astype(np.float32) * 0.3,
                        _boxes(rng, 20)])
    np.testing.assert_allclose(tiou.iou_3d(_t(a), _t(b)).numpy(),
                               np.asarray(jax.jit(jiou.iou_3d)(a, b)),
                               atol=1e-5)
    np.testing.assert_allclose(tiou.iou_3d_matrix(_t(a), _t(b)).numpy(),
                               np.asarray(jax.jit(jiou.iou_3d_matrix)(a, b)),
                               atol=1e-5)
    np.testing.assert_allclose(tiou.overlap_height(_t(a), _t(b)).numpy(),
                               np.asarray(jiou.overlap_height(a, b)),
                               atol=1e-6)


@pytest.mark.parametrize("fn", ["odiou_3d", "min_area_rect_diag"])
def test_odiou_values_and_grads_match_jax(fn):
    rng = np.random.RandomState(2)
    g = _boxes(rng, 64)
    q = g + (rng.randn(64, 7) * [0.3, 0.3, 0.2, 0.2, 0.3, 0.2, 0.4]).astype(
        np.float32)
    if fn == "min_area_rect_diag":
        # point sets in general position: a rectangle's parallel edges give
        # equal areas, and which one a float argmin picks is rounding noise
        g, q = rng.randn(64, 8, 2).astype(np.float32) * 3, None
    jfn, tfn = getattr(jodiou, fn), getattr(todiou, fn)
    args = (g,) if q is None else (g, q)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(jfn(*a) * jnp.arange(64.0)),
        argnums=tuple(range(len(args)))))(*args)
    want = np.asarray(jax.jit(jfn)(*args))
    targs = [_t(a).requires_grad_(True) for a in args]
    got = tfn(*targs)
    (got * torch.arange(64.0)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    for t, w in zip(targs, wgrads):
        assert rel_err(t.grad, w) < 1e-4


@functools.lru_cache(maxsize=None)
def golden(name):
    return dict(np.load(os.path.join(GOLDENS, name), allow_pickle=True))


@pytest.mark.parametrize("name", list(VAL_RTOL))
def test_odiou_goldens(name):
    """Values and input gradients against the reference's own autograd
    (bounds of tests/test_odiou_ref_goldens.py)."""
    gd = golden("ref_odiou.npz")
    g = _t(gd[f"{name}_g"]).requires_grad_(True)
    q = _t(gd[f"{name}_q"]).requires_grad_(True)
    clean = gd[f"{name}_clean"]
    ref = gd[f"{name}_val"]
    od = todiou.odiou_3d(g, q)
    od.sum().backward()  # pairs are independent: per-pair gradients
    err = np.abs(od.detach().numpy() - ref) / (np.abs(ref) + 1e-4)
    assert err[clean].max() <= VAL_RTOL[name]
    if (~clean).any():
        assert err[~clean].max() <= 0.1
    for ours, key in ((g.grad.numpy(), "dg"), (q.grad.numpy(), "dq")):
        r = gd[f"{name}_{key}"]
        bound = GRAD_ATOL + GRAD_RTOL * np.abs(r[clean])
        assert (np.abs(ours[clean] - r[clean]) <= bound).all(), key


def test_odiou_golden_composed_loss():
    gd = golden("ref_odiou.npz")
    g = _t(gd["composed_g"]).requires_grad_(True)
    q = _t(gd["composed_q"]).requires_grad_(True)
    loss = todiou.odiou_3d_loss(g, q, _t(gd["composed_w"]),
                                float(gd["composed_batch_size"]))
    ref = float(gd["composed_loss"])
    assert abs(loss.item() - ref) / abs(ref) <= 1e-3
    loss.backward()
    for o, r in ((g.grad.numpy(), gd["composed_dg"]),
                 (q.grad.numpy(), gd["composed_dq"])):
        assert (np.abs(o - r) <= 5e-3 + 0.02 * np.abs(r)).all()


def _golden_batch(gd):
    return {k: to_torch(gd[k]) for k in ("anchors", "labels", "reg_targets",
                                         "labels_raw", "reg_targets_raw")} | {
        "transformation": {k: to_torch(gd[k]) for k in
                           ("flipped", "noise_rotation", "noise_scale")}}


def _golden_preds(gd, who):
    return {"box_preds": _t(gd[f"{who}_box"]),
            "cls_preds": _t(gd[f"{who}_cls"]),
            "iou_preds": _t(gd[f"{who}_iou"]),
            "dir_cls_preds": _t(gd[f"{who}_dir"])}


def _golden_cfg(gd):
    return tl.LossConfig(consistency=tl.ConsistencyConfig(
        top_k=gd["anchors"].shape[1],
        post_center_range=tuple(gd["post_center_range"].tolist())))


def _close(ours, ref, rtol=2e-4, name=""):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rtol * (abs(ref) + 1e-3), (name, ours, ref)


def test_sessd_loss_goldens_terms():
    """Every scalar term against the reference's MultiGroupHead.loss,
    consistency_loss and EMA loss (bounds of test_sessd_loss_goldens.py)."""
    gd = golden("ref_sessd_loss.npz")
    batch, cfg = _golden_batch(gd), _golden_cfg(gd)
    total, m = tl.detection_loss(_golden_preds(gd, "stu"), batch, cfg)
    _close(total, gd["scalar_loss"], name="loss")
    for k in ("cls_loss_reduced", "loc_loss_reduced", "dir_loss_reduced",
              "iou_pred_loss", "ious_loss", "cls_pos_loss", "cls_neg_loss"):
        _close(m[k], gd[f"scalar_{k}"], name=k)
    cons, _ = tl.consistency_loss(_golden_preds(gd, "stu"),
                                  _golden_preds(gd, "tea"), batch["anchors"],
                                  batch["transformation"], cfg.consistency)
    _close(cons, gd["scalar_consistency_loss"], rtol=5e-4, name="cons")
    total, m = tl.detection_loss(_golden_preds(gd, "tea"), batch, cfg,
                                 labels_key="labels_raw",
                                 reg_targets_key="reg_targets_raw",
                                 include_odiou=False)
    _close(total, gd["scalar_loss_ema"], name="loss_ema")
    for k in ("cls_loss_reduced", "loc_loss_reduced", "dir_loss_reduced",
              "iou_pred_loss"):
        _close(m[k], gd[f"scalar_{k}_ema"], name=k + "_ema")


def test_sessd_loss_goldens_gradients():
    gd = golden("ref_sessd_loss.npz")
    batch, cfg = _golden_batch(gd), _golden_cfg(gd)
    preds = {k: v.requires_grad_(True)
             for k, v in _golden_preds(gd, "stu").items()}
    sup, _ = tl.detection_loss(preds, batch, cfg)
    cons, _ = tl.consistency_loss(preds, _golden_preds(gd, "tea"),
                                  batch["anchors"], batch["transformation"],
                                  cfg.consistency)
    (sup + float(gd["consistency_weight"]) * cons).backward()
    for name, key in (("box_preds", "grad_box"), ("cls_preds", "grad_cls"),
                      ("iou_preds", "grad_iou"),
                      ("dir_cls_preds", "grad_dir")):
        ref = gd[key]
        atol = 2.5e-3 if key == "grad_box" else 1e-4
        diff = np.abs(preds[name].grad.numpy() - ref)
        assert (diff <= atol + 2e-3 * np.abs(ref)).all(), key


def random_loss_case(seed=3, b=2, a=96):
    """Student/teacher head outputs over ``a`` anchors of real boxes, the
    teacher near the student so the consistency loss finds pairs (identity
    augmentation on sample 0, a flip + rotation + scale on sample 1)."""
    rng = np.random.RandomState(seed)
    anchors = np.stack([_boxes(rng, a) for _ in range(b)])
    anchors[..., 0] = np.abs(anchors[..., 0]) + 1
    labels = rng.choice([-1, 0, 1], (b, a), p=[0.1, 0.6, 0.3]).astype(np.int32)
    reg = (rng.randn(b, a, 7) * 0.1).astype(np.float32)
    box = (reg + rng.randn(b, a, 7) * 0.3).astype(np.float32)
    cls = rng.randn(b, a, 1).astype(np.float32) + 1.0
    stu = {"box_preds": box, "cls_preds": cls,
           "iou_preds": rng.randn(b, a, 1).astype(np.float32) * 0.5,
           "dir_cls_preds": rng.randn(b, a, 2).astype(np.float32)}
    tea = {k: (v + rng.randn(*v.shape) * 0.02).astype(np.float32)
           for k, v in stu.items()}
    batch = {"anchors": anchors, "labels": labels, "reg_targets": reg,
             "labels_raw": labels, "reg_targets_raw": reg,
             "transformation": {
                 "flipped": np.array([False, True]),
                 "noise_rotation": np.array([0.0, 0.3], np.float32),
                 "noise_scale": np.array([1.0, 1.02], np.float32)}}
    cfg = dict(max_positive_anchors=40, top_k=48)
    return stu, tea, batch, cfg


@pytest.mark.parametrize("term", ["detection", "teacher", "consistency"])
def test_loss_terms_match_jax(term):
    stu, tea, batch, c = random_loss_case()
    jcfg = jl.LossConfig(max_positive_anchors=c["max_positive_anchors"],
                         consistency=jl.ConsistencyConfig(top_k=c["top_k"]))
    tcfg = tl.LossConfig(max_positive_anchors=c["max_positive_anchors"],
                         consistency=tl.ConsistencyConfig(top_k=c["top_k"]))
    kw = (dict(labels_key="labels_raw", reg_targets_key="reg_targets_raw",
               include_odiou=False) if term == "teacher" else {})

    def jax_fn(p):
        if term == "consistency":
            return jl.consistency_loss(p, tea, batch["anchors"],
                                       batch["transformation"],
                                       jcfg.consistency)
        return jl.detection_loss(p, batch, jcfg, **kw)

    def port_fn(p):
        if term == "consistency":
            return tl.consistency_loss(p, _t(tea), _t(batch["anchors"]),
                                       _t(batch["transformation"]),
                                       tcfg.consistency)
        return tl.detection_loss(p, _t(batch), tcfg, **kw)

    (want, aux), wgrad = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(
        stu)
    preds = {k: v.requires_grad_(True) for k, v in _t(stu).items()}
    got, gaux = port_fn(preds)
    got.backward()
    assert rel_err(got.detach(), want) < 1e-5
    if term == "consistency":
        assert float(want) > 0 and rel_err(gaux.detach(), aux) < 1e-5
    else:
        for k, v in aux.items():
            assert abs(float(gaux[k].detach()) - float(v)) <= 1e-5 * (
                abs(float(v)) + 1e-3), k
    for k, p in preds.items():
        # a head output the total does not reach has no gradient here and
        # a zero one in JAX
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert rel_err(grad, wgrad[k]) < 1e-4 or not np.any(wgrad[k]), k


def test_topk_takes_lower_index_first_on_ties():
    scores = np.array([[0, 1, 1, 0, 1, -1, 1, 0]], np.float32)
    vals, idx = tl.topk(to_torch(scores), 6)
    jv, ji = jax.lax.top_k(scores, 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
