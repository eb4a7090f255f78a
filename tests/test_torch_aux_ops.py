"""The aux ops with no SE-SSD user (``sessd_torch/ops/points.py``,
``pointnet.py``, ``roi.py``, ``correlation.py``) against the JAX package's
on the inputs of test_pointnet_ops.py, test_roi_points_ops.py and
test_correlation.py: outputs within 1e-5, indices and masks equal, and
gradients within 1e-5 where the op is differentiable."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops import correlation as jcorr
from sessd_tpu.ops import pointnet as jpn
from sessd_tpu.ops import points as jpts
from sessd_tpu.ops import roi as jroi
from sessd_torch.ops import correlation as tcorr
from sessd_torch.ops import pointnet as tpn
from sessd_torch.ops import points as tpts
from sessd_torch.ops import roi as troi
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-3, 3, (n, 3)),
                           rng.uniform(1, 4, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def test_points_in_boxes3d():
    rng = np.random.RandomState(0)
    pts = rng.randn(200, 4).astype(np.float32) * 5
    boxes = _boxes(rng, 5)
    got = tpts.points_in_boxes3d(t(pts), t(boxes))
    equal(got, jpts.points_in_boxes3d(jnp.asarray(pts), jnp.asarray(boxes)))
    assert got.any() and not got.all()


@pytest.mark.parametrize("with_intensity", [True, False])
def test_points_to_bev(with_intensity):
    rng = np.random.RandomState(1)
    pts = np.array([[0.5, 0.5, 1.0, 0.7], [0.5, 0.5, 2.0, 0.3],
                    [9.5, 9.5, 0.5, 0.9]], np.float32)
    pts = np.concatenate([pts, np.stack(
        [rng.uniform(-1, 11, 300), rng.uniform(-1, 11, 300),
         rng.uniform(-0.5, 3.5, 300), rng.rand(300)], 1).astype(np.float32)])
    rng_ = (0, 0, 0, 10, 10, 3)
    got = tpts.points_to_bev(t(pts), rng_, (10, 10), with_intensity)
    want = jpts.points_to_bev(jnp.asarray(pts), rng_, (10, 10),
                              with_intensity)
    assert got.shape == want.shape
    close(got, want)
    equal(tpts.points_bound_filter(t(pts), rng_),
          jpts.points_bound_filter(jnp.asarray(pts), rng_))


@pytest.mark.parametrize("masked", [False, True])
def test_farthest_point_sample(masked):
    rng = np.random.RandomState(2)
    xyz = np.concatenate([rng.randn(50, 3) * 0.1,
                          rng.randn(50, 3) * 0.1 + 100.0]).astype(np.float32)
    mask = np.arange(100) % 3 != 0 if masked else None
    got = tpn.farthest_point_sample(t(xyz), 8,
                                    None if mask is None else t(mask))
    want = jpn.farthest_point_sample(jnp.asarray(xyz), 8, mask)
    equal(got, want)
    assert len(set(got.tolist())) == 8


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_and_group(masked):
    rng = np.random.RandomState(3)
    xyz = rng.rand(60, 3).astype(np.float32)
    centers = np.concatenate([rng.rand(6, 3), [[9, 9, 9]]]).astype(
        np.float32)
    mask = np.arange(60) % 4 != 0 if masked else None
    got = tpn.ball_query(t(centers), t(xyz), 0.3, 8,
                         None if mask is None else t(mask))
    want = jpn.ball_query(jnp.asarray(centers), jnp.asarray(xyz), 0.3, 8,
                          mask)
    for g, w in zip(got, want):
        equal(g, w)
    assert got[1][0].all() and not got[1][-1].any()
    feats = rng.randn(60, 5).astype(np.float32)
    equal(tpn.group_points(t(feats), got[0]),
          jpn.group_points(jnp.asarray(feats), want[0]))


def test_three_nn_interpolate():
    rng = np.random.RandomState(4)
    support = rng.randn(30, 3).astype(np.float32)
    query = rng.randn(12, 3).astype(np.float32)
    feats = rng.randn(30, 8).astype(np.float32)
    mask = np.arange(30) % 5 != 0
    for m in (None, mask):
        d, idx = tpn.three_nn(t(query), t(support),
                              None if m is None else t(m))
        jd, jidx = jpn.three_nn(jnp.asarray(query), jnp.asarray(support), m)
        equal(idx, jidx)
        close(d, jd)
        close(tpn.three_interpolate(t(feats), idx, d),
              jpn.three_interpolate(jnp.asarray(feats), jidx, jd))
    # the support points themselves reproduce their features
    d, idx = tpn.three_nn(t(support), t(support))
    close(tpn.three_interpolate(t(feats), idx, d), feats, 1e-4)


def test_box2d_iou_rotated():
    rng = np.random.RandomState(5)
    b1 = np.concatenate([rng.uniform(-2, 2, (6, 2)), rng.uniform(1, 3, (6, 2)),
                         rng.uniform(-np.pi, np.pi, (6, 1))], 1)
    b2 = b1[::-1] + rng.uniform(-0.5, 0.5, b1.shape)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    got = troi.box2d_iou_rotated(t(b1), t(b2))
    close(got, jroi.box2d_iou_rotated(jnp.asarray(b1), jnp.asarray(b2)))
    assert (got > 0).any()


@pytest.mark.parametrize("num_sampled", [8, 2])
def test_roipool3d(num_sampled):
    rng = np.random.RandomState(6)
    box = np.concatenate([np.array([[0, 0, 0, 2, 4, 2, 0]], np.float32),
                          _boxes(rng, 3)])
    pts = np.concatenate([np.array([[0, 0, 0], [0.5, 1.0, 0.5], [5, 5, 5],
                                    [-0.5, -1, 0]], np.float32),
                          rng.uniform(-3, 3, (20, 3)).astype(np.float32)])
    feats = rng.randn(len(pts), 2).astype(np.float32)
    got = troi.roipool3d(t(pts), t(feats), t(box), num_sampled, 0.1)
    want = jroi.roipool3d(jnp.asarray(pts), jnp.asarray(feats),
                          jnp.asarray(box), num_sampled, 0.1)
    assert got[0].shape == (4, num_sampled, 5)
    close(got[0], want[0])
    equal(got[1], want[1])


def _roi_align_inputs():
    rng = np.random.RandomState(7)
    fm = rng.randn(16, 16, 2).astype(np.float32)
    rois = np.array([[8, 8, 6, 4, 0.3], [2, 14, 5, 5, -1.0],
                     [15, 1, 4, 8, 2.0]], np.float32)
    return fm, rois


def test_rotated_roi_align_and_gradient():
    fm, rois = _roi_align_inputs()
    got = troi.rotated_roi_align(t(fm), t(rois), (5, 4), 1.0, 2)
    close(got, jroi.rotated_roi_align(jnp.asarray(fm), jnp.asarray(rois),
                                      (5, 4), 1.0, 2))
    x = t(fm).requires_grad_(True)
    troi.rotated_roi_align(x, t(rois)).sum().backward()
    want = jax.grad(lambda f: jroi.rotated_roi_align(
        f, jnp.asarray(rois)).sum())(jnp.asarray(fm))
    close(x.grad, want)
    # a constant map pools to the constant
    const = troi.rotated_roi_align(torch.full((32, 32, 3), 2.5),
                                   t(rois * 2), out_size=(5, 5))
    close(const[0], np.full((5, 5, 3), 2.5, np.float32))


@pytest.mark.parametrize("shift", [(0, 0), (1, 2)])
def test_correlation(shift):
    rng = np.random.RandomState(8)
    f1 = rng.randn(12, 14, 16).astype(np.float32)
    f2 = np.roll(f1, shift, axis=(0, 1))
    got = tcorr.correlation(t(f1), t(f2), max_displacement=3)
    want = jcorr.correlation(jnp.asarray(f1), jnp.asarray(f2), 3)
    assert got.shape == (12, 14, 49)
    close(got, want)
    peak = (shift[0] + 3) * 7 + shift[1] + 3
    assert (got[4:-4, 4:-4].argmax(-1) == peak).float().mean() > 0.9
    close(tcorr.correlation(t(f1), t(f2), 2, stride=2),
          jcorr.correlation(jnp.asarray(f1), jnp.asarray(f2), 2, 2))


def test_align_feature_and_gradient():
    rng = np.random.RandomState(9)
    f = rng.randn(8, 8, 2).astype(np.float32)
    flow = rng.uniform(-1.5, 1.5, (8, 8, 2)).astype(np.float32)
    close(tcorr.align_feature(t(f), t(flow)),
          jcorr.align_feature(jnp.asarray(f), jnp.asarray(flow)))
    fl = t(flow).requires_grad_(True)
    tcorr.align_feature(t(f), fl).sum().backward()
    want = jax.grad(lambda x: jcorr.align_feature(
        jnp.asarray(f), x).sum())(jnp.asarray(flow))
    close(fl.grad, want)
    close(tcorr.align_feature(t(f), torch.zeros(8, 8, 2)), f)
