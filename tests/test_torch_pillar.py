"""The pillar-column plan (``sessd_torch.ops.pillar``) against
``sessd_tpu.ops.pillar`` function by function on the same inputs, and
against the port's own voxel-row sparse conv (``ops.sparse``) on the same
grid and weights, as tests/test_pillar_engine.py holds the JAX plan
against JAX's.

Tolerances: index arrays, pillar sets, columns, occupancy, LUTs, offsets,
reordered kernels, cover masks and dense scatters exactly equal (dtype
included); ``pillar_conv`` within 1e-5 of the max of JAX's output (f32, one
conv over the same gathered values in another summation order); against
the voxel-row conv 1e-5 absolute and relative per conv, 1e-4 over the
three-conv chain (as the JAX test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops import pillar as jpl
from sessd_tpu.ops import sparse as jsp
from sessd_torch.ops import pillar as pl
from sessd_torch.ops import sparse as sp
from tests.test_torch_common import rel_err
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

SHAPE = (2, 9, 13, 11)
DOWNS = [((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # stages 1 and 2
         ((3, 3, 3), (2, 2, 2), (0, 1, 1)),   # stage 3
         ((3, 1, 1), (2, 1, 1), (0, 0, 0))]   # stage 4, the z collapse


def random_grid(seed, shape=SHAPE, n=70, c=5):
    """A random voxel set through JAX's ``grid_from_coords``: (JAX grid,
    its sorted features, the port's grid and features)."""
    rng = np.random.RandomState(seed)
    b, d, h, w = shape
    lin = rng.choice(b * d * h * w, size=n, replace=False)
    coords = np.stack([lin // (d * h * w), (lin // (h * w)) % d,
                       (lin // w) % h, lin % w], 1).astype(np.int32)
    valid = rng.uniform(size=n) > 0.15
    feats = rng.randn(n, c).astype(np.float32)
    grid, perm = jsp.grid_from_coords(jnp.asarray(coords),
                                      jnp.asarray(valid), shape,
                                      capacity=n + 8)
    x = jnp.where(grid.mask[:, None], jnp.asarray(feats)[perm], 0.0)
    port = pl.SparseGrid(torch.from_numpy(np.array(grid.ids)), shape)
    return grid, x, port, torch.from_numpy(np.array(x))


def jpillars(seed, capacity=80, **kw):
    grid, x, pgrid, px = random_grid(seed, **kw)
    return (jpl.pillars_from_grid(grid, x, capacity),
            pl.pillars_from_grid(pgrid, px, capacity))


def same(got, want):
    """Exactly equal, dtype included."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def same_set(got: pl.PillarSet, want):
    same(got.ids, want.ids)
    assert got.shape == want.shape and got.depth == want.depth


@pytest.mark.parametrize("capacity", [80, 30], ids=["fits", "truncated"])
def test_pillars_from_grid(capacity):
    (jset, jcols, jocc), (pset, pcols, pocc) = jpillars(0, capacity)
    same_set(pset, jset)
    same(pcols, jcols)
    same(pocc, jocc)
    assert pset.capacity == capacity


@pytest.mark.parametrize("capacity", [80, 40000], ids=["int16", "int32"])
def test_bev_lut(capacity):
    (jset, _, _), (pset, _, _) = jpillars(1)
    if capacity != jset.capacity:  # the same set in a larger table
        pad = np.full(capacity - jset.capacity, jsp.SENTINEL, np.int32)
        ids = np.concatenate([np.asarray(jset.ids), pad])
        jset = jset._replace(ids=jnp.asarray(ids))
        pset = pset._replace(ids=torch.from_numpy(ids))
    same(pl._bev_lut(pset), jpl._bev_lut(jset))


@pytest.mark.parametrize("kernel", [(3, 3), (1, 1), (2, 3)])
def test_kernel_offsets_2d(kernel):
    same(pl._kernel_offsets_2d(kernel), jpl._kernel_offsets_2d(kernel))


def test_bev_rulebook_submanifold():
    (jset, _, _), (pset, _, _) = jpillars(2)
    same(pl.bev_rulebook(pset), jpl.bev_rulebook(jset))


@pytest.mark.parametrize("kernel,stride,padding", DOWNS,
                         ids=["s2p1", "s2p011", "z_collapse"])
def test_downsample_pillars_and_strided_rulebook(kernel, stride, padding):
    (jset, _, _), (pset, _, _) = jpillars(3, 100, n=90, c=4)
    d = SHAPE[1]
    od = (d + 2 * padding[0] - kernel[0]) // stride[0] + 1
    args = (kernel[1:], stride[1:], padding[1:])
    jout = jpl.downsample_pillars(jset, *args, out_capacity=128,
                                  out_depth=od)
    pout = pl.downsample_pillars(pset, *args, out_capacity=128, out_depth=od)
    same_set(pout, jout)
    assert int(pout.mask.sum()) > 0
    same(pl.bev_rulebook(pset, pout, *args),
         jpl.bev_rulebook(jset, jout, *args))


@pytest.mark.parametrize("kernel_shape", [(3, 3, 3), (3, 1, 1)])
def test_reorder_kernel(kernel_shape):
    w = np.random.RandomState(4).randn(int(np.prod(kernel_shape)), 5,
                                       6).astype(np.float32)
    same(pl.reorder_kernel(torch.from_numpy(w), kernel_shape),
         jpl.reorder_kernel(jnp.asarray(w), kernel_shape))


def test_pillar_conv_submanifold_matches_jax():
    (jset, jcols, jocc), (pset, pcols, pocc) = jpillars(5)
    w = np.random.RandomState(5).randn(27, 5, 6).astype(np.float32)
    want = jpl.pillar_conv(jcols, jpl.bev_rulebook(jset), jnp.asarray(w))
    got = pl.pillar_conv(pcols, pl.bev_rulebook(pset), torch.from_numpy(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("kernel,stride,padding", DOWNS,
                         ids=["s2p1", "s2p011", "z_collapse"])
def test_pillar_conv_strided_matches_jax(kernel, stride, padding):
    (jset, jcols, jocc), (pset, pcols, pocc) = jpillars(6, 100, n=90, c=4)
    od = (SHAPE[1] + 2 * padding[0] - kernel[0]) // stride[0] + 1
    args = (kernel[1:], stride[1:], padding[1:])
    w = np.random.RandomState(6).randn(int(np.prod(kernel)), 4,
                                       6).astype(np.float32)
    jout = jpl.downsample_pillars(jset, *args, out_capacity=128, out_depth=od)
    pout = pl.downsample_pillars(pset, *args, out_capacity=128, out_depth=od)
    want, wcover = jpl.pillar_conv(
        jcols, jpl.bev_rulebook(jset, jout, *args), jnp.asarray(w), kernel,
        z_stride=stride[0], z_pad=padding[0], occ=jocc)
    got, cover = pl.pillar_conv(
        pcols, pl.bev_rulebook(pset, pout, *args), torch.from_numpy(w),
        kernel, z_stride=stride[0], z_pad=padding[0], occ=pocc)
    assert got.shape == want.shape == (128, od, 6)
    assert rel_err(got.numpy(), want) <= 1e-5
    same(cover, wcover)
    assert cover.any()


def test_pillar_to_dense():
    (jset, jcols, jocc), (pset, pcols, pocc) = jpillars(7)
    same(pl.pillar_to_dense(pcols, pset), jpl.pillar_to_dense(jcols, jset))
    same(pl.pillar_to_dense(pocc[..., None], pset),
         jpl.pillar_to_dense(jocc[..., None], jset))


# the port's plan against the port's voxel-row conv (ops.sparse)

def test_submanifold_conv_equals_voxel_row_conv():
    _, _, grid, x = random_grid(1)
    w = torch.from_numpy(np.random.RandomState(1).randn(27, 5, 6).astype(
        np.float32))
    rb = sp.subm_rulebook(grid.ids, SHAPE)
    want = sp.to_dense(sp.sparse_conv_apply(x, rb, w, grid.mask), grid.ids,
                       SHAPE)
    pillars, cols, occ = pl.pillars_from_grid(grid, x, capacity=80)
    out = pl.pillar_conv(cols, pl.bev_rulebook(pillars), w) * occ[..., None]
    np.testing.assert_allclose(pl.pillar_to_dense(out, pillars).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,stride,padding", DOWNS,
                         ids=["s2p1", "s2p011", "z_collapse"])
def test_strided_conv_equals_voxel_row_conv(kernel, stride, padding):
    _, _, grid, x = random_grid(2, n=90, c=4)
    w = torch.from_numpy(np.random.RandomState(2).randn(
        int(np.prod(kernel)), 4, 6).astype(np.float32))
    out_ids, out_shape, rbd = sp.downsample_rulebook(
        grid.ids, SHAPE, kernel, stride, padding, out_capacity=256)
    out_mask = out_ids < sp.SENTINEL
    want = sp.to_dense(sp.sparse_conv_apply(x, rbd, w, out_mask), out_ids,
                       out_shape)
    exist = sp.to_dense(torch.ones(256, 1), out_ids, out_shape)[..., 0]

    args = (kernel[1:], stride[1:], padding[1:])
    pillars, cols, occ = pl.pillars_from_grid(grid, x, capacity=100)
    opil = pl.downsample_pillars(pillars, *args, out_capacity=128,
                                 out_depth=out_shape[1])
    out, cover = pl.pillar_conv(cols, pl.bev_rulebook(pillars, opil, *args),
                                w, kernel, z_stride=stride[0],
                                z_pad=padding[0], occ=occ)
    got = pl.pillar_to_dense(out * cover[..., None], opil)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the covered sites are the strided conv's output sites, exactly
    covered = pl.pillar_to_dense(cover[..., None], opil)[..., 0]
    np.testing.assert_array_equal(covered.numpy() > 0, exist.numpy() > 0)


def test_chain_of_three_convs_equals_voxel_row_convs():
    """subm -> strided -> subm, the backbone's pattern, through both plans
    with the same weights."""
    shape = (1, 9, 16, 14)
    _, _, grid, x = random_grid(3, shape=shape, n=80, c=4)
    rng = np.random.RandomState(3)
    w1, wd, w2 = (torch.from_numpy(rng.randn(27, cin, 8).astype(np.float32))
                  for cin in (4, 8, 8))

    rb = sp.subm_rulebook(grid.ids, shape)
    a = sp.sparse_conv_apply(x, rb, w1, grid.mask)
    ids2, shape2, rbd = sp.downsample_rulebook(grid.ids, shape,
                                               out_capacity=128)
    m2 = ids2 < sp.SENTINEL
    b_ = sp.sparse_conv_apply(a, rbd, wd, m2)
    c_ = sp.sparse_conv_apply(b_, sp.subm_rulebook(ids2, shape2), w2, m2)
    want = sp.to_dense(c_, ids2, shape2)

    pillars, cols, occ = pl.pillars_from_grid(grid, x, capacity=96)
    a_p = pl.pillar_conv(cols, pl.bev_rulebook(pillars), w1) * occ[..., None]
    opil = pl.downsample_pillars(pillars, out_capacity=96, out_depth=5)
    rbx = pl.bev_rulebook(pillars, opil, (3, 3), (2, 2), (1, 1))
    b_p, cover = pl.pillar_conv(a_p, rbx, wd, z_stride=2, z_pad=1, occ=occ)
    b_p = b_p * cover[..., None]
    c_p = pl.pillar_conv(b_p, pl.bev_rulebook(opil), w2) * cover[..., None]
    np.testing.assert_allclose(pl.pillar_to_dense(c_p, opil).numpy(),
                               want.numpy(), rtol=1e-4, atol=1e-4)
