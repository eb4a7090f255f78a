"""Shared inputs of the port's parity tests (sessd_torch vs sessd_tpu); holds
no tests itself.

Inputs are made with numpy from a seed and handed to both frameworks:
host rulebook chains from ``native.build_rulebooks`` on a cropped grid, and
JAX ``VoxelNet`` variables with nontrivial BatchNorm statistics, carried to
the port through ``sessd_torch.utils.convert_jax``.
"""
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sessd_tpu.data.rulebooks import DOWNS
from sessd_tpu.utils import native as ref_native
from sessd_torch.utils import native as port_native
import test_torch_threads  # noqa: F401 (torch's threads under xdist)


def guard_reference_native():
    """Build the JAX package's ``native/libsessd_native.so`` under the
    port's lock (temporary file + one rename) and hand it to the reference
    loader if that cached ``None``. The reference loader compiles straight
    onto the final path with a lock inside one process only, so test
    workers that collect together could load a half-written file."""
    lib = port_native.build_library(port_native.SRC_DIR, ref_native._LIB_PATH)
    with ref_native._lock:
        if ref_native._native is None:
            ref_native._native = ref_native._Native(ctypes.CDLL(str(lib)))
            ref_native._tried = True
    return ref_native._native


# Built under locks shared by every test process before any test runs:
# each worker imports this module while it collects, so both packages' host
# libraries are whole before a test of either package loads one.
guard_reference_native()
NATIVE = port_native.ensure_native()

SPARSE_SHAPE = (41, 32, 32)
CAPS = (512, 512, 400, 256, 128)
SEED = 2  # of the inputs of the shared JAX interpret-mode run


def host_inputs(seed, b=1, v=300, sparse_shape=SPARSE_SHAPE, caps=CAPS,
                out_dtype=np.int32):
    """Random unique voxels per sample + the host rulebook chain, laid out as
    HostPreprocessor does: feats [b*cap0, 4] zero-padded per sample.
    Returns (feats, coords_bzyx, valid, rulebooks)."""
    rng = np.random.RandomState(seed)
    cap0 = caps[0]
    feats = np.zeros((b * cap0, 4), np.float32)
    coords = np.zeros((b * cap0, 4), np.int32)
    valid = np.zeros((b * cap0,), bool)
    for s in range(b):
        cells = rng.choice(int(np.prod(sparse_shape)), v, replace=False)
        o = s * cap0
        coords[o:o + v, 0] = s
        coords[o:o + v, 1:] = np.stack(np.unravel_index(cells, sparse_shape),
                                       1)
        feats[o:o + v] = rng.randn(v, 4)
        valid[o:o + v] = True
    rb = NATIVE.build_rulebooks(
        coords, valid, (b,) + tuple(sparse_shape), [c * b for c in caps],
        DOWNS, out_dtype=out_dtype)
    return feats, coords, valid, rb


def as_int16(rulebooks):
    """The int16 (transfer-compressed) form of an int32 chain; ids stay."""
    return {k: (v if k == "ids" else
                ([a.astype(np.int16) for a in v] if isinstance(v, list)
                 else v.astype(np.int16)))
            for k, v in rulebooks.items()}


def random_variables(shapes, seed=0):
    """Fill a variables tree of ShapeDtypeStructs from a numpy seed: kernels
    at fan-in scale, random biases and BN statistics/affines (so the BN fold
    is exercised)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "'kernel'" in name:
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif "'mean'" in name or "'bias'" in name:
            v = rng.randn(*shape) * 0.3
        elif "'var'" in name:
            v = rng.rand(*shape) + 0.5
        elif "'scale'" in name:
            v = 1.0 + rng.randn(*shape) * 0.2
        else:
            raise KeyError(name)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_voxelnet_variables(sparse_shape=SPARSE_SHAPE, caps=CAPS, seed=0):
    """Random nontrivial VoxelNet variables; the tree comes from tracing
    init (no compile), the values from numpy."""
    from sessd_tpu.models import VoxelNet

    feats, coords, valid, rb = host_inputs(seed, sparse_shape=sparse_shape,
                                           caps=caps)
    model = VoxelNet(sparse_shape=sparse_shape, stage_capacity=caps,
                     dense_from_stage=5, conv_impl="gather")
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), feats[:, None, :], coords,
                           np.ones(len(feats), np.int32), valid, 1,
                           train=False, rulebooks=rb))
    return random_variables(shapes, seed)


@functools.lru_cache(maxsize=None)
def jax_fused_reference(seed):
    """The JAX serving forward, ``VoxelNet(conv_impl="fused")`` with the
    Pallas kernels in interpret mode, on ``host_inputs(seed)`` (int32 chain)
    and ``jax_voxelnet_variables()``. Returns (backbone BEV [1, H, W, C*D],
    head outputs of task 0) as numpy. Cached: the backbone and slice tests
    share one interpret-mode run."""
    from sessd_tpu.models import VoxelNet
    from sessd_tpu.models.backbone import SpMiddleFHD

    feats, coords, valid, rb = host_inputs(seed)
    model = VoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                     dense_from_stage=5, conv_impl="fused")
    preds, state = model.apply(
        jax_voxelnet_variables(), jnp.asarray(feats)[:, None, :], coords,
        np.ones(len(feats), np.int32), valid, 1, train=False, rulebooks=rb,
        capture_intermediates=lambda m, _: isinstance(m, SpMiddleFHD))
    (bev,) = state["intermediates"]["backbone"]["__call__"]
    out = [np.array(bev), {k: np.array(v) for k, v in preds[0].items()}]
    for a in [out[0], *out[1].values()]:
        a.setflags(write=False)  # shared by every caller of the cache
    return tuple(out)


def port_voxelnet(variables, sparse_shape=SPARSE_SHAPE):
    """The port's VoxelNet (f32, CPU) holding the same weights."""
    from sessd_torch.models.detector import VoxelNet
    from sessd_torch.utils.convert_jax import convert_jax

    model = VoxelNet(sparse_shape=sparse_shape)
    model.load_state_dict(convert_jax(variables))
    return model.eval()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))
