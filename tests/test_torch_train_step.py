"""One SE-SSD training step of the port (sessd_torch/train/train_step.py)
against the JAX package's ``make_train_step`` on the same ``TrainState``,
carried over by ``sessd_torch.utils.convert_jax``: sparse shape
(41, 32, 32), batch 2, host rulebook chains, student plan dense_from_stage=3
and teacher plan 5, f32 on the CPU (the port's sparse convs through the K4/K5
twins).

The EMA parameters differ from the student's and the teacher sees the same
voxels, so the consistency loss finds pairs (sample 0 keeps the identity
augmentation). The batch seed is one whose forward puts no ReLU or
threshold input within float32 rounding of its kink in either framework: a
ReLU whose input JAX and the port round to opposite signs moves the
gradients upstream of it by a few percent, which says nothing about the
port (seed 17, for one, does this). Tolerances, and why:
- every loss term: 1e-5 relative (f32, the same formulas), but 1e-4 for
  the two consistency terms: they are smooth-L1 of differences between
  near-equal teacher and student boxes, so f32 rounding of ~10 m boxes is
  ~1e-4 of the difference; and 1e-4 for the gradients' norm, which sums
  gradients that agree to ~1e-4;
- every gradient tensor: 1e-3 of its max (sums through 24 convs, BatchNorm
  and the ODIoU geometry in another order);
- parameters after the step: 2.5 x lr absolute. At Adam's first step the
  update is about lr * sign(g), so a gradient entry within rounding of 0 may
  move either way;
- EMA parameters: the same bound scaled by (1 - alpha);
- BatchNorm running statistics of student and teacher: 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sessd_tpu.core.anchors import create_anchors_3d_range
from sessd_tpu.models import VoxelNet as JaxVoxelNet
from sessd_tpu.train import losses as jl
from sessd_tpu.train import optim as jo
from sessd_tpu.train.train_step import TrainState as JaxTrainState
from sessd_tpu.train.train_step import make_train_step as jax_make_step
from sessd_torch.models.detector import VoxelNet
from sessd_torch.train import losses as tl
from sessd_torch.train import optim as to
from sessd_torch.train.train_step import TrainState, make_train_step
from sessd_torch.utils.convert_jax import convert_train_state
from tests.test_torch_common import (CAPS, SPARSE_SHAPE, host_inputs,
                                     jax_voxelnet_variables, rel_err,
                                     to_torch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

B = 2
STEP = 5  # EMA alpha = 1 - 1/6
OCFG = dict(lr_max=3e-3, total_steps=100)
K = 16  # top-K of positives and of consistency candidates (32 anchors)


def make_batch(seed=12):
    """Loader-layout batch: voxels [B, V, 1, 4], labels over the 4 x 4 x 2
    anchors of the cropped grid; the teacher sees the same voxels."""
    feats, coords, valid, rb = host_inputs(seed, b=B)
    rng = np.random.RandomState(seed)
    v = CAPS[0]
    anchors = create_anchors_3d_range(
        [1, 4, 4], [0, -40, -1.0, 70.4, 40, -1.0]).reshape(-1, 7)
    a = anchors.shape[0]
    labels = rng.choice([-1, 0, 1], (B, a), p=[0.1, 0.5, 0.4]).astype(
        np.int32)
    reg = (rng.randn(B, a, 7) * 0.1).astype(np.float32)
    batch = {
        "voxels": feats.reshape(B, v, 1, 4),
        "coords": coords[:, 1:].reshape(B, v, 3),
        "num_points": np.ones((B, v), np.int32),
        "voxel_mask": valid.reshape(B, v),
        "rulebooks": rb,
        "anchors": np.broadcast_to(anchors, (B, a, 7)).astype(np.float32),
        "labels": labels, "reg_targets": reg,
        "labels_raw": labels, "reg_targets_raw": reg,
        "transformation": {
            "flipped": np.array([False, True]),
            "noise_rotation": np.array([0.0, 0.2], np.float32),
            "noise_scale": np.array([1.0, 1.03], np.float32)},
    }
    for k in ("voxels", "coords", "num_points", "voxel_mask", "rulebooks"):
        batch[k + "_raw"] = batch[k]
    return batch


def initial_state():
    """Student variables, and EMA variables 0.2% off them (close enough
    that teacher and student boxes pair up at IoU > 0.7)."""
    student = jax_voxelnet_variables()
    rng = np.random.RandomState(4)
    ema = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) * (1 + 0.002 * rng.randn(*x.shape))).astype(
            np.float32), student)
    return student, ema


def _capture_grads():
    """An optax stage that keeps the gradients it is handed in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _loss_cfgs():
    return (jl.LossConfig(max_positive_anchors=K,
                          consistency=jl.ConsistencyConfig(top_k=K)),
            tl.LossConfig(max_positive_anchors=K,
                          consistency=tl.ConsistencyConfig(top_k=K)))


@functools.lru_cache(maxsize=None)
def jax_step():
    """(state before, state after, grads, metrics) of make_train_step."""
    student, ema = initial_state()
    model = JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                        dense_from_stage=3, conv_impl="gather",
                        backbone_remat=False)
    opt = optax.chain(_capture_grads(),
                      jo.build_optimizer(jo.OneCycleConfig(**OCFG)))
    state = JaxTrainState(
        step=jnp.int32(STEP), params=student["params"],
        batch_stats=student["batch_stats"], ema_params=ema["params"],
        ema_batch_stats=ema["batch_stats"],
        opt_state=opt.init(student["params"]))
    step = jax_make_step(model, opt, _loss_cfgs()[0],
                         teacher_model=model.clone(dense_from_stage=5))
    new, metrics = jax.jit(step)(state, make_batch(), jnp.float32(0.7))
    new = jax.tree_util.tree_map(np.asarray, new)
    return (state, new, new.opt_state[0],
            {k: float(v) for k, v in metrics.items()})


def as_torch(tree):
    """Nested dicts / lists of numpy arrays -> the same of CPU tensors."""
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_torch(v) for v in tree]
    return to_torch(np.ascontiguousarray(tree))


def port_batch(batch: dict) -> dict:
    """A JAX step's batch as the port's step takes it: CPU tensors, the
    chains under ``inputs`` (the model's third forward argument)."""
    return as_torch({k.replace("rulebooks", "inputs"): v
                     for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def port_step():
    """(student, teacher, grads by parameter name, metrics) of the port's
    step on the same state and batch."""
    state0 = jax_step()[0]
    conv = convert_train_state(jax.tree_util.tree_map(np.asarray, state0))
    student = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=3)
    teacher = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=5)
    student.load_state_dict(conv["student"])
    teacher.load_state_dict(conv["teacher"])
    ocfg = to.OneCycleConfig(**OCFG)
    opt = to.AdamW(list(student.parameters()), to.one_cycle_lr(ocfg),
                   to.one_cycle_mom(ocfg))
    grads = {}
    step_fn = opt.step

    def capture(gs):
        grads.update(zip([n for n, _ in student.named_parameters()],
                         [g.clone() for g in gs]))
        return step_fn(gs)

    opt.step = capture
    state = TrainState(conv["step"], student, teacher, opt)
    metrics = make_train_step(_loss_cfgs()[1])(state, port_batch(make_batch()),
                                               0.7)
    assert state.step == STEP + 1
    return student, teacher, grads, {k: float(v) for k, v in metrics.items()}


def test_step_loss_terms():
    want = jax_step()[3]
    got = port_step()[3]
    assert set(want) == set(got)
    assert want["consistency_loss"] > 0 and want["ious_loss"] > 0
    for k, v in want.items():
        rtol = 1e-4 if k.startswith("consistency") or k == "grad_norm" \
            else 1e-5
        assert abs(got[k] - v) <= rtol * abs(v) + 1e-7, (k, got[k], v)


def test_step_gradients():
    _, new, jgrads, _ = jax_step()
    want = convert_train_state(new._replace(params=jgrads))["student"]
    got = port_step()[2]
    assert set(got) <= set(want)
    for name, g in got.items():
        w = want[name].numpy()
        if not np.any(w):
            assert not g.any(), name
            continue
        assert rel_err(g, w) < 1e-3, name


@pytest.mark.parametrize("tree", ["student", "teacher"])
def test_step_state_after(tree):
    _, new, _, _ = jax_step()
    want = convert_train_state(new)[tree]
    module = port_step()[0 if tree == "student" else 1]
    lr = to.one_cycle_lr(to.OneCycleConfig(**OCFG))(0)
    alpha = 1 - 1 / (STEP + 1)
    bound = 2.5 * lr * (1.0 if tree == "student" else 1 - alpha)
    for name, v in module.state_dict().items():
        w = want[name].numpy()
        if "running" in name:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            assert np.abs(v.numpy() - w).max() <= bound, name
