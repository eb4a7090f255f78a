"""Warm start and optimizer carry-over of the port against the JAX package,
on the CPU at the cropped grid of ``tests/test_torch_train_step.py``
(sparse shape (41, 32, 32), batch 2, f32, the sparse convs through the
K4/K5 twins):

- ``convert_train_state`` carries the inner Adam moments and both counts
  of a JAX state after 3 optax steps exactly, and a 4th step from the
  converted state matches optax's;
- the warm start: a JAX state after 2 CIA-SSD steps (``enable_ssl=False``)
  goes through ``sessd_tpu.utils.checkpoint.load_params_only``'s semantics
  (params into both nets, moments kept, ``_restart_schedule``) in JAX, and
  through a port checkpoint and ``checkpoint.load_params_only`` in the
  port; then one SE-SSD step in each. Loss terms agree to 1e-5 relative
  (1e-4 for the two consistency terms and the gradients' norm, as in
  ``test_torch_train_step.py``: differences of near-equal boxes, and a sum
  of gradients that agree to ~1e-4); parameters, EMA parameters and both
  moments to 1e-5 absolute (Adam's moments carry over, so the step is no
  sign-like first step); the lr and beta1 the step applied equal optax's
  ``hyperparams`` exactly;
- a checkpoint written before the optimizer's counts were split still
  loads, with the schedule count equal to Adam's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sessd_tpu.models import VoxelNet as JaxVoxelNet
from sessd_tpu.train import optim as jo
from sessd_tpu.train.train_step import TrainState as JaxTrainState
from sessd_tpu.train.train_step import make_train_step as jax_make_step
from sessd_tpu.utils.checkpoint import _restart_schedule
from sessd_torch.models.detector import VoxelNet
from sessd_torch.train import optim as to
from sessd_torch.train.train_step import TrainState, make_train_step
from sessd_torch.utils import checkpoint as ckpt
from sessd_torch.utils.convert_jax import (convert_jax, convert_train_state,
                                           load_train_state)
from tests.test_torch_common import CAPS, SPARSE_SHAPE, jax_voxelnet_variables
from tests.test_torch_train_step import (_loss_cfgs, initial_state,
                                         make_batch, port_batch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

CIA_CFG = dict(lr_max=3e-3, total_steps=100)
SE_CFG = dict(lr_max=3e-3, total_steps=40)  # another schedule, restarted


def _port_state(ocfg, dense_from_stage=3):
    student = VoxelNet(sparse_shape=SPARSE_SHAPE,
                       dense_from_stage=dense_from_stage)
    teacher = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=5)
    cfg = to.OneCycleConfig(**ocfg)
    opt = to.AdamW(list(student.parameters()), to.one_cycle_lr(cfg),
                   to.one_cycle_mom(cfg))
    return TrainState(0, student, teacher, opt)


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.randn(*np.shape(p)) * 0.05).astype(np.float32),
        params)


def test_convert_carries_moments_and_counts():
    variables = jax_voxelnet_variables()
    params = variables["params"]
    opt = jo.build_optimizer(jo.OneCycleConfig(**CIA_CFG))
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    for seed in range(3):
        upd, opt_state = update(_grads(params, seed), opt_state, params)
        params = optax.apply_updates(params, upd)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    jstate = JaxTrainState(jnp.int32(3), np_tree(params),
                           variables["batch_stats"], np_tree(params),
                           variables["batch_stats"], np_tree(opt_state))
    conv = convert_train_state(jstate)
    inner = opt_state[1].inner_state[0]
    assert conv["optimizer"]["count"] == 3 == int(inner.count)
    assert conv["optimizer"]["sched_count"] == 3 == int(opt_state[1].count)
    for key in ("mu", "nu"):
        tree = np_tree(getattr(inner, key))
        want = convert_jax({"params": tree,
                            "batch_stats": variables["batch_stats"]})
        got = conv["optimizer"][key]
        assert set(got) == {k for k in want if "running_" not in k}
        for name, t in got.items():
            assert torch.equal(t, want[name]), (key, name)
    # one layer by hand: backbone block 0's kernel [27, 4, 16] ->
    # spconv [3, 3, 3, 4, 16]
    np.testing.assert_array_equal(
        conv["optimizer"]["mu"]["backbone.middle_conv.0.weight"].numpy(),
        np.asarray(inner.mu["backbone"]["SparseConvBlock_0"]["kernel"])
        .reshape(3, 3, 3, 4, 16))

    state = _port_state(CIA_CFG)
    load_train_state(state, conv)
    opt_t = state.optimizer
    assert (opt_t.count, opt_t.sched_count, state.step) == (3, 3, 3)
    # a 4th step from the carried state is optax's 4th step
    g = _grads(params, 3)
    upd, _ = update(g, opt_state, params)
    want = convert_jax({"params": np_tree(optax.apply_updates(params, upd)),
                        "batch_stats": variables["batch_stats"]})
    sd = convert_jax({"params": g, "batch_stats": variables["batch_stats"]})
    opt_t.step([sd[n] for n, _ in state.student.named_parameters()])
    for name, p in state.student.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def _jax_model(dense_from_stage):
    return JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                       dense_from_stage=dense_from_stage, conv_impl="gather",
                       backbone_remat=False)


def _cia_loss_cfg():
    """CIA-SSD trains the SmoothL1 regression (cia_ssd_kitti_car.py)."""
    return _loss_cfgs()[0]._replace(reg_loss="smooth_l1")


@functools.lru_cache(maxsize=None)
def jax_warm_start():
    """(CIA state after 2 steps, SE state after the warm start and one SE
    step, SE step metrics) in JAX."""
    student, ema = initial_state()
    model = _jax_model(3)
    opt_a = jo.build_optimizer(jo.OneCycleConfig(**CIA_CFG))
    state = JaxTrainState(
        step=jnp.int32(0), params=student["params"],
        batch_stats=student["batch_stats"], ema_params=ema["params"],
        ema_batch_stats=ema["batch_stats"],
        opt_state=opt_a.init(student["params"]))
    cia_step = jax.jit(jax_make_step(model, opt_a, _cia_loss_cfg(),
                                     enable_ssl=False))
    batch = make_batch()
    for _ in range(2):
        state, _ = cia_step(state, batch, jnp.float32(0.0))
    cia = jax.tree_util.tree_map(np.asarray, state)

    # load_params_only (sessd_tpu/utils/checkpoint.py:96-109) on a fresh
    # SE-SSD template: step 0, params into both nets, schedule restarted
    opt_b = jo.build_optimizer(jo.OneCycleConfig(**SE_CFG))
    warm = JaxTrainState(
        step=jnp.int32(0), params=cia.params, batch_stats=cia.batch_stats,
        ema_params=cia.params, ema_batch_stats=cia.batch_stats,
        opt_state=_restart_schedule(cia.opt_state))
    se_step = jax.jit(jax_make_step(model, opt_b, _loss_cfgs()[0],
                                    teacher_model=_jax_model(5)))
    new, metrics = se_step(warm, batch, jnp.float32(0.7))
    return (cia, jax.tree_util.tree_map(np.asarray, new),
            {k: float(v) for k, v in metrics.items()})


@functools.lru_cache(maxsize=None)
def port_warm_start(tmp):
    """The port's SE step after ``load_params_only`` from a checkpoint of
    the JAX CIA state; returns (state, metrics)."""
    cia = jax_warm_start()[0]
    src = _port_state(CIA_CFG)
    load_train_state(src, convert_train_state(cia))
    ckpt.save_checkpoint(tmp, src, epoch=2)
    state = _port_state(SE_CFG)
    state.student.reset_parameters(torch.Generator().manual_seed(5))
    assert ckpt.load_params_only(tmp, state) is state
    opt = state.optimizer
    assert (state.step, opt.count, opt.sched_count) == (0, 2, 0)
    for a, b in zip(state.teacher.state_dict().values(),
                    state.student.state_dict().values()):
        assert torch.equal(a, b)
    metrics = make_train_step(_loss_cfgs()[1])(state, port_batch(make_batch()),
                                               0.7)
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    return port_warm_start(str(tmp_path_factory.mktemp("cia")))


def test_warm_start_loss_terms(warm):
    want = jax_warm_start()[2]
    got = warm[1]
    assert set(want) == set(got)
    for k, v in want.items():
        rtol = 1e-4 if k.startswith("consistency") or k == "grad_norm" \
            else 1e-5
        assert abs(got[k] - v) <= rtol * abs(v) + 1e-7, (k, got[k], v)


def test_warm_start_hyperparams_exact(warm):
    """The step applied the restarted schedule's step 0, with Adam's bias
    correction at count 3, as optax did."""
    new = jax_warm_start()[1]
    hp = new.opt_state[1].hyperparams
    opt = warm[0].optimizer
    assert opt.hyperparams["learning_rate"] == float(hp["learning_rate"])
    assert opt.hyperparams["b1"] == float(hp["b1"])
    assert (opt.count, opt.sched_count) == (
        int(new.opt_state[1].inner_state[0].count),
        int(new.opt_state[1].count)) == (3, 1)


@pytest.mark.parametrize("what", ["student", "teacher", "mu", "nu"])
def test_warm_start_state_after_step(warm, what):
    new = jax_warm_start()[1]
    conv = convert_train_state(new)
    state = warm[0]
    if what in ("student", "teacher"):
        got = getattr(state, what).state_dict()
        want = conv[what]
    else:
        names = [n for n, _ in state.student.named_parameters()]
        got = dict(zip(names, getattr(state.optimizer, what)))
        want = conv["optimizer"][what]
    for name, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_pr3_checkpoint_still_loads(tmp_path):
    """A checkpoint with one optimizer count (the format before the counts
    were split) resumes with sched_count = count."""
    state = _port_state(CIA_CFG)
    opt = state.optimizer
    blob = {"epoch": 3, "step": 7, "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict(),
            "optimizer": {"count": 7,
                          "mu": [torch.full_like(m, 0.5) for m in opt.mu],
                          "nu": [torch.full_like(m, 0.25) for m in opt.nu]}}
    path = ckpt.checkpoint_path(tmp_path, 3)
    path.parent.mkdir(parents=True)
    torch.save(blob, path)
    fresh = _port_state(CIA_CFG)
    got, epoch = ckpt.load_checkpoint(tmp_path, fresh)
    o = fresh.optimizer
    assert (epoch, fresh.step, o.count, o.sched_count) == (3, 7, 7, 7)
    assert all(bool((m == 0.5).all()) for m in o.mu)
    assert all(bool((n == 0.25).all()) for n in o.nu)
    warm = _port_state(CIA_CFG)
    ckpt.load_params_only(tmp_path, warm)
    assert (warm.step, warm.optimizer.count,
            warm.optimizer.sched_count) == (0, 7, 0)
    assert ckpt.load_params_only(tmp_path / "none", warm) is None
