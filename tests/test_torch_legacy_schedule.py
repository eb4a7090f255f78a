"""The legacy LrUpdaterHook schedules (``sessd_torch.train.optim.
build_legacy_schedule``) against ``sessd_tpu.train.optim.
build_legacy_schedule`` at every step of a short run, for every policy and
warmup the JAX function accepts; and ``builder.build_optimizer_from_cfg``
selecting it where the JAX builder does, its AdamW (beta1 0.9) against
optax over three steps. f32; tolerance 1e-6 relative on the learning rate
(the same float32 arithmetic; pow and cos from another library), 2e-6 of
each tensor's max on the parameters, as for the one-cycle recipe."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sessd_tpu import builder as jbuilder
from sessd_tpu.config import Config as JaxConfig
from sessd_tpu.train import optim as jo
from sessd_torch import builder
from sessd_torch.config import Config
from sessd_torch.train import optim as to
from tests.test_torch_common import rel_err, to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

SPE, TOTAL = 7, 49  # steps per epoch, steps of the run
POLICIES = [
    ("fixed", dict()),
    ("step", dict(gamma=0.1, milestones=(2, 5))),
    ("step", dict(gamma=0.5)),          # no milestone: the base lr
    ("exp", dict(gamma=0.8)),
    ("poly", dict(power=0.9)),
    ("poly", dict(power=2.0)),
    ("cosine", dict(min_lr=1e-5)),
]
WARMUPS = [None, ("constant", 0.25), ("linear", 0.1), ("exp", 1.0 / 3.0)]
CASES = [(p, kw, w) for p, kw in POLICIES for w in WARMUPS]


@pytest.mark.parametrize(
    "policy,kw,warmup", CASES,
    ids=[f"{p}-{i}-{w[0] if w else 'none'}"
         for i, (p, kw, w) in enumerate(CASES)])
def test_legacy_schedule_matches_jax_at_every_step(policy, kw, warmup):
    extra = {} if warmup is None else dict(
        warmup=warmup[0], warmup_iters=12, warmup_ratio=warmup[1])
    jfn = jo.build_legacy_schedule(policy, 3e-3, SPE, TOTAL, **kw, **extra)
    tfn = to.build_legacy_schedule(policy, 3e-3, SPE, TOTAL, **kw, **extra)
    for step in range(TOTAL + 3):
        want = float(jfn(jnp.int32(step)))
        got = tfn(step)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * abs(want), step


def test_unknown_policy_and_warmup_raise():
    with pytest.raises(ValueError, match="policy"):
        to.build_legacy_schedule("linear", 1.0, SPE, TOTAL)
    with pytest.raises(ValueError, match="warmup"):
        to.build_legacy_schedule("fixed", 1.0, SPE, TOTAL, warmup="cos")


LR_CONFIGS = [
    dict(type="step", lr=0.01, step=(2,), gamma=0.1),
    dict(policy="cosine", min_lr=1e-4, warmup="linear", warmup_iters=5,
         warmup_ratio=0.2),
    dict(type="poly", power=0.9),       # lr from the optimizer section
]


@pytest.mark.parametrize("lr_config", LR_CONFIGS,
                         ids=["step", "cosine-warmup", "poly-optimizer-lr"])
def test_builder_selects_the_legacy_schedule(lr_config):
    """The same config through both builders: the same lr at every step,
    and the port's AdamW (constant beta1 0.9) against optax's
    ``build_optimizer_with_schedule`` over three steps, one clipped."""
    section = dict(total_epochs=4,
                   optimizer=dict(type="adam", lr=0.02, wd=0.01,
                                  amsgrad=False),
                   optimizer_config=dict(grad_clip=dict(max_norm=35)),
                   lr_config=lr_config)
    rng = np.random.RandomState(0)
    shapes = [(27, 4, 16), (16,), (128, 64, 3, 3)]
    params = [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * scale for s in shapes]
             for scale in (0.05, 3.0, 0.1)]

    opt, jlr = jbuilder.build_optimizer_from_cfg(JaxConfig(section), 5)
    ours, lr_fn = builder.build_optimizer_from_cfg(
        Config(section), 5, [to_torch(p.copy()) for p in params])
    for step in range(22):
        want = float(jlr(jnp.int32(step)))
        assert abs(lr_fn(step) - want) <= 1e-6 * abs(want), step

    state = opt.init(params)
    update = jax.jit(opt.update)
    for g in grads:
        upd, state = update(g, state, params)
        params = [np.asarray(a) for a in optax.apply_updates(params, upd)]
        ours.step([to_torch(a) for a in g])
        assert ours.hyperparams["b1"] == pytest.approx(0.9)
        for p, want in zip(ours.params, params):
            assert rel_err(p, want) < 2e-6
    assert float(optax.global_norm(grads[1])) > 35
