"""The port's one-cycle schedule, AdamW and global-norm clip
(sessd_torch/train/optim.py) against optax as the JAX package builds it
(``sessd_tpu.train.optim.build_optimizer``), over three steps, one of them
clipped. f32; tolerance 1e-6 relative on the schedule, 2e-6 of each
tensor's max on the parameters (the same float32 arithmetic in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sessd_tpu.train import optim as jo
from sessd_torch.train import optim as to
from tests.test_torch_common import rel_err, to_torch
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

CFG = dict(lr_max=3e-3, total_steps=50, pct_start=0.4, div_factor=10.0)


@pytest.mark.parametrize("which", ["lr", "mom"])
def test_one_cycle_schedule_matches_jax(which):
    jfn = getattr(jo, f"one_cycle_{which}")(jo.OneCycleConfig(**CFG))
    tfn = getattr(to, f"one_cycle_{which}")(to.OneCycleConfig(**CFG))
    for step in [0, 1, 7, 19, 20, 21, 33, 49, 50, 60]:
        want = float(jfn(jnp.int32(step)))
        assert abs(tfn(step) - want) <= 1e-6 * abs(want), step


def test_adamw_clip_matches_optax_over_three_steps():
    rng = np.random.RandomState(0)
    shapes = [(27, 4, 16), (16,), (16,), (128, 64, 3, 3)]
    params = [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    # step 1 is far above the clip norm of 35, steps 0 and 2 below it
    grads = [[rng.randn(*s).astype(np.float32) * scale for s in shapes]
             for scale in (0.05, 3.0, 0.1)]
    opt = jo.build_optimizer(jo.OneCycleConfig(**CFG))
    state = opt.init(params)
    ours = to.AdamW([to_torch(p.copy()) for p in params],
                    to.one_cycle_lr(to.OneCycleConfig(**CFG)),
                    to.one_cycle_mom(to.OneCycleConfig(**CFG)))
    update = jax.jit(opt.update)
    for g in grads:
        norm = float(optax.global_norm(g))
        upd, state = update(g, state, params)
        params = [np.asarray(a) for a in optax.apply_updates(params, upd)]
        got_norm = ours.step([to_torch(a) for a in g])
        assert abs(float(got_norm) - norm) <= 1e-6 * norm
        for p, want in zip(ours.params, params):
            assert rel_err(p, want) < 2e-6
    assert ours.count == 3
    assert float(optax.global_norm(grads[1])) > 35 > float(
        optax.global_norm(grads[0]))
