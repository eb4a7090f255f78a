"""Data parallel of the port (sessd_torch/parallel/mesh.py, the synchronized
``BatchNorm``, the train step's gradient and metric all-reduce) against the
JAX package's mesh on the same inputs: two gloo ranks on the CPU, each in
a process of its own (tests/test_torch_rank_workers.py), against
``jax.shard_map`` over two of the conftest's eight CPU devices.

1. ``AllReduceSum`` against ``psum``: the sum, and the gradient of every
   shard's loss through it (the transpose of ``psum`` is a ``psum``), to
   1e-6.
2. The synchronized BatchNorm, masked (``MaskedBatchNorm(axis_name=...)``)
   and unmasked (flax ``nn.BatchNorm(axis_name=...)``), on the same rows
   split in two: outputs and running statistics to 1e-5, the input and
   affine gradients to 1e-5 of their max (the affine ones averaged over
   the ranks, as the step does); the forward also equals one process's
   BatchNorm over the rows together, and a forward under ``no_grad`` (the
   teacher's) gives the same outputs and statistics.
3. One SE-SSD teacher/student step of the port on two ranks, twice,
   against ``make_train_step(axis_name=DATA_AXIS)`` under
   ``make_sharded_train_step``: sparse shape (41, 32, 32), the caps of
   test_torch_common.py, batch 4 (2 per rank, each with its own host
   chain), f32, the same TrainState through ``convert_train_state``: the
   first step from the initial state, the second from JAX's state after
   the first (optimizer moments included), so each step is held to one
   step's tolerances and a systematic sync error shows in the second
   step's Adam update, which depends on the gradients' magnitudes, not
   only their signs. (Chained from the port's own first step, the second
   step's losses move by up to 7e-5 relative and ``grad_norm`` by 0.7%:
   the first step's parameters differ by up to 2.5 x lr where a gradient
   is within rounding of 0, as below.) At the tolerances
   test_torch_train_step.py states and justifies: loss terms 1e-5
   relative (1e-4 for the consistency terms and ``grad_norm``),
   parameters 2.5 x the step's lr (at Adam's first steps an entry whose
   gradient is within rounding of 0 may move either way by about lr), EMA
   parameters the same bound x (1 - alpha), BatchNorm statistics 1e-5.
   After each step the two ranks' states are bit-equal.
4. ``all_gather_detections`` gathers every rank's buffers, and rank 0's
   merge (``merge_rank_detections``) drops wrap-padded duplicates, orders
   by dataset index and fills indices no rank ran with empty entries.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import PartitionSpec as P

from sessd_tpu.models import VoxelNet as JaxVoxelNet
from sessd_tpu.models.layers import MaskedBatchNorm, batch_norm_2d
from sessd_tpu.parallel.mesh import (DATA_AXIS, make_mesh,
                                     make_sharded_train_step, replicate,
                                     shard_batch)
from sessd_tpu.train import optim as jo
from sessd_tpu.train.train_step import TrainState as JaxTrainState
from sessd_tpu.train.train_step import make_train_step as jax_make_step
from sessd_torch.models.layers import BatchNorm
from sessd_torch.train import optim as to
from sessd_torch.train.trainer import _GATHER_KEYS, merge_rank_detections
from sessd_torch.utils.convert_jax import convert_train_state
from tests import test_torch_rank_workers as workers
from tests.test_torch_common import CAPS, SPARSE_SHAPE, host_inputs, rel_err
from tests.test_torch_train_step import (OCFG, STEP, K, _loss_cfgs,
                                         initial_state, port_batch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

WORLD = 2
C = 16


def mesh2():
    return make_mesh(jax.devices()[:WORLD])


def shard_map(fn, n_in, n_out):
    return jax.jit(jax.shard_map(
        fn, mesh=mesh2(), in_specs=(P(DATA_AXIS),) * n_in,
        out_specs=(P(DATA_AXIS),) * n_out, check_vma=False))


def unit_inputs():
    """Per-rank inputs [WORLD, ...] of the unit checks, from numpy."""
    rng = np.random.RandomState(3)
    d = {"psum_x": rng.randn(WORLD, 5), "psum_c": rng.randn(WORLD, 5)}
    n = 48
    d.update({
        "masked.x": rng.randn(WORLD, n, C) * 2 + 1,
        "masked.mask": rng.rand(WORLD, n) < 0.7,
        "masked.w": rng.randn(WORLD, n, C),
        "unmasked.x": rng.randn(WORLD, 1, C, 6, 5) * 2 + 1,
        "unmasked.w": rng.randn(WORLD, 1, C, 6, 5)})
    for kind in ("masked", "unmasked"):
        d.update({f"{kind}.weight": 1 + 0.2 * rng.randn(C),
                  f"{kind}.bias": 0.3 * rng.randn(C),
                  f"{kind}.running_mean": 0.3 * rng.randn(C),
                  f"{kind}.running_var": 0.5 + rng.rand(C)})
    cap, post = 3, 4
    d.update({
        "gather.ids": np.array([[5, 7, -1], [6, 5, 9]]),
        "gather.box3d_lidar": rng.randn(WORLD, cap, post, 7),
        "gather.scores": rng.rand(WORLD, cap, post),
        "gather.label_preds": rng.randint(0, 3, (WORLD, cap, post)),
        "gather.valid": rng.rand(WORLD, cap, post) < 0.5})
    return {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64
                                else v) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def units():
    """(inputs, [rank results]) of workers.units."""
    import tempfile

    d = unit_inputs()
    out = tempfile.mkdtemp(prefix="torch_parallel_")
    torch.save(d, f"{out}/inputs.pt")
    workers.spawn(workers.units, WORLD, f"{out}/inputs.pt", out)
    return d, [torch.load(f"{out}/units_{r}.pt", weights_only=False)
               for r in range(WORLD)]


def test_all_reduce_sum_matches_psum():
    d, res = units()

    def per_shard(x, c):
        def loss(x):
            s = jax.lax.psum(x, DATA_AXIS)
            return jnp.sum(c * s * s), s
        (_, s), g = jax.value_and_grad(loss, has_aux=True)(x)
        return s, g

    s, g = shard_map(per_shard, 2, 2)(d["psum_x"].numpy(),
                                      d["psum_c"].numpy())
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["psum"], np.asarray(s)[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res[r]["psum_grad"], np.asarray(g)[r],
                                   rtol=1e-6, atol=1e-6)


class _Masked(nn.Module):
    @nn.compact
    def __call__(self, x, mask):
        return MaskedBatchNorm(axis_name=DATA_AXIS)(x, mask, True)


class _Unmasked(nn.Module):
    @nn.compact
    def __call__(self, x):
        return batch_norm_2d(x, train=True, axis_name=DATA_AXIS)


def _jax_bn(kind, d):
    """The JAX BatchNorm over the two shards: (y, new stats, dx, pmean of
    the affine gradients), each [WORLD, ...] in the port's layout."""
    p = {k[len(kind) + 1:]: v.numpy() for k, v in d.items()
         if k.startswith(kind + ".")}
    params = {"params": {"BatchNorm_0" if kind == "unmasked" else
                         "MaskedBatchNorm_0": {"scale": p["weight"],
                                               "bias": p["bias"]}},
              "batch_stats": {"BatchNorm_0" if kind == "unmasked" else
                              "MaskedBatchNorm_0": {
                                  "mean": p["running_mean"],
                                  "var": p["running_var"]}}}
    if kind == "masked":
        x, args = p["x"], (p["mask"],)
        model, w = _Masked(), p["w"]
    else:  # NCHW -> NHWC
        x, args = p["x"].transpose(0, 1, 3, 4, 2), ()
        model, w = _Unmasked(), p["w"].transpose(0, 1, 3, 4, 2)

    def per_shard(x, w, *args):
        x, w = x[0], w[0]
        args = tuple(a[0] for a in args)

        def loss(prm, x):
            y, upd = model.apply({"params": prm,
                                  "batch_stats": params["batch_stats"]},
                                 x, *args, mutable=["batch_stats"])
            return jnp.sum(y * w), (y, upd["batch_stats"])
        (_, (y, st)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params["params"], x)
        gp = jax.lax.pmean(gp, DATA_AXIS)
        (st,) = st.values()
        (gp,) = gp.values()
        return (y[None], gx[None], st["mean"][None], st["var"][None],
                gp["scale"][None], gp["bias"][None])

    y, gx, mean, var, gs, gb = (np.asarray(a) for a in shard_map(
        per_shard, 2 + len(args), 6)(x, w, *args))
    if kind == "unmasked":
        y, gx = (a.transpose(0, 1, 4, 2, 3) for a in (y, gx))
    return {"y": y, "dx": gx, "running_mean": mean, "running_var": var,
            "dweight": gs, "dbias": gb}


@pytest.mark.parametrize("kind", ["masked", "unmasked"])
def test_sync_batch_norm_matches_jax(kind):
    d, res = units()
    want = _jax_bn(kind, d)
    for r in range(WORLD):
        got = res[r][kind]
        for k in ("y", "running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k][r], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {r}")
        for k in ("dx", "dweight", "dbias"):
            assert rel_err(got[k], want[k][r]) < 1e-5, (k, r)
        # no_grad: the same forward, the same synced statistics
        torch.testing.assert_close(got["y_no_grad"], got["y"], rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["running_var_no_grad"],
                                   got["running_var"], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["masked", "unmasked"])
def test_sync_batch_norm_equals_one_process(kind):
    """The ranks' forward equals one process's over all rows."""
    d, res = units()
    p = {k[len(kind) + 1:]: v for k, v in d.items()
         if k.startswith(kind + ".")}
    bn = BatchNorm(C)
    bn.load_state_dict({k: p[k] for k in ("weight", "bias", "running_mean",
                                          "running_var")})
    x = torch.cat(list(p["x"]))
    mask = torch.cat(list(p["mask"]))[:, None] if "mask" in p else None
    y = bn.train()(x, mask)
    got = torch.cat([res[r][kind]["y"] for r in range(WORLD)])
    torch.testing.assert_close(got, y, rtol=1e-5, atol=1e-5)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(res[0][kind][k], getattr(bn, k),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["masked", "unmasked"])
def test_sync_batch_norm_group_of_one_equals_local(kind):
    """A group of one (gloo, this process) normalizes as no group does, on
    channels whose mean is large against their spread (where E[x^2] -
    E[x]^2 cancels): outputs and running statistics bit-equal, the input
    gradient within 1e-7 of its max (the backward sums in another
    order)."""
    import torch.distributed as dist

    from sessd_torch.parallel import mesh

    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(500, C) * 3 + 40).astype(np.float32))
    mask = (torch.from_numpy(rng.rand(500, 1) > 0.3) if kind == "masked"
            else None)
    dy = torch.from_numpy(rng.randn(500, C).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{mesh.free_port()}")
    try:
        outs = []
        for group in (None, dist.group.WORLD):
            bn = BatchNorm(C, process_group=group).train()
            bn.weight.data.copy_(weight)
            xg = x.clone().requires_grad_(True)
            y = bn(xg, mask)
            (dx,) = torch.autograd.grad((y * dy).sum(), xg)
            outs.append((y, bn.running_mean, bn.running_var, dx))
    finally:
        dist.destroy_process_group()
    for want, got in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(got, want)
    assert rel_err(outs[1][3], outs[0][3]) <= 1e-7


def test_all_gather_detections():
    d, res = units()
    for r in range(WORLD):
        got = res[r]["gathered"]
        assert set(got) == set(_GATHER_KEYS)
        for k in _GATHER_KEYS:
            assert got[k].dtype == d["gather." + k].dtype, k
            assert torch.equal(got[k], d["gather." + k]), k
    # the psum and one BN sync per forward (two kinds x two forwards), one
    # affine-gradient bucket per kind, one gather per buffer
    assert res[0]["collectives"] == {"bn": 5, "grad": 2, "gather": 5}


def test_merge_rank_detections():
    """Rank 0's merge of hand-built buffers: image ids 5, 6, 7 at dataset
    indices 0, 1, 3 of five; id 5 twice (wrap padding), id 9 outside the
    split, -1 an unused row."""
    d, _ = units()
    g = {k: d["gather." + k].numpy() for k in _GATHER_KEYS}
    id_to_index = {5: 0, 6: 1, 7: 3, 8: 2, 4: 4}
    dets = merge_rank_detections(g, id_to_index, 5)
    assert len(dets) == 5
    for di, (r, row) in {0: (0, 0), 1: (1, 0), 3: (0, 1)}.items():
        v = g["valid"][r, row]
        assert dets[di]["metadata"] == {"image_idx": int(g["ids"][r, row])}
        np.testing.assert_array_equal(dets[di]["box3d_lidar"],
                                      g["box3d_lidar"][r, row][v])
        np.testing.assert_array_equal(dets[di]["scores"],
                                      g["scores"][r, row][v])
        np.testing.assert_array_equal(dets[di]["label_preds"],
                                      g["label_preds"][r, row][v])
    for di in (2, 4):
        assert dets[di]["box3d_lidar"].shape == (0, 7)
        assert dets[di]["scores"].shape == (0,)
        assert dets[di]["metadata"] is None
    # an eval cut by max_batches lists as many indices as were run
    assert len(merge_rank_detections(g, id_to_index, 5, partial=True)) == 3


# ---------------------------------------------------------------------------
# 3. the slice: two SE-SSD steps on two ranks against the sharded JAX step

B = 4
STEPS = 2
CW = 0.7


def slice_batch():
    """The batch of 4: each half (one rank's, one JAX shard's) with its own
    int32 host chain at caps x 2, both chains stacked on a leading shard
    axis as ``build_sharded_batch_rulebooks`` lays them out."""
    from sessd_tpu.core.anchors import create_anchors_3d_range
    from sessd_tpu.data.rulebooks import _tree_stack

    halves = [host_inputs(seed, b=B // WORLD) for seed in (12, 13)]
    rng = np.random.RandomState(12)
    v = CAPS[0]
    anchors = create_anchors_3d_range(
        [1, 4, 4], [0, -40, -1.0, 70.4, 40, -1.0]).reshape(-1, 7)
    a = anchors.shape[0]
    labels = rng.choice([-1, 0, 1], (B, a), p=[0.1, 0.5, 0.4]).astype(
        np.int32)
    reg = (rng.randn(B, a, 7) * 0.1).astype(np.float32)
    batch = {
        "voxels": np.concatenate([h[0] for h in halves]).reshape(B, v, 1, 4),
        "coords": np.concatenate([h[1][:, 1:] for h in halves]).reshape(
            B, v, 3),
        "num_points": np.ones((B, v), np.int32),
        "voxel_mask": np.concatenate([h[2] for h in halves]).reshape(B, v),
        "rulebooks": _tree_stack([h[3] for h in halves]),
        "anchors": np.broadcast_to(anchors, (B, a, 7)).astype(np.float32),
        "labels": labels, "reg_targets": reg,
        "labels_raw": labels, "reg_targets_raw": reg,
        "transformation": {
            "flipped": np.array([False, True, False, True]),
            "noise_rotation": np.array([0.0, 0.2, -0.1, 0.05], np.float32),
            "noise_scale": np.array([1.0, 1.03, 0.97, 1.0], np.float32)},
    }
    for k in ("voxels", "coords", "num_points", "voxel_mask", "rulebooks"):
        batch[k + "_raw"] = batch[k]
    return batch, [h[3] for h in halves]


def rank_batch(batch, chains, r):
    """Rank r's half as the port's step takes it."""
    lb = B // WORLD
    half = {}
    for k, v in batch.items():
        if k.startswith("rulebooks"):
            half[k] = chains[r]
        elif isinstance(v, dict):
            half[k] = {kk: vv[r * lb:(r + 1) * lb] for kk, vv in v.items()}
        else:
            half[k] = v[r * lb:(r + 1) * lb]
    return port_batch(half)


@functools.lru_cache(maxsize=None)
def jax_steps():
    """(state before, [state after each step], [metrics of each step]) of
    the sharded JAX step on two devices."""
    student, ema = initial_state()
    kw = dict(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
              conv_impl="gather", backbone_remat=False, axis_name=DATA_AXIS)
    model = JaxVoxelNet(dense_from_stage=3, **kw)
    opt = jo.build_optimizer(jo.OneCycleConfig(**OCFG))
    state = JaxTrainState(
        step=jnp.int32(STEP), params=student["params"],
        batch_stats=student["batch_stats"], ema_params=ema["params"],
        ema_batch_stats=ema["batch_stats"],
        opt_state=opt.init(student["params"]))
    step = make_sharded_train_step(jax_make_step(
        model, opt, _loss_cfgs()[0], axis_name=DATA_AXIS,
        teacher_model=model.clone(dense_from_stage=5)), mesh2())
    batch, _ = slice_batch()
    sbatch = shard_batch(batch, mesh2())
    cur = replicate(state, mesh2())
    states, metrics = [], []
    for _ in range(STEPS):
        cur, m = step(cur, sbatch, jnp.float32(CW))
        states.append(jax.tree_util.tree_map(np.asarray, cur))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, states, metrics


@functools.lru_cache(maxsize=None)
def port_steps():
    """[rank results] of workers.slice_steps on the same batch: step s
    from JAX's state before its step s."""
    import tempfile

    state0, states, _ = jax_steps()
    batch, chains = slice_batch()
    out = tempfile.mkdtemp(prefix="torch_parallel_slice_")
    starts = [jax.tree_util.tree_map(np.asarray, state0)] + states[:-1]
    torch.save({
        "states": [convert_train_state(s) for s in starts],
        "sparse_shape": SPARSE_SHAPE, "ocfg": OCFG, "top_k": K, "cw": CW,
        "batches": [rank_batch(batch, chains, r) for r in range(WORLD)],
    }, f"{out}/inputs.pt")
    workers.spawn(workers.slice_steps, WORLD, f"{out}/inputs.pt", out)
    return [torch.load(f"{out}/slice_{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_slice_ranks_bit_equal():
    res = port_steps()
    for s in range(STEPS):
        a, b = res[0][s], res[1][s]
        assert a["step"] == b["step"] == STEP + s + 1
        assert a["metrics"] == b["metrics"], s
        bad = [k for k in a["state"]
               if not torch.equal(a["state"][k], b["state"][k])]
        assert not bad, (s, bad[:5])


@pytest.mark.parametrize("s", range(STEPS))
def test_slice_loss_terms(s):
    want = jax_steps()[2][s]
    got = port_steps()[0][s]["metrics"]
    assert set(want) == set(got)
    # the first step pairs teacher and student boxes (consistency > 0)
    assert want["ious_loss"] > 0 and (s or want["consistency_loss"] > 0)
    for k, v in want.items():
        rtol = 1e-4 if k.startswith("consistency") or k == "grad_norm" \
            else 1e-5
        assert abs(got[k] - v) <= rtol * abs(v) + 1e-7, (s, k, got[k], v)


@pytest.mark.parametrize("s", range(STEPS))
@pytest.mark.parametrize("tree", ["student", "teacher"])
def test_slice_state_after(tree, s):
    want = convert_train_state(jax_steps()[1][s])[tree]
    got = port_steps()[0][s]["state"]
    lr = float(to.one_cycle_lr(to.OneCycleConfig(**OCFG))(s))
    alpha = 1 - 1 / (STEP + s + 1)
    bound = 2.5 * lr * (1.0 if tree == "student" else 1 - alpha)
    for name, w in want.items():
        v = got[f"{tree}.{name}"].numpy()
        if "running" in name:
            np.testing.assert_allclose(v, w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} after step {s}")
        else:
            assert np.abs(v - w.numpy()).max() <= bound, (name, s)
