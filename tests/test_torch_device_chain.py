"""The inputs built on the device, against the JAX package on the CPU:
``ops.voxelize.voxelize_torch`` against ``voxelize_jax`` (exact), each
function of the port's device rulebook chain against JAX's
(``sessd_tpu/ops/sparse.py``) and ``build_device_chain`` against the port's
host C++ chain (dtype and values), on the cases of
``tests/test_host_rulebooks.py``: batch 1 and 2, no slack, truncation at
each stage the geometry leaves rows in, the int16 and the int32 occupancy LUT, and the binary search
under a budget patched to zero. Then the model on device chains: VoxelNet's
head outputs against JAX's ``VoxelNet`` with ``rulebooks=None`` (f32, 1e-4
of the max), one ``host_rulebooks=False`` training step against JAX's
``make_train_step`` without chains (the tolerances of
``test_torch_train_step.py``), and ``validate()`` with the key off against
JAX's device-chain eval function (the tolerances of ``test_torch_eval.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessd_tpu.ops import sparse as jsp
from sessd_tpu.ops.voxelize import VoxelizerSpec, voxelize_jax
from sessd_torch.data.rulebooks import DOWNS
from sessd_torch.ops import sparse as sp
from sessd_torch.ops.voxelize import VoxelizerSpec as PortSpec
from sessd_torch.ops.voxelize import voxelize_torch
from tests.test_torch_common import (CAPS, NATIVE, SPARSE_SHAPE, host_inputs,
                                     jax_voxelnet_variables, port_voxelnet,
                                     rel_err, to_torch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

SMALL = dict(point_cloud_range=(0.0, 0.0, 0.0, 4.0, 4.0, 2.0),
             voxel_size=(1.0, 1.0, 1.0), max_points=2, max_voxels=8)


def _voxelize_both(pts, num_valid=None, **spec):
    jv = voxelize_jax(jnp.asarray(pts), VoxelizerSpec(**spec), num_valid)
    tv = voxelize_torch(to_torch(pts), PortSpec(**spec), num_valid)
    return [np.asarray(a) for a in jv], [a.numpy() for a in tv]


def _random_points(rng, n):
    return np.stack([rng.uniform(-1, 21, n), rng.uniform(-11, 11, n),
                     rng.uniform(-2.5, 2.5, n), rng.uniform(0, 1, n)],
                    1).astype(np.float32)


@pytest.mark.parametrize("case", ["binning", "overflow", "padding",
                                  "random", "random_capped"])
def test_voxelize_matches_jax(case):
    """Every output bit for bit, dtypes included, on test_voxelize.py's
    cases: points dropped past max_points, out-of-range points, voxels past
    max_voxels (lowest ids survive), padded point rows, and random clouds
    that fit and that overflow the voxel cap."""
    rng = np.random.RandomState(0)
    spec, num_valid = dict(SMALL), None
    if case == "binning":
        pts = np.array([[0.5, 0.5, 0.5, 1.0], [0.6, 0.4, 0.2, 2.0],
                        [0.7, 0.3, 0.1, 3.0], [3.5, 3.5, 1.5, 4.0],
                        [9.0, 0.0, 0.0, 5.0]], np.float32)
    elif case == "overflow":
        spec.update(max_points=1, max_voxels=2)
        pts = np.stack([np.arange(4)[::-1] + 0.5, np.zeros(4), np.zeros(4),
                        np.zeros(4)], 1).astype(np.float32)
    elif case == "padding":
        pts = np.zeros((10, 4), np.float32)
        pts[0] = [0.5, 0.5, 0.5, 1.0]
        pts[1:] = [3.5, 3.5, 1.5, 9.0]
        num_valid = 1
    else:
        spec = dict(point_cloud_range=(0, -10, -2, 20, 10, 2),
                    voxel_size=(0.25, 0.25, 0.5), max_points=4,
                    max_voxels=2048 if case == "random" else 300)
        pts = _random_points(rng, 2000)
    want, got = _voxelize_both(pts, num_valid, **spec)
    for w, g in zip(want, got, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if case == "padding":
        assert int(got[3]) == 1
    if case == "random_capped":
        assert int(got[3]) == 300 and (got[1] >= 0).all()


def _coords(rng, n, shape):
    cells = rng.choice(int(np.prod(shape)), n, replace=False)
    return np.stack(np.unravel_index(cells, shape), 1).astype(np.int32)


def chain_case(name):
    """(coords [N, 4] bzyx, valid [N], shape, caps) of a case of
    test_host_rulebooks.py: each sample's voxels at the head of its block
    of caps[0] / batch rows, the rest padding."""
    if name == "truncated":  # tight caps: stages 0-2 fill and truncate
        rng = np.random.RandomState(1)
        shape, n = (1, 21, 64, 64), 400
        coords = _coords(rng, n, shape)
        return coords, np.ones(n, bool), shape, [n, 150, 80, 40, 20]
    batch, slack = {"b1": (1, 30), "b2": (2, 30), "b1_slack0": (1, 0)}[name]
    rng = np.random.RandomState(0)
    shape = (batch, 21, 160, 144)
    n = 600 * batch
    caps = [n + slack, n + slack, n, n // 2 + 40, n // 4 + 20]
    coords = _coords(rng, n, shape)
    per = caps[0] // batch
    full = np.zeros((caps[0], 4), np.int32)
    valid = np.zeros((caps[0],), bool)
    for bi in range(batch):
        rows = coords[coords[:, 0] == bi]
        full[bi * per: bi * per + len(rows)] = rows
        valid[bi * per: bi * per + len(rows)] = True
    return full, valid, shape, caps


def _jax_chain(coords, valid, shape, caps):
    """JAX's chain, jitted afresh (a patched LUT budget is read at trace
    time, so no earlier trace may be reused)."""
    def chain(coords, valid):
        grid, perm = jsp.grid_from_coords(coords, valid, shape, caps[0])
        out = {"perm": perm, "ids": [grid.ids], "subm": [], "down": []}
        for i, (dk, ds, dp) in enumerate(DOWNS):
            out["subm"].append(jsp.subm_rulebook(grid))
            grid, rbd = jsp.downsample_rulebook(grid, dk, ds, dp,
                                                caps[i + 1])
            out["ids"].append(grid.ids)
            out["down"].append(rbd)
        return out

    return jax.tree_util.tree_map(np.asarray, jax.jit(chain)(coords, valid))


def _port_chain(coords, valid, shape, caps):
    """The chain through each of the port's functions in turn, each
    building its own LUT (``build_device_chain`` shares one per grid)."""
    ids, perm = sp.grid_from_coords(to_torch(coords), to_torch(valid), shape,
                                    caps[0])
    out = {"perm": perm, "ids": [ids], "subm": [], "down": []}
    for i, (dk, ds, dp) in enumerate(DOWNS):
        out["subm"].append(sp.subm_rulebook(ids, shape))
        ids, shape, rbd = sp.downsample_rulebook(ids, shape, dk, ds, dp,
                                                 caps[i + 1])
        out["ids"].append(ids)
        out["down"].append(rbd)
    return out


def _flat(chain):
    return [(k, i, a) for k in ("perm", "ids", "subm", "down")
            for i, a in enumerate(chain[k] if isinstance(chain[k], list)
                                  else [chain[k]])]


PLANS = ["int16_lut", "int32_lut", "search"]


def plan_case(case, plan):
    """chain_case at a LUT plan. int32_lut: every grid's capacity past
    2^15 - 1, so each LUT holds int32 rows (and the chain comes out int32),
    with the coords padded to the first capacity by invalid rows, as the
    callers lay them out."""
    coords, valid, shape, caps = chain_case(case)
    if plan != "int32_lut":
        return coords, valid, shape, caps
    caps = [c + 33000 for c in caps]
    pad = caps[0] - len(coords)
    return (np.concatenate([coords, np.zeros((pad, 4), np.int32)]),
            np.concatenate([valid, np.zeros(pad, bool)]), shape, caps)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("case", ["b1", "b2", "b1_slack0", "truncated"])
def test_chain_functions_match_jax(case, plan, monkeypatch):
    """grid_from_coords, subm_rulebook and downsample_rulebook against
    JAX's, array for array (the port's int64 perm as values)."""
    coords, valid, shape, caps = plan_case(case, plan)
    if plan == "search":
        monkeypatch.setattr(jsp, "LUT_BUDGET_BYTES", 0)
        monkeypatch.setattr(sp, "LUT_BUDGET_BYTES", 0)
        assert sp.occupancy_lut(torch.zeros(4, dtype=torch.int32),
                                shape) is None
    want = _jax_chain(coords, valid, shape, caps)
    got = _port_chain(coords, valid, shape, caps)
    for (k, i, w), (_, _, g) in zip(_flat(want), _flat(got), strict=True):
        assert g.shape == w.shape, (k, i)
        if k != "perm":
            assert g.dtype == torch.int32, (k, i, g.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{k}[{i}]")
    if case == "truncated" and plan != "int32_lut":  # stages 0-2 full
        assert all((i < sp.SENTINEL).all() for i in got["ids"][:3])


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("case", ["b1", "b2", "b1_slack0", "truncated"])
def test_device_chain_equals_host_chain(case, plan, monkeypatch):
    """build_device_chain against the port's host C++ builder at the same
    caps: the same dtype (int16 where max(caps) < 2^15), shape and values
    in every array; saturated flags the full stages."""
    coords, valid, shape, caps = plan_case(case, plan)
    if plan == "search":
        monkeypatch.setattr(sp, "LUT_BUDGET_BYTES", 0)
    dt = np.int16 if max(caps) < 2 ** 15 else np.int32
    host = NATIVE.build_rulebooks(coords, valid, shape, caps, DOWNS,
                                  out_dtype=dt)
    got, saturated = sp.build_device_chain(to_torch(coords), to_torch(valid),
                                           shape, caps)
    for (k, i, w), (_, _, g) in zip(_flat(host), _flat(got), strict=True):
        assert g.numpy().dtype == w.dtype, (k, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{k}[{i}]")
    full = [int((np.asarray(host["ids"][i]) < sp.SENTINEL).sum()) >= caps[i]
            for i in range(5)]
    assert saturated.dtype == torch.bool and saturated.tolist() == full
    if case == "truncated" and plan != "int32_lut":
        assert full == [True] * 3 + [False] * 2


def _bzyx(coords_zyx, b):
    v = coords_zyx.shape[0] // b
    return coords_zyx.reshape(b, v, 3)


@functools.lru_cache(maxsize=None)
def jax_heads(b):
    """JAX VoxelNet's head outputs with ``rulebooks=None``: the in-graph
    chain, then the all-sparse plan through the gather conv."""
    from sessd_tpu.models import VoxelNet

    feats, coords, valid, _ = host_inputs(7, b=b)
    model = VoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                     dense_from_stage=5, conv_impl="gather")
    fwd = jax.jit(lambda variables, f, c, m: model.apply(
        variables, f[:, None], c, np.ones(len(feats), np.int32), m, b,
        train=False))
    preds = fwd(jax_voxelnet_variables(), feats, coords, valid)
    return {k: np.asarray(v) for k, v in preds[0].items()}


@pytest.mark.parametrize("b", [1, 2])
def test_voxelnet_on_device_chains_matches_jax(b):
    """The port's VoxelNet (stage caps CAPS) on ``device_inputs``' chain:
    head outputs within 1e-4 of the max of JAX's; the int16 chain and its
    int32 copy give the same outputs, in the serving plan and through the
    training plan (with the inverse rulebooks autograd builds)."""
    feats, coords, valid, host = host_inputs(7, b=b)
    model = port_voxelnet(jax_voxelnet_variables())
    model.stage_capacity = CAPS
    chain, saturated = model.device_inputs(
        to_torch(coords[:, 1:]).reshape(b, -1, 3),
        to_torch(valid).reshape(b, -1), b)
    assert chain["subm"][0].dtype == torch.int16
    for (k, i, w), (_, _, g) in zip(_flat(host), _flat(chain), strict=True):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{k}[{i}]")
    # stage 1 of this input fills its 512 rows x b, as in JAX's chain
    assert saturated.tolist() == [False, True, False, False, False]
    chain32 = {k: ([a.int() for a in v] if isinstance(v, list) else v.int())
               for k, v in chain.items()}
    vox = to_torch(feats)[:, None]
    num = torch.ones(len(feats), dtype=torch.int32)
    with torch.no_grad():
        got = model(vox, num, chain, b)[0]
        got32 = model(vox, num, chain32, b)[0]
    want = jax_heads(b)
    for k, w in want.items():
        assert rel_err(got[k].numpy(), w) <= 1e-4, k
        assert torch.equal(got[k], got32[k]), k

    model.train()
    outs = []
    for rb in (chain, chain32):
        x = vox.clone().requires_grad_(True)
        out = model(x, num, rb, b, train=True)[0]
        sum(v.sum() for v in out.values()).backward()
        outs.append((out["box_preds"].detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# --- one host_rulebooks=False training step against JAX without chains --


@functools.lru_cache(maxsize=None)
def jax_device_chain_step():
    """make_train_step's (metrics, grads, state after) on the batch of
    test_torch_train_step.py without its chains: JAX builds both chains
    in the step."""
    import optax

    from sessd_tpu.models import VoxelNet as JaxVoxelNet
    from sessd_tpu.train import optim as jo
    from sessd_tpu.train.train_step import TrainState as JaxTrainState
    from sessd_tpu.train.train_step import make_train_step as jax_make_step
    from tests import test_torch_train_step as ts

    student, ema = ts.initial_state()
    model = JaxVoxelNet(sparse_shape=SPARSE_SHAPE, stage_capacity=CAPS,
                        dense_from_stage=3, conv_impl="gather",
                        backbone_remat=False)
    opt = optax.chain(ts._capture_grads(),
                      jo.build_optimizer(jo.OneCycleConfig(**ts.OCFG)))
    state = JaxTrainState(
        step=jnp.int32(ts.STEP), params=student["params"],
        batch_stats=student["batch_stats"], ema_params=ema["params"],
        ema_batch_stats=ema["batch_stats"],
        opt_state=opt.init(student["params"]))
    step = jax_make_step(model, opt, ts._loss_cfgs()[0],
                         teacher_model=model.clone(dense_from_stage=5))
    batch = {k: v for k, v in ts.make_batch().items()
             if not k.startswith("rulebooks")}
    new, metrics = jax.jit(step)(state, batch, jnp.float32(0.7))
    new = jax.tree_util.tree_map(np.asarray, new)
    return state, new, {k: float(v) for k, v in metrics.items()}


def test_device_chain_step_matches_jax():
    """The port's step on a batch with coords and masks and no chains:
    each loss term within 1e-5 relative (1e-4 for the consistency terms and
    grad_norm), each gradient tensor within 1e-3 of its max, and the
    saturation flags of both chains (student, teacher) on the side."""
    from sessd_torch.models.detector import VoxelNet
    from sessd_torch.train import optim as to
    from sessd_torch.train.train_step import TrainState, make_train_step
    from sessd_torch.utils.convert_jax import convert_train_state
    from tests import test_torch_train_step as ts

    state0, new, want = jax_device_chain_step()
    conv = convert_train_state(jax.tree_util.tree_map(np.asarray, state0))
    nets = []
    for dfs, key in ((3, "student"), (5, "teacher")):
        net = VoxelNet(sparse_shape=SPARSE_SHAPE, dense_from_stage=dfs,
                       stage_capacity=CAPS)
        net.load_state_dict(conv[key])
        nets.append(net)
    ocfg = to.OneCycleConfig(**ts.OCFG)
    opt = to.AdamW(list(nets[0].parameters()), to.one_cycle_lr(ocfg),
                   to.one_cycle_mom(ocfg))
    grads = {}
    step_fn = opt.step

    def capture(gs):
        grads.update(zip([n for n, _ in nets[0].named_parameters()],
                         [g.clone() for g in gs]))
        return step_fn(gs)

    opt.step = capture
    batch = ts.port_batch({k: v for k, v in ts.make_batch().items()
                           if not k.startswith("rulebooks")})
    assert not any(k.startswith("inputs") for k in batch)
    metrics = make_train_step(ts._loss_cfgs()[1])(
        TrainState(conv["step"], *nets, opt), batch, 0.7)
    saturated = metrics.pop("saturated")
    # stage 1 fills in both chains, as in the host chains of this batch
    assert saturated.tolist() == [[False, True, False, False, False]] * 2
    got = {k: float(v) for k, v in metrics.items()}
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 1e-4 if k.startswith("consistency") or k == "grad_norm" \
            else 1e-5
        assert abs(got[k] - v) <= rtol * abs(v) + 1e-7, (k, got[k], v)
    jgrads = convert_train_state(
        new._replace(params=new.opt_state[0]))["student"]
    for name, g in grads.items():
        w = jgrads[name].numpy()
        if not np.any(w):
            assert not g.any(), name
            continue
        assert rel_err(g.numpy(), w) <= 1e-3, name


# --- validate() with host_rulebooks off against JAX's device-chain eval --


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    from kitti_synth import make_kitti_root
    from sessd_torch.tools import train as train_cli
    from sessd_torch.tools.create_data import create_kitti_data
    from sessd_torch.train.trainer import Trainer
    from tests.test_torch_eval import TINY

    tmp = tmp_path_factory.mktemp("device_eval")
    root = tmp / "kitti"
    make_kitti_root(root, num_frames=3, num_cars=3)
    create_kitti_data(str(root), {"train": range(3), "val": range(3)})
    cfg_path = tmp / "tiny.py"
    cfg_path.write_text(TINY.replace(
        "{BASE}", str(train_cli.builder.CONFIG_DIR / "se_ssd_kitti_car.py"))
        + "data = dict(data, host_rulebooks=False)\n")
    cfg = train_cli.load(str(cfg_path), str(root))
    trainer = Trainer(cfg, work_dir=str(tmp / "work"), device="cpu")
    return trainer, cfg, tmp


def test_validate_on_device_chains_matches_jax(eval_setup):
    """validate() with ``data.host_rulebooks=False``: the loader builds no
    chain, each eval batch's chain is built from its coords and masks, and
    the hybrid plan's detections of every val image are JAX's eval
    function's without chains on the same weights and padded batches
    (boxes within 1e-4, scores within 1e-5)."""
    from sessd_tpu.train.trainer import Trainer as JaxTrainer
    from sessd_torch.utils.convert_jax import convert_jax

    trainer, cfg, tmp = eval_setup
    assert not trainer.host_inputs
    assert trainer.train_loader.batch_transform is None
    jt = JaxTrainer(cfg, work_dir=str(tmp / "jax_work"), distributed=False)
    assert not jt._eval_rb
    state = jt.state
    trainer.state.student.load_state_dict(convert_jax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})))
    results = trainer.validate()
    assert results is not None
    got = trainer.val_detections

    run = jt._build_eval_fn()
    full_b = cfg.data["samples_per_gpu"]
    want = []
    batches = iter(trainer.val_loader)
    try:
        for batch in batches:
            nb = batch["voxels"].shape[0]
            args = [np.concatenate([batch[k], np.zeros(
                (full_b - nb,) + batch[k].shape[1:], batch[k].dtype)])
                for k in ("voxels", "coords", "num_points", "voxel_mask",
                          "frustum")]
            dets = {k: np.asarray(v) for k, v in run(
                (state.params, state.batch_stats,
                 *map(jnp.asarray, args))).items()}
            want += [{k: dets[k][i][dets["valid"][i]]
                      for k in ("box3d_lidar", "scores", "label_preds")}
                     for i in range(nb)]
    finally:
        batches.close()
    assert len(got) == len(want) == 3
    assert sum(len(d["scores"]) for d in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label_preds"], w["label_preds"])
        np.testing.assert_allclose(g["box3d_lidar"], w["box3d_lidar"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4,
                                   atol=1e-5)


def test_trainer_run_on_device_chains(eval_setup):
    """``Trainer.run`` with the key off: the loader stages coords and
    masks, each step builds both chains, and the step's saturation flags,
    read back with the metrics at the log point, count the batch exactly
    where the host chains of the same batch report a full stage."""
    trainer, cfg, _ = eval_setup
    trainer.train_loader.set_epoch(0)
    batches = iter(trainer.train_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    host = trainer.state.student.host_transform(trainer.stage_capacity,
                                                trainer.suffixes)(batch)
    full = any(host["saturated" + s] for s in trainer.suffixes)
    dev = trainer._device_batch(batch)
    assert not any(k.startswith("inputs") for k in dev)
    assert dev["coords_raw"].shape == batch["coords_raw"].shape
    trainer.run(max_steps=1)
    (row,) = trainer.history
    assert "saturated" not in row and np.isfinite(row["loss"])
    assert trainer.saturated_batches == int(full)


def test_points_in_serving_matches_host_prep():
    """``serve.make_points_infer_fn`` (voxelize, VFE and chain on the
    device) against ``make_infer_fn`` on ``HostPreprocessor``'s output,
    same weights, on three scans cut to a 32 x 32 grid: the features after
    the perm within 1e-6, the chain equal to the host's but for the perm
    (the voxel rows come in another order), head outputs within
    1e-4 of the max and the same detections."""
    from sessd_torch.core.anchors import create_anchors_3d_range
    from sessd_torch.models.predict import PredictConfig
    from sessd_torch.ops.voxelize import VoxelizerSpec as Spec
    from sessd_torch.serve import (HostPreprocessor, make_infer_fn,
                                   make_points_infer_fn, make_scene,
                                   stage_inputs)

    spec = Spec(point_cloud_range=(0.0, -6.4, -3.0, 12.8, 6.4, 1.0),
                voxel_size=(0.4, 0.4, 0.1), max_points=5, max_voxels=3000)
    assert spec.sparse_shape == SPARSE_SHAPE
    caps = (3000, 3000, 2400, 1600, 1000)
    model = port_voxelnet(jax_voxelnet_variables())
    anchors = create_anchors_3d_range(
        [1, 4, 4], [0, -6.4, -1.0, 12.8, 6.4, -1.0]).reshape(-1, 7)
    pcfg = PredictConfig(score_threshold=0.05,
                         post_center_range=(0, -6.4, -5, 12.8, 6.4, 5))
    prep = HostPreprocessor(spec, caps)
    host_infer = make_infer_fn(model, anchors, pcfg, caps, 1, "cpu")
    dev_infer = make_points_infer_fn(model, anchors, pcfg, spec, caps, "cpu")
    found = 0
    for seed in range(3):
        points = make_scene(seed=seed)[0]
        p = prep(points)
        with torch.inference_mode():
            voxels, num_points, chain, saturated = dev_infer.stages(
                to_torch(points))
            # the voxel rows come in id order, not FCFS: all but the perm
            for (k, i, w), (_, _, g) in zip(_flat(p["rulebooks"])[1:],
                                            _flat(chain)[1:], strict=True):
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"{k}[{i}]")
            assert not saturated.any()
            feats = model.reader(voxels, num_points)
            host_feats, host_rb = stage_inputs(p["feats"], p["rulebooks"],
                                               "cpu")
            perm, hperm = chain["perm"].long(), host_rb["perm"].long()
            mask = (chain["ids"][0] < sp.SENTINEL)[:, None]
            np.testing.assert_allclose(
                torch.where(mask, feats[perm], 0).numpy(),
                torch.where(mask, host_feats[hperm], 0).numpy(), atol=1e-6)
            got = model(voxels, num_points, chain, 1)[0]
            want = model(host_feats[:, None], torch.ones(
                len(host_feats), dtype=torch.int32), host_rb, 1)[0]
        for k in want:
            assert rel_err(got[k].numpy(), want[k].numpy()) <= 1e-4, k
        gd, hd = dev_infer(points), host_infer(p["feats"], p["rulebooks"])
        np.testing.assert_array_equal(gd[2].numpy(), hd[2].numpy())
        np.testing.assert_allclose(gd[0].numpy(), hd[0].numpy(), atol=1e-4)
        np.testing.assert_allclose(gd[1].numpy(), hd[1].numpy(), atol=1e-5)
        found += int(gd[2].sum())
    assert found > 0
