"""The port's evaluation on the CPU at a tiny size: one padded val batch of a
synthetic KITTI root through ``Trainer`` (host chain -> all-sparse serving
plan -> predict with the frustum cull) against the JAX
``Trainer._build_eval_fn`` path on the same weights, carried across by
``convert_jax``; a checkpoint round trip; and ``python -m
sessd_torch.tools.test`` end to end (``--out``, ``--eval_ids``)."""
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kitti_synth import make_kitti_root
from sessd_torch.tools import test as test_cli
from sessd_torch.tools import train as train_cli
from sessd_torch.tools.create_data import create_kitti_data
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils import checkpoint as ckpt
from sessd_torch.utils.convert_jax import convert_jax
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

# a low score threshold, so random weights give detections to compare
TINY = """
_base = "{BASE}"
exec(compile(open(_base).read(), _base, "exec"))
my_paras = dict(my_paras, batch_size=2)
voxel_generator = dict(voxel_generator, voxel_size=[0.4, 0.4, 0.1],
                       max_voxel_num=3000)
stage_capacity = (3000, 3000, 2400, 1600, 1000)
test_cfg = dict(test_cfg, score_threshold=0.05)
data = dict(data, samples_per_gpu=2, workers_per_gpu=2)
"""


def _dets_equal(a, b):
    for x, y in zip(a, b, strict=True):
        for k in ("box3d_lidar", "scores", "label_preds"):
            np.testing.assert_array_equal(x[k], y[k])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    root = tmp / "kitti"
    make_kitti_root(root, num_frames=3, num_cars=3)
    create_kitti_data(str(root), {"train": range(3), "val": range(3)})
    cfg_path = tmp / "tiny.py"
    cfg_path.write_text(TINY.replace(
        "{BASE}", str(train_cli.builder.CONFIG_DIR / "se_ssd_kitti_car.py")))
    trainer = Trainer(train_cli.load(str(cfg_path), str(root)),
                      work_dir=str(tmp / "work"), device="cpu")
    return trainer, cfg_path, root, tmp


def test_eval_batch_matches_jax(setup):
    """Boxes within 1e-4 and scores within 1e-5 (tests/test_trainer_e2e.py
    tolerances) of the JAX eval function on the same weights, on the
    trailing val batch, which both pad to the full batch."""
    from sessd_tpu.train.trainer import Trainer as JaxTrainer

    trainer, cfg_path, root, tmp = setup
    jt = JaxTrainer(train_cli.load(str(cfg_path), str(root)),
                    work_dir=str(tmp / "jax_work"), distributed=False)
    assert jt._eval_rb
    state = jt.state
    trainer.state.student.load_state_dict(convert_jax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})))

    batches = iter(trainer.val_loader)
    try:
        *_, batch = batches
    finally:
        batches.close()
    assert batch["voxels"].shape[0] == 1  # 3 frames at batch 2
    got = trainer._eval_batch(batch, use_ema=False)
    batch = dict(batch, **{k: np.concatenate([batch[k], np.zeros_like(
        batch[k])]) for k in ("voxels", "coords", "num_points",
                              "voxel_mask", "frustum")})

    run = jt._build_eval_fn()
    args = (state.params, state.batch_stats,
            *(jnp.asarray(batch[k]) for k in ("voxels", "coords",
                                              "num_points", "voxel_mask",
                                              "frustum")))
    want = {k: np.asarray(v)
            for k, v in run(args, jt._batch_rulebooks(batch)).items()}
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["label_preds"], want["label_preds"])
    np.testing.assert_allclose(got["box3d_lidar"], want["box3d_lidar"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4,
                               atol=1e-5)


def test_eval_warns_once_on_a_full_stage(setup, caplog):
    """A stage-1 capacity below the batch's occupancy fills its id table:
    the eval chain logs one saturation warning per trainer, naming it
    beside stage 0, which the tiny config fills to its voxel cap. The
    stages after it take only what the truncated stage 1 covers."""
    trainer = setup[0]
    batches = iter(trainer.val_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    saved = trainer.stage_capacity, trainer._eval_sat_warned
    trainer.stage_capacity = saved[0][:1] + (16,) * 4
    trainer._eval_sat_warned = False
    try:
        with caplog.at_level(logging.WARNING):
            trainer._eval_inputs(batch)
            trainer._eval_inputs(batch)
    finally:
        trainer.stage_capacity, trainer._eval_sat_warned = saved
    msgs = [r.getMessage() for r in caplog.records
            if "SATURATION" in r.getMessage()]
    assert len(msgs) == 1, msgs
    assert "stages [0, 1] (rows [6000, 32])" in msgs[0], msgs


def test_checkpoint_round_trip(setup):
    """save -> a fresh trainer loads it -> identical detections, step,
    epoch and optimizer moments."""
    trainer, cfg_path, root, tmp = setup
    trainer.state.step, trainer.epoch = 7, 2
    trainer.state.optimizer.mu[0].normal_()
    trainer.save_checkpoint()
    other = Trainer(train_cli.load(str(cfg_path), str(root)),
                    work_dir=str(tmp / "other"), device="cpu")
    state, epoch = ckpt.load_checkpoint(trainer.work_dir, other.state)
    assert (epoch, state.step) == (2, 7)
    assert state.optimizer.mu[0].equal(trainer.state.optimizer.mu[0])
    for a, b in zip(trainer.state.teacher.state_dict().values(),
                    state.teacher.state_dict().values()):
        assert a.equal(b)
    want = trainer.predict_samples([0, 1, 2])
    assert sum(len(d["scores"]) for d in want) > 0
    _dets_equal(other.predict_samples([0, 1, 2]), want)


def test_tools_test_entry_point(setup):
    """``--out`` holds the AP tables ``validate`` gives; ``--eval_ids``
    writes one KITTI label file per id, 16 fields a line."""
    trainer, cfg_path, root, tmp = setup
    trainer.save_checkpoint()
    out = tmp / "results.pkl"
    common = [str(cfg_path), "--work_dir", trainer.work_dir,
              "--data-root", str(root), "--device", "cpu"]
    _, results = test_cli.main(common + ["--out", str(out)])
    with open(out, "rb") as f:
        assert pickle.load(f) == results
    assert results == trainer.validate()
    assert set(results) == {"Car"}

    save = tmp / "labels"
    test_cli.main(common + ["--eval_ids", "0", "2", "--save_dir", str(save)])
    lines = [ln for i in (0, 2)
             for ln in (save / f"{i:06d}.txt").read_text().splitlines() if ln]
    assert lines and all(len(ln.split(" ")) == 16 for ln in lines)
    # multi-process eval takes the process count with the coordinator
    # (tests/test_torch_multiprocess.py runs it); without, it raises before
    # any rendezvous
    with pytest.raises(ValueError, match="needs --num-processes"):
        test_cli.main(common + ["--coordinator", "localhost:1"])
