"""The port's entry points in data parallel on the CPU: ``python -m
sessd_torch.tools.train --coordinator ... --num-processes 2`` and
``tools.test --coordinator``, two gloo ranks, each in a process of its own
(tests/test_torch_rank_workers.py), on a tiny synthetic KITTI root (the
config of test_torch_train_entry.py at batch 2 per rank: train frames 0-3,
one step per rank in its one epoch; val frames 0-4, so each rank's shard
of 3 wraps one sample from the other shard and ends in a padded batch).
Its stage 0 holds exactly ``max_voxel_num`` voxels per frame, so every
batch trips the saturation count without losing a voxel, and the later
stages hold any two frames: a frame's detections do not depend on the
frame it is batched with, so a rank's shard yields what one process's
batches yield. The ranks run one thread each, and so does the one-process
run they are held against (other thread counts sum in other orders).

Checks: both ranks finish; only rank 0 writes checkpoints, logs and
``eval_results.json`` (each rank has its own work dir, so rank 1's stays
empty); the ranks' final states are bit-equal and their losses equal; the
merged AP of the run's final validation equals a single-process
``tools.test`` of the same checkpoint entry for entry, and rank 0's merged
per-image detections equal that process's bit for bit, in dataset order;
so do rank 0's table and detections from ``tools.test --coordinator``,
where rank 1 names its own, empty work dir and evaluates the checkpoint
rank 0 sends (rank 1 prints no table and writes no ``--out``). The
single-process ``validate()`` is held against JAX's by test_torch_eval.py.
Misused flags raise before any rendezvous: a coordinator without the
process count, and a CUDA device on a machine without one.
"""
import json
import math
import os
import pickle

import numpy as np
import pytest
import torch

from kitti_synth import make_kitti_root
from sessd_torch.data.kitti_eval import format_results
from sessd_torch.tools import test as test_cli
from sessd_torch.tools import train as train_cli
from sessd_torch.tools.create_data import create_kitti_data
from tests import test_torch_rank_workers as workers
from tests.test_torch_train_entry import TINY
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

WORLD = 2


def flat(results) -> dict:
    """AP tables (or their JSON form) -> {(class, metric, difficulty, key):
    float}; difficulties as strings, as JSON keys them."""
    return {(c, m, str(d), k): float(v) for c, t in results.items()
            for m, ds in t.items() for d, ks in ds.items()
            for k, v in ks.items()}


def assert_same_tables(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    diff = [(k, fa[k], fb[k]) for k in fa if not (
        fa[k] == fb[k] or (math.isnan(fa[k]) and math.isnan(fb[k])))]
    assert not diff, diff[:5]


def assert_same_detections(a, b):
    """Two per-image detection lists (``Trainer.val_detections``): the same
    image ids in dataset order, bit-equal boxes, scores and labels."""
    assert [d["metadata"]["image_idx"] for d in a] == \
        [d["metadata"]["image_idx"] for d in b]
    for x, y in zip(a, b):
        for k in ("box3d_lidar", "scores", "label_preds"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), \
                (x["metadata"]["image_idx"], k)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiprocess")
    root = tmp / "kitti"
    make_kitti_root(root, num_frames=5, num_cars=3)
    create_kitti_data(str(root), {"train": range(4), "val": range(5)})
    cfg = tmp / "tiny.py"
    cfg.write_text(TINY.replace(
        "{BASE}", str(train_cli.builder.CONFIG_DIR / "se_ssd_kitti_car.py"))
        + "total_epochs = 1\ndata = dict(data, workers_per_gpu=1)\n"
        "stage_capacity = (3000, 6000, 4800, 3200, 2000)\n")
    out = str(tmp)
    common = [str(cfg), "--data-root", str(root)]
    workers.spawn(workers.tool, WORLD, "train",
                  common + ["--work_dir", str(tmp / "work_{rank}")], out)
    trained = [torch.load(tmp / f"train_{r}.pt", weights_only=False)
               for r in range(WORLD)]
    work = str(tmp / "work_0")
    single_out = str(tmp / "single.pkl")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, single = test_cli.main(common + ["--work_dir", work, "--device",
                                              "cpu", "--out", single_out])
    finally:
        torch.set_num_threads(threads)
    # rank 1's work dir holds no checkpoint: it evaluates rank 0's
    workers.spawn(workers.tool, WORLD, "test",
                  common + ["--work_dir", str(tmp / "work_{rank}"),
                            "--out", str(tmp / "mp_{rank}.pkl")], out)
    tested = [torch.load(tmp / f"test_{r}.pt", weights_only=False)
              for r in range(WORLD)]
    return tmp, trained, (single, one.val_detections), tested


def test_ranks_train_in_step(run):
    _, trained, _, _ = run
    for r, res in enumerate(trained):
        assert (res["rank"], res["world"]) == (r, WORLD)
        # a batch whose chain is full (this config's stage 0 is
        # max_voxel_num) is counted and trained on: the ranks stay in step
        assert res["saturated"] == 1
        assert res["step"] == 1 and len(res["history"]) == 1
        assert f"rank {r}: trained 1 steps to step 1" in res["printed"]
        assert all(math.isfinite(v) for v in res["history"][0].values()
                   if isinstance(v, float))
    assert trained[0]["digest"] == trained[1]["digest"]
    # the metrics are averaged over the ranks: the same on both
    h0, h1 = (trained[r]["history"][0] for r in range(WORLD))
    keys = set(h0) - {"data_time", "step_time"}
    assert {k: h0[k] for k in keys} == {k: h1[k] for k in keys}


def test_only_rank_zero_writes(run):
    tmp, _, _, _ = run
    lead = tmp / "work_0"
    assert (lead / "checkpoints" / "epoch_1.pt").exists()
    for name in ("eval_results.json", "log.json", "train.log",
                 "config_snapshot.py", "run_env.txt"):
        assert (lead / name).exists(), name
    assert not [p for p in (tmp / "work_1").rglob("*")]


def test_merged_ap_equals_one_process(run):
    """The run's final validation: every rank its shard, rank 0 the merge
    and the AP, against one process's ``tools.test`` of the checkpoint."""
    tmp, trained, (single, dets), _ = run
    assert single is not None and set(single) == {"Car"}
    with open(tmp / "work_0" / "eval_results.json") as f:
        merged = json.load(f)
    assert_same_tables(merged, single)
    # five val images, some with boxes: the lists are not trivially equal
    assert len(dets) == 5 and sum(len(d["scores"]) for d in dets) > 0
    assert_same_detections(trained[0]["detections"], dets)
    assert trained[1]["detections"] is None


def test_tools_test_coordinator(run):
    tmp, _, (single, dets), tested = run
    for r, res in enumerate(tested):
        assert (res["rank"], res["world"]) == (r, WORLD)
    assert tested[0]["digest"] == tested[1]["digest"]
    assert_same_detections(tested[0]["detections"], dets)
    assert tested[1]["detections"] is None
    with open(tmp / "mp_0.pkl", "rb") as f:
        mp = pickle.load(f)
    with open(tmp / "single.pkl", "rb") as f:
        assert_same_tables(mp, pickle.load(f))
    assert_same_tables(mp, single)
    assert format_results(mp) in tested[0]["printed"]
    assert "AP11@" not in tested[1]["printed"]
    assert not os.path.exists(tmp / "mp_1.pkl")


@pytest.mark.parametrize("tool", [train_cli, test_cli])
@pytest.mark.parametrize("flags,error", [
    (["--coordinator", "127.0.0.1:9", "--device", "cpu"], ValueError),
    (["--num-processes", "2", "--device", "cpu"], ValueError),
    pytest.param(["--coordinator", "127.0.0.1:9", "--num-processes", "2",
                  "--process-id", "0", "--device", "cuda"], SystemExit,
                 marks=pytest.mark.skipif(
                     torch.cuda.is_available(),
                     reason="asks for CUDA where there is none")),
])
def test_misused_flags_raise(tool, flags, error):
    with pytest.raises(error):
        tool.main(["se_ssd_kitti_car.py"] + flags)
