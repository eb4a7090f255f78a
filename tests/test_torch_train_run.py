"""The port's training run on the CPU at a tiny size (the cropped grid of
``tests/test_torch_train_entry.py``, 2 train and 2 val synthetic frames,
batch 2 (one step per epoch), a short NMS, f32, the sparse convs through
their twins):

- ``Trainer.resume`` from ``epoch_1.pt`` of a 3-epoch run ends equal, bit
  for bit, to the run that was not interrupted (the loader seeds every
  epoch and sample, and the checkpoint holds the whole state);
- ``python -m sessd_torch.tools.train --load_from`` warm-starts an SE-SSD
  run from a CIA-SSD one, validates every epoch with ``val_interval=1``
  (``val_history`` rows at epochs 1 and 2) and writes
  ``eval_results.json``; ``--resume_from`` then continues it;
- ``sessd_torch.scripts.acceptance_ap`` runs both stages (1 + 1 epochs)
  and writes a record with the JAX script's keys; its recipe's ``data``
  block sets every key of the JAX script's to the same value.
"""
import ast
import json
import pathlib
import re

import pytest
import torch

from kitti_synth import make_kitti_root
from sessd_torch import builder
from sessd_torch.scripts import acceptance_ap
from sessd_torch.tools import train as train_cli
from sessd_torch.tools.create_data import create_kitti_data
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils import checkpoint as ckpt
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

TINY = """
_base = "{BASE}"
exec(compile(open(_base).read(), _base, "exec"))
my_paras = dict(my_paras, batch_size=2)
voxel_generator = dict(voxel_generator, voxel_size=[0.4, 0.4, 0.1],
                       max_voxel_num=3000)
stage_capacity = (3000, 3000, 2400, 1600, 1000)
test_cfg = dict(test_cfg, score_threshold=0.0,
                nms=dict(test_cfg["nms"], nms_pre_max_size=64,
                         nms_post_max_size=32))
data = dict(data, samples_per_gpu=2, workers_per_gpu=2)
log_config = dict(interval=1)
"""
# the two lines of cia_ssd_kitti_car.py over the SE-SSD config
CIA = """
my_paras = dict(my_paras, enable_ssl=False)
model = dict(model, bbox_head=dict(model["bbox_head"], reg_loss="smooth_l1"))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_run")
    make_kitti_root(tmp / "kitti", num_frames=4, num_cars=3)
    create_kitti_data(str(tmp / "kitti"), {"train": range(2),
                                           "val": range(2, 4)})
    return tmp


def _config(tmp, name, extra):
    path = tmp / f"{name}.py"
    path.write_text(TINY.replace(
        "{BASE}", str(builder.CONFIG_DIR / "se_ssd_kitti_car.py")) + extra)
    return str(path)


def _tensors(state):
    opt = state.optimizer
    return ([*state.student.state_dict().values(),
             *state.teacher.state_dict().values(), *opt.mu, *opt.nu],
            (state.step, opt.count, opt.sched_count))


def test_resume_is_bit_exact(root):
    cfg = train_cli.load(_config(root, "three", "total_epochs = 3\n"),
                         str(root / "kitti"))
    whole = Trainer(cfg, work_dir=str(root / "whole"), device="cpu")
    whole.run()
    assert whole.epoch == 3 and whole.state.step == 3

    src = ckpt.checkpoint_path(root / "whole", 1)
    dst = ckpt.checkpoint_path(root / "resumed", 1)
    dst.parent.mkdir(parents=True)
    dst.write_bytes(src.read_bytes())
    resumed = Trainer(cfg, work_dir=str(root / "resumed"), device="cpu")
    resumed.resume()
    assert resumed.epoch == 1 and resumed.state.step == 1
    resumed.run()
    got, got_counts = _tensors(resumed.state)
    want, want_counts = _tensors(whole.state)
    assert got_counts == want_counts == (3, 3, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert [h["step"] for h in resumed.history] == [2, 3]
    assert resumed.history[-1]["loss"] == whole.history[-1]["loss"]


def test_tools_train_load_from_resume_from(root):
    data = ["--data-root", str(root / "kitti"), "--device", "cpu"]
    cia_dir, se_dir = str(root / "cia"), str(root / "se")
    cia = train_cli.main([_config(root, "cia", CIA + "total_epochs = 1\n"),
                          "--work_dir", cia_dir, *data])
    assert cia.state.optimizer.count == 1 and not cia.enable_ssl

    se = train_cli.main([
        _config(root, "se", "total_epochs = 2\nval_interval = 1\n"),
        "--work_dir", se_dir, "--load_from", cia_dir, *data])
    opt = se.state.optimizer
    assert (se.state.step, opt.count, opt.sched_count) == (2, 3, 2)
    assert [r["epoch"] for r in se.val_history] == [1, 2]
    with open(root / "se" / "eval_results.json") as f:
        assert set(json.load(f)) == {"Car"}
    log = (root / "se" / "train.log").read_text()
    assert f"warm start (student+teacher) from {cia_dir}" in log
    assert log.count(", cls_loss_reduced: ") == 2

    again = train_cli.main([_config(root, "se3", "total_epochs = 3\n"),
                            "--work-dir", se_dir, "--resume_from", se_dir,
                            *data])
    opt = again.state.optimizer
    assert again.epoch == 3
    assert (again.state.step, opt.count, opt.sched_count) == (3, 4, 3)
    assert [h["step"] for h in again.history] == [3]
    assert "resumed from epoch 2" in (root / "se" / "train.log").read_text()


# the JAX script's record keys (scripts/acceptance_ap.py:327-353)
RECORD_KEYS = {"acceptance", "date", "hardware", "train_frames",
               "val_frames", "cars_per_frame", "voxel_size_m", "max_voxels",
               "batch", "precision", "from_scratch", "recipe",
               "val_gt_counts", "stage_cia", "stage_sessd", "teacher_ema_ap",
               "total_steps", "scenes_trained", "wall_s", "floor"}
STAGE_KEYS = {"work", "steps", "epochs", "train_plus_eval_s",
              "trainer_init_s", "timing", "train_split_3d_ap",
              "ap_trajectory", "final_ap"}


def _recipe_data(path) -> dict:
    """The ``data`` dict of an acceptance script's CONFIG, its placeholders
    filled with a dummy."""
    tree = ast.parse(pathlib.Path(path).read_text())
    text = next(node.value.value for node in tree.body
                if isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["CONFIG"])
    ns = {}
    exec(re.sub(r"\{[A-Z_]+\}", "1", text), ns)
    return ns["data"]


def test_acceptance_recipe_data_equals_jax():
    """The port's recipe sets every key of the JAX script's ``data`` block
    to the same value, ``host_rulebooks=False`` (chains on the device)
    among them."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    want = _recipe_data(repo / "scripts" / "acceptance_ap.py")
    got = _recipe_data(acceptance_ap.__file__)
    assert want["host_rulebooks"] is False
    assert {k: got.get(k) for k in want} == want


def test_acceptance_two_stages(tmp_path):
    out = tmp_path / "record.json"
    tiny = TINY.split("\n", 3)[3] + 'precision = "float32"\n'
    rec = acceptance_ap.main(2, 2, 1, 1, 1, ground_points=3000, num_cars=3,
                             out=str(out), device="cpu", overrides=tiny)
    assert json.loads(out.read_text()) == rec
    assert set(rec) == RECORD_KEYS and rec["hardware"] == "cpu"
    for stage in ("stage_cia", "stage_sessd"):
        assert set(rec[stage]) == STAGE_KEYS and rec[stage]["steps"] == 1
    assert [len(rec[s]["ap_trajectory"]) for s in
            ("stage_cia", "stage_sessd")] == [1, 2]
    assert rec["stage_sessd"]["ap_trajectory"][-1]["ema"] is True
    assert set(rec["floor"]) == {"metric", "value", "required",
                                 "gt_boxes_in_bin", "passed"}
    assert rec["floor"]["required"] == 70.0 and rec["total_steps"] == 2
    assert rec["stage_sessd"]["timing"]["intervals"] == 1
    logs = tmp_path / "record_logs"
    assert (logs / "cia_train.log").exists() and (
        logs / "sessd_log.json").exists()
