"""The port's training entry point on the CPU at a tiny size:
``python -m sessd_torch.tools.train`` on a synthetic KITTI root prepared by
``sessd_torch.tools.create_data``, through the JAX package's host data path
and C++ rulebooks, for a few SE-SSD steps (the sparse convs on their plain
twins). Checks the per-step record, the teacher's EMA formula on a step, and
that the student moved."""
import math

import pytest
import torch

from kitti_synth import make_kitti_root
from sessd_torch.tools import train as train_cli
from sessd_torch.tools.create_data import create_kitti_data
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

TINY = """
_base = "{BASE}"
exec(compile(open(_base).read(), _base, "exec"))
my_paras = dict(my_paras, batch_size=2)
voxel_generator = dict(voxel_generator, voxel_size=[0.4, 0.4, 0.1],
                       max_voxel_num=3000)
stage_capacity = (3000, 3000, 2400, 1600, 1000)
test_cfg = dict(test_cfg, score_threshold=0.0)
data = dict(data, samples_per_gpu=2, workers_per_gpu=2)
log_config = dict(interval=1)
total_epochs = 2
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_entry")
    root = tmp / "kitti"
    make_kitti_root(root, num_frames=4, num_cars=3)
    create_kitti_data(str(root), {"train": range(4), "val": range(4)})
    cfg_path = tmp / "tiny.py"
    cfg_path.write_text(TINY.replace(
        "{BASE}", str(train_cli.builder.CONFIG_DIR / "se_ssd_kitti_car.py")))
    init = train_cli.load(str(cfg_path), str(root))
    trainer = train_cli.main([str(cfg_path), "--work-dir", str(tmp / "work"),
                              "--max-steps", "3", "--data-root", str(root),
                              "--device", "cpu"])
    return trainer, init, tmp


def test_entry_point_trains(run):
    trainer, init, tmp = run
    assert init.data["train"]["info_path"].startswith(
        str(tmp / "kitti")) and init.db_sampler["db_info_path"].startswith(
        str(tmp / "kitti"))
    hist = trainer.history
    assert [h["step"] for h in hist] == [1, 2, 3]
    for h in hist:
        for k in ("loss", "cls_loss_reduced", "ious_loss", "dir_loss_reduced",
                  "iou_pred_loss", "consistency_loss", "loss_ema",
                  "grad_norm"):
            assert math.isfinite(h[k]), (h["step"], k)
    assert hist[0]["num_pos"] > 0
    # log interval 1: one TextLogger line per step
    log = (tmp / "work" / "train.log").read_text()
    assert log.count(", cls_loss_reduced: ") == 3


def test_teacher_is_ema_of_student(run):
    """After the step with counter s: teacher = alpha * teacher_before +
    (1 - alpha) * student_after, alpha = min(1 - 1/(s+1), 0.999). Replays
    one more step on the trainer's own state."""
    trainer, _, _ = run
    state = trainer.state
    tea0 = [p.detach().clone() for p in state.teacher.parameters()]
    stu0 = [p.detach().clone() for p in state.student.parameters()]
    s = state.step
    batch = next(iter(trainer.train_loader))
    trainer.train_step(state, trainer._device_batch(batch), 0.5)
    alpha = min(1 - 1 / (s + 1), 0.999)
    moved = 0.0
    for e0, p0, e, p in zip(tea0, stu0, state.teacher.parameters(),
                            state.student.parameters()):
        torch.testing.assert_close(e, alpha * e0 + (1 - alpha) * p,
                                   rtol=1e-5, atol=1e-6)
        moved = max(moved, float((p.detach() - p0).abs().max()))
    assert moved > 0
