"""Acceptance run of the port: the reference's own two-stage recipe, trained
and scored end to end with the official KITTI AP.

The reference verifies itself by train -> official KITTI AP
(tools/test.py:183-264, det3d/datasets/kitti/kitti.py:141-167) and never
trains SE-SSD from scratch: both nets warm-start from a trained CIA-SSD
checkpoint, the optimizer state carries over and the schedule restarts
(examples/second/configs/config.py:273-275, trainer_sessd.py:212-217).
This script runs that recipe through ``sessd_torch`` on a synthetic KITTI
root (``sessd_torch.utils.kitti_synth``) with a HELD-OUT val split, at the
full 0.05 m grid, with the same configuration, stages, floor and record
keys as ``scripts/acceptance_ap.py``:

  stage A  CIA-SSD supervised-only pretrain (enable_ssl=False: no teacher),
  stage B  SE-SSD (teacher/student + consistency) warm-started from A
           (``Trainer.load_from``).

Both stages record an AP-vs-epoch trajectory (``Trainer.val_history``); the
floor metric is AP40 3D MODERATE (the easy bin gates on 2D box height
> 40 px and is starved on synthetic val), with the per-difficulty valid-GT
counts in the record. The record is printed, and written to ``--out``
(with the stages' logs beside it, in ``<out stem>_logs/``).

Usage:
  python -m sessd_torch.scripts.acceptance_ap [n_train] [n_val]
      [cia_epochs] [sessd_epochs] [val_interval] [--out PATH]
      [--device cuda] [--workers N]

``--workers N`` loads samples in N spawned processes instead of the
configuration's two threads. The samples are the same (each is drawn from
its own (epoch, index) seed); the per-sample augmentation is pure Python,
so with threads it holds the interpreter lock against the training step.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import tempfile
import time

CONFIG = """
tasks = [dict(num_class=1, class_names=["Car"])]
class_names = ["Car"]
box_coder = dict(type="ground_box3d_coder", n_dim=7)
my_paras = dict(batch_size=4, enable_ssl={SSL})
model = dict(
    type="VoxelNet",
    reader=dict(type="VoxelFeatureExtractorV3", num_input_features=4),
    backbone=dict(type="SpMiddleFHD", num_input_features=4, ds_factor=8),
    neck=dict(type="SSFA", num_input_features=128),
    bbox_head=dict(
        type="MultiGroupHead", mode="3d", in_channels=128, tasks=tasks,
        box_coder=box_coder, encode_background_as_zeros=True,
        loss_norm=dict(type="NormByNumPositives"),
        loss_cls=dict(type="SigmoidFocalLoss", alpha=0.25, gamma=2.0,
                      loss_weight=1.0),
        use_sigmoid_score=True,
        loss_bbox=dict(type="WeightedSmoothL1Loss", sigma=3.0, codewise=True,
                       loss_weight=2.0),
        encode_rad_error_by_sin=True,
        loss_aux=dict(type="WeightedSoftmaxClassificationLoss", loss_weight=0.2),
        direction_offset=0.0,
        # stage A trains the classic sin-encoded SmoothL1 (mg_head.py:616,
        # the loss the CIA-SSD warm-start producer uses); ODIoU is only ever
        # optimized from a warm start in the reference (losses.LossConfig
        # .reg_loss) — from scratch it plateaus in a 90-deg yaw local optimum
        reg_loss="{REG}",
    ),
)
target_assigner = dict(
    type="iou",
    anchor_generators=[dict(
        type="anchor_generator_range", sizes=[1.6, 3.9, 1.56],
        anchor_ranges=[0, -40.0, -1.0, 70.4, 40.0, -1.0], rotations=[0, 1.57],
        matched_threshold=0.6, unmatched_threshold=0.45, class_name="Car")],
    sample_positive_fraction=-1, sample_size=512,
    region_similarity_calculator=dict(type="nearest_iou_similarity"),
    tasks=tasks,
)
assigner = dict(box_coder=box_coder, target_assigner=target_assigner,
                out_size_factor=8, enable_similar_type=True)
train_cfg = dict(assigner=assigner)
test_cfg = dict(
    nms=dict(use_rotate_nms=True, nms_pre_max_size=1000,
             nms_post_max_size=100, nms_iou_threshold=0.01),
    score_threshold=0.3,
    post_center_limit_range=[0, -40.0, -5.0, 70.4, 40.0, 5.0],
    max_per_img=100,
)
voxel_generator = dict(
    range=[0, -40.0, -3.0, 70.4, 40.0, 1.0],
    voxel_size=[0.05, 0.05, 0.1],
    max_points_in_voxel=5, max_voxel_num=20000,
)
# synthetic scenes + GT-AUG are denser than real KITTI at stage 1/2:
# measured worst per-sample occupancies 25.5k / 15.1k against the default
# (22k, 18k) caps -> stage-1 truncation every dense batch. Headroom
# restored here.
stage_capacity = (20000, 30000, 20000, 12000, 8000)
data_root = "{ROOT}"
db_sampler = dict(type="GT-AUG", enable=True,
                  db_info_path=data_root + "/dbinfos_train.pkl",
                  sample_groups=[dict(Car=15)],
                  db_prep_steps=[dict(filter_by_min_num_points=dict(Car=5)),
                                 dict(filter_by_difficulty=[-1])],
                  rate=1.0)
train_preprocessor = dict(mode="train", shuffle_points=True,
                          gt_loc_noise=[0.25, 0.25, 0.25],
                          gt_rot_noise=[-0.157, 0.157],
                          global_rot_noise=[-0.785, 0.785],
                          global_scale_noise=[0.95, 1.05],
                          remove_points_after_sample=True,
                          db_sampler=db_sampler,
                          class_names=class_names, enable_similar_type=True)
data = dict(
    samples_per_gpu=4, workers_per_gpu=2,
    # rulebook chains built on the card (ops.sparse.build_device_chain), as
    # the reference recipe trains: on an NVIDIA H100 80GB HBM3 (700 W) the
    # device chains were also the faster route, 245.3 against 253.1 ms per
    # bf16 step at these caps, with a data-time share of 0.213 against the
    # loader-built chains' 0.492 (PERF.md, section 5)
    host_rulebooks=False,
    train=dict(type="KittiDataset", root_path=data_root,
               info_path=data_root + "/infos_train.pkl",
               class_names=class_names),
    val=dict(type="KittiDataset", root_path=data_root,
             info_path=data_root + "/infos_val.pkl",
             class_names=class_names),
)
optimizer = dict(type="adam", wd=0.01, fixed_wd=True)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85],
                 div_factor=10.0, pct_start=0.4)
checkpoint_config = dict(interval={CKPT_INT})
log_config = dict(interval=20)
total_epochs = {EPOCHS}
work_dir = "{WORK}"
load_from = None
resume_from = None
workflow = [("train", {EPOCHS}), ("val", 1)]
precision = "bfloat16"
val_interval = {VALINT}
"""

# floor: far below reference-on-real-KITTI numbers but far above chance —
# proves the assembled two-stage recipe (targets, losses, optimizer, EMA,
# consistency, warm start, predict, eval) trains to real detections on
# held-out scenes. MODERATE bin: the easy bin is starved on synthetic val
# (40 px height gate), see count_valid_gt in the record.
FLOOR_METRIC = ("3d", 1, "AP40")  # metric, difficulty=moderate, table
FLOOR_VALUE = 70.0


def _table(res):
    if not res:
        return None
    car = res["Car"]
    return {m: {{0: "easy", 1: "moderate", 2: "hard"}[d]:
                {k: round(v, 2) for k, v in car[m][d].items()}
                for d in (0, 1, 2)}
            for m in ("bbox", "bev", "3d")}


def _traj(val_history):
    """Compact AP-vs-step trajectory rows (3D AP40 per difficulty)."""
    rows = []
    for r in val_history:
        d3 = r.get("Car", {}).get("3d", {})
        rows.append({
            "epoch": r["epoch"], "step": r["step"], "ema": r["ema"],
            "3d_AP40": {name: d3.get(d, {}).get("AP40")
                        for d, name in ((0, "easy"), (1, "moderate"),
                                        (2, "hard"))},
        })
    return rows


def _log_timing(work):
    """Mean data/step time from the stage's json log (the TextLogger rows,
    each an average over its log interval)."""
    path = os.path.join(work, "log.json")
    if not os.path.exists(path):
        return None
    data_t, step_t = [], []
    with open(path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if "data_time" in row and "step_time" in row:
                data_t.append(row["data_time"])
                step_t.append(row["step_time"])
    if not step_t:
        return None
    # drop the first interval rows (first-call allocations, cold caches)
    k = min(2, len(step_t) - 1)

    def mean(xs):
        return round(sum(xs[k:]) / max(len(xs) - k, 1), 4)

    return {"mean_data_time_s": mean(data_t), "mean_step_time_s": mean(step_t),
            "intervals": len(step_t)}


def _hardware(device: str) -> str:
    if not device.startswith("cuda"):
        return device
    from ..utils.profiling import card_line

    return card_line()


def run_stage(tag, tmp, root, ssl, epochs, val_interval, ckpt_interval,
              device, load_from=None, overrides=""):
    from .. import builder
    from ..train.trainer import Trainer

    work = os.path.join(tmp, f"work_{tag}")
    text = (CONFIG.replace("{ROOT}", root)
            .replace("{WORK}", work)
            .replace("{SSL}", str(bool(ssl)))
            .replace("{REG}", "odiou" if ssl else "smooth_l1")
            .replace("{EPOCHS}", str(epochs))
            .replace("{CKPT_INT}", str(ckpt_interval))
            .replace("{VALINT}", str(val_interval))) + overrides
    cfg_path = os.path.join(tmp, f"cfg_{tag}.py")
    with open(cfg_path, "w") as f:
        f.write(text)
    cfg = builder.Config.fromfile(cfg_path)

    t0 = time.perf_counter()
    trainer = Trainer(cfg, work_dir=work, device=device)
    init_s = time.perf_counter() - t0
    if load_from is not None:
        trainer.load_from(load_from)
    print(f"[{tag}] trainer init: {init_s:.1f}s "
          f"(warm start: {load_from is not None})", flush=True)

    t0 = time.perf_counter()
    results = trainer.run()
    train_s = time.perf_counter() - t0
    steps = int(trainer.state.step)
    print(f"[{tag}] trained {steps} steps + vals in {train_s:.1f}s", flush=True)

    # overfit diagnostic: AP on the TRAIN split. High train / low val =
    # generalization (more frames); low train = recipe/under-training.
    cfg.data["val"]["info_path"] = cfg.data["train"]["info_path"]
    val_ds, val_loader = trainer.val_dataset, trainer.val_loader
    n_hist = len(trainer.val_history)
    trainer.val_dataset = builder.build_dataset(cfg, "val", seed=0)
    trainer.val_loader = builder.build_dataloader(cfg, trainer.val_dataset,
                                                  shuffle=False, seed=0)
    results_train = trainer.validate()
    trainer.val_dataset, trainer.val_loader = val_ds, val_loader
    del trainer.val_history[n_hist:]  # keep the trajectory val-only
    train_3d = (results_train or {}).get("Car", {}).get("3d", {})

    return trainer, results, {
        "work": work, "steps": steps, "epochs": epochs,
        "train_plus_eval_s": round(train_s, 1),
        "trainer_init_s": round(init_s, 1),
        "timing": _log_timing(work),
        "train_split_3d_ap": {n: {k: round(v, 2) for k, v in
                                  train_3d.get(d, {}).items()}
                              for d, n in ((0, "easy"), (1, "moderate"),
                                           (2, "hard"))},
        "ap_trajectory": _traj(trainer.val_history),
    }


def _keep_logs(tmp, dst):
    """The stages' files (configs, logs, run context) into ``dst``."""
    os.makedirs(dst, exist_ok=True)
    for tag in ("cia", "sessd"):
        work = os.path.join(tmp, f"work_{tag}")
        if not os.path.isdir(work):
            continue
        for name in os.listdir(work):
            p = os.path.join(work, name)
            if os.path.isfile(p):
                shutil.copy(p, os.path.join(dst, f"{tag}_{name}"))


def main(n_train=128, n_val=32, cia_epochs=100, sessd_epochs=75,
         val_interval=10, ground_points=16000, num_cars=10, out=None,
         device="cuda", overrides="", workers=None):
    """Both stages and the record (returned, printed, and written to
    ``out``). ``overrides`` is config text appended to both stages'
    configs (a smaller grid, for a quick run); ``workers`` switches the
    loader to that many worker processes."""
    if workers:
        overrides += (f"\ndata = dict(data, workers_per_gpu={int(workers)}, "
                      f"worker_type=\"process\")\n")
    from ..data import kitti_common as kc
    from ..data.kitti_eval import count_valid_gt
    from ..utils.kitti_synth import make_kitti_root

    tmp = tempfile.mkdtemp(prefix="accept_")
    wall0 = time.perf_counter()
    try:
        root = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        n_frames = n_train + n_val
        make_kitti_root(root, num_frames=n_frames, num_cars=num_cars,
                        pts_per_car=400, ground_points=ground_points)
        train_ids = list(range(n_train))
        val_ids = list(range(n_train, n_frames))
        for name, ids in (("infos_train.pkl", train_ids),
                          ("infos_val.pkl", val_ids)):
            infos = kc.create_kitti_info(root, ids, num_workers=2)
            with open(os.path.join(root, name), "wb") as f:
                pickle.dump(infos, f)
        kc.create_reduced_point_cloud(root, os.path.join(root,
                                                         "infos_train.pkl"))
        kc.create_reduced_point_cloud(root, os.path.join(root,
                                                         "infos_val.pkl"))
        # GT-AUG database from the TRAIN split only (no val leakage)
        kc.create_groundtruth_database(
            root, os.path.join(root, "infos_train.pkl"),
            dbinfo_path=os.path.join(root, "dbinfos_train.pkl"),
            used_classes=("Car",))
        print(f"data prep: {time.perf_counter() - t0:.1f}s", flush=True)

        # stage A: CIA-SSD supervised-only pretrain (config.py:273-275's
        # load_from producer). Checkpoint cadence must land on the final
        # epoch — the warm start loads the latest checkpoint.
        ckpt_a = max(1, cia_epochs // 4)
        cia_epochs -= cia_epochs % ckpt_a
        trainer_a, results_a, rec_a = run_stage(
            "cia", tmp, root, ssl=False, epochs=cia_epochs,
            val_interval=val_interval, ckpt_interval=ckpt_a, device=device,
            overrides=overrides)
        del trainer_a

        # stage B: SE-SSD warm-started from stage A
        trainer_b, results_b, rec_b = run_stage(
            "sessd", tmp, root, ssl=True, epochs=sessd_epochs,
            val_interval=val_interval, ckpt_interval=max(1, sessd_epochs),
            device=device, load_from=rec_a["work"], overrides=overrides)
        results_ema = trainer_b.validate(use_ema=True)
        rec_b["ap_trajectory"] = _traj(trainer_b.val_history)

        gt_counts = count_valid_gt(
            trainer_b.val_dataset.ground_truth_annotations, ("Car",))

        mname, diff, key = FLOOR_METRIC
        floor_ap = float(results_b["Car"][mname][diff][key])
        record = {
            "acceptance": "two-stage train->official-KITTI-AP on held-out "
                          "synthetic val (CIA-SSD pretrain -> SE-SSD warm "
                          "start, the reference recipe), sessd_torch",
            "date": time.strftime("%Y-%m-%d"),
            "hardware": _hardware(device),
            "train_frames": n_train, "val_frames": n_val,
            "cars_per_frame": num_cars,
            "voxel_size_m": 0.05, "max_voxels": 20000, "batch": 4,
            "precision": "bfloat16",
            "from_scratch": False,
            "recipe": "CIA-SSD pretrain (enable_ssl=False) -> SE-SSD "
                      "load_from warm start (student+teacher params, Adam "
                      "moments kept, one-cycle restarted)",
            "val_gt_counts": gt_counts,
            "stage_cia": dict(rec_a, final_ap=_table(results_a)),
            "stage_sessd": dict(rec_b, final_ap=_table(results_b)),
            "teacher_ema_ap": _table(results_ema),
            "total_steps": rec_a["steps"] + rec_b["steps"],
            "scenes_trained": 4 * (rec_a["steps"] + rec_b["steps"]),
            "wall_s": round(time.perf_counter() - wall0, 1),
            "floor": {"metric": f"{key} {mname} moderate",
                      "value": round(floor_ap, 2),
                      "required": FLOOR_VALUE,
                      "gt_boxes_in_bin": gt_counts["Car"]["moderate"],
                      "passed": bool(floor_ap >= FLOOR_VALUE)},
        }
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(record, f, indent=1)
        print(json.dumps(record, indent=1), flush=True)
        print("ACCEPTANCE", "PASSED" if record["floor"]["passed"] else "FAILED",
              flush=True)
        return record
    finally:
        if out:
            _keep_logs(tmp, os.path.splitext(os.path.abspath(out))[0]
                       + "_logs")
        if os.environ.get("SESSD_ACCEPT_KEEP"):
            print(f"keeping artifacts in {tmp} (SESSD_ACCEPT_KEEP)",
                  flush=True)
        else:
            shutil.rmtree(tmp, ignore_errors=True)


def _args(argv=None):
    ap = argparse.ArgumentParser(
        description="Two-stage acceptance run (CIA-SSD -> SE-SSD) of the "
                    "port on synthetic KITTI")
    for name, default in (("n_train", 128), ("n_val", 32),
                          ("cia_epochs", 100), ("sessd_epochs", 75),
                          ("val_interval", 10)):
        ap.add_argument(name, type=int, nargs="?", default=default)
    ap.add_argument("--out", default=None,
                    help="write the record here (and the logs beside it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=None,
                    help="loader worker processes (default: the "
                         "configuration's two threads)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _args()
    main(a.n_train, a.n_val, a.cia_epochs, a.sessd_epochs, a.val_interval,
         out=a.out, device=a.device, workers=a.workers)
