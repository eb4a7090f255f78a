"""Evaluate a checkpoint of the port on the KITTI val split (counterpart of
``tools/test.py``).

    python -m sessd_torch.tools.test se_ssd_kitti_car.py --work_dir W \\
        [--checkpoint_epoch E] [--use_ema] [--out results.pkl] \\
        [--eval_ids 3 7 --save_dir D] [--data-root R] [--device cuda]

``config`` is a path or the name of a config in ``sessd_torch/configs``;
``--data-root`` replaces its ``data_root`` as ``tools.train`` does. The
checkpoint is the latest under ``W/checkpoints`` unless
``--checkpoint_epoch`` names one. Without ``--eval_ids`` the whole val split
is evaluated, the AP tables are printed and, with ``--out``, pickled. With
``--eval_ids`` (KITTI image ids of the val split) only those samples run,
and each one's detections are written as a KITTI label file to
``--save_dir``.

Multi-process evaluation (the reference's ``tools/dist_test.py``): start
it once per rank with ``--coordinator HOST:PORT --num-processes N
--process-id I`` (or under ``torchrun``), with ``--device`` and
``--dist-backend`` as ``tools.train`` takes them. Every rank evaluates
rank 0's checkpoint (the one found in rank 0's ``--work_dir``, broadcast
to the others) on its shard of the val split, the fixed-shape detection
buffers are gathered, and rank 0 merges them, prints the AP tables and
writes ``--out``; the other ranks print none. ``--eval_ids`` runs in one
process only.
"""
from __future__ import annotations

import argparse
import os
import pickle

import torch.distributed as dist

from ..data.kitti_common import annos_to_kitti_label
from ..data.kitti_eval import format_results
from ..train.trainer import Trainer
from ..utils import checkpoint as ckpt
from .train import add_process_args, load, setup_process


def main(argv=None):
    ap = argparse.ArgumentParser(description="Test a detector (PyTorch)")
    ap.add_argument("config")
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--checkpoint_epoch", type=int, default=None)
    ap.add_argument("--use_ema", action="store_true",
                    help="evaluate the EMA teacher instead of the student")
    ap.add_argument("--out", default=None, help="pkl path for the AP tables")
    ap.add_argument("--eval_ids", type=int, nargs="+", default=None,
                    help="KITTI image ids of the val split: per-sample "
                         "detections as KITTI label files in --save_dir")
    ap.add_argument("--save_dir", default="sample_eval_results")
    ap.add_argument("--data-root", default=None)
    add_process_args(ap)
    args = ap.parse_args(argv)
    device = setup_process(args)

    cfg = load(args.config, args.data_root)
    work_dir = args.work_dir or cfg.work_dir
    trainer = Trainer(cfg, work_dir=work_dir, device=device)
    if args.eval_ids is not None and trainer.world > 1:
        raise SystemExit("--eval_ids runs in one process only")
    state, epoch = ckpt.load_checkpoint(work_dir, trainer.state,
                                        args.checkpoint_epoch)
    if state is not None:
        trainer.epoch = epoch
    # every rank evaluates rank 0's checkpoint and epoch
    if not trainer._replicate(state is not None):
        raise SystemExit(f"no checkpoint found under {work_dir}")
    trainer.logger.info(f"evaluating epoch {epoch} (ema={args.use_ema})")

    if args.eval_ids is not None:
        ds = trainer.val_dataset
        id_to_index = {int(info["image"]["image_idx"]): i
                       for i, info in enumerate(ds.infos)}
        unknown = [i for i in args.eval_ids if i not in id_to_index]
        if unknown:
            raise SystemExit(f"--eval_ids not in the val split: {unknown} "
                             f"(split has {len(id_to_index)} samples)")
        indices = [id_to_index[i] for i in args.eval_ids]
        dets = trainer.predict_samples(indices, use_ema=args.use_ema)
        annos = ds.convert_detection_to_kitti_annos(dets, indices=indices)
        os.makedirs(args.save_dir, exist_ok=True)
        for image_id, anno in zip(args.eval_ids, annos):
            path = os.path.join(args.save_dir, f"{image_id:06d}.txt")
            with open(path, "w") as f:
                f.write("\n".join(annos_to_kitti_label(anno)) + "\n")
            trainer.logger.info(f"sample {image_id}: {len(anno['name'])} "
                                f"detections -> {path}")
        return trainer, dets

    results = trainer.validate(use_ema=args.use_ema)
    if results is not None and trainer.rank == 0:
        print(format_results(results))
        if args.out:
            with open(args.out, "wb") as f:
                pickle.dump(results, f)
            trainer.logger.info(f"wrote {args.out}")
    if trainer.group is not None:
        dist.destroy_process_group()
    return trainer, results


if __name__ == "__main__":
    main()
