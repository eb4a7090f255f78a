"""Train SE-SSD with the port (counterpart of ``tools/train.py``; saves
checkpoints under ``<work-dir>/checkpoints``, no resume yet).

    python -m sessd_torch.tools.train se_ssd_kitti_car_bf16.py \\
        --work-dir work_dirs/x --max-steps 100 --data-root data/kitti

``config`` is a path or the name of a config in ``sessd_torch/configs``.
``--data-root`` replaces the config's ``data_root`` in every data path
(infos, GT database), as prepared by ``sessd_torch.tools.create_data``.
"""
from __future__ import annotations

import argparse
import os

from .. import builder
from ..train.trainer import Trainer


def load(config: str, data_root=None):
    cfg = (builder.Config.fromfile(config) if os.path.exists(config)
           else builder.load_config(config))
    if data_root:
        old = cfg.data_root.rstrip("/")

        def swap(path):
            return data_root.rstrip("/") + path[len(old):] if \
                path.startswith(old) else path

        for split in ("train", "val", "test"):
            if split in cfg.data:
                d = cfg.data[split]
                d["root_path"] = swap(d["root_path"])
                d["info_path"] = swap(d["info_path"])
        if cfg.get("db_sampler"):
            cfg.db_sampler["db_info_path"] = swap(
                cfg.db_sampler["db_info_path"])
        cfg.data_root = data_root
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a detector (PyTorch)")
    ap.add_argument("config")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = load(args.config, args.data_root)
    trainer = Trainer(cfg, work_dir=args.work_dir, seed=args.seed,
                      device=args.device)
    history = trainer.run(max_steps=args.max_steps)
    last = history[-1] if history else {}
    print(f"trained {len(history)} steps; last loss "
          f"{last.get('loss', float('nan')):.6g}")
    return trainer


if __name__ == "__main__":
    main()
