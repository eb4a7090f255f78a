"""Train SE-SSD with the port (counterpart of ``tools/train.py``).

    python -m sessd_torch.tools.train se_ssd_kitti_car_bf16.py \\
        --work_dir work_dirs/x --data-root data/kitti \\
        [--load_from work_dirs/cia] [--resume_from work_dirs/x] \\
        [--max-steps 100]

``config`` is a path or the name of a config in ``sessd_torch/configs``.
``--data-root`` replaces the config's ``data_root`` in every data path
(infos, GT database), as prepared by ``sessd_torch.tools.create_data``.
``--load_from D`` (or the config's ``load_from``) warm-starts both nets
from the latest checkpoint under ``D`` with the schedule restarted;
``--resume_from`` (or the config's ``resume_from``) continues the run of
the work dir from its latest checkpoint, as the JAX tool does.
Checkpoints go to ``<work_dir>/checkpoints``. A run that is not cut by
``--max-steps`` ends with a validation, whose AP tables are written to
``<work_dir>/eval_results.json``.

Data parallel, one process per GPU (the reference's
``torch.distributed.launch``; the JAX tool's ``--coordinator``): start the
same command once per rank with

    --coordinator HOST:PORT --num-processes N --process-id I

(``HOST:PORT`` where rank 0 listens), or under ``torchrun``, whose
environment stands in for the three flags. Each rank trains on its shard
with ``samples_per_gpu`` scenes per step on ``--device``, by default
``cuda:<I % number of cards>``; the CPU only with ``--device cpu``.
``--dist-backend`` is ``nccl`` on CUDA and ``gloo`` on the CPU by default;
ranks that share one card need ``gloo`` (NCCL refuses two ranks on one
device). Rank 0 alone writes checkpoints, logs and ``eval_results.json``.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from .. import builder
from ..parallel.mesh import init_distributed
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


def _plain(o):
    """AP tables -> JSON-ready lists and numbers (tools/train.py:75-82)."""
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_plain(v) for v in o]
    if hasattr(o, "tolist"):
        return o.tolist()
    return o


def add_process_args(ap: argparse.ArgumentParser):
    """The device and data-parallel flags both tools take."""
    ap.add_argument("--device", default=None,
                    help="cuda:<process id %% number of cards> by default; "
                         "cpu runs on the CPU")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous: data parallel, "
                         "one process per GPU")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", default=None,
                    help="nccl (CUDA) or gloo (CPU) by default")


def setup_process(args) -> torch.device:
    """This process's device, and its process group where ``--coordinator``
    or torchrun's environment (WORLD_SIZE) asks for one. A CUDA device that
    is absent is an error, never a CPU run."""
    local = (args.process_id if args.process_id is not None
             else int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(args.device or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {device}: no CUDA device here (pass "
                             f"--device cpu to run on the CPU)")
        if device.index is None:
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if args.coordinator is not None or "WORLD_SIZE" in os.environ or \
            args.num_processes is not None or args.process_id is not None:
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, args.dist_backend
                         or ("nccl" if device.type == "cuda" else "gloo"),
                         device=device)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a detector (PyTorch)")
    ap.add_argument("config")
    ap.add_argument("--work_dir", "--work-dir", dest="work_dir",
                    default=None)
    ap.add_argument("--resume_from", default=None)
    ap.add_argument("--load_from", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_process_args(ap)
    args = ap.parse_args(argv)
    device = setup_process(args)
    cfg = load(args.config, args.data_root)
    work_dir = args.work_dir or cfg.work_dir
    trainer = Trainer(cfg, work_dir=work_dir, seed=args.seed, device=device)
    load_from = args.load_from or cfg.get("load_from")
    if load_from:
        trainer.load_from(load_from)
    if args.resume_from or cfg.get("resume_from"):
        trainer.resume()
    steps = len(trainer.history)
    results = trainer.run(max_steps=args.max_steps)
    if results is not None and trainer.rank == 0:
        path = os.path.join(work_dir, "eval_results.json")
        with open(path, "w") as f:
            json.dump(_plain(results), f, indent=1)
        trainer.logger.info(f"wrote {path}")
    last = trainer.history[-1] if len(trainer.history) > steps else {}
    rank = f"rank {trainer.rank}: " if trainer.group is not None else ""
    print(f"{rank}trained {len(trainer.history) - steps} steps to step "
          f"{trainer.state.step}; last loss "
          f"{last.get('loss', float('nan')):.6g}")
    if trainer.group is not None:
        dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
