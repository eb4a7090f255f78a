"""The data-parallel SE-SSD training step on N cards, one process per card.

    torchrun --standalone --nproc_per_node N \\
        -m sessd_torch.scripts.profile_data_parallel [--data-root R]

Each rank builds the bf16 SE-SSD Car ``Trainer`` (batch 4 per rank, the
acceptance recipe's stage caps, seeded random weights) on a KITTI root:
``R``, or by default a synthetic one of 8 ray-cast frames per rank that
rank 0 writes (``make_synthetic_root``). The rank's first ``BATCHES``
batches of its loader shard are staged on its card before any step, so the
host data path is outside the numbers:

- ``step``: host clock around one ``train_step`` that ends in a
  synchronize, median and p90 per rank over ``STEPS`` steps after
  ``WARMUP`` (every step runs the collectives: 56 BatchNorm syncs, the
  gradient and metric buckets);
- ``scenes_per_s``: N x 4 over the slowest rank's median;
- ``peak_gib``: ``torch.cuda.max_memory_allocated`` per rank;
- ``equal``: whether every rank ends with the same bits
  (``mesh.state_digest``, gathered).

Rank 0 prints the card line and, last, one JSON object with every number.
With N = 1 it measures the same step in a group of one rank.
"""
from __future__ import annotations

import argparse
import ast
import itertools
import json
import os
import re
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..builder import CONFIG_DIR
from ..parallel import mesh
from ..tools.train import load
from ..train.trainer import Trainer
from ..utils.profiling import card_line
from .acceptance_ap import CONFIG
from .profile_train import SEED, make_synthetic_root

BATCHES = 2
WARMUP = 3
STEPS = 20
PER_RANK_FRAMES = 8


# the acceptance recipe's stage caps: chains at batch 4 that do not
# saturate on the ray-cast frames
CAPS = ast.literal_eval(re.search(r"^stage_capacity = (\(.*\))$", CONFIG,
                                  re.M).group(1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_data_parallel: needs a CUDA device")
    local = int(os.environ.get("LOCAL_RANK", 0))
    device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    mesh.init_distributed(backend="nccl", device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    card = card_line()

    with tempfile.TemporaryDirectory(prefix="sessd_dp_") as tmp:
        root = args.data_root
        if root is None:
            # one root, written once, read by every rank (one machine)
            root = [f"{tmp}/kitti" if rank == 0 else None]
            dist.broadcast_object_list(root, 0)
            root = root[0]
            if rank == 0:
                make_synthetic_root(root, num_frames=PER_RANK_FRAMES * world,
                                    num_cars=10)
            dist.barrier()
        # the shipped config at CAPS (``Config`` takes no assignment)
        cfg_path = f"{tmp}/dp_{rank}.py"
        shipped = str(CONFIG_DIR / "se_ssd_kitti_car_bf16.py")
        with open(cfg_path, "w") as f:
            f.write(f"__file__ = {shipped!r}\n"
                    "exec(compile(open(__file__).read(), __file__, "
                    "'exec'))\n"
                    f"stage_capacity = {CAPS!r}\n")
        cfg = load(cfg_path, root)
        trainer = Trainer(cfg, work_dir=f"{tmp}/work_{rank}", seed=SEED,
                          device=device)
        loader = iter(trainer.train_loader)
        batches = []
        try:
            for b in itertools.islice(loader, BATCHES):
                trainer._check_train_saturation(b)
                batches.append(trainer._device_batch(b))
        finally:
            loader.close()
        dist.barrier()

    state, step_fn = trainer.state, trainer.train_step

    def step(i):
        t0 = time.perf_counter()
        step_fn(state, batches[i % len(batches)], 1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for i in range(WARMUP):
        step(i)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    times = [step(i) for i in range(STEPS)]
    mine = {"rank": rank, "step": float(np.median(times)),
            "step_p90": float(np.percentile(times, 90)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "digest": mesh.state_digest(state),
            "saturated": trainer.saturated_batches}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    dist.destroy_process_group()
    if rank != 0:
        return
    slowest = max(r["step"] for r in ranks)
    r = {"card": card, "world": world, "backend": "nccl",
         "batch_per_rank": cfg.data["samples_per_gpu"], "steps": STEPS,
         "scenes_per_s": world * cfg.data["samples_per_gpu"] / slowest * 1e3,
         "equal": len({x["digest"] for x in ranks}) == 1,
         "ranks": [{k: v for k, v in x.items() if k != "digest"}
                   for x in ranks], "collectives": dict(mesh.collectives)}
    print(card)
    print(json.dumps(r))


if __name__ == "__main__":
    main()
