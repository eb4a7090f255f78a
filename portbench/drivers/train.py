"""Training cells: ``Trainer.train_step`` of ``sessd_torch`` (teacher
forward, student forward and backward, five losses, AdamW, EMA) on a pool
of augmented batches staged on the device before the window.

Set-up: the synthetic KITTI root and the pool of ``pool`` batches, made
from the seed by the frozen host layer (GT-AUG, the global and per-object
noise, targets, packed as the trainer packs them); the ``Trainer`` with
the seeded weights; the first ``follow`` steps, recorded for the
comparison with the reference, then ``warm`` more. The window cycles the
pool, one ``train_step`` after another, and ends in a synchronize:
``train_scenes_per_s`` is every scene of every step over the window.
``--trace 1`` profiles ``trace_steps`` steps instead and reads the
per-layer metrics from them.

Traffic parameters (``portbench/traffic/<mix>.json``): ``frames``,
``cars_per_frame``, ``pts_per_car``, ``ground_points`` (the root),
``pool``, ``loader_threads``, ``consistency_weight``, ``follow``, ``warm``,
``trace_steps``, and ``overrides`` of the program's config.
"""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from .. import harness
from . import common
from .data import load_config, make_root, train_loader

# the training kernels by profiler name, and their comparison entries
KERNELS = ("sparse_conv_fwd_kernel", "sparse_conv_dfeat_kernel",
           "sparse_conv_dw_partial_kernel", "sparse_conv_dw_reduce_kernel")


def inputs(c: dict, seed: int, tmp: str) -> dict:
    """Everything a run of the cell is made of, from the seed: the config,
    the pool of host batches (and its anchors and epoch length), the
    weights on the device."""
    cfgj, tr = c["config"], c["traffic"]
    s_root, s_load, s_weights = harness.seeds(seed, 3)
    root = f"{tmp}/kitti"
    make_root(root, tr, s_root)
    cfg = load_config(cfgj, tr, root)
    loader = train_loader(cfg, s_load, tr["loader_threads"])
    return {"cfg": cfg, "pool": common.take_batches(loader, tr["pool"]),
            "anchors": loader.dataset.anchors.astype(np.float32),
            "steps_per_epoch": len(loader),
            "pack": bool(cfg.data.get("pack_targets", True)),
            "batch": int(cfg.data["samples_per_gpu"]),
            "cw": float(tr["consistency_weight"]),
            "sd": common.weights(s_weights)}


def follow_reference(x: dict, n: int, **kw) -> dict:
    """The reference's first ``n`` steps on the run's inputs."""
    from ..reference import train as ref_train

    return ref_train.follow(x["cfg"], x["sd"], x["pool"][:n], x["anchors"],
                            x["cw"], x["steps_per_epoch"], common.DEVICE,
                            x["pack"], **kw)


def run(c: dict, seed: int, seconds: float, trace: bool,
        t_start: float) -> dict:
    from sessd_torch.train.train_step import pack_batch
    from sessd_torch.train.trainer import Trainer

    tr = c["traffic"]
    limits = c["config"]["limits"][c["workload"]["traffic"]]
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        x = inputs(c, seed, tmp)
        cfg, pool, batch, sd, cw = (x[k] for k in ("cfg", "pool", "batch",
                                                   "sd", "cw"))
        trainer = Trainer(cfg, work_dir=f"{tmp}/work", seed=0,
                          device=common.DEVICE, distributed=False)
        st = trainer.state
        st.student.load_state_dict(sd)
        st.teacher.load_state_dict(sd)
        staged = [trainer._device_batch(pack_batch(b) if x["pack"] else b)
                  for b in pool]
        step = trainer.train_step
        dfs = st.student.dense_from_stage
        flags = []

        def one(i):
            m = step(st, staged[i % len(staged)], cw)
            if "saturated" in m:
                flags.append(m["saturated"])
            return m

        prog = {"loss": [], "start": common.leaves(st.student)}
        heads = [common.capture(net.bbox_head, key, prog)
                 for net, key in ((st.student, "head"),
                                  (st.teacher, "teacher_head"))]
        for i in range(tr["follow"]):
            m = one(i)
            prog["loss"].append(m["loss"])
            if i == 0:
                for h in heads:
                    h.remove()
                prog["consistency"] = m["consistency_loss"]
                prog["det1"] = m["loss"] - cw * m["consistency_loss"]
                d1 = float(np.float32(1) - np.float32(
                    st.optimizer.hyperparams["b1"]))
                prog["grad"] = {n: mu.clone() / d1 for (n, _), mu in
                                zip(st.student.named_parameters(),
                                    st.optimizer.mu)}
        prog["student"] = common.leaves(st.student)
        prog["teacher"] = common.leaves(st.teacher)
        done = tr["follow"]
        for i in range(done, done + tr["warm"]):
            one(i)
        done += tr["warm"]
        common.sync()
        setup_s = time.perf_counter() - t_start
        before = common.entry_launches()

        res = {"notes": [], "end_to_end": {}}
        if trace:
            n = tr["trace_steps"]
            prof, window, host = common.profiled(lambda k: one(done + k), n)
            traced = [(done + k) % len(staged) for k in range(n)]
        else:
            marks, probe = [], common.host_probe()
            n, window = common.timed(lambda k: one(done + k), seconds, marks)
            res["notes"].append(common.host_note(probe, marks))
            res["end_to_end"] = {"train_scenes_per_s": n * batch / window,
                                 "setup_s": setup_s}
        memory_peak = common.memory_peak()
        comparison = common.entry_launches() - before
        saturated = int(torch.stack(flags).any(-1).sum()) if flags else 0
        prog["loss"] = [float(v) for v in prog["loss"]]
        prog["consistency"] = float(prog["consistency"])
        prog["det1"] = float(prog["det1"])
        res.update(attempted=n, failed=0, memory_peak=memory_peak)
        voxels = sum(int(np.sum(b["voxel_mask"])) for b in pool)
        res["notes"].append(f"window {window:.3f} s, {n} steps of {batch} "
                            f"scenes, setup {setup_s:.3f} s, {voxels} "
                            "voxels in the pool")
        del trainer, st, staged, step, one, flags
        common.free()

        from ..reference.train import compare

        ref = follow_reference(x, tr["follow"])
        nums = compare(prog, ref)
        res["notes"].append(
            "losses program " + ", ".join(f"{v:.6g}" for v in prog["loss"])
            + " reference " + ", ".join(f"{v:.6g}" for v in ref["loss"])
            + f"; {nums['leaves_excluded']} leaves left out of delta_gap; "
            f"worst leaves: grad {nums['grad_leaf']}, delta "
            f"{nums['delta_leaf']}")
        res["notes"].append("readings " + ", ".join(
            f"{k} {v!r}" for k, v in nums.items()
            if isinstance(v, float)))
        res["readings"] = {k: v for k, v in nums.items()
                           if isinstance(v, float)}
        res["checks"] = [(k, nums[k], lim) for k, lim in limits.items()]
        res["checks"] += [("saturated_chains", saturated, 0),
                          ("comparison_entry_launches", comparison, 0)]
        if trace:
            res["trace"] = common.trace_train(
                prof, window, host, n, batch, cfg, sd,
                [pool[i] for i in traced], KERNELS, dfs)
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
