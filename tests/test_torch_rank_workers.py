"""Rank processes of the port's data-parallel tests (test_torch_parallel.py,
test_torch_multiprocess.py); holds no tests itself.

Each worker runs in a process of its own, started with
``torch.multiprocessing`` (spawn), joins a gloo group of ``world`` ranks on
localhost, does its part on the CPU and saves what it saw with
``torch.save`` under ``out``; the test process compares. Workers import
torch, numpy and the port only: never jax or the JAX package.
"""
import io
import os
import sys

import torch
import torch.distributed as dist


def spawn(fn, world: int, *args):
    """Run ``fn(rank, world, port, *args)`` in ``world`` spawned processes
    and wait for them; raises if one fails."""
    import torch.multiprocessing as mp

    from sessd_torch.parallel.mesh import free_port

    mp.start_processes(fn, args=(world, free_port()) + args, nprocs=world,
                       start_method="spawn")


def _join(rank, world, port):
    # test workers share the machine's cores: one thread each
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)


def units(rank, world, port, inputs, out):
    """AllReduceSum, the synchronized BatchNorm (masked and unmasked) and
    all_gather_detections on this rank's share of ``inputs``."""
    from sessd_torch.models.layers import BatchNorm
    from sessd_torch.parallel import mesh

    _join(rank, world, port)
    d = torch.load(inputs, weights_only=True)
    res = {}

    x = d["psum_x"][rank].clone().requires_grad_(True)
    s = mesh.all_reduce_sum(x, dist.group.WORLD)
    loss = (d["psum_c"][rank] * s * s).sum()
    res["psum"] = s.detach()
    res["psum_grad"] = torch.autograd.grad(loss, x)[0]

    for kind in ("masked", "unmasked"):
        p = {k[len(kind) + 1:]: v for k, v in d.items()
             if k.startswith(kind + ".")}
        bn = BatchNorm(p["weight"].numel(), process_group=dist.group.WORLD)
        bn.load_state_dict({k: p[k] for k in ("weight", "bias",
                                              "running_mean",
                                              "running_var")})
        bn.train()
        x = p["x"][rank].clone().requires_grad_(True)
        mask = p["mask"][rank][:, None] if "mask" in p else None
        y = bn(x, mask)
        loss = (y * p["w"][rank]).sum()
        gx, gw, gb = torch.autograd.grad(loss, [x, bn.weight, bn.bias])
        mesh.all_reduce_mean_([gw, gb], dist.group.WORLD)
        res[kind] = {"y": y.detach(), "dx": gx, "dweight": gw, "dbias": gb,
                     "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
        # the teacher's case: no graph, the statistics still synced
        with torch.no_grad():
            bn.load_state_dict({k: p[k] for k in ("weight", "bias",
                                                  "running_mean",
                                                  "running_var")})
            res[kind]["y_no_grad"] = bn(p["x"][rank], mask)
            res[kind]["running_var_no_grad"] = bn.running_var.clone()

    bufs = {k[len("gather."):]: v[rank] for k, v in d.items()
            if k.startswith("gather.")}
    res["gathered"] = mesh.all_gather_detections(bufs, dist.group.WORLD)
    res["collectives"] = dict(mesh.collectives)
    torch.save(res, os.path.join(out, f"units_{rank}.pt"))
    dist.destroy_process_group()


def slice_steps(rank, world, port, inputs, out):
    """SE-SSD train steps of the port on this rank's half batch, each from
    its converted JAX state (``states``); saves the state and metrics after
    each."""
    from sessd_torch.models.detector import VoxelNet
    from sessd_torch.models.layers import sync_batch_norm
    from sessd_torch.parallel.mesh import state_tensors
    from sessd_torch.train import losses as tl
    from sessd_torch.train import optim as to
    from sessd_torch.train.train_step import TrainState, make_train_step
    from sessd_torch.utils.convert_jax import load_train_state

    _join(rank, world, port)
    d = torch.load(inputs, weights_only=False)
    group = dist.group.WORLD
    student = VoxelNet(sparse_shape=d["sparse_shape"], dense_from_stage=3)
    teacher = VoxelNet(sparse_shape=d["sparse_shape"], dense_from_stage=5)
    for m in (student, teacher):
        sync_batch_norm(m, group)
    ocfg = to.OneCycleConfig(**d["ocfg"])
    opt = to.AdamW(list(student.parameters()), to.one_cycle_lr(ocfg),
                   to.one_cycle_mom(ocfg))
    state = TrainState(0, student, teacher, opt)
    k = d["top_k"]
    step = make_train_step(
        tl.LossConfig(max_positive_anchors=k,
                      consistency=tl.ConsistencyConfig(top_k=k)),
        process_group=group)
    res = []
    for start in d["states"]:
        load_train_state(state, start)
        metrics = step(state, d["batches"][rank], d["cw"])
        res.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "state": {k: v.clone() for k, v in
                              state_tensors(state).items()},
                    "step": state.step})
    torch.save(res, os.path.join(out, f"slice_{rank}.pt"))
    dist.destroy_process_group()


def tool(rank, world, port, which, argv, out):
    """``python -m sessd_torch.tools.<which> ARGV --coordinator ...`` as
    rank ``rank`` on the CPU with gloo, in this process ("{rank}" in ARGV
    is the rank); saves its printed lines, its ``Trainer.rank_report()``
    and the per-image detections of its last validation (rank 0's merge,
    None on the other ranks)."""
    from sessd_torch.tools import test as test_cli
    from sessd_torch.tools import train as train_cli

    torch.set_num_threads(1)
    argv = [a.replace("{rank}", str(rank)) for a in argv] + [
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
        "--process-id", str(rank), "--dist-backend", "gloo", "--device",
        "cpu"]
    printed = io.StringIO()
    stdout, sys.stdout = sys.stdout, printed
    try:
        if which == "train":
            trainer = train_cli.main(argv)
        else:
            trainer, _ = test_cli.main(argv)
    finally:
        sys.stdout = stdout
    res = dict(trainer.rank_report(), printed=printed.getvalue(),
               detections=trainer.val_detections)
    torch.save(res, os.path.join(out, f"{which}_{rank}.pt"))
