"""Data-parallel plumbing of the port (counterpart of
``sessd_tpu/parallel/mesh.py``): one process per GPU, as the reference runs
(SURVEY §2.3: ``torch.distributed.launch``, NCCL, DDP, sync-BN, a pickled
``all_gather`` for eval), where the JAX package has one mesh axis with
``psum``/``pmean``/``all_gather`` over it.

- ``init_distributed``  the process group (``jax.distributed.initialize`` +
  ``make_mesh``): every rank is one member of the data axis;
- ``replicate``         rank 0's module or train state on every rank
  (``replicate``, a replicated array);
- ``AllReduceSum``      ``psum`` with its transpose: a sum over ranks whose
  backward sums the incoming gradients over ranks as well, so the gradient
  upstream of a synchronized BatchNorm carries the other ranks' terms, as
  ``jax.shard_map`` gives it;
- ``all_reduce_mean_``  ``pmean`` of a list of tensors, one flat bucket per
  dtype (a train step makes a few collectives, not one per parameter);
- ``all_gather_detections``  fixed-shape detection buffers from every rank
  (``all_gather_detections``, ``process_allgather``);
- ``state_digest``      a hash of a train state's bits, to show that ranks
  hold the same state.

The student is not wrapped in ``DistributedDataParallel``: the train step
takes its gradients with ``torch.autograd.grad``, which fires none of the
hooks DDP reduces in, so it reduces them itself (``all_reduce_mean_``)
before the optimizer step. No function here picks a backend or a device,
and no collective error is caught.

``collectives`` counts the collectives issued, by kind: ``bn`` (one per
synchronized BatchNorm forward), ``grad`` and ``metrics`` (the step's
buckets), ``broadcast`` and ``gather``.
"""
from __future__ import annotations

import datetime
import hashlib
import socket
from collections import Counter
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

collectives: Counter = Counter()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl", timeout: float = 600.0,
                     device: Optional[torch.device] = None):
    """Join the process group of ``num_processes`` ranks, as rank
    ``process_id``, at ``coordinator`` (``host:port`` of rank 0's
    rendezvous); returns the group. Without the three flags the group comes
    from torchrun's environment (``env://``: MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE), as ``jax.distributed.initialize()`` reads its cluster.
    ``timeout`` (seconds) bounds the rendezvous and every collective: long,
    as the JAX tool's ``initialization_timeout=600``, so a rank that builds
    its kernels or loads its data slower than the others is waited for.
    Under NCCL, ``device`` (this rank's card) binds the group to it."""
    flags = (num_processes, process_id)
    if coordinator is None and any(f is not None for f in flags):
        raise ValueError("--num-processes/--process-id need --coordinator")
    if coordinator is not None and any(f is None for f in flags):
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if coordinator is not None and not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    kw = {} if coordinator is None else dict(
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)
    if backend == "nccl" and device is not None:
        device = torch.device(device)
        kw["device_id"] = (device if device.index is not None else
                           torch.device("cuda", torch.cuda.current_device()))
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout), **kw)
    return dist.group.WORLD


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[tuple, list]:
    """Indices of ``tensors`` by (dtype, device)."""
    out: Dict[tuple, list] = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out


@torch.no_grad()
def _bucketed(tensors: Sequence[torch.Tensor], op, kind: str):
    """``op(flat)`` on one flat copy of the tensors of each (dtype,
    device), written back in place."""
    for idx in _buckets(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        op(flat)
        collectives[kind] += 1
        off = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[off:off + n].view_as(tensors[i]))
            off += n


def _states(obj) -> list:
    """The modules whose state ``replicate`` broadcasts: a module, or a
    train state's two nets (``student``, ``teacher``)."""
    if isinstance(obj, torch.nn.Module):
        return [obj]
    return [obj.student, obj.teacher]


def replicate(obj, group=None, src: int = 0):
    """Make ``obj`` on every rank equal to rank ``src``'s, in place: a
    module (parameters and buffers) or a ``TrainState`` (both nets, the
    optimizer's moments and its two counts, the step). Returns ``obj``."""
    tensors = [t for m in _states(obj)
               for t in list(m.parameters()) + list(m.buffers())]
    opt = getattr(obj, "optimizer", None)
    if opt is not None:
        tensors += list(opt.mu) + list(opt.nu)
    _bucketed(tensors, lambda f: dist.broadcast(f, src, group=group),
              "broadcast")
    if opt is not None:
        counts = broadcast_ints([obj.step, opt.count, opt.sched_count],
                                tensors[0].device, group, src)
        obj.step, opt.count, opt.sched_count = counts
    return obj


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """A ``TrainState``'s tensors by name: both nets' state dicts and the
    optimizer's moments."""
    opt = state.optimizer
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    out.update({f"mu.{i}": t for i, t in enumerate(opt.mu)})
    out.update({f"nu.{i}": t for i, t in enumerate(opt.nu)})
    return out


def state_digest(state) -> str:
    """sha256 over ``state_tensors(state)``, names and bytes in name order:
    equal on two ranks exactly when their states are bit-equal."""
    h = hashlib.sha256()
    tensors = state_tensors(state)
    for k in sorted(tensors):
        t = tensors[k].detach().reshape(-1).cpu()
        h.update(k.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def broadcast_ints(values: Sequence[int], device, group=None,
                   src: int = 0) -> list:
    """Rank ``src``'s ``values`` (Python ints) on every rank, through one
    int64 tensor on ``device`` (the backend's: a CUDA device for NCCL)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=device)
    dist.broadcast(t, src, group=group)
    collectives["broadcast"] += 1
    return [int(v) for v in t.tolist()]


class AllReduceSum(torch.autograd.Function):
    """``psum`` over the ranks of ``group``: forward, the sum of every
    rank's ``x``; backward, the sum of every rank's incoming gradient (the
    transpose of a sum that every rank reads). Works under ``no_grad`` (the
    teacher's BatchNorm) as a plain all-reduce."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    collectives["bn"] += 1
    return AllReduceSum.apply(x, group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                     kind: str = "grad"):
    """``pmean`` of ``tensors`` over the ranks of ``group``, in place: one
    all-reduce of one flat bucket per dtype (and device)."""
    world = dist.get_world_size(group)

    def op(flat):
        dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
        flat.div_(world)

    _bucketed(tensors, op, kind)
    return tensors


def all_gather_detections(buffers: Dict[str, torch.Tensor],
                          group=None) -> Dict[str, torch.Tensor]:
    """Every rank's fixed-shape ``buffers`` (equal shapes on all ranks),
    stacked on a new leading rank axis: {name: [world, *shape]}, on the
    host. The buffers travel as host tensors, as ``process_allgather``
    gathers numpy; under NCCL, which takes device tensors only, through the
    current CUDA device."""
    world = dist.get_world_size(group)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == dist.Backend.NCCL
           else torch.device("cpu"))
    out = {}
    for name, t in buffers.items():
        # gloo gathers no bool tensors: a mask travels as uint8
        send = t.to(dev, torch.uint8 if t.dtype == torch.bool else t.dtype)
        parts = [torch.empty_like(send) for _ in range(world)]
        dist.all_gather(parts, send.contiguous(), group=group)
        collectives["gather"] += 1
        out[name] = torch.stack(parts).cpu().to(t.dtype)
    return out


def free_port() -> int:
    """A free TCP port on localhost, for the coordinator of ranks that
    share this machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
