"""What the drivers share: the seeded weights, the timed and the profiled
loops, the launch counters of the program's comparison entries, and the
reduction of a traced window to the per-layer numbers (model FLOPs and
each sparse conv's roofline bound, counted on the reference's own
rulebooks of the very batches the window ran)."""
from __future__ import annotations

import collections
import itertools
import time
from typing import Callable, List

import numpy as np
import torch

from .. import harness
from ..reference.model import VoxelNet, sparse_conv_shapes
from ..reference.weights import make_state_dict

# where the drivers run the program and the reference; the tests run a
# whole cell on the CPU at "cpu", with the kernels' plain twins
DEVICE = "cuda"

# the program's comparison entries (scalar tiles, the f32 ring), by module
# and function: the main path launches none of them
ENTRIES = {"sessd_torch.ops.cuda.sparse_conv": (
               "fused_sparse_conv_scalar", "fused_sparse_conv_stream_ring"),
           "sessd_torch.ops.cuda.sparse_conv_train": (
               "sparse_conv_fwd_scalar", "sparse_conv_dfeat_scalar",
               "sparse_conv_dw_scalar")}


def weights(seed: int) -> dict:
    """The detector's seeded state dict on the card (``reference/weights``)."""
    return make_state_dict(VoxelNet().state_dict(), seed, DEVICE)


def leaves(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def capture(module, key: str, into: dict):
    """A forward hook that keeps ``module``'s first task output, as float32
    copies, in ``into[key]``; returns the hook's handle."""
    def hook(_m, _i, out):
        into[key] = {k: v.detach().float().clone() for k, v in out[0].items()}

    return module.register_forward_hook(hook)


def take_batches(loader, n: int) -> List[dict]:
    """The loader's first ``n`` batches, epoch after epoch (each epoch is
    shuffled and augmented anew)."""
    out, epoch = [], 0
    while len(out) < n:
        loader.set_epoch(epoch)
        it = iter(loader)
        try:
            out += list(itertools.islice(it, n - len(out)))
        finally:
            it.close()
        epoch += 1
    return out


def entry_launches() -> int:
    import importlib

    total = 0
    for mod, names in ENTRIES.items():
        m = importlib.import_module(mod)
        total += sum(getattr(getattr(m, f, None), "launches", 0)
                     for f in names)
    return total


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def memory_peak() -> int:
    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0


class HostEvent:
    """A CUDA event where the drivers run on the CPU: already reached."""

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return 0.0


def event(timing: bool = False):
    return (torch.cuda.Event(enable_timing=timing) if DEVICE == "cuda"
            else HostEvent())


def free():
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def timed(one: Callable[[int], object], seconds: float, marks=None):
    """Calls ``one(k)`` for k = 0, 1, ... until ``seconds`` have passed,
    then synchronizes. Returns (calls, window seconds); ``marks``, a list,
    gets the window's start and each call's return time."""
    sync()
    t0 = time.perf_counter()
    if marks is not None:
        marks.append(t0)
    n = 0
    while True:
        one(n)
        n += 1
        t = time.perf_counter()
        if marks is not None:
            marks.append(t)
        if t - t0 >= seconds:
            break
    sync()
    return n, time.perf_counter() - t0


def _steal_ticks() -> tuple:
    """(steal, all) ticks of the machine's CPUs since boot (/proc/stat)."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        return ticks[7], sum(ticks)
    except (OSError, IndexError, ValueError):
        return 0, 0


def host_probe() -> dict:
    """What the host has done so far: this process's CPU seconds and
    involuntary context switches, the machine's steal ticks, the garbage
    collections, and the CUDA allocator's calls for device memory."""
    import gc
    import resource

    use = resource.getrusage(resource.RUSAGE_SELF)
    stats = torch.cuda.memory_stats() if DEVICE == "cuda" else {}
    steal, total = _steal_ticks()
    return {"cpu_s": use.ru_utime + use.ru_stime, "nivcsw": use.ru_nivcsw,
            "steal": steal, "ticks": total,
            "gc": sum(g["collections"] for g in gc.get_stats()),
            "malloc": stats.get("num_device_alloc", 0),
            "t": time.perf_counter()}


def host_note(before: dict, marks=None) -> str:
    """One line on what the host did between ``before`` and now: the
    process's CPU share of the wall time, involuntary context switches,
    the machine's steal share, collections, device allocations, and the
    calls in each quarter of the window (``marks`` as ``timed`` keeps
    them)."""
    now = host_probe()
    wall = now["t"] - before["t"]
    ticks = max(now["ticks"] - before["ticks"], 1)
    note = (f"host: cpu {100 * (now['cpu_s'] - before['cpu_s']) / wall:.1f}"
            f"% of {wall:.3f} s, {now['nivcsw'] - before['nivcsw']} "
            f"involuntary switches, steal "
            f"{100 * (now['steal'] - before['steal']) / ticks:.2f}%, "
            f"{now['gc'] - before['gc']} collections, "
            f"{now['malloc'] - before['malloc']} device allocations")
    if marks and len(marks) > 1:
        t0, t1 = marks[0], marks[-1]
        quarter = [0] * 4
        for t in marks[1:]:
            quarter[min(int(4 * (t - t0) / max(t1 - t0, 1e-9)), 3)] += 1
        note += ", calls by quarter " + "/".join(map(str, quarter))
    return note


# steps (or batches) traced with the host's ops as well, after the traced
# window, to name the device's idle gaps
HOST_STEPS = 2


def device_activity():
    """The profiler's activities of a traced window: the device's alone
    (the host's CPU where the drivers run on the CPU)."""
    a = torch.profiler.ProfilerActivity
    return [a.CUDA] if DEVICE == "cuda" else [a.CPU]


def profiled(one: Callable[[int], object], n: int):
    """``n`` calls of ``one`` under ``torch.profiler`` with device activity
    only, ending in a synchronize, then ``HOST_STEPS`` more with the host's
    ops too. Returns (profile, window seconds, host profile)."""
    sync()
    with torch.profiler.profile(activities=device_activity()) as prof:
        t0 = time.perf_counter()
        for k in range(n):
            one(k)
        sync()
        window = time.perf_counter() - t0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as host:
        for k in range(n, n + HOST_STEPS):
            one(k)
        sync()
    return prof, window, host


def idx_bytes(rows: int) -> int:
    """The program's rulebook index width: int16 where every capacity of
    the batch fits under 2^15, else int32 (both chain builders' rule)."""
    return 2 if rows < 2 ** 15 else 4


def fwd_bound(conv, elt: int, ib: int, dtype: str) -> float:
    """One forward conv (K1, K3 or K4): inputs, rulebook, weights read once
    and the output written once; 2 x hits x Cin x Cout operations."""
    cin, cout, hits, n_in, n_out, k = conv
    nbytes = (n_in * cin + n_out * cout + k * cin * cout) * elt \
        + n_out * k * ib
    return harness.conv_bound_s(2.0 * hits * cin * cout, nbytes, dtype)


def dfeat_bound(conv, elt: int, ib: int, dtype: str) -> float:
    """The input gradient: the output gradient, the inverse rulebook and
    the weights read once, the input gradient written once."""
    cin, cout, hits, n_in, n_out, k = conv
    nbytes = (n_out * cout + n_in * cin + k * cin * cout) * elt \
        + n_in * k * ib
    return harness.conv_bound_s(2.0 * hits * cin * cout, nbytes, dtype)


def forward_flops(model: VoxelNet, inputs, chain) -> float:
    """The operations one forward asks for: the reference's sparse convs
    multiply only the rows each tap hits, so ``FlopCounterMode`` counts
    2 x hits x Cin x Cout for them and the dense layers as they are."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(*inputs, chain)
    return float(counter.get_total_flops())


def sparse_convs_before(dense_from_stage: int) -> int:
    """How many of the backbone's convs a plan that densifies from stage
    ``dense_from_stage`` runs sparse: every conv of the stages before it,
    and the strided conv into it."""
    from ..reference.model import PLAN

    dfs = min(max(int(dense_from_stage), 1), len(PLAN))
    return (sum(n_subm for _, n_subm, *_ in PLAN[:dfs])
            + sum(1 for _, _, down, *_ in PLAN[1:dfs + 1] if down))


def trace_train(prof, window: float, host, steps: int, batch: int, cfg, sd,
                batches: List[dict], kernels,
                dense_from_stage: int) -> harness.Trace:
    """The per-layer numbers of a traced training window: each step is a
    teacher forward on the raw scenes and a student forward and backward
    (3 x its forward) on the augmented ones; the student's convs that run
    sparse under its plan (``dense_from_stage``, read from the program's
    student) run K4, dFeat (all but the first conv) and dW, the teacher's
    14 run K4."""
    from ..reference.train import model_inputs

    dtype = cfg.get("precision", "float32")
    elt = 2 if dtype == "bfloat16" else 4
    caps = [int(c) * batch for c in cfg["stage_capacity"]]
    ib = idx_bytes(max(caps))
    sparse_student = sparse_convs_before(dense_from_stage)
    t = harness.Trace(prof, window, host)
    model = VoxelNet().to(DEVICE).eval()
    model.load_state_dict(sd)
    flops = bound = 0.0
    for b in batches:
        for sfx, mult in (("_raw", 1.0), ("", 3.0)):
            vox, npts, coords = model_inputs(b, sfx, DEVICE, True)
            chain = model.chain(coords, batch)
            flops += mult * forward_flops(model, (vox, npts), chain)
            convs = sparse_conv_shapes(model, chain)
            if sfx:
                bound += sum(fwd_bound(c, elt, ib, dtype) for c in convs)
            else:
                mine = convs[:sparse_student]
                bound += sum(fwd_bound(c, elt, ib, dtype) for c in mine)
                bound += sum(dfeat_bound(c, elt, ib, dtype)
                             for c in mine[1:])
                # dW reads the inputs, the output gradient and the
                # rulebook and writes the weights: the forward's bytes
                bound += sum(fwd_bound(c, elt, ib, dtype) for c in mine)
    t.steps = steps
    t.extra.update(kind="train", model_flops=flops,
                   peak_flops=harness.PEAK_FLOPS[dtype],
                   sparse_bound_s=bound,
                   sparse_s=t.kernel_s(*kernels))
    return t


def trace_infer(prof, window: float, host, ran: List[int], dtype: str, sd,
                groups: List[List[np.ndarray]], voxelize, kernels,
                predict_ms: float) -> harness.Trace:
    """The per-layer numbers of a traced serving window that ran the pool's
    batches ``ran`` (indices into ``groups``, the scans of each): the
    forward's operations and the K1/K3 convs' bounds on the reference's
    rulebooks."""
    t = harness.Trace(prof, window, host)
    model = VoxelNet().to(DEVICE).eval()
    model.load_state_dict(sd)
    elt = 2 if dtype == "bfloat16" else 4
    flops = bound = 0.0
    for j, times in collections.Counter(ran).items():
        vox, npts, coords, rows = voxelize(groups[j])
        chain = model.chain(coords, len(groups[j]))
        flops += times * forward_flops(model, (vox, npts), chain)
        bound += times * sum(fwd_bound(c, elt, idx_bytes(rows), dtype)
                             for c in sparse_conv_shapes(model, chain))
    t.steps = len(ran)
    t.extra.update(kind="infer", model_flops=flops,
                   peak_flops=harness.PEAK_FLOPS[dtype],
                   sparse_bound_s=bound, sparse_s=t.kernel_s(*kernels),
                   predict_ms=predict_ms)
    return t
