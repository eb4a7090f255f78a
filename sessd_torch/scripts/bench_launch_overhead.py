"""The fixed cost of one kernel launch of the port, on one CUDA device.

    python -m sessd_torch.scripts.bench_launch_overhead

The counterpart of ``scripts/bench_wconv_ablate2.py``. Its empty kernel
(``ops.cuda.ablate.empty_launch``, ``csrc/sparse_conv_ablate.cu``) writes
zeros over out [20224, 16] bf16 at 256, 512 and 1024 rows per block. The
TPU script also toggled scalar prefetch and whether the features were
resident in VMEM; those have no CUDA meaning (a kernel's arguments are
pointers, and a block loads its own indices), so there are no such
variants here. For each block size, over ``CALLS`` calls:

(a) host µs per call through the port's Python -> ctypes path: the
    enqueue alone (no synchronize), and ``CALLS`` calls with one
    synchronize at the end;
(b) device µs per launch: CUDA events around ``CALLS`` launches queued
    behind a spin on the device, so the host's issue time is hidden;
(c) the same ``CALLS`` launches issued from one C entry
    (``empty_launch_repeat``), which removes the Python cost: host µs per
    launch and device µs per launch as in (b);
(d) the counterpart of the TPU script's "full windowed_conv (glue +
    kernel)": the public ``sparse_conv_fwd`` wrapper (checks, output
    allocation, ctypes call) at N = 20000 rows, K = 27, 16 -> 16 bf16, on
    a sorted rulebook, against ``CALLS`` bare launches of the same kernel
    from one C entry (``sparse_conv_fwd_repeat``), host and device.

The last line is one JSON object with every number and the card.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..ops.cuda import ablate
from ..ops.cuda import sparse_conv_train as kt
from ..utils.profiling import card_line, queued_span_ms

NPAD, COUT = 20224, 16
BLOCK_ROWS = (256, 512, 1024)
CALLS = 30
GLUE_N, K, CIN = 20000, 27, 16
SEED = 0


def _host_us(fn, calls: int, launches: int) -> dict:
    """Host µs per launch of ``calls`` calls of ``fn`` that issue
    ``launches`` launches in all: the enqueue alone, and the same ended by
    one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issued = time.perf_counter()
    torch.cuda.synchronize()
    done = time.perf_counter()
    return {"issue_us": (issued - t0) / launches * 1e6,
            "synced_us": (done - t0) / launches * 1e6}


def glue_inputs(device, seed: int = SEED):
    """The TPU script's glue inputs: x [20000, 16], a rulebook sorted per
    tap [20000, 27] int32, w [27, 16, 16], bf16."""
    rng = np.random.RandomState(seed)
    x = rng.randn(GLUE_N, CIN).astype(np.float32)
    w = rng.randn(K, CIN, COUT).astype(np.float32)
    rb = np.sort(rng.randint(0, GLUE_N, (GLUE_N, K)), 0).astype(np.int32)
    return (torch.from_numpy(x).to(device, torch.bfloat16),
            torch.from_numpy(rb).to(device),
            torch.from_numpy(w).to(device, torch.bfloat16))


def run(calls: int = CALLS) -> dict:
    """Every measurement above on the current CUDA device (raises without
    one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_launch_overhead needs a CUDA device")
    out = torch.empty((NPAD, COUT), dtype=torch.bfloat16, device="cuda")
    res = {"empty": {}}
    for block in BLOCK_ROWS:
        one = lambda b=block: ablate.empty_launch(out, b)  # noqa: E731
        rep = lambda b=block: ablate.empty_launch_repeat(  # noqa: E731
            out, b, calls)
        res["empty"][block] = {
            "a_host": _host_us(one, calls, calls),
            "b_device_us": queued_span_ms(one, calls) * 1e3,
            "c_host": _host_us(rep, 1, calls),
            "c_device_us": queued_span_ms(rep, 1) * 1e3 / calls}
    x, rb, w = glue_inputs("cuda")
    y = torch.empty((GLUE_N, COUT), dtype=torch.bfloat16, device="cuda")
    wrapper = lambda: kt.sparse_conv_fwd(x, rb, w)  # noqa: E731
    bare = lambda: ablate.sparse_conv_fwd_repeat(x, rb, w, y,  # noqa: E731
                                                 calls)
    res["glue"] = {
        "wrapper_host": _host_us(wrapper, calls, calls),
        "wrapper_device_us": queued_span_ms(wrapper, calls) * 1e3,
        "bare_host": _host_us(bare, 1, calls),
        "bare_device_us": queued_span_ms(bare, 1) * 1e3 / calls}
    return res


def main():
    card = card_line()
    res = run()
    print(card)
    for block, r in res["empty"].items():
        print(f"empty kernel, {block:4d} rows/block: (a) host "
              f"{r['a_host']['issue_us']:.2f} us/call issued, "
              f"{r['a_host']['synced_us']:.2f} us/call synced; (b) device "
              f"{r['b_device_us']:.2f} us/launch; (c) one C call: host "
              f"{r['c_host']['issue_us']:.2f} us/launch issued, "
              f"{r['c_host']['synced_us']:.2f} synced, device "
              f"{r['c_device_us']:.2f} us/launch")
    g = res["glue"]
    print(f"(d) sparse_conv_fwd N={GLUE_N} K={K} 16->16 bf16: wrapper host "
          f"{g['wrapper_host']['issue_us']:.2f} us/call issued, "
          f"{g['wrapper_host']['synced_us']:.2f} synced, device "
          f"{g['wrapper_device_us']:.2f} us; bare C launches host "
          f"{g['bare_host']['issue_us']:.2f} us/launch issued, "
          f"{g['bare_host']['synced_us']:.2f} synced, device "
          f"{g['bare_device_us']:.2f} us")
    print(json.dumps({"card": card, **res}))


if __name__ == "__main__":
    main()
