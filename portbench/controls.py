"""The readings the comparison limits are set from, on the chip at each
cell's own size: the control (the reference in the next precision below
the configuration's) and the planted faults, against the float32
reference, on the seeds given.

    python3 -m portbench.controls --workload <cell> --seeds <n> [<n> ...]

Training cells: the control is the reference with every conv's input and
weight rounded to float8 e4m3 (bfloat16 configurations) or with TF32 on
(float32 ones); the fault is each batch's second half left out of the
step, the mean taken over the rest. A state left unchanged reads 1 by the
measure and needs no run. Serving cells: the control's head outputs
against the reference's. Witnesses of what the numbers hold without any
fault: the reference with every conv's input and weight rounded to
bfloat16 (bfloat16 configurations), and, with ``--witness-cpu``, the
float32 reference on the CPU. With ``--program``, the program's own
readings instead: a whole run of the cell per seed (a one-second window),
all in one process. One JSON line per seed and reading; the benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch


def _train(c: dict, seed: int, witness_cpu: bool = False):
    from .drivers import common, train
    from .reference.train import compare

    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        x = train.inputs(c, seed, tmp)
        n = c["traffic"]["follow"]
        ref = train.follow_reference(x, n)
        low = x["cfg"].get("precision", "float32") == "bfloat16"
        if low:
            ctl = train.follow_reference(x, n, quant="fp8")
        else:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                ctl = train.follow_reference(x, n)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
        yield ("control_fp8" if low else "control_tf32"), compare(ctl, ref)
        half = train.follow_reference(x, n, drop_half=True)
        yield "fault_half_batch", compare(half, ref)
        if low:
            wit = train.follow_reference(x, n, quant="bf16")
            yield "witness_bf16_rounding", compare(wit, ref)
        elif witness_cpu:
            common.DEVICE = "cpu"
            try:
                wit = train.follow_reference(x, n)
            finally:
                common.DEVICE = "cuda"
            yield "witness_cpu", compare(wit, ref)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _infer(c: dict, seed: int, witness_cpu: bool = False):
    from .drivers import infer

    x = infer.inputs(c, seed)
    ref = infer.reference_heads(x)
    for name, quant in (("control_fp8", "fp8"),
                        ("witness_bf16_rounding", "bf16")):
        low = infer.reference_heads(x, quant=quant)
        gap = max(float(torch.linalg.vector_norm(a[k] - b[k])
                        / torch.linalg.vector_norm(b[k]))
                  for a, b in zip(low, ref) for k in b)
        yield name, {"head_gap": gap}


def _program(c: dict, seed: int, witness_cpu: bool = False):
    from . import harness

    res = harness.driver(c["traffic"]["driver"]).run(
        c, seed=seed, seconds=1.0, trace=False, t_start=time.perf_counter())
    judged = all(v <= lim for _, v, lim in res["checks"])
    yield "program", {**res["readings"], "correct": judged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--witness-cpu", action="store_true",
                    help="float32 cells: also the reference on the CPU")
    ap.add_argument("--program", action="store_true",
                    help="the program's readings instead of the controls'")
    args = ap.parse_args(argv)
    from . import harness
    from .run import _caches

    _caches()
    if not torch.cuda.is_available():
        print("portbench.controls: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = harness.cell(args.workload)
    kind = c["traffic"]["driver"]
    for seed in args.seeds:
        gen = (_program if args.program
               else {"train": _train, "infer": _infer}[kind])
        for name, nums in gen(c, seed, args.witness_cpu):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
