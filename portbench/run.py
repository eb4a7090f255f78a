"""The benchmark of ``sessd_torch`` on NVIDIA GPUs: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name (``BENCHMARK.json``, ``portbench/harness.py``);
the cell's driver (``portbench/drivers``) builds its inputs and weights
from the seed, warms up, measures for ``--seconds`` (``--trace 0``: the
end-to-end metrics) or profiles a fixed stretch of the same loop
(``--trace 1``: the per-layer metrics), then compares what the timed path
produced with the plain reference (``portbench/reference``). The last line
of standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error. Without as many CUDA
devices as the cell asks for it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _caches():
    """Every build and kernel cache of the run inside the checkout, at
    fixed paths: only a checkout's first run of a cell builds."""
    from .harness import ROOT

    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed is a whole number >= 0")
    _caches()
    from . import harness

    c = harness.cell(args.workload)
    chips = int(c["workload"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    drv = harness.driver(c["traffic"]["driver"])
    res = drv.run(c, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t_start=T_START)

    bench, name = c["bench"], args.workload
    metrics = {}
    if args.trace:
        t = res["trace"]
        for m in harness.cell_metrics(bench, name, "per_layer"):
            value = harness.metric_reader(m["name"]).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(bench, name, "end_to_end"):
            if m["name"] in res["end_to_end"]:
                metrics[m["name"]] = {"value": float(res["end_to_end"]
                                                     [m["name"]]),
                                      "unit": m["unit"]}
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    checks = res["checks"]
    correct = all(v <= lim for _, v, lim in checks)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(res["memory_peak"])}
    out = {"correct": correct, "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": device}
    if args.trace:
        t = res["trace"]
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = t.breakdown()
    for note in res.get("notes", []):
        print(f"portbench: {note}", file=sys.stderr)
    for key, value, limit in checks:
        print(f"check {key} = {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    out["checks"] = {key: {"value": value, "limit": limit}
                     for key, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
