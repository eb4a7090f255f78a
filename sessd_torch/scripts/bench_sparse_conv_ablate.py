"""Where the time of one gather-GEMM conv goes: the conv tile with one cost
removed at a time, on one CUDA device.

    python -m sessd_torch.scripts.bench_sparse_conv_ablate

The counterpart of ``scripts/bench_wconv_ablate.py`` at its shape and from
its seed: N = 20096 feature rows of 16 channels, NPAD = 20224 output rows,
16 -> 16 channels, K = 27 taps, bf16, and a sorted int32 rulebook (each
tap's column drawn uniformly and sorted, as the TPU script draws it),
transposed to the port's [n_out, taps] layout. Each variant runs
``ops.cuda.ablate.sparse_conv_ablate`` (``csrc/sparse_conv_ablate.cu``):

- ``full``: the real conv, K = 27, on the scalar tile (the same
  arithmetic as ``fused_sparse_conv_scalar`` with zero bias and no ReLU);
- ``k9``: ``full`` on the first 9 taps' rulebook (``rb[:, :9]``);
- ``linear``: row n of every tap reads row n: no rulebook loads, no
  indirection;
- ``no_gather``: the rulebook is read, the staged rows are a constant: no
  feature loads;
- ``fma_only``: rows and weights staged once, then only the tap loop's FMAs.

Each time is the median over ``REPS`` launches of CUDA events around one
launch, the launch queued behind a spin on the device so that the events
see the kernel and not the host's issue time. The differences between
variants follow: the cost of the rulebook loads and indirection, of the
feature gathers, of staging rows and weights per tap, of the FMAs, and of
one tap. The last line is one JSON object with every number and the card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.cuda import ablate
from ..utils.profiling import card_line, queued_device_ms

N, CIN, COUT, K = 20096, 16, 16, 27
NPAD = 20224
REPS = 30
SEED = 0
# variant -> (kernel mode, taps)
VARIANTS = {"full": ("full", K), "k9": ("full", 9),
            "linear": ("linear", K), "no_gather": ("no_gather", K),
            "fma_only": ("fma_only", K)}
# the differences printed after the times: label -> (minuend, subtrahend,
# divisor)
DIFFERENCES = {
    "rulebook loads + indirection (full - linear)": ("full", "linear", 1),
    "feature gathers (full - no_gather)": ("full", "no_gather", 1),
    "per-tap staging of rows and weights (linear - fma_only)":
        ("linear", "fma_only", 1),
    "FMAs and the tap loop (fma_only)": ("fma_only", None, 1),
    "one tap of the full conv ((full - k9) / 18)": ("full", "k9", 18),
}


def make_inputs(device, seed: int = SEED) -> dict:
    """The TPU script's arrays from its seed, in the port's layouts:
    feats [N, 16] bf16, rb [NPAD, K] int32 (sorted per tap), w2 [K, 16, 16]
    bf16."""
    rng = np.random.RandomState(seed)
    feats_t = rng.randn(CIN, N).astype(np.float32)
    rb = np.sort(rng.randint(0, N - 1, (K, NPAD)), axis=1).astype(np.int32)
    w2t = rng.randn(COUT, K * CIN).astype(np.float32)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return {"feats": put(feats_t.T, torch.bfloat16),
            "rb": put(rb.T, torch.int32),
            "w2": put(w2t.T.reshape(K, CIN, COUT), torch.bfloat16)}


def variant_args(inputs: dict, name: str):
    """(feats, rb, w2, mode) of one variant."""
    mode, taps = VARIANTS[name]
    rb = inputs["rb"] if taps == K else inputs["rb"][:, :taps].contiguous()
    w2 = inputs["w2"] if taps == K else inputs["w2"][:taps].contiguous()
    return inputs["feats"], rb, w2, mode


def run(inputs=None, reps: int = REPS) -> dict:
    """{variant: kernel ms} on the current CUDA device (raises without
    one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_sparse_conv_ablate needs a CUDA device")
    inputs = inputs or make_inputs("cuda")
    times = {}
    for name in VARIANTS:
        args = variant_args(inputs, name)
        times[name] = queued_device_ms(
            lambda a=args: ablate.sparse_conv_ablate(*a), reps)
    return times


def differences(times: dict) -> dict:
    return {label: (times[a] - (times[b] if b else 0.0)) / div
            for label, (a, b, div) in DIFFERENCES.items()}


def main():
    card = card_line()
    times = run()
    print(card)
    for name, ms in times.items():
        mode, taps = VARIANTS[name]
        print(f"{name:10s} (mode {mode}, K={taps:2d}): {ms:.4f} ms")
    diffs = differences(times)
    for label, ms in diffs.items():
        print(f"{label}: {ms:.4f} ms")
    print(json.dumps({"card": card, "ms": times, "differences_ms": diffs}))


if __name__ == "__main__":
    main()
