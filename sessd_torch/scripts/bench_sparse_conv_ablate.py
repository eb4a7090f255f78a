"""Where the time of one gather-GEMM conv goes: the conv tiles with one cost
removed at a time, on one CUDA device.

    python -m sessd_torch.scripts.bench_sparse_conv_ablate

The counterpart of ``scripts/bench_wconv_ablate.py`` at its shape and from
its seed: N = 20096 feature rows of 16 channels, NPAD = 20224 output rows,
16 -> 16 channels, K = 27 taps, bf16, and a sorted int32 rulebook (each
tap's column drawn uniformly and sorted, as the TPU script draws it),
transposed to the port's [n_out, taps] layout: every tap hits every 64-row
tile, so no tap is skipped. Two tables on it.

The scalar tile the convs ran before (``ops.cuda.ablate.sparse_conv_ablate``,
its one copy in ``csrc/sparse_conv_ablate.cu``):

- ``full``: the real conv, K = 27, with no bias and no ReLU;
- ``k9``: ``full`` on the first 9 taps' rulebook (``rb[:, :9]``);
- ``linear``: row n of every tap reads row n: no rulebook loads, no
  indirection;
- ``no_gather``: the rulebook is read, the staged rows are a constant: no
  feature loads;
- ``fma_only``: rows and weights staged once, then only the tap loop's FMAs.

The tensor-core tile every bf16 conv at 16-64 channels runs
(``ops.cuda.ablate.sparse_conv_ablate_mma``: ``csrc/gather_mma.cuh``'s tile
itself in one of its modes):

- ``full``: the tile as the bf16 training forward runs it (its bits);
- ``k9``: ``full`` on 9 taps;
- ``linear``: no rulebook loads, no indirection, no tap skipped;
- ``no_gather``: the rulebook read and ballot, every hit row copied from
  feature row 0: no scattered rows, but every block reads one line;
- ``mma_only``: tap 0 staged once, then only the wgmma chain over the taps;
- ``copy_only``: the ring's gathers and weight copies, no wgmma;
- ``fixed``: the rulebook read, keep flags, ballot and a store of zeros: the
  fixed cost of a launch of these tiles.

Then the tensor-core modes on three convs of a batch-1 request
(``chain_inputs``: the host rulebook chain of ``make_scene(0)`` at
SERVING_CAPS, int32, with seeded random bf16 features and weights): subm0b
(16 -> 16, K = 27, 313 tiles), subm3a (64 -> 64, K = 27, 94 tiles) and
down3 (64 -> 64, K = 3, 63 tiles), beside the resident serving conv K1
(zero bias, ReLU) launched at one, two and four CTAs per tile
(``fused_sparse_conv_at_split``).

Each time is the median over ``REPS`` launches of CUDA events around one
launch, the launch queued behind a spin on the device so that the events
see the kernel and not the host's issue time. The differences between
variants follow. The last line is one JSON object with every number and
the card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.cuda import ablate
from ..ops.cuda import sparse_conv as sc
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
# the tensor-core tile's variants: variant -> (mode, taps)
MMA_VARIANTS = {"full": ("full", K), "k9": ("full", 9),
                "linear": ("linear", K), "no_gather": ("no_gather", K),
                "mma_only": ("mma_only", K), "copy_only": ("copy_only", K),
                "fixed": ("fixed", K)}
MMA_DIFFERENCES = {
    "fixed cost: launch, rulebook read, ballot, store (fixed)":
        ("fixed", None, 1),
    "the tap chain (full - fixed)": ("full", "fixed", 1),
    "rulebook loads + indirection + skipping (full - linear)":
        ("full", "linear", 1),
    "scattered rows against one hot row (full - no_gather)":
        ("full", "no_gather", 1),
    "ring copies alone (copy_only - fixed)": ("copy_only", "fixed", 1),
    "wgmma chain alone (mma_only - fixed)": ("mma_only", "fixed", 1),
    "one tap of the full conv ((full - k9) / 18)": ("full", "k9", 18),
}
# the same differences on a chain conv (no k9 variant there)
MMA_DIFFERENCES_CHAIN = {label: v for label, v in MMA_DIFFERENCES.items()
                         if "k9" not in v}
# batch-1 convs of the ablation on the chain: name -> (rulebook kind, chain
# index, stage it reads, channels)
CHAIN_CONVS = {"subm0b": ("subm", 0, 0, 16), "subm3a": ("subm", 3, 3, 64),
               "down3": ("down", 3, 3, 64)}
SPLITS = (1, 2, 4)  # K1's CTAs per tile beside the chain's modes


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


def chain_inputs(device, seed: int = SEED) -> dict:
    """{conv: (feats [n_in, C] bf16, rb [n_out, K] int32, w2 [K, C, C]
    bf16)} of the CHAIN_CONVS of one batch-1 request: the rulebooks of
    ``make_scene(0)`` at SERVING_CAPS from the host preprocessor, features
    and weights drawn from ``seed``."""
    from .. import builder
    from ..serve import SERVING_CAPS, HostPreprocessor, make_scene

    cfg = builder.load_config("se_ssd_kitti_car_bf16.py")
    prep = HostPreprocessor(builder.build_voxelizer(cfg.voxel_generator),
                            SERVING_CAPS)
    chain = prep(make_scene(seed=0)[0])["rulebooks"]
    rng = np.random.RandomState(seed)
    out = {}
    for name, (kind, idx, stage, c) in CHAIN_CONVS.items():
        rb = np.asarray(chain[kind][idx]).astype(np.int32)
        feats = rng.randn(SERVING_CAPS[stage], c).astype(np.float32)
        w2 = (rng.randn(rb.shape[1], c, c) / np.sqrt(rb.shape[1] * c))
        out[name] = (torch.from_numpy(feats).to(device, torch.bfloat16),
                     torch.from_numpy(rb).to(device),
                     torch.from_numpy(w2).to(device, torch.bfloat16))
    return out


def _need_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("bench_sparse_conv_ablate needs a CUDA device")


def run(inputs=None, reps: int = REPS) -> dict:
    """{variant: kernel ms} of the scalar tile on the current CUDA device
    (raises without one)."""
    _need_cuda()
    inputs = inputs or make_inputs("cuda")
    times = {}
    for name in VARIANTS:
        args = variant_args(inputs, name)
        times[name] = queued_device_ms(
            lambda a=args: ablate.sparse_conv_ablate(*a), reps)
    return times


def mma_variant_args(inputs: dict, name: str):
    """(feats, rb, w2, mode) of one tensor-core variant."""
    mode, taps = MMA_VARIANTS[name]
    feats, rb, w2, _ = variant_args(inputs, "k9" if taps == 9 else "full")
    return feats, rb, w2, mode


def run_mma(inputs=None, reps: int = REPS) -> dict:
    """{variant: kernel ms} of the tensor-core tile on the current CUDA
    device (raises without one)."""
    _need_cuda()
    inputs = inputs or make_inputs("cuda")
    times = {}
    for name in MMA_VARIANTS:
        args = mma_variant_args(inputs, name)
        times[name] = queued_device_ms(
            lambda a=args: ablate.sparse_conv_ablate_mma(*a), reps)
    return times


def run_chain(chain=None, reps: int = REPS) -> dict:
    """{conv: {mode: kernel ms}} of the tensor-core tile's modes on the
    batch-1 convs (``chain_inputs``)."""
    _need_cuda()
    chain = chain or chain_inputs("cuda")
    return {name: {mode: queued_device_ms(
                lambda a=args, m=mode: ablate.sparse_conv_ablate_mma(*a, m),
                reps) for mode in ablate.MMA_MODES}
            for name, args in chain.items()}


def k1_at_splits(chain=None, reps: int = REPS) -> dict:
    """{conv: {S: ms}}: K1 (zero bias, ReLU) on the same batch-1 convs at
    S CTAs per tile (``fused_sparse_conv_at_split``, a comparison entry),
    and the S its own rule picks on this card under "rule"."""
    _need_cuda()
    chain = chain or chain_inputs("cuda")
    out = {}
    for name, (feats, rb, w2) in chain.items():
        bias = torch.zeros(w2.shape[2], device=feats.device)
        args = (feats, rb, w2, bias, feats.shape[0])
        row = {s: queued_device_ms(
            lambda s=s: sc.fused_sparse_conv_at_split(*args, split=s), reps)
            for s in SPLITS}
        row["rule"] = sc.launch_split(rb.shape[0], w2.shape[1], w2.shape[2],
                                      feats.dtype)
        out[name] = row
    return out


def differences(times: dict, table: dict = DIFFERENCES) -> dict:
    return {label: (times[a] - (times[b] if b else 0.0)) / div
            for label, (a, b, div) in table.items()}


def main():
    _need_cuda()
    card = card_line()
    inputs = make_inputs("cuda")
    times = run(inputs)
    mma = run_mma(inputs)
    chain = chain_inputs("cuda")
    on_chain = run_chain(chain)
    splits = k1_at_splits(chain)
    print(card)
    print("scalar tile, 16 -> 16, N = 20096:")
    for name, ms in times.items():
        mode, taps = VARIANTS[name]
        print(f"  {name:10s} (mode {mode}, K={taps:2d}): {ms:.4f} ms")
    diffs = differences(times)
    for label, ms in diffs.items():
        print(f"  {label}: {ms:.4f} ms")
    print("tensor-core tile, 16 -> 16, N = 20096:")
    for name, ms in mma.items():
        mode, taps = MMA_VARIANTS[name]
        print(f"  {name:10s} (mode {mode}, K={taps:2d}): {ms:.4f} ms")
    mma_diffs = differences(mma, MMA_DIFFERENCES)
    for label, ms in mma_diffs.items():
        print(f"  {label}: {ms:.4f} ms")
    chain_diffs = {name: differences(row, MMA_DIFFERENCES_CHAIN)
                   for name, row in on_chain.items()}
    for name, row in on_chain.items():
        print(f"tensor-core tile, batch-1 {name}: " + ", ".join(
            f"{m} {ms:.4f}" for m, ms in row.items()) + " ms; K1 " + ", ".join(
            f"S={s} {splits[name][s]:.4f}" for s in SPLITS)
            + f" ms (rule S={splits[name]['rule']})")
        for label, ms in chain_diffs[name].items():
            print(f"  {label}: {ms:.4f} ms")
    print(json.dumps({"card": card, "ms": times, "differences_ms": diffs,
                      "mma_ms": mma, "mma_differences_ms": mma_diffs,
                      "chain_ms": on_chain, "chain_differences_ms":
                      chain_diffs, "k1_at_split_ms": splits}))


if __name__ == "__main__":
    main()
