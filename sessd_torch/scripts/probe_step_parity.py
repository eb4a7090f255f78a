"""How far one f32 SE-SSD training step moves when the rounding of its
sparse convs changes, on one CUDA device.

    python -m sessd_torch.scripts.probe_step_parity [--out PATH]

``chip_smoke.py`` holds one f32 step through the kernels against the same
step through their plain twins (cuBLAS f32, TF32 off) from the same state
on the same batch: loss terms within 1e-4 relative, each gradient within
1e-3 of its max. This script runs that comparison with the kernel side's
convs swapped, one variant at a time, each from a copy of the same state
of a Trainer of the f32 config (``se_ssd_kitti_car.py``) at the acceptance
recipe's stage caps on a synthetic KITTI root of 8 ray-cast frames (the
setup of ``bench_f32_kernels``), on its first batch:

- ``shipped``: the kernels as the training step runs them;
- ``all scalar``: f32 dFeat through its scalar entry as well, the
  rounding of the scalar tile throughout;
- ``fwd 3xtf32``: K4 through its 3xTF32 entry (``sparse_conv_fwd_tf32``);
- ``fwd 3xtf32 teacher``: the same for the teacher's 14 forwards only
  (the first 14 K4 calls of the step), the student's 10 on K4;
- ``fwd f64``: K4 replaced by its twin computed in f64 and rounded once
  (the exact conv);
- ``fwd twin 1e-7 noise``: K4 replaced by its twin times (1 + 1e-7 z), z
  standard normal (seeded).

For each: the worst loss term's relative difference and the worst
gradients' differences over their max, with the parameters' names. The
last line is one JSON object with every number and the card.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import tempfile

import torch

from sessd_torch.ops.cuda import sparse_conv_train as kt
from sessd_torch.scripts.bench_f32_kernels import first_batch, write_config
from sessd_torch.scripts.profile_train import make_synthetic_root
from sessd_torch.tools.train import load as load_train_config
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils.profiling import card_line

SEED = 0
TEACHER_CONVS = 14  # the teacher's K4 calls come first in a step
KERNELS = ("sparse_conv_fwd", "sparse_conv_dfeat", "sparse_conv_dw")


@contextlib.contextmanager
def swapped(**fns):
    """``kt``'s kernels replaced by ``fns`` (SparseConvFunction looks them
    up at each call)."""
    saved = {n: getattr(kt, n) for n in fns}
    try:
        for n, fn in fns.items():
            if not hasattr(fn, "launches"):
                fn.launches = 0  # the wrappers count through their name
            setattr(kt, n, fn)
        yield
    finally:
        for n, fn in saved.items():
            setattr(kt, n, fn)


def step(trainer, db, ctx):
    """One train_step from a copy of the trainer's state: (metrics,
    {parameter: gradient})."""
    state = copy.deepcopy(trainer.state)
    state.optimizer.params = list(state.student.parameters())
    names = [n for n, _ in state.student.named_parameters()]
    grads = {}
    apply = state.optimizer.step

    def capture(gs):
        grads.update(zip(names, [g.detach().clone() for g in gs]))
        return apply(gs)

    state.optimizer.step = capture
    with ctx:
        metrics = trainer.train_step(state, db, 0.5)
    torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, grads


def compare(kernel, twin) -> dict:
    (mk, gk), (mt, gt) = kernel, twin
    terms = sorted(((abs(mk[k] - v) / (abs(v) + 1e-6), k)
                    for k, v in mt.items()), reverse=True)
    grads = []
    for name, g in gt.items():
        peak = float(g.abs().max())
        if peak > 0:
            grads.append((float((gk[name] - g).abs().max()) / peak, name))
    grads.sort(reverse=True)
    return {"loss_term_rel": terms[0][0], "loss_term": terms[0][1],
            "gradient_rel": grads[0][0], "gradient": grads[0][1],
            "next_gradients": grads[1:4]}


def variants(gen):
    calls = {"n": 0}

    def teacher_tf32(x, rb, w, mask=None):
        calls["n"] += 1
        fn = kt.sparse_conv_fwd_tf32 if calls["n"] <= TEACHER_CONVS \
            and x.shape[1] >= 16 else KT["sparse_conv_fwd"]
        return fn(x, rb, w, mask)

    def f64(x, rb, w, mask=None):
        return kt.sparse_conv_fwd_ref(x.double(), rb, w.double(),
                                      mask).float()

    def noisy(x, rb, w, mask=None):
        y = kt.sparse_conv_fwd_ref(x, rb, w, mask)
        return y * (1 + 1e-7 * torch.randn(y.shape, device=y.device,
                                           generator=gen))

    def fwd_tf32(x, rb, w, mask=None):
        fn = kt.sparse_conv_fwd_tf32 if x.shape[1] >= 16 \
            else KT["sparse_conv_fwd"]
        return fn(x, rb, w, mask)

    return [("shipped", {}),
            ("all scalar", {"sparse_conv_dfeat": kt.sparse_conv_dfeat_scalar}),
            ("fwd 3xtf32", {"sparse_conv_fwd": fwd_tf32}),
            ("fwd 3xtf32 teacher", {"sparse_conv_fwd": teacher_tf32}),
            ("fwd f64", {"sparse_conv_fwd": f64}),
            ("fwd twin 1e-7 noise", {"sparse_conv_fwd": noisy})], calls


KT = {n: getattr(kt, n) for n in KERNELS}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_step_parity needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    gen = torch.Generator(device="cuda")
    twins = {n: getattr(kt, n + "_ref") for n in KERNELS}
    result = {"card": card, "variants": {}}
    with tempfile.TemporaryDirectory(prefix="probe_parity_") as tmp:
        root = f"{tmp}/kitti"
        make_synthetic_root(root, num_frames=8, num_cars=10)
        cfg = load_train_config(write_config(f"{tmp}/work.py"), root)
        trainer = Trainer(cfg, work_dir=f"{tmp}/work", seed=SEED,
                          device="cuda")
        db = first_batch(trainer)
        todo, calls = variants(gen)
        for name, fns in todo:
            gen.manual_seed(SEED)
            calls["n"] = 0
            kernel = step(trainer, db, swapped(**fns))
            twin = step(trainer, db, swapped(**twins))
            r = compare(kernel, twin)
            result["variants"][name] = r
            print(f"{name}: loss terms {r['loss_term_rel']:.2e} "
                  f"({r['loss_term']}), gradients {r['gradient_rel']:.2e} "
                  f"of their max ({r['gradient']}); next "
                  + ", ".join(f"{n} {v:.2e}" for v, n in r["next_gradients"])
                  + f" [{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
