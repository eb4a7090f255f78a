"""How far one f32 SE-SSD training step moves when the rounding of its
sparse convs changes, on one CUDA device, and which of the step's discrete
choices carry the change.

    python -m sessd_torch.scripts.probe_step_parity [--out PATH]
        [--repeats N] [--variants NAME ...] [--deterministic]

``chip_smoke.py`` holds one f32 step through the kernels against the same
step through their plain twins (cuBLAS f32, TF32 off) from the same state
on the same batch: loss terms within 1e-4 relative, each gradient within
1e-3 of its max. A step has discrete choices: each ReLU's mask, the
branches of the losses (smooth-L1, the box clips, the consistency loss's
top-K and matching), the IoU geometry's bounds, the rectangle ODIoU's
diagonal takes. A forward that rounds otherwise than the twin flips a few
of them, and at seeded random weights one flipped element moves a weight
gradient by about 1/sqrt(rows) of its max: the terms of a gradient over
~140k rows have incoherent signs, so its max grows like sqrt(rows) of one
term. ``StepPins`` records those choices in the twin step and replays them
in the kernel step, which then differs from the twin only by its
arithmetic; the gate replays the kinds of PINNED.

This script runs the comparison with the kernel side changed, one variant
at a time, each from a copy of the same state of a Trainer of the f32
config (``se_ssd_kitti_car.py``) at the acceptance recipe's stage caps on
a synthetic KITTI root of 8 ray-cast frames (the setup of
``bench_f32_kernels``), on its first batch, against a twin step that
records every choice of ``KINDS`` (``--repeats`` such twin steps, each
against every variant; cuDNN's convs and the backward's atomic adds make
the card's steps differ run to run, ``--deterministic`` takes cuDNN's
deterministic algorithms):

- ``twin again`` / ``twin again pinned``: the twin step once more, free
  and with PINNED replayed (the card's own run-to-run difference);
- ``shipped``: the kernels as the training step runs them (f32 K4 through
  3xTF32), free; ``shipped pinned relu``: with every ReLU mask replayed;
  ``shipped pinned relu sort argmax``: also the consistency loss's top-K
  orders and matching; ``shipped pinned``: with PINNED replayed;
  ``shipped pinned all``: with every choice of ``KINDS`` replayed (a
  replayed choice whose inputs came through other, unpinned choices is
  not the op's: a recorded amax position whose value moved under a
  flipped comparison gives that value, so the kinds are pinned together
  or not at all);
- ``fwd f64`` / ``fwd f64 pinned``: K4 replaced by its twin computed in f64
  and rounded once (the exact conv), free and with PINNED replayed;
- ``fwd twin 1e-7 noise`` / ``fwd twin 1e-7 noise pinned``: K4 replaced by
  its twin times (1 + 1e-7 z), z standard normal (seeded), the same two
  ways.

For each: the worst loss term's relative difference and the worst
gradients' differences over their max, with the parameters' names, and
per kind of choice the calls that flipped and how many elements (for a
sort also how many indices left its first SORT_HEAD). The last line is
one JSON object with every number and the card.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import tempfile

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from sessd_torch.ops.cuda import sparse_conv_train as kt
from sessd_torch.scripts.bench_f32_kernels import first_batch, write_config
from sessd_torch.scripts.profile_train import make_synthetic_root
from sessd_torch.tools.train import load as load_train_config
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils.profiling import card_line

SEED = 0
KERNELS = ("sparse_conv_fwd", "sparse_conv_dfeat", "sparse_conv_dw")
STEP_BOUNDS = (1e-4, 1e-3)  # loss terms relative, each gradient of its max
# the kinds of choice the pinned gate replays: every ReLU mask, and the
# minimum-area rectangle ODIoU's diagonal takes (``core.odiou._rect_diag``)
PINNED = ("relu", "argmin")
# a sort's leading columns whose membership ``StepPins.summary`` reports:
# the consistency loss's top-K (``ConsistencyConfig.top_k``)
SORT_HEAD = 256


def _named(*names):
    return {getattr(m, n) for n in names for m in (torch, torch.Tensor)}


def _sign(a, b):
    return (a > b).to(torch.int8) - (a < b).to(torch.int8)


def _extremum(pick_a):
    """The choice of ``torch.maximum`` (``pick_a`` where a > b) or
    ``minimum``, replayed: the recorded side, and at a recorded tie the
    mean, whose gradient is the op's (half to each side)."""
    def replay(args, kwargs, d):
        a, b = args[0], args[1]
        return torch.where(d == pick_a, a, torch.where(d == -pick_a, b,
                                                       (a + b) / 2))
    return (lambda args, kwargs, out: _sign(args[0], args[1]), replay)


def _reduce_dims(x, args, kwargs):
    dim = args[1] if len(args) > 1 else kwargs.get("dim", ())
    dim = (dim,) if isinstance(dim, int) else tuple(dim)
    keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    return (dim or tuple(range(x.dim()))), keep


def _amax_decide(args, kwargs, out):
    x = args[0]
    dim, keep = _reduce_dims(x, args, kwargs)
    return x == (out if keep else out.reshape(
        [1 if d in {i % x.dim() for i in dim} else s
         for d, s in enumerate(x.shape)]))


def _amax_replay(args, kwargs, d):
    """The elements that were the extremum, averaged: the op's value and,
    at ties, its gradient (split evenly)."""
    x = args[0]
    dim, keep = _reduce_dims(x, args, kwargs)
    w = d / d.sum(dim, keepdim=True)
    return (x * w).sum(dim, keepdim=keep)


def _clamp_min_bound(args, kwargs):
    return args[1] if len(args) > 1 else kwargs["min"]


def _no_inplace(args, kwargs):
    if kwargs.get("inplace") or (len(args) > 1 and args[1] is True):
        raise ValueError("StepPins replays out-of-place ReLUs only")


def _relu_replay(args, kwargs, d):
    _no_inplace(args, kwargs)
    return torch.where(d, args[0], 0.0)


def _head_flips(live, choice) -> int:
    """Indices among the first SORT_HEAD of each row of a sort (along its
    last dim) that are not among the recorded row's first SORT_HEAD."""
    k = min(SORT_HEAD, live.shape[-1])
    return sum(int((~torch.isin(a, b)).sum()) for a, b in zip(
        live[..., :k].reshape(-1, k), choice[..., :k].reshape(-1, k)))


def _sort_replay(args, kwargs, d):
    dim = args[1] if len(args) > 1 and isinstance(args[1], int) \
        else kwargs.get("dim", -1)
    return torch.return_types.sort((args[0].gather(dim, d), d))


# kind -> (functions, decide(args, kwargs, out) -> the choice, replay(args,
# kwargs, choice) -> the output the op gives where it makes that choice).
# Each replayed output equals the op's where the choice is the op's own,
# and so does its gradient.
KINDS = {
    "relu": ({torch.relu, F.relu, torch.Tensor.relu},
             lambda args, kwargs, out: out > 0, _relu_replay),
    "compare": (_named("gt", "lt", "ge", "le", "eq", "ne"),
                lambda args, kwargs, out: out,
                lambda args, kwargs, d: d),
    "maximum": ({torch.maximum},) + _extremum(1),
    "minimum": ({torch.minimum},) + _extremum(-1),
    "clamp_min": (_named("clamp_min"),
                  lambda args, kwargs, out: args[0] >= _clamp_min_bound(
                      args, kwargs),
                  lambda args, kwargs, d: torch.where(
                      d, args[0], _clamp_min_bound(args, kwargs))),
    "abs": (_named("abs"), lambda args, kwargs, out: torch.sign(args[0]),
            lambda args, kwargs, d: args[0] * d),
    "amax": (_named("amax", "amin"), _amax_decide, _amax_replay),
    "argmax": (_named("argmax"), lambda args, kwargs, out: out,
               lambda args, kwargs, d: d),
    "argmin": (_named("argmin"), lambda args, kwargs, out: out,
               lambda args, kwargs, d: d),
    "sort": (_named("sort"), lambda args, kwargs, out: out.indices,
             _sort_replay),
}


class _Intercept(TorchFunctionMode):
    """Routes the calls of ``funcs`` ({function: kind}) on floating-point
    inputs to ``on_call(kind, func, args, kwargs)``; every other call runs
    as it is."""

    def __init__(self, funcs, on_call):
        super().__init__()
        self.funcs, self.on_call = funcs, on_call

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self.funcs.get(func)
        if kind is None or not (args and isinstance(args[0], torch.Tensor)
                                and args[0].is_floating_point()):
            return func(*args, **kwargs)
        return self.on_call(kind, func, args, kwargs)


class StepPins:
    """The discrete choices of one training step, recorded in call order and
    replayed in another step that runs the same code: check code for the
    step-parity gates, read by nothing on the training or serving path.

    ``record()`` runs a step with every call of the functions of ``kinds``
    (KINDS; by default the step's ReLUs: ``torch.relu``, ``F.relu``, which
    ``nn.ReLU`` calls, and ``Tensor.relu``) on floating-point inputs
    recorded: for a ReLU its mask, x > 0. ``replay(pin)`` runs another
    step, matches its calls to the recorded ones in order and counts each
    call's flipped elements (``flips``); the calls of the kinds in ``pin``
    (all recorded kinds by default, none for a free reading) give the
    output of the recorded choice (a ReLU ``torch.where(mask, x, 0)``), the
    rest their own. It raises where the calls differ from the recorded
    ones in number, function or shape: no call falls through unmatched.
    """

    def __init__(self, kinds=("relu",)):
        unknown = set(kinds) - set(KINDS)
        if unknown:
            raise ValueError(f"no such kinds of choice: {sorted(unknown)}")
        self.kinds = tuple(kinds)
        self.funcs = {f: k for k in self.kinds for f in KINDS[k][0]}
        self.records = []  # (kind, function name, choice)
        # per replayed call: (kind, name, flipped, sort head flipped)
        self.flips = []

    @contextlib.contextmanager
    def record(self):
        self.records = []

        def on_call(kind, func, args, kwargs):
            out = func(*args, **kwargs)
            choice = KINDS[kind][1](args, kwargs, out)
            self.records.append((kind, func.__name__, choice.detach()))
            return out

        with _Intercept(self.funcs, on_call):
            yield self

    @contextlib.contextmanager
    def replay(self, pin=None):
        pin = set(self.kinds if pin is None else pin)
        if pin - set(self.kinds):
            raise ValueError(f"cannot pin {sorted(pin - set(self.kinds))}: "
                             f"not recorded")
        calls = iter(self.records)
        flips = []

        def on_call(kind, func, args, kwargs):
            rec = next(calls, None)
            if rec is None:
                raise ValueError(f"call {len(flips)} ({func.__name__}) was "
                                 f"not recorded: the step makes more calls "
                                 f"than the recorded {len(self.records)}")
            want_kind, name, choice = rec
            out = func(*args, **kwargs)
            live = KINDS[kind][1](args, kwargs, out)
            if (kind, func.__name__) != (want_kind, name) \
                    or live.shape != choice.shape:
                raise ValueError(f"call {len(flips)}: {func.__name__} "
                                 f"{tuple(live.shape)}, recorded {name} "
                                 f"{tuple(choice.shape)}")
            flips.append((kind, name, (live != choice).sum(),
                          _head_flips(live, choice) if kind == "sort"
                          else 0))
            return KINDS[kind][2](args, kwargs, choice) if kind in pin \
                else out

        with _Intercept(self.funcs, on_call):
            yield self
        if len(flips) != len(self.records):
            raise ValueError(f"the step made {len(flips)} of the recorded "
                             f"{len(self.records)} calls")
        self.flips = [(k, n, int(f), h) for k, n, f, h in flips]

    def summary(self) -> dict:
        """Per kind of the last replay: calls, calls with a flip, flipped
        elements (for sorts also ``head_flipped``: indices that left the
        first SORT_HEAD of a row), and the flips per call (ReLUs) or
        (call, flips) of the calls that flipped (the rest)."""
        out = {}
        for i, (kind, _, f, head) in enumerate(self.flips):
            s = out.setdefault(kind, {"calls": 0, "calls_flipped": 0,
                                      "flipped": 0, "head_flipped": 0,
                                      "per_call": []})
            s["calls"] += 1
            s["calls_flipped"] += f > 0
            s["flipped"] += f
            s["head_flipped"] += head
            if kind == "relu":
                s["per_call"].append(f)
            elif f:
                s["per_call"].append((i, f))
        return out


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


def twins():
    """The step's sparse convs through their plain twins."""
    return swapped(**{n: getattr(kt, n + "_ref") for n in KERNELS})


def step(trainer, db, *ctxs):
    """One train_step from a copy of the trainer's state under ``ctxs``:
    (metrics, {parameter: gradient})."""
    state = copy.deepcopy(trainer.state)
    state.optimizer.params = list(state.student.parameters())
    names = [n for n, _ in state.student.named_parameters()]
    grads = {}
    apply = state.optimizer.step

    def capture(gs):
        grads.update(zip(names, [g.detach().clone() for g in gs]))
        return apply(gs)

    state.optimizer.step = capture
    with contextlib.ExitStack() as stack:
        for ctx in ctxs:
            stack.enter_context(ctx)
        metrics = trainer.train_step(state, db, 0.5)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, grads


def compare(kernel, twin) -> dict:
    """The worst loss term's relative difference and the worst gradients'
    differences over their max (a gradient that is zero in the twin must
    be zero in the kernel step); ``ok`` where both are within
    STEP_BOUNDS."""
    (mk, gk), (mt, gt) = kernel, twin
    terms = sorted(((abs(mk[k] - v) / (abs(v) + 1e-6), k)
                    for k, v in mt.items()), reverse=True)
    grads = []
    for name, g in gt.items():
        peak = float(g.abs().max())
        err = float((gk[name] - g).abs().max())
        if peak > 0 or err > 0:
            grads.append((err / peak if peak > 0 else float("inf"), name))
    grads.sort(reverse=True)
    return {"loss_term_rel": terms[0][0], "loss_term": terms[0][1],
            "gradient_rel": grads[0][0], "gradient": grads[0][1],
            "next_gradients": grads[1:4],
            "ok": terms[0][0] <= STEP_BOUNDS[0]
            and grads[0][0] <= STEP_BOUNDS[1]}


def describe(r: dict) -> str:
    return (f"loss terms {r['loss_term_rel']:.2e} ({r['loss_term']}), "
            f"gradients {r['gradient_rel']:.2e} of their max "
            f"({r['gradient']}); next "
            + ", ".join(f"{n} {v:.2e}" for v, n in r["next_gradients"]))


def variants(gen):
    """(name, kernel-side swaps, kinds pinned: None all, () none)."""
    def f64(x, rb, w, mask=None):
        return kt.sparse_conv_fwd_ref(x.double(), rb, w.double(),
                                      mask).float()

    def noisy(x, rb, w, mask=None):
        y = kt.sparse_conv_fwd_ref(x, rb, w, mask)
        return y * (1 + 1e-7 * torch.randn(y.shape, device=y.device,
                                           generator=gen))

    twin = {n: getattr(kt, n + "_ref") for n in KERNELS}
    relu = ("relu",)
    return [("twin again", twin, ()),
            ("twin again pinned", twin, PINNED),
            ("shipped", {}, ()),
            ("shipped pinned relu", {}, relu),
            ("shipped pinned relu sort argmax", {},
             ("relu", "sort", "argmax")),
            ("shipped pinned", {}, PINNED),
            ("shipped pinned all", {}, None),
            ("fwd f64", {"sparse_conv_fwd": f64}, ()),
            ("fwd f64 pinned", {"sparse_conv_fwd": f64}, PINNED),
            ("fwd twin 1e-7 noise", {"sparse_conv_fwd": noisy}, ()),
            ("fwd twin 1e-7 noise pinned", {"sparse_conv_fwd": noisy},
             PINNED)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--repeats", type=int, default=1,
                    help="twin steps recorded, each compared with every "
                         "variant")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="run only these variants (by name)")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms in every step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_step_parity needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.deterministic
    card = card_line()
    gen = torch.Generator(device="cuda")
    result = {"card": card, "deterministic": args.deterministic,
              "repeats": []}
    with tempfile.TemporaryDirectory(prefix="probe_parity_") as tmp:
        root = f"{tmp}/kitti"
        make_synthetic_root(root, num_frames=8, num_cars=10)
        cfg = load_train_config(write_config(f"{tmp}/work.py"), root)
        trainer = Trainer(cfg, work_dir=f"{tmp}/work", seed=SEED,
                          device="cuda")
        db = first_batch(trainer)
        todo = [v for v in variants(gen)
                if args.variants is None or v[0] in args.variants]
        for rep in range(args.repeats):
            pins = StepPins(tuple(KINDS))
            with pins.record():
                twin = step(trainer, db, twins())
            counts = {}
            for kind, _, _ in pins.records:
                counts[kind] = counts.get(kind, 0) + 1
            print(f"twin step {rep}: {len(pins.records)} choices recorded "
                  f"{counts}")
            result["repeats"].append({})
            for name, fns, pin in todo:
                gen.manual_seed(SEED)
                r = compare(step(trainer, db, swapped(**fns),
                                 pins.replay(pin)), twin)
                r["pinned"] = sorted(pins.kinds if pin is None else pin)
                r["flips"] = pins.summary()
                result["repeats"][-1][name] = r
                flipped = "; ".join(
                    f"{k} {s['flipped']} in {s['calls_flipped']}/"
                    f"{s['calls']} calls" + (
                        f" ({s['head_flipped']} of the top {SORT_HEAD})"
                        if k == "sort" else "")
                    for k, s in r["flips"].items() if s["flipped"])
                relu = r["flips"].get("relu", {}).get("per_call", [])
                print(f"[{rep}] {name} (pinned: "
                      f"{', '.join(r['pinned']) or 'none'}): {describe(r)}; "
                      f"gate {'passes' if r['ok'] else 'fails'}; flips: "
                      f"{flipped or 'none'}; ReLU flips per call {relu} "
                      f"[{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
