"""Device time per launch of the sparse-conv kernels on the reference
config's f32 paths (``se_ssd_kitti_car.py``, ``precision = "float32"``),
on one CUDA device.

    python -m sessd_torch.scripts.bench_f32_kernels
    PYTHONPATH=OTHER_TREE python sessd_torch/scripts/bench_f32_kernels.py

A Trainer of the f32 config at the acceptance recipe's stage caps on a
synthetic KITTI root of 8 ray-cast frames (``profile_train.
make_synthetic_root``), seeded random weights:

- its first training batch (batch 4, the loader's int32 chains): the
  student's 10 convs and the teacher's 14, each conv's input the ReLU of
  the previous forward (``chip_smoke.py`` phase 4's chains). K4
  (``sparse_conv_fwd``) on all 24, the step's dFeat (``sparse_conv_dfeat``,
  the student's convs after the first: 9) and dW (``sparse_conv_dw``, the
  student's 10), each with its plain twin on the same calls;
- its first val batch on host chains (batch 4): K1 (``fused_sparse_conv``)
  on the convs the stream rule keeps resident and K3
  (``fused_sparse_conv_stream``) on the others, with their twin on the
  same calls;
- the first conv (4 -> 16, the direct body) of that training batch in f32
  and in bf16: K4 on both chains, dFeat (16 -> 4, the voxel features'
  gradient, off the step's path) and dW on the student's, each with its
  twin and its bound; dW also with the share of rows each tap hits and
  its time at chunks of 1024 and 512 rows (DW_CHUNK_SWEEP) besides
  DW_CHUNK_ROWS.

Every time is a device time (``queued_device_ms``, the median of 20). Per
kernel: the mean ms per launch over its convs (and over those with 16-64
channels apart), the bound per launch (each
input read and each output written once over 3.35 TB/s, against 2 x hits x
Cin x Cout flops over 67 TFLOP/s on the direct body, or three times those
flops over TF32's 494.7 TFLOP/s on a 3xTF32 body, the larger; the body as
``conv_instance`` names it in the tree under test; dW's also with its f32
partials written and read back), and its launches per
f32 path: a training step (24 K4, 9 dFeat, 10 dW), an eval batch on device
chains (the student's 10 K4) and an eval batch on host chains (the K1 and
K3 the stream rule gives). The second form times another tree's kernels
with this script (its imports are absolute), so two trees compare in
turns on one card, and where two runs print the same ``dw_sha256`` (a
digest of every student conv's dW, in f32 and on the same inputs in bf16)
their dW bits are the same. The last line is one JSON object with every
number and the card.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import json
import re
import tempfile

import numpy as np
import torch

from sessd_torch import builder
from sessd_torch.models.backbone import PLAN, pick_conv
from sessd_torch.ops import sparse as sp
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from sessd_torch.scripts import acceptance_ap
from sessd_torch.scripts.profile_train import make_synthetic_root
from sessd_torch.tools.train import load as load_train_config
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils.profiling import card_line, queued_device_ms

CONFIG = "se_ssd_kitti_car.py"
REPS = 20
SEED = 0
HBM_BYTES_PER_S = 3.35e12
DW_CHUNK_SWEEP = (1024, 512)  # conv 0's dW besides DW_CHUNK_ROWS
# the card's published dense rates (H100 SXM data sheet, at 700 W): f32 on
# the CUDA cores, and TF32 on the tensor cores, which a 3xTF32 body runs
# three times over
F32_FLOPS = 67e12
TF32_FLOPS = 494.7e12
BF16_FLOPS = 989e12
TF32_PASSES = 3
ACCEPT_CAPS = ast.literal_eval(re.search(
    r"^stage_capacity = (\(.*\))$", acceptance_ap.CONFIG, re.M).group(1))
# (rulebook kind, chain index, output stage) of each backbone conv in order
CONV_CHAIN = [c for stage, (_, n_subm, dk, _, _) in enumerate(PLAN)
              for c in ([("down", stage - 1, stage)] if dk else [])
              + [("subm", stage, stage)] * n_subm]


def bound_ms(tensors, hits: int, cin: int, cout: int, body: str,
             extra_bytes: int = 0, dtype=torch.float32) -> dict:
    """The least device ms of one launch: its bytes (the tensors' and
    ``extra_bytes``) over the memory rate against its flops over the rate
    of its body (f32 on the CUDA cores, in either type for a body off the
    tensor cores; three TF32 passes for "tf32"; the bf16 peak for a bf16
    tensor-core body), and which of the two."""
    moved = sum(t.numel() * t.element_size() for t in tensors) + extra_bytes
    flops = 2 * hits * cin * cout
    if body == "tf32":
        op_s = TF32_PASSES * flops / TF32_FLOPS
    elif body == "mma" and dtype == torch.bfloat16:
        op_s = flops / BF16_FLOPS
    else:
        op_s = flops / F32_FLOPS
    secs = {"bytes": moved / HBM_BYTES_PER_S, "operations": op_s}
    by = max(secs, key=secs.get)
    return {"ms": secs[by] * 1e3, "by": by}


class Rows:
    """Per-conv records of one kernel; ``summary`` averages them per
    launch."""

    def __init__(self):
        self.rows = []

    def add(self, **row):
        self.rows.append(row)
        return row

    def summary(self) -> dict:
        n = len(self.rows)
        out = {"convs": n}
        for key in ("ms", "plain_ms", "bound_ms", "bound_with_partials_ms"):
            vals = [r[key] for r in self.rows if r.get(key) is not None]
            out[key] = sum(vals) / len(vals) if len(vals) == n else None
        out["bound_by"] = sorted({r["bound_by"] for r in self.rows})
        out["body"] = sorted({r["body"] for r in self.rows})
        # the convs with 16-64 channels on both sides, apart from the first
        # conv's 4-channel side
        wide = [r for r in self.rows if 4 not in (r["cin"], r["cout"])]
        out["wide_convs"] = len(wide)
        out["wide_ms"] = sum(r["ms"] for r in wide) / len(wide) \
            if wide else None
        return out


def write_config(path: str) -> str:
    with open(path, "w") as f:
        f.write(f"__file__ = {str(builder.CONFIG_DIR / CONFIG)!r}\n"
                "exec(compile(open(__file__).read(), __file__, 'exec'))\n"
                f"stage_capacity = {ACCEPT_CAPS!r}\n")
    return path


def first(loader):
    batches = iter(loader)
    try:
        return next(batches)
    finally:
        batches.close()


def first_batch(trainer):
    """The loader's first training batch on the device, through the
    saturation guard (as ``chip_smoke.py`` stages it)."""
    batch = first(trainer.train_loader)
    trainer._check_train_saturation(batch)
    return trainer._device_batch(batch)


def conv_inputs(model, db, sfx):
    """The first conv's input of one chain: the reader's features in the
    chain's row order, zero on padding rows."""
    rb = db["inputs" + sfx]
    vox = db["voxels" + sfx]
    b, v = vox.shape[:2]
    feats = model.reader(vox.reshape(b * v, *vox.shape[2:]),
                         db["num_points" + sfx].reshape(b * v))
    x = feats[rb["perm"].long()]
    return rb, torch.where((rb["ids"][0] < sp.SENTINEL)[:, None], x, 0.0)


def time_train(trainer, db, records, dw_outputs):
    """K4 on both chains, dFeat and dW on the student's. Each student
    conv's dW, in f32 and on the same inputs in bf16, goes into
    ``dw_outputs`` (for ``digest``)."""
    model = trainer.state.student
    blocks = model.backbone.blocks()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for plan, sfx, n in (("student", "", 10), ("teacher", "_raw", 14)):
        rb, x = conv_inputs(model, db, sfx)
        for i in range(n):
            conv = blocks[i][0]
            kind, idx, out_stage = CONV_CHAIN[i]
            rbk = rb[kind][idx]
            mask = rb["ids"][out_stage] < sp.SENTINEL
            w = conv.weight.detach().reshape(
                -1, *conv.weight.shape[-2:]).float().contiguous()
            cin, cout = w.shape[1], w.shape[2]
            n_hits = int((rbk != x.shape[0]).sum())
            y = kt.sparse_conv_fwd(x, rbk, w, mask)
            body = sc.conv_instance("sparse_conv_fwd", torch.float32, cin,
                                    cout)
            row = records["fwd"].add(
                plan=plan, conv=i, cin=cin, cout=cout, rows=rbk.shape[0],
                body=body,
                ms=queued_device_ms(lambda: kt.sparse_conv_fwd(x, rbk, w,
                                                               mask), REPS),
                plain_ms=queued_device_ms(
                    lambda: kt.sparse_conv_fwd_ref(x, rbk, w, mask), REPS),
                **_bound(bound_ms((x, rbk, w, mask, y), n_hits, cin, cout,
                                  body)))
            line = _line("fwd", row)
            if plan == "student":
                dout = torch.randn(rbk.shape[0], cout, device="cuda",
                                   generator=gen)
                dout = torch.where(mask[:, None], dout, 0.0)
                if i > 0:  # the step's input gradients: not the voxels'
                    inv = sp.inverse_rulebook(rbk, x.shape[0])
                    body = sc.conv_instance("sparse_conv_dfeat",
                                            torch.float32, cout, cin)
                    got = kt.sparse_conv_dfeat(dout, inv, w)
                    row = records["dfeat"].add(
                        plan=plan, conv=i, cin=cout, cout=cin,
                        rows=inv.shape[0], body=body,
                        ms=queued_device_ms(
                            lambda: kt.sparse_conv_dfeat(dout, inv, w), REPS),
                        plain_ms=queued_device_ms(
                            lambda: kt.sparse_conv_dfeat_ref(dout, inv, w),
                            REPS),
                        **_bound(bound_ms((dout, inv, w, got), n_hits, cout,
                                          cin, body)))
                    line += _line("dfeat", row)
                body = sc.conv_instance("sparse_conv_dw", torch.float32,
                                        cin, cout)
                got = kt.sparse_conv_dw(x, rbk, dout)
                dw_outputs[f"conv {i} float32"] = got
                dw_outputs[f"conv {i} bfloat16"] = kt.sparse_conv_dw(
                    x.bfloat16(), rbk, dout.bfloat16())
                chunks = -(-rbk.shape[0] // kt.DW_CHUNK_ROWS)
                partials = 2 * chunks * rbk.shape[1] * cin * cout * 4
                row = records["dw"].add(
                    plan=plan, conv=i, cin=cin, cout=cout, rows=rbk.shape[0],
                    body=body,
                    ms=queued_device_ms(lambda: kt.sparse_conv_dw(x, rbk,
                                                                  dout), REPS),
                    plain_ms=queued_device_ms(
                        lambda: kt.sparse_conv_dw_ref(x, rbk, dout), REPS),
                    bound_with_partials_ms=bound_ms(
                        (x, rbk, dout, got), n_hits, cin, cout, body,
                        partials)["ms"],
                    **_bound(bound_ms((x, rbk, dout, got), n_hits, cin, cout,
                                      body)))
                line += _line("dw", row)
            print(f"{plan} conv {i:2d} {cin:2d}->{cout:2d} rows "
                  f"{rbk.shape[0]:6d}:{line}")
            x = torch.relu(y)


def time_conv0(trainer, db, records):
    """The first conv of the training batch in f32 and bf16: K4 on both
    chains, dFeat (16 -> 4) and dW on the student's, each with its twin
    and its bound; dW with each tap's hit share and its chunk sweep."""
    model = trainer.state.student
    conv = model.backbone.blocks()[0][0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        w = conv.weight.detach().reshape(
            -1, *conv.weight.shape[-2:]).to(dtype).contiguous()
        cin, cout = w.shape[1], w.shape[2]
        for plan, sfx in (("student", ""), ("teacher", "_raw")):
            rb, x = conv_inputs(model, db, sfx)
            x = x.to(dtype)
            kind, idx, out_stage = CONV_CHAIN[0]
            rbk = rb[kind][idx]
            mask = rb["ids"][out_stage] < sp.SENTINEL
            n_hits = int((rbk != x.shape[0]).sum())
            calls = [("fwd", cin, cout, (x, rbk, w, mask),
                      lambda: kt.sparse_conv_fwd(x, rbk, w, mask),
                      lambda: kt.sparse_conv_fwd_ref(x, rbk, w, mask))]
            if plan == "student":
                dout = torch.randn(rbk.shape[0], cout, device="cuda",
                                   generator=gen)
                dout = torch.where(mask[:, None], dout, 0.0).to(dtype)
                inv = sp.inverse_rulebook(rbk, x.shape[0])
                calls += [
                    ("dfeat", cout, cin, (dout, inv, w),
                     lambda: kt.sparse_conv_dfeat(dout, inv, w),
                     lambda: kt.sparse_conv_dfeat_ref(dout, inv, w)),
                    ("dw", cin, cout, (x, rbk, dout),
                     lambda: kt.sparse_conv_dw(x, rbk, dout),
                     lambda: kt.sparse_conv_dw_ref(x, rbk, dout))]
            line = ""
            for kernel, a, b, ins, kern, twin in calls:
                got = kern()
                body = sc.conv_instance(f"sparse_conv_{kernel}", dtype, a, b)
                row = records[f"{kernel} conv0 {name}"].add(
                    plan=plan, conv=0, cin=a, cout=b, rows=rbk.shape[0],
                    body=body, ms=queued_device_ms(kern, REPS),
                    plain_ms=queued_device_ms(twin, REPS),
                    **_bound(bound_ms(ins + (got,), n_hits, a, b, body,
                                      dtype=dtype)))
                if kernel == "dw":
                    row["tap_hit_share"] = (
                        rbk != x.shape[0]).float().mean(0).tolist()
                    row["chunk_sweep"] = {
                        c: queued_device_ms(
                            lambda c=c: kt.sparse_conv_dw(x, rbk, dout, c),
                            REPS)
                        for c in DW_CHUNK_SWEEP}
                line += _line(kernel, row)
            print(f"conv 0 {name} {plan} rows {rbk.shape[0]:6d}:{line}")


def digest(tensors: dict) -> str:
    """sha256 of the names and bytes of ``tensors`` in order."""
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def _bound(b: dict) -> dict:
    return {"bound_ms": b["ms"], "bound_by": b["by"]}


def _line(name, row) -> str:
    more = ""
    if "tap_hit_share" in row:
        share = row["tap_hit_share"]
        more += (f", hit share per tap "
                 f"{[round(h, 3) for h in share]} (all taps "
                 f"{sum(share) / len(share):.4f})")
    for c, ms in row.get("chunk_sweep", {}).items():
        more += f", at {c}-row chunks {ms:.4f}"
    return (f" {name} [{row['body']}] {row['ms']:.4f} ms{more}, twin "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']});")


def time_eval(trainer, records):
    """K1 and K3 on the first val batch's host chains, as validate() runs
    them (the stream rule at the trainer's caps)."""
    batch = first(trainer.val_loader)
    host_rb = trainer._eval_inputs(batch)
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    rb = {k: [put(a) for a in x] if isinstance(x, list) else put(x)
          for k, x in host_rb.items()}
    vox = batch["voxels"]
    b, v = vox.shape[:2]
    model = trainer.state.student
    step = iter(range(14))

    def conv(x, rbk, w2, bias, n_in):
        i = next(step)
        fn = pick_conv(x.shape[1], n_in, torch.float32)
        name = "k3" if fn is sc.fused_sparse_conv_stream else "k1"
        args = (x, rbk, w2, bias, n_in)
        y = fn(*args)
        cin, cout = x.shape[1], w2.shape[2]
        body = sc.conv_instance(fn.__name__, torch.float32, cin, cout)
        row = records[name].add(
            conv=i, cin=cin, cout=cout, rows=rbk.shape[0], body=body,
            ms=queued_device_ms(lambda: fn(*args), REPS),
            plain_ms=queued_device_ms(
                lambda: sc.fused_sparse_conv_ref(*args), REPS),
            **_bound(bound_ms((x, rbk, w2, bias, y), int((rbk != n_in).sum()),
                              cin, cout, body)))
        print(f"eval conv {i:2d} {cin:2d}->{cout:2d} rows "
              f"{rbk.shape[0]:6d}:{_line(name, row)}")
        return y

    with torch.inference_mode():
        feats = model.reader(put(vox).reshape(b * v, *vox.shape[2:]),
                             put(batch["num_points"]).reshape(b * v))
        model.backbone(feats, rb, b, model.sparse_shape, torch.float32,
                       conv=conv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_f32_kernels needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    records = {k: Rows() for k in ("fwd", "dfeat", "dw", "k1", "k3")}
    records.update({f"{k} conv0 {t}": Rows() for k in ("fwd", "dfeat", "dw")
                    for t in ("float32", "bfloat16")})
    dw_outputs = {}
    with tempfile.TemporaryDirectory(prefix="bench_f32_") as tmp:
        root = f"{tmp}/kitti"
        make_synthetic_root(root, num_frames=8, num_cars=10)
        work = f"{tmp}/work"
        cfg = load_train_config(write_config(f"{work}.py"), root)
        trainer = Trainer(cfg, work_dir=work, seed=SEED, device="cuda")
        if cfg.get("precision") != "float32":
            raise SystemExit(f"{CONFIG} is not the f32 config")
        db = first_batch(trainer)
        with torch.no_grad():
            time_train(trainer, db, records, dw_outputs)
            time_conv0(trainer, db, records)
        time_eval(trainer, records)
    summary = {k: r.summary() for k, r in records.items()}
    launches = {"train_step": {"fwd": 24, "dfeat": 9, "dw": 10},
                "eval_device_chains": {"fwd": 10},
                "eval_host_chains": {"k1": summary["k1"]["convs"],
                                     "k3": summary["k3"]["convs"]}}
    for k, s in summary.items():
        more = ""
        if s["bound_with_partials_ms"] is not None:
            more += f", bound with partials {s['bound_with_partials_ms']:.4f}"
        if s["wide_ms"] is not None and s["wide_convs"] < s["convs"]:
            more += (f"; over its {s['wide_convs']} convs of 16-64 channels "
                     f"{s['wide_ms']:.4f}")
        print(f"f32 {k}: {s['convs']} convs, {s['body']}, per launch "
              f"{s['ms']:.4f} ms{more}, twin {s['plain_ms']:.4f}, bound "
              f"{s['bound_ms']:.4f} ({', '.join(s['bound_by'])}) [{card}]")
    dw_sha256 = digest(dw_outputs)
    print(f"dW outputs: {len(dw_outputs)} (each student conv, f32 and "
          f"bf16), sha256 {dw_sha256} [{card}]")
    result = {"card": card, "summary": summary, "launches": launches,
              "dw_sha256": dw_sha256,
              "convs": {k: r.rows for k, r in records.items()}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"card": card, "summary": summary,
                      "launches": launches, "dw_sha256": dw_sha256}))


if __name__ == "__main__":
    main()
