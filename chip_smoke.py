"""Smoke check of the PyTorch/CUDA port (``sessd_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases, each printing its own lines; any failure exits non-zero:
1. The card (``nvidia-smi`` name and power limit) and the build of the CUDA
   kernels from ``sessd_torch/csrc`` (one nvcc per source, in parallel,
   into ``build/sessd_torch/``), with the body and blocks per SM of each
   training tile instance (``kt.blocks_per_sm``), and the body, blocks per
   SM, registers and spill stores of each dW partial-kernel and K3
   instance (``instance_resources`` on the build's ptxas log).
2. The fused sparse conv kernel (K1) against its plain PyTorch twin on the
   card, for every one of the 14 backbone convs on the features the
   previous conv produced, at full KITTI width (sparse shape (41, 1600,
   1408), SERVING_CAPS, a ray-cast scene): f32 (TF32 off, bound 1e-4 of
   max|twin|) and bf16 (bound 2e-2), batch 1 on int16 rulebooks and batch 4
   on int32 ones. Per-conv times are device times (``median_ms``:
   CUDA-event medians of 20 launches, each queued behind a device spin).
   Each batch-1 bf16 conv also prints its body ("mma": the tensor-core tile
   of ``csrc/gather_mma.cuh``), the cluster size S its launch took, the
   count of 64-row tiles with a hit and, where S > 1, its time at one CTA
   per tile and its distance from that result. The first conv (4 -> 16,
   ``csrc/gather_direct.cuh``'s direct body) must give the same bits on two
   runs in both types at both batches, and prints its time beside the
   twin's and its bound.
   The streaming kernel (K3) against its twin and against K1 on every conv
   that streams in one bf16 batch-8 request at SERVING_CAPS (stages 1-2),
   equal to K1 bit for bit where K1 runs one CTA per tile, with K3, K1 and
   twin times and the share of (tile, tap) pairs no row hits, which the
   tile skips, per conv.
3. End-to-end serving through ``sessd_torch.serve.ExactBatchServer``: the
   SE-SSD Car VoxelNet (sessd_torch/configs/se_ssd_kitti_car_bf16.py, seeded
   random weights, 70,400 anchors) serves 12 batch-1 requests and one
   batch-4 request with the cls bias at the focal prior, then one batch-1
   request without it, all through K1; then batch-8 serving, 6 requests of
   eight scans, through K1 and K3 by the stream rule (p50 and scenes/s).
   Checks: finite outputs of the expected shapes, the launch counts per
   request, and the head outputs of the kernel path equal to the twin
   path's (f32, TF32 off) to 1e-3 of the max at batch 1 and batch 8.
4. The training kernels against their twins: the forward (K4), input
   gradient and weight gradient (K5) of every sparse conv of both training
   plans (student: 10 convs on the augmented chain; teacher: 14 on the raw
   chain; the input gradient of the first conv too, 16 -> 4 on the direct
   body in both types, timed apart from the sums), full width, batch 4,
   the loader's int32 chains from a synthetic
   KITTI root (``sessd_torch.utils.kitti_synth``) at the acceptance
   recipe's stage caps (ACCEPT_CAPS). Each conv takes the features the
   previous one produced. Bounds: f32 1e-4 of max|twin| (1e-3 for the
   weight gradient, a reduction over all rows), bf16 2e-2; dW gives the
   same bits on two runs. Each conv's K4, dFeat and dW body is checked:
   the tensor-core ones in bf16, in f32 through 3xTF32, and the direct
   ones for the first conv's 4-channel side, which must give the same
   bits on two runs (K4 on both chains, dFeat 16 -> 4 and dW on the
   student's) and are timed beside their twins. In both types one K4 call
   and one dFeat call each make one launch and one allocation, their
   output (no copy or packing of the weights). Kernel and twin
   device-time medians per conv (bf16, student chain; f32: K4 on both
   chains, dFeat and dW on the student's, printed per launch, dW's bound
   also with its partials); for the bf16 forward also the share of
   (tile, tap) pairs skipped; for the input gradient the share of (tile,
   tap) pairs of the inverse rulebook skipped and the share of gathered
   rows zero-filled; for dW the shares of (chunk, tap) and (step, tap)
   pairs skipped, the f32 partials' bytes, and its time at each chunk size
   of DW_CHUNK_SWEEP.
5. Training through ``sessd_torch.train.trainer.Trainer`` (bf16 config,
   batch 4, SSL on, ACCEPT_CAPS, packed batches as every Trainer here:
   ``data.pack_targets`` is on by default) for 6 steps: every loss term and the
   gradient norm finite, the student moved, the teacher equal to the EMA
   formula on the last step, exactly 24 forward, 9 input-gradient and 10
   weight-gradient launches per step, and no batch that saturated a stage.
   Prints the step-time median, the data-time share and the peak device
   memory.
6. One f32 step (TF32 off) on one batch through the kernels, K4 through
   its plain twin (``kt.sparse_conv_fwd_ref``: the twin step's forward and
   ReLU masks), and, from an identical state, through their twins: loss
   terms within 1e-4 relative, each gradient tensor within 1e-3 of its
   max. It holds the step's wiring and the 3xTF32 dFeat and dW.
   Before it, from copies of the same fresh state, the shipped path (K4
   through 3xTF32) against the twins: the twin step records its choices of
   ``probe_step_parity.PINNED`` (every ReLU mask, student and teacher,
   and the minimum-area rectangle ODIoU's diagonal takes) and the kernel
   step replays them (``StepPins``), held to the same bounds; the free
   reading (no replay) and the flipped ReLU elements per call are
   printed, not gated. Any change of the forward's rounding flips a few
   ReLU elements, each of which moves a weight gradient by ~1/sqrt(rows)
   of its max, and now and then an ODIoU rectangle near a tie in area.
7. Evaluation on that f32 trainer: K3 and K1 (both 3xTF32 at one CTA per
   tile) against their twin within 1e-4, bit-equal to each other and to
   f32 K4 with their epilogue, on the convs that stream in one batch-4
   eval batch at ACCEPT_CAPS (derived from the stream rule at those caps),
   timed with K1 and the twin on the same calls, with no stage
   saturated; and K1 on the convs it runs there within 1e-4 of its twin
   and, on the 3xTF32 tile, bit-equal to K4 with the epilogue (on the
   first conv's direct body, the same bits on two runs), timed with its
   twin (f32 per-launch times);
   ``Trainer.validate()`` over the val split (the same 8 frames), with the
   K1 and K3 launches per batch the rule gives; ``save_checkpoint``; then
   ``python -m sessd_torch.tools.test`` in a subprocess on that checkpoint
   and the config at the same caps, which must give the same AP tables and
   write ``--out``.
8. Ablation: the micro-benchmark kernels through their scripts, the main
   path of these kernels: S1 (``sessd_torch.scripts.bench_sparse_conv_ablate``,
   the conv tiles with one cost removed at a time, per-variant ms: the
   scalar tile's copy and the tensor-core tile on the 16 -> 16 input, and
   the tensor-core tile's modes on three batch-1 convs, subm0b, subm3a and
   down3, beside K1 at one, two and four CTAs per tile) and S2
   (``sessd_torch.scripts.bench_launch_overhead``, the empty launch: host
   and device us per launch, through Python and from one C call, and the
   ``sparse_conv_fwd`` wrapper against its bare launches). Then S1's scalar
   ``full`` mode must equal the scalar tile's in-order f32 sum
   (``ablate.scalar_tile_sum``) bit for bit, its tensor-core ``full`` mode
   bf16 K4 without a mask bit for bit (on both shapes), every mode must match its plain version within
   2e-2 of max|plain| (exactly zero where it stores zeros), and S2's output
   must be all zeros.
9. Warm start and resume on the 8-frame root: a CIA-SSD bf16 trainer runs
   one epoch (2 steps) and checkpoints; an SE-SSD bf16 trainer's
   ``load_from`` must give teacher = student = the CIA student, the CIA
   moments, a restarted schedule (``sched_count`` 0, ``count`` 2) and step
   0, then trains one epoch (2 finite steps); a third trainer's
   ``resume()`` from that work dir must restore epoch, step, both counts
   and every tensor exactly. Neither training run may saturate a stage.
10. Acceptance path: ``python -m sessd_torch.scripts.acceptance_ap 8 4 1 1
   1 --out ...`` in a subprocess must write a record with the floor, each
   stage's AP trajectory and a finite AP (the path, not the AP, is
   checked).
11. Pillars serving (after phase 3's head parity): PointPillars
   (``point_pillars_kitti_car.py``, full width: 12,000 pillars x 100
   points, the 496 x 432 grid, RPN 3/5/5 blocks at 64/128/256, 107,136
   anchors; seeded random weights) in bf16 at batch 1 through
   ``serve.PillarPreprocessor`` and ``make_pillar_infer_fn`` on
   ``make_scene(0-3)``: host prep ms, p50 and p90, and one request split
   by stage on the host clock (H2D, PFN, scatter, RPN, head, predict);
   then with the cls bias at 0 (valid detections > 0), and the f32 model's
   head outputs on the card against its run on the CPU within 1e-3 of the
   max, with as many valid detections (> 0) as the CPU's run and the CPU's
   decode of the card's head outputs. No sparse kernel launches.
12. DI-NMS: one batch-1 SE-SSD Car request (f32) decoded on the card with
   ``nms_type="rotate_weighted_nms"``, the cls bias at 0, the IoU head's at
   1 and the box head scaled by BOX_SCALE; ``rotate_weighted_nms`` on the
   decoded boxes against the host oracle ``core/nms_np.py`` on the same
   boxes: the same leaders kept (> 0, up to nms_post_max_size), boxes
   within 1e-4 and scores within 1e-5. The request launches K1 and K3 as
   the stream rule gives; they join the kernels line's counts.
13. Pillars training (after phase 10): a PointPillars Trainer (bf16, batch
   2, no rulebooks, no sparse kernel launched) takes one epoch of 4 steps
   on the 8-frame root and validates; ``tools.test`` on its checkpoint must
   give the same AP tables. Step median, data-time share, peak memory.
14. 3-class: a bf16 Trainer of ``se_ssd_kitti_3class.py`` (supervised, 6
   anchors per location, 211,200 anchors) at ACCEPT_CAPS takes 4 steps at
   batch 4 with exactly 10 K4, 9 dFeat and 10 dW launches per step and no
   saturated batch; an f32 Trainer resumes its checkpoint and runs
   ``validate()`` with the K1 and K3 launches per batch the stream rule
   gives and ``cls_preds`` [4, 211200, 3]. Its launches join the K1, K3,
   K4 and K5 counts of the kernels line.
15. Data parallel: two ranks, each a process of its own
   (``chip_smoke.py --rank-worker``, ``rank_worker``) running
   ``sessd_torch.tools.train`` with ``--coordinator 127.0.0.1:<free port>
   --num-processes 2 --dist-backend gloo --device cuda:0`` (NCCL refuses
   two ranks on one card): the bf16 SE-SSD Car config at ACCEPT_CAPS, 4
   scenes per rank, one step per rank in each of DP_EPOCHS epochs of the
   8-frame root, a checkpoint per epoch, the final validation over the
   ranks. Fails unless both ranks exit 0 with DP_EPOCHS finite steps,
   equal losses, no saturated batch and bit-equal final states (a sha256
   per rank over both nets and the optimizer's moments), rank 0 alone
   wrote checkpoints and ``eval_results.json`` (each rank has its own
   work dir), the first masked BatchNorm's synced moments equal those of
   both ranks' masked rows gathered within 1e-5 of their max, and each
   rank launched 24 K4, 9 dFeat and 10 dW per step, as phase 5. Prints
   per rank the step median, peak device memory, losses, launches and
   collectives per step, beside the card line. Two ranks that share one
   card through gloo say nothing of scaling over cards.
16. Data parallel NCCL: a Trainer in a process group of one rank over NCCL
   and one outside any group, f32, NCCL_STEPS steps, each from the outside
   trainer's state before it: loss terms within 1e-4 relative, the same
   launches, one gradient bucket per step.
17. Multi-process eval: two ranks of ``tools.test --coordinator`` (gloo,
   cuda:0) on phase 15's checkpoint: rank 0's AP tables equal one
   process's ``tools.test`` of it entry for entry, rank 1 prints and
   writes none, each rank launches the K1 and K3 the stream rule gives
   for its batches. The launches of phases 15-17 (every rank's) join the
   kernels line.
18. Device inputs (after phase 7): the voxelizer and the rulebook chain on
   the card. ``build_device_chain`` equals HostPreprocessor's C++ chain
   (dtype, shape, values) on the same coords for ``make_scene(0-7)`` at
   batch 1 and in 8 batches of 8 at SERVING_CAPS (int32 at batch 8, its
   stage-0 lookups by binary search). Batch-1 ``make_points_infer_fn``
   (points on the card -> ``voxelize_torch`` -> VFE -> chain -> K1 ->
   neck, head, predict) against ``make_infer_fn`` on host prep, same
   weights, on the scenes whose voxels fit ``max_voxels`` (those over it
   are printed: the card keeps the lowest ids, the host the first seen):
   head outputs within 1e-3 (f32) and 2e-2 (bf16) of the max, and in f32
   with the cls bias at 0 the same detections; bf16 p50/p90 over 16
   requests (14 K1 each), the device prep ms (CUDA events) and the host
   prep ms per scene; voxelize, chain and backbone under
   ``torch.cuda.set_sync_debug_mode("error")``. A bf16 batch-4 Trainer
   with ``data.host_rulebooks=False`` at ACCEPT_CAPS: its first step on
   device chains against the same step on the host chains from the same
   state, loss terms within 1e-4 relative; then DEVICE_STEPS steps with
   24/9/10 K4/dFeat/dW launches each, finite, no saturated batch, and the
   device chains of every batch it trained on (student and teacher) equal
   to its host chains; step median and peak memory; then one training
   forward and backward on a batch-1 int16 device chain and on its int32
   copy: outputs, the voxels' gradient (10 dFeat launches, the first
   conv's 16 -> 4 among them) and the weight gradients bit-equal. An f32
   Trainer with
   the key off: the hybrid eval plan's head outputs (K4 + cuDNN) within
   1e-3 of the host chain's all-sparse plan on val batch 0, then
   ``validate()`` with 10 K4 launches per batch and no K1. Then
   ``tools.get_flops`` (SE-SSD Car, 16000 voxels) and
   ``tools.time_analyze`` on the card, their lines printed. The phase's
   launches join the kernels line.

19. Pillar plan (after phase 3's head parity): ``sessd_torch.ops.pillar``
   at full width on a SERVING_CAPS scene (``make_scene(0)``, stage 1 not
   full), f32 (TF32 off) and bf16, with the serving model's raw kernels:
   the first conv on K4 gives both plans their stage-0 input, then subm0b
   (stage 0), down0 (into stage 1, with the cover mask) and subm1a (stage
   1) run through the plan (pillar columns, one gather, one cuDNN conv)
   chained on its own outputs and through K4 chained on its own. Each
   output at the chain's voxel rows within 1e-4 (f32) / 2e-2 (bf16) of the
   max of K4's; down0's covered sites exactly the chain's stage-1 voxels.
   Prints per conv the pillars, the plan's and K4's device times and the
   set-up time, each line with the card's name and power limit.
20. Checkpoint import (after phase 19): the serving model's weights saved
   as a det3d ``.pth`` ({state_dict, meta, optimizer}; ``module.`` keys,
   ``num_batches_tracked`` beside each BatchNorm) and loaded by
   ``utils.convert_torch.load_torch_checkpoint`` into a VoxelNet of the
   same config on the card: meta kept, and one batch-1 request's head
   outputs bit-equal to the source model's.
21. Packed step (after phase 6): one f32 step on a batch packed by
   ``train_step.pack_batch`` against the same step on the batch unpacked
   (voxels rounded through f16 first, the one field packing rounds), from
   the same state: ``unpack_batch`` on the card bit-equal to the unpacked
   batch's tensors, loss terms within 1e-6 relative and the gradient norm
   within 1e-5; the staged bytes of both.
22. Rotated NMS (after phase 3): the kernel pair of ``ops/cuda/nms.py``
   at serving's shapes, batch 8 of car-sized boxes in tight groups, IoU
   0.01, post 100: pre 256 with 70 valid rows a scene (the small path of
   the serving cell) and pre 1000 with every row valid (the full path).
   The kept ranks and validity equal to the twin's (``rotated_nms_ref``)
   on the card, the largest difference printed; device ms of the pair
   (``median_ms``), the twin's on the host clock (it reads the device once
   per fixpoint pass and scene), and the bound: the larger of the
   triangle's IoU operations (NMS_PAIR_FLOPS a pair of valid boxes) over
   67 TFLOP/s and the bytes (boxes and scores read, mask written and read,
   slots written) over 3.35 TB/s. No PyTorch call computes a rotated NMS.
   The main-path phases count the pair's launches: 2 a batch wherever
   ``predict_batch`` runs ``rotate_nms`` on the card (serving b1/b4/b8,
   points-in serving, eval, 3-class, data parallel, multi-process eval),
   none on DI-NMS or in training steps; their sum joins the kernels
   line.
23. CenterPoint instances (after phase 22): the kernels CenterPoint-Voxel
   (Waymo, ``centerpoint_waymo_bf16.py``) adds, once each against its
   twin on the card at that model's row counts: bf16 K1 and K3 at (64,
   128) and (128, 128) (``sc.WIDE_PAIRS``: 120,000 rows, random
   rulebooks, 27 taps; within 2e-2 of the twin's max), the residual
   blocks' store (``residual=``, the identity added before the ReLU) at 16,
   32, 64 and 128 channels at their stages' rows in a batch of 4 scans
   (430,000, 350,000, 150,000 and 60,000), the first conv's 5
   input channels zero-padded to 16 through K1's and K3's 16 -> 16
   instance against the 5-channel twin (800,000 rows), and the rotated-NMS
   pair at pre 4096 (batch 4, 2,800 valid rows a scene, IoU 0.7, post
   500) with kept ranks equal to the twin's; device ms of each beside its
   bound.
24. BatchNorm fold (after phase 23): one serving batch of each model,
   SE-SSD Car bf16 at batch 8 (the ray-cast scans of phase 3) and
   CenterPoint-Voxel bf16 at batch 4 (a synthetic ground surface of
   ~90k voxels a scan at the published grid and caps), staged, random
   BatchNorm statistics, folded and channels-last (the serving path)
   against the unfolded NCHW path in the same process (``unfolded_path``):
   host ms a batch (median of 10, synchronised), device ms a batch and
   launches by kernel name (``torch.profiler`` over 8 batches), the
   launches and ms of what the fold removes (cuDNN's layout transposes,
   the broadcast elementwise passes, the ReLU passes), the
   ``conv_bn_folded`` count a batch (14 and 20), and each path's heads'
   relative L2 distance from an f32 neck and head (TF32 off) on the same
   BEV map (the folded one within 2e-2). Fails on a transpose left in the
   folded batch but the one cuDNN writes a one-channel output through.

The entry kept for same-call comparisons (``fused_sparse_conv_at_split``,
K1 at a forced cluster size) counts its own launches; a main-path phase
that launched it fails.

The last lines are the kernels JSON line (each kernel's time, its plain
twin's, its launches on the main path, and its bound: the larger of the
bytes it must move over 3.35 TB/s and its 2*hits*Cin*Cout flops over the
peak for the input type, 67 TFLOP/s f32 or 989 TFLOP/s bf16, and for a
3xTF32 body three times those flops over 494.7 TFLOP/s TF32), the card
line, and the result line ``{"ok": true, "device": {...}}``. The S1 row
also carries ``old_tile_ms`` (its scalar copy's ``full``), K1, K3, K4,
dFeat, dW and S1 the name of their ``tile``, K3, K4 and dFeat
``skipped_tap_share``, dW its skipped (chunk, tap) and (step, tap) shares,
its partials' bytes and its time by chunk rows, S1 its tensor-core mode
tables, and K1, K3, K4, dFeat and dW an ``f32`` object: per-launch ms on
the f32 paths (phases 4 and 7), the twin's and the bound's (dW's also
with its partials), and the body; K3's also K1's time and its distance
from K1, K1's its max abs error against the twin. K1, K4, dFeat and dW
also carry ``cin4``: the first conv's 4-channel side on the direct body,
per call (K1 at batch 1 and 4 in both types, K4 on both training chains,
dFeat 16 -> 4 and dW on the student's), its ms, the twin's and the
call's bound.
Without a CUDA device it raises and prints no result.
"""
import ast
import contextlib
import copy
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sessd_torch import builder
from sessd_torch.core import box_torch, nms_np
from sessd_torch.core.nms import rotate_weighted_nms
from sessd_torch.core.nms import score_order as nms_score_order
from sessd_torch.models import backbone as bb
from sessd_torch.models import layers
from sessd_torch.models.backbone import PLAN, pick_conv
from sessd_torch.models.pillars import PointPillars, pillar_scatter
from sessd_torch.ops import pillar as pil
from sessd_torch.ops import sparse as sp
from sessd_torch.ops.cuda import ablate
from sessd_torch.ops.cuda import nms as nms_cuda
from sessd_torch.ops.cuda import sparse_conv as sc
from sessd_torch.ops.cuda import sparse_conv_train as kt
from sessd_torch.parallel import mesh
from sessd_torch.scripts import acceptance_ap
from sessd_torch.scripts import bench_launch_overhead as bench_launch
from sessd_torch.scripts import bench_sparse_conv_ablate as bench_ablate
from sessd_torch.scripts import probe_step_parity as pins
from sessd_torch.scripts.profile_train import make_synthetic_root
from sessd_torch.models.predict import predict_batch
from sessd_torch.serve import (SERVING_CAPS, TRAIN_CAPS, ExactBatchServer,
                               PillarPreprocessor, make_pillar_infer_fn,
                               HostPreprocessor, make_infer_fn,
                               make_points_infer_fn, make_scene,
                               saturated_stages, stage_inputs)
from sessd_torch.tools import get_flops, time_analyze
from sessd_torch.tools.train import load as load_train_config
from sessd_torch.train.train_step import (pack_batch, sigmoid_rampup,
                                          unpack_batch)
from sessd_torch.train.trainer import Trainer
from sessd_torch.utils import convert_torch, profiling
from sessd_torch.utils.profiling import card_line, queued_device_ms

CONV_NAMES = ["subm0a", "subm0b", "down0", "subm1a", "subm1b", "down1",
              "subm2a", "subm2b", "subm2c", "down2", "subm3a", "subm3b",
              "subm3c", "down3"]
BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0
# the card's published rates (H100 SXM data sheet, dense, at 700 W): f32
# on the CUDA cores, bf16 and TF32 on the tensor cores; a 3xTF32 body
# ("tf32": f32 dFeat, K3 and dW, K4's entry) runs three TF32 products per
# f32 one
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 494.7e12}
TF32_PASSES = 3
B8_REQUESTS = 6
# every Trainer here runs at the acceptance recipe's stage caps: the
# ray-cast frames with GT-AUG overflow TRAIN_CAPS at stage 1, and a
# saturated chain trains on truncated voxels
ACCEPT_CAPS = ast.literal_eval(re.search(
    r"^stage_capacity = (\(.*\))$", acceptance_ap.CONFIG, re.M).group(1))


class Bound:
    """The least time the card could take for a kernel's work summed over
    calls: each input read once and each output written once over the
    memory rate, against 2*hits*Cin*Cout flops over the input type's peak
    (on a 3xTF32 body, ``body`` "tf32", three times those flops over the
    TF32 peak); the larger of the two."""

    def __init__(self):
        self.seconds = {"bytes": 0.0, "operations": 0.0}

    def add(self, tensors, hits: int, cin: int, cout: int, dtype,
            body: str = "", extra_bytes: int = 0):
        moved = sum(t.numel() * t.element_size() for t in tensors)
        self.seconds["bytes"] += (moved + extra_bytes) / HBM_BYTES_PER_S
        flops = 2 * hits * cin * cout
        self.seconds["operations"] += (
            TF32_PASSES * flops / PEAK_FLOPS["tf32"] if body == "tf32"
            else flops / PEAK_FLOPS[dtype])

    def ms(self) -> float:
        return max(self.seconds.values()) * 1e3

    def by(self) -> str:
        return max(self.seconds, key=self.seconds.get)


def hits(rb, miss: int) -> int:
    return int((rb != miss).sum())


class TileSkips:
    """(tile, tap) pairs that no row of a tile of ``rows`` rows hits,
    summed over convs: at 64 rows the taps the tensor-core tile neither
    gathers nor multiplies. Also the row slots of the pairs it does gather
    and the share of them that miss, which the tile zero-fills."""

    def __init__(self):
        self.pairs = 0
        self.skipped = 0.0
        self.slots = 0
        self.hit_rows = 0

    def add(self, rb, miss: int, rows: int = 64) -> float:
        flags, share = sp.tile_tap_hits(rb, miss, rows)
        self.pairs += flags.numel()
        self.skipped += share * flags.numel()
        self.slots += int(flags.sum()) * rows
        self.hit_rows += hits(rb, miss)
        return share

    def share(self) -> float:
        return self.skipped / self.pairs if self.pairs else 0.0

    def fill_share(self) -> float:
        return 1.0 - self.hit_rows / self.slots if self.slots else 0.0


def median_ms(fn, reps=20) -> float:
    """Device ms of one ``fn()``: the median of ``reps`` CUDA-event pairs,
    each call queued behind a spin on the device, so the wrapper's host
    time (tens of us a call, S2) is not counted."""
    return queued_device_ms(fn, reps)


def build_model(config: str, device, prior: bool):
    """Seeded random weights; the cls bias at the focal prior (pi = 0.01)
    or, with ``prior`` off, at 0, where every anchor scores about 0.5."""
    cfg = builder.load_config(config)
    model = builder.build_detector(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    set_prior(model, prior)
    return model.to(device).eval(), cfg


def set_prior(model, on: bool):
    builder.set_cls_prior(model, 0.01 if on else None)


# the template arguments of a kernel instance as the compiler mangles them:
# element type (f f32, 13__nv_bfloat16 bf16), index type (s int16, i
# int32), Cin, Cout
_MANGLED_ARGS = r"I(f|13__nv_bfloat16)([si])Li(\d+)ELi(\d+)E"


def instance_resources(log: str, kernel: str) -> dict:
    """{(dtype, idx, cin, cout): (registers, spill store bytes)} of each
    instance of ``kernel`` in nvcc's ``-Xptxas=-v`` log."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        key = name and re.search(kernel + _MANGLED_ARGS, name)
        # the residual-store instances (template flag RES, "Lb1E") of K3
        # share the plain ones' channels: the plain ones are listed
        if m and key and "Lb1E" not in name:
            dtype = "float32" if key.group(1) == "f" else "bfloat16"
            idx = "int16" if key.group(2) == "s" else "int32"
            out[dtype, idx, int(key.group(3)), int(key.group(4))] = (
                int(m.group(1)), spill)
    return out


def phase_build():
    t0 = time.perf_counter()
    sc.build()
    secs = time.perf_counter() - t0
    log = sc.build_info["log"]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    # blocks per SM of each training tile instance, by (entry, dtype, pair)
    blocks = {f"{entry[12:]} {str(dtype)[6:]} {cin}x{cout}":
              f"{sc.conv_instance(entry, dtype, cin, cout)} "
              f"{kt.blocks_per_sm(entry, dtype, cin, cout)}"
              for entry, pairs in (("sparse_conv_fwd", sc.FWD_PAIRS),
                                   ("sparse_conv_dfeat", sc.DFEAT_PAIRS))
              for dtype in (torch.float32, torch.bfloat16)
              for cin, cout in pairs}
    print(f"build: {secs:.2f} s ({sc.build_info['path']}); "
          f"{len(regs)} kernel instances, max {max(regs, default=0)} "
          f"registers, {spills} bytes spill stores; training tiles (body, "
          f"blocks per SM): " + ", ".join(f"{k}: {v}"
                                         for k, v in blocks.items()))
    # dW's partial kernel (at DW_CHUNK_ROWS) and the stream kernel: body,
    # blocks per SM and, from this build's log, each int32 instance's
    # registers and spill stores (none where the library was cached)
    res = {"dw": instance_resources(log, "sparse_conv_dw_partial_kernel"),
           "stream": instance_resources(log,
                                        "fused_sparse_conv_stream_kernel")}
    lines = []
    for name, entry, pairs in (("dw", "sparse_conv_dw", sc.DW_PAIRS),
                               ("stream", "fused_sparse_conv_stream",
                                sc.STREAM_PAIRS)):
        for dtype in (torch.float32, torch.bfloat16):
            for cin, cout in pairs:
                n_blocks = (kt.blocks_per_sm(entry, dtype, cin, cout)
                            if name == "dw" else
                            sc.stream_blocks_per_sm(cin, cout, dtype))
                regs_spill = res[name].get((str(dtype)[6:], "int32", cin,
                                            cout), ("?", "?"))
                lines.append(f"{name} {str(dtype)[6:]} {cin}x{cout}: "
                             f"{sc.conv_instance(entry, dtype, cin, cout)} "
                             f"{n_blocks} blocks, {regs_spill[0]} registers,"
                             f" {regs_spill[1]} B spilled")
    print(f"build: dW (at {kt.DW_CHUNK_ROWS}-row chunks) and K3 instances "
          f"(body, blocks per SM, registers, spill stores): "
          + "; ".join(lines))


class Direct:
    """The first conv's 4-channel side on the direct body, per (kernel,
    tag): device ms of the body and of the twin, and the call's Bound;
    every call held to the same bits on a second run (``check``; the
    twin bound is the caller's)."""

    def __init__(self):
        self.rows = {}

    def check(self, what, got, again):
        if not torch.equal(got, again):
            diff = float((got.float() - again.float()).abs().max())
            raise AssertionError(f"{what}: the direct body's second run "
                                 f"differs by {diff:.3e}")

    def add(self, kernel, tag, ms, plain_ms, bound):
        self.rows.setdefault(kernel, {})[tag] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.ms(),
            "bound_by": bound.by()}
        return (f"direct {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
                f"{bound.ms():.4f} ms ({bound.by()}), the same bits on two "
                "runs")


def phase_kernels(model, spec, device):
    """Every backbone conv through kernel and twin on identical inputs; the
    batch-1 convs timed, in bf16 also, where K1 splits its tiles over a
    cluster, at one CTA per tile. The first conv (the direct body) gives
    the same bits on two runs in both types and batches and is timed at
    both batches. Returns (max abs error, {"ms", "plain_ms": sums over the
    14 b1 bf16 convs}, the bound of those convs, a Direct)."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    scenes = [make_scene(seed=s)[0] for s in range(4)]
    staged = {1: stage_inputs(**prep(scenes[0]), device=device),
              4: stage_inputs(**prep.batch(scenes), device=device)}
    worst_abs, bound = 0.0, Bound()
    sums = {"ms": 0.0, "plain_ms": 0.0}
    direct = Direct()
    for batch, dtype in ((1, torch.float32), (1, torch.bfloat16),
                         (4, torch.float32), (4, torch.bfloat16)):
        feats, rb = staged[batch]
        idx = str(rb["subm"][0].dtype).replace("torch.", "")
        tag = f"b{batch} {str(dtype).replace('torch.', '')} {idx}"
        timed = batch == 1
        step = iter(range(len(CONV_NAMES)))

        def checked(x, rbk, w2, bias, n_in):
            nonlocal worst_abs
            i = next(step)
            cin, cout = x.shape[1], w2.shape[2]
            y = sc.fused_sparse_conv(x, rbk, w2, bias, n_in)
            want = sc.fused_sparse_conv_ref(x, rbk, w2, bias, n_in)
            torch.cuda.synchronize()
            diff = float((y.float() - want.float()).abs().max())
            peak = float(want.float().abs().max())
            if not peak > 0:  # a dead signal would make the check vacuous
                raise AssertionError(f"{CONV_NAMES[i]} {tag}: all-zero "
                                     "output")
            rel = diff / peak
            worst_abs = max(worst_abs, diff)
            inst = sc.conv_instance("fused_sparse_conv", dtype, cin, cout)
            split = sc.launch_split(rbk.shape[0], cin, cout, dtype)
            wave = f" (wave {sc.launch_wave(cin, cout)})" \
                if inst == "mma" else ""
            line = (f"conv {i:2d} {CONV_NAMES[i]:6s} {cin:2d}->{cout:2d} "
                    f"K={w2.shape[0]:2d} rows {rbk.shape[0]:5d} {tag}: "
                    f"{inst} S={split}{wave} max|twin| {peak:.3e} rel_err "
                    f"{rel:.2e}")
            if inst == "direct":
                args = (x, rbk, w2, bias, n_in)
                direct.check(f"{CONV_NAMES[i]} {tag}", y,
                             sc.fused_sparse_conv(*args))
                one = Bound()
                one.add((x, rbk, w2, bias, y), hits(rbk, n_in), cin, cout,
                        dtype)
                line += "; " + direct.add(
                    "fused_sparse_conv", tag,
                    median_ms(lambda: sc.fused_sparse_conv(*args)),
                    median_ms(lambda: sc.fused_sparse_conv_ref(*args)), one)
            if timed:
                args = (x, rbk, w2, bias, n_in)
                k_ms = median_ms(lambda: sc.fused_sparse_conv(*args))
                r_ms = median_ms(lambda: sc.fused_sparse_conv_ref(*args))
                line += f" kernel {k_ms:.4f} ms twin {r_ms:.4f} ms"
                if dtype == torch.bfloat16:
                    flags, _ = sp.tile_tap_hits(rbk, n_in)
                    line += (f"; tiles {flags.shape[0]}, "
                             f"{int(flags.any(1).sum())} with a hit")
                    if split > 1:
                        one = sc.fused_sparse_conv_at_split(*args, split=1)
                        torch.cuda.synchronize()
                        s1_rel, _ = _rel(y, one)
                        s1_ms = median_ms(
                            lambda: sc.fused_sparse_conv_at_split(
                                *args, split=1))
                        line += (f"; at S=1 {s1_ms:.4f} ms (rel diff "
                                 f"{s1_rel:.1e})")
                        if not s1_rel <= BOUNDS[dtype]:
                            raise AssertionError(
                                f"{CONV_NAMES[i]} {tag}: S={split} differs "
                                f"from S=1 by {s1_rel:.3e}")
                    sums["ms"] += k_ms
                    sums["plain_ms"] += r_ms
                    bound.add((x, rbk, w2, bias, y), hits(rbk, n_in), cin,
                              cout, dtype)
            print(line)
            if not rel <= BOUNDS[dtype]:
                raise AssertionError(f"{CONV_NAMES[i]} {tag}: rel_err "
                                     f"{rel:.3e} > {BOUNDS[dtype]}")
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"{CONV_NAMES[i]} {tag}: non-finite")
            return y

        with torch.inference_mode():
            model.backbone(feats, rb, batch, model.sparse_shape, dtype,
                           conv=checked)
        if next(step, None) is not None:
            raise AssertionError("backbone ran fewer than 14 convs")
    print(f"kernel vs twin: all 14 convs within bounds at b1/int16 and "
          f"b4/int32, f32 and bf16, the first conv's direct body the same "
          f"bits on two runs; b1 bf16 sums kernel {sums['ms']:.4f} ms, twin "
          f"{sums['plain_ms']:.4f} ms, bound {bound.ms():.4f} ms "
          f"({bound.by()}) [{card_line()}]")
    return worst_abs, sums, bound, direct


# (name, output stage) of the convs the pillar plan runs: the second
# stage-0 subm conv, the strided conv into stage 1 and stage 1's first subm
PILLAR_CONVS = (("subm0b", 0), ("down0", 1), ("subm1a", 1))


def _at_voxels(cols, pillars, ids, depth):
    """The pillar columns' values [N, C] at the voxel rows of ``ids``
    (z-minor, SENTINEL-padded; zero on padding rows)."""
    valid = ids < sp.SENTINEL
    v = torch.where(valid, ids, 0).long()
    prow = torch.searchsorted(pillars.ids, (v // depth).int())
    prow = prow.clamp_max(pillars.capacity - 1)
    found = valid & (pillars.ids[prow] == (v // depth).int())
    got = cols[prow, v % depth]
    return torch.where(found[:, None], got, 0.0), found, valid


def phase_pillar_plan(model, spec, device, card):
    """The pillar-column plan (``sessd_torch.ops.pillar``) at full width on
    stage 0 and stage 1 of a SERVING_CAPS scene against K4 on the same
    chain and weights, f32 (TF32 off) and bf16: each conv's output at the
    chain's voxel rows within BOUNDS of K4's, the strided conv's covered
    sites exactly the chain's stage-1 voxels, and both times."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    feats, rb = stage_inputs(**prep(make_scene(seed=0)[0]), device=device)
    ids = rb["ids"]
    if ids[1][-1] < sp.SENTINEL:
        raise AssertionError("stage 1 of the scene is full: the chain "
                             "truncates where the plan does not")
    depth0, depth1 = model.sparse_shape[0], sp.downsample_out_shape(
        (1,) + model.sparse_shape, *PLAN[1][2:])[1]
    blocks = model.backbone.blocks()
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        w = [blocks[i][0].weight.detach().reshape(
            -1, *blocks[i][0].weight.shape[-2:]).to(dtype).contiguous()
            for i in range(4)]
        masks = [i < sp.SENTINEL for i in ids[:2]]
        x = feats[rb["perm"].long()]
        x = torch.where(masks[0][:, None], x, 0.0).to(dtype)
        # the first conv (4 -> 16) on K4 gives both plans their input
        x = torch.relu(kt.sparse_conv_fwd(x, rb["subm"][0], w[0], masks[0]))
        grid = pil.SparseGrid(ids[0], (1,) + model.sparse_shape)

        def setup():
            p0, cols, occ = pil.pillars_from_grid(grid, x, ids[0].shape[0])
            p1 = pil.downsample_pillars(p0, out_capacity=ids[1].shape[0],
                                        out_depth=depth1)
            return (p0, cols, occ, p1, pil.bev_rulebook(p0),
                    pil.bev_rulebook(p0, p1, (3, 3), (2, 2), (1, 1)),
                    pil.bev_rulebook(p1))

        p0, cols, occ, p1, rb0, rbd, rb1 = setup()
        setup_ms = median_ms(setup, 5)
        runs = {
            "subm0b": (lambda: pil.pillar_conv(cols, rb0, w[1]),
                       lambda: kt.sparse_conv_fwd(x, rb["subm"][0], w[1],
                                                  masks[0]))}
        out0 = runs["subm0b"][0]() * occ[..., None]
        y0 = runs["subm0b"][1]()
        c0, x0 = torch.relu(out0), torch.relu(y0)
        runs["down0"] = (
            lambda: pil.pillar_conv(c0, rbd, w[2], z_stride=2, z_pad=1,
                                    occ=occ),
            lambda: kt.sparse_conv_fwd(x0, rb["down"][0], w[2], masks[1]))
        out1, cover = runs["down0"][0]()
        y1 = runs["down0"][1]()
        c1, x1 = torch.relu(out1 * cover[..., None]), torch.relu(y1)
        runs["subm1a"] = (
            lambda: pil.pillar_conv(c1, rb1, w[3]),
            lambda: kt.sparse_conv_fwd(x1, rb["subm"][1], w[3], masks[1]))
        out2 = runs["subm1a"][0]() * cover[..., None]
        y2 = runs["subm1a"][1]()
        torch.cuda.synchronize()

        # the strided conv's covered sites are the chain's stage-1 voxels
        at, found, valid = _at_voxels(cover[..., None], p1, ids[1], depth1)
        at = at[:, 0]
        if not (torch.equal(found, valid) and bool((at[valid] == 1).all())
                and int((cover > 0).sum()) == int(valid.sum())):
            raise AssertionError(f"pillar plan {dtype}: covered sites differ "
                                 f"from the chain's stage-1 voxels")
        tag = str(dtype).replace("torch.", "")
        for (name, stage), out, y in zip(
                PILLAR_CONVS, (out0, out1 * cover[..., None], out2),
                (y0, y1, y2)):
            depth, pset = (depth0, p0) if stage == 0 else (depth1, p1)
            got, _, _ = _at_voxels(out, pset, ids[stage], depth)
            rel, _ = _rel(got, y)
            if not torch.isfinite(out.float()).all() or \
                    not rel <= BOUNDS[dtype]:
                raise AssertionError(f"pillar plan {name} {tag}: rel_err "
                                     f"{rel:.3e} > {BOUNDS[dtype]}")
            plan_ms = median_ms(runs[name][0], 10)
            k4_ms = median_ms(runs[name][1], 10)
            lines.append(
                f"pillar plan {name} (stage {stage}) {tag}: pillars "
                f"{int(pset.mask.sum())} x depth {depth}, voxels "
                f"{int((ids[stage] < sp.SENTINEL).sum())}; rel_err vs K4 "
                f"{rel:.2e}; plan {plan_ms:.4f} ms (gather + cuDNN conv) vs "
                f"K4 {k4_ms:.4f} ms")
        lines.append(f"pillar plan set-up {tag} (pillar sets and 3 BEV "
                     f"rulebooks): {setup_ms:.4f} ms")
    for line in lines:
        print(f"{line} [{card}]")


def _det3d_state_dict(model) -> dict:
    """A VoxelNet's weights as det3d saves them: DDP's ``module.`` prefix
    and torch BatchNorm's ``num_batches_tracked`` beside its statistics."""
    sd = {}
    for k, v in model.state_dict().items():
        sd["module." + k] = v.detach().cpu().clone()
        if k.endswith(".running_var"):
            sd["module." + k.replace("running_var", "num_batches_tracked")] \
                = torch.tensor(1000)
    return sd


def phase_checkpoint_import(model, cfg, spec, device, tmp):
    """``utils.convert_torch.load_torch_checkpoint`` round trip on the card:
    the bf16 serving model's weights saved as a det3d .pth (state_dict,
    meta, optimizer), loaded into a VoxelNet built from the model's config
    ``cfg`` on the card, and one batch-1 request through both: head
    outputs bit-equal."""
    path = os.path.join(tmp, "det3d_se_ssd.pth")
    torch.save({"state_dict": _det3d_state_dict(model),
                "meta": {"epoch": 60, "iter": 55680},
                "optimizer": {"state": {}, "param_groups": [{"lr": 3e-3}]}},
               path)
    t0 = time.perf_counter()
    loaded, meta = convert_torch.load_torch_checkpoint(path, cfg, device)
    secs = time.perf_counter() - t0
    if meta != {"epoch": 60, "iter": 55680} or loaded.training:
        raise AssertionError(f"checkpoint meta {meta}")
    prep = HostPreprocessor(spec, SERVING_CAPS)
    feats, rb = stage_inputs(**prep(make_scene(seed=1)[0]), device=device)
    ones = torch.ones(feats.shape[0], dtype=torch.int32, device=device)
    with torch.inference_mode():
        want = model(feats[:, None, :], ones, rb, 1)[0]
        got = loaded(feats[:, None, :], ones, rb, 1)[0]
    torch.cuda.synchronize()
    if set(got) != set(want) or not all(torch.equal(got[k], want[k])
                                        for k in want):
        raise AssertionError("det3d checkpoint: heads differ from the "
                             "source model's")
    if not all(torch.isfinite(v.float()).all() for v in got.values()):
        raise AssertionError("det3d checkpoint: non-finite heads")
    print(f"det3d checkpoint ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"{len(_det3d_state_dict(model))} entries): loaded onto the card "
          f"in {secs:.2f} s, batch-1 {str(model.dtype)[6:]} heads bit-equal "
          f"to the source model's ({', '.join(f'{k} {tuple(v.shape)}' for k, v in got.items())})")
    del loaded
    torch.cuda.empty_cache()


def tf32_with_epilogue(x, rbk, w2, bias, n_in, relu=True):
    """f32 K4 (the 3xTF32 tile f32 K1 and K3 run, without the epilogue)
    with their bias, ReLU and any-hit mask added in torch: f32 K1's and
    K3's bits."""
    y = kt.sparse_conv_fwd(x, rbk, w2) + bias
    if relu:
        y = torch.relu(y)
    return torch.where((rbk != n_in).any(1, keepdim=True), y, 0.0)


def check_stream_convs(backbone, feats, rb, batch, sparse_shape, dtype, tag,
                       want_streamed, resident=None):
    """The backbone's all-sparse plan on (feats, rb) with every conv that
    streams run through K3, its twin and K1 on identical inputs: K3 within the bound of the twin and of K1, and equal
    to K1 bit for bit where K1 runs one CTA per tile (in bf16 both on the
    tensor-core tile, in f32 both through 3xTF32 at S = 1); in f32 also
    equal bit for bit to f32 K4 with K3's epilogue
    (``tf32_with_epilogue``); each of these convs timed (device-time
    medians of 10). The other convs run K1; where ``resident`` (a
    PerLaunch) is given, each is held within the bound of its twin and, on
    the 3xTF32 tile, equal bit for bit to K4 with the epilogue (on the
    direct body the same bits on a second run), and timed with its twin
    into ``resident``. Returns {"worst": max abs error vs twin, "vs_k1":
    max abs difference from K1, "ms", "k1_ms", "plain_ms": sums, "bound":
    Bound, "tiles": TileSkips, "streamed": the streamed convs, "body": K3's, "k1_worst": max abs
    error of the resident K1 vs twin}."""
    out = {"worst": 0.0, "vs_k1": 0.0, "ms": 0.0, "k1_ms": 0.0,
           "plain_ms": 0.0, "bound": Bound(),
           "tiles": TileSkips(), "k1_worst": 0.0}
    step = iter(range(len(CONV_NAMES)))
    streamed = []

    def checked(x, rbk, w2, bias, n_in):
        i = next(step)
        if pick_conv(x.shape[1], n_in, dtype) is sc.fused_sparse_conv:
            y = sc.fused_sparse_conv(x, rbk, w2, bias, n_in)
            if resident is not None:
                args = (x, rbk, w2, bias, n_in)
                cin, cout = x.shape[1], w2.shape[2]
                body = sc.conv_instance("fused_sparse_conv", dtype, cin,
                                        cout)
                rel, diff = _rel(y, sc.fused_sparse_conv_ref(*args))
                out["k1_worst"] = max(out["k1_worst"], diff)
                if not rel <= BOUNDS[dtype]:
                    raise AssertionError(f"{CONV_NAMES[i]} {tag}: K1 rel_err "
                                         f"{rel:.3e} > {BOUNDS[dtype]}")
                if body == "tf32" and not torch.equal(
                        y, tf32_with_epilogue(*args)):
                    raise AssertionError(f"{CONV_NAMES[i]} {tag}: f32 K1 "
                                         "differs from K4 with the epilogue")
                if body == "direct" and not torch.equal(
                        y, sc.fused_sparse_conv(*args)):
                    raise AssertionError(f"{CONV_NAMES[i]} {tag}: K1's direct "
                                         "body differs on a second run")
                k_ms = median_ms(lambda: sc.fused_sparse_conv(*args), 10)
                r_ms = median_ms(lambda: sc.fused_sparse_conv_ref(*args), 10)
                resident.add(body, k_ms, r_ms)
                resident.bound.add((x, rbk, w2, bias, y), hits(rbk, n_in),
                                   cin, cout, dtype, body)
                print(f"resident conv {i:2d} {CONV_NAMES[i]:6s} {cin:2d}->"
                      f"{cout:2d} rows {rbk.shape[0]:6d} {tag}: K1 "
                      f"[{body}] rel_err vs twin {rel:.2e}"
                      + {"tf32": ", equal to K4 with the epilogue",
                         "direct": ", the same bits on two runs"}.get(body,
                                                                      "")
                      + f"; {k_ms:.4f} ms, twin {r_ms:.4f} ms")
            return y
        streamed.append(CONV_NAMES[i])
        args = (x, rbk, w2, bias, n_in)
        y = sc.fused_sparse_conv_stream(*args)
        want = sc.fused_sparse_conv_ref(*args)
        k1 = sc.fused_sparse_conv(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(y.float()).all():
            raise AssertionError(f"{CONV_NAMES[i]} {tag}: non-finite")
        rel, diff = _rel(y, want)
        rel_k1, vs_k1 = _rel(y, k1)
        split = sc.launch_split(rbk.shape[0], x.shape[1], w2.shape[2], dtype)
        out["worst"] = max(out["worst"], diff)
        out["vs_k1"] = max(out["vs_k1"], vs_k1)
        times = [median_ms(lambda f=f: f(*args), 10) for f in (
            sc.fused_sparse_conv_stream, sc.fused_sparse_conv,
            sc.fused_sparse_conv_ref)]
        for key, t in zip(("ms", "k1_ms", "plain_ms"), times):
            out[key] += t
        body = sc.conv_instance("fused_sparse_conv_stream", dtype,
                                x.shape[1], w2.shape[2])
        out["body"] = body
        out["bound"].add((x, rbk, w2, bias, y), hits(rbk, n_in), x.shape[1],
                         w2.shape[2], dtype, body)
        skipped = out["tiles"].add(rbk, n_in)
        print(f"stream conv {i:2d} {CONV_NAMES[i]:6s} {x.shape[1]:2d}->"
              f"{w2.shape[2]:2d} K={w2.shape[0]:2d} rows {rbk.shape[0]:6d} "
              f"{tag}: K3 [{body}] rel_err vs twin {rel:.2e}, vs K1 "
              f"{rel_k1:.2e}, max|K3-K1| {vs_k1:.3e} (K1 S={split}); K3 "
              f"{times[0]:.4f} ms, K1 {times[1]:.4f} ms, twin "
              f"{times[2]:.4f} ms; taps skipped "
              f"{skipped:.3f}")
        if not (rel <= BOUNDS[dtype] and rel_k1 <= BOUNDS[dtype]):
            raise AssertionError(f"{CONV_NAMES[i]} {tag}: K3 rel_err "
                                 f"{rel:.3e} vs twin, {rel_k1:.3e} vs K1 > "
                                 f"{BOUNDS[dtype]}")
        if split == 1 and not torch.equal(y, k1):
            raise AssertionError(f"{CONV_NAMES[i]} {tag}: K3 differs from K1 "
                                 "at one CTA per tile")
        if dtype == torch.float32 and not torch.equal(
                y, tf32_with_epilogue(*args)):
            raise AssertionError(f"{CONV_NAMES[i]} {tag}: f32 K3 differs "
                                 "from K4 with its epilogue")
        return y

    with torch.inference_mode():
        backbone(feats, rb, batch, sparse_shape, dtype, conv=checked)
    if next(step, None) is not None:
        raise AssertionError("backbone ran fewer than 14 convs")
    if streamed != want_streamed:
        raise AssertionError(f"{tag}: streamed {streamed}, want "
                             f"{want_streamed}")
    out["streamed"] = streamed
    same = ("K1 and K4 with the epilogue" if dtype == torch.float32
            else "K1 at one CTA per tile")
    print(f"stream kernel {tag}: {len(streamed)} convs within bounds and "
          f"equal to {same}; max abs error vs twin {out['worst']:.3e}, "
          f"max|K3-K1| {out['vs_k1']:.3e}; sums K3 {out['ms']:.4f} ms, K1 "
          f"{out['k1_ms']:.4f} ms, twin "
          f"{out['plain_ms']:.4f} ms, bound {out['bound'].ms():.4f} ms "
          f"({out['bound'].by()}); taps skipped {out['tiles'].share():.3f} of "
          f"{out['tiles'].pairs} (tile, tap) pairs")
    return out


CONV_CIN = [4, 16, 16, 32, 32, 32, 64, 64, 64, 64, 64, 64, 64, 64]
CONV_STAGE = [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3]  # stage it reads


def streamed_convs(caps, batch, dtype) -> list:
    """The convs the backbone runs through K3 at these caps, by the JAX
    stream rule (``pick_conv``) on each conv's input rows."""
    return [name for name, c, st in zip(CONV_NAMES, CONV_CIN, CONV_STAGE)
            if pick_conv(c, caps[st] * batch, dtype)
            is sc.fused_sparse_conv_stream]


def phase_stream_serving(model, spec, device):
    """K3 on the streamed convs of one bf16 batch-8 request."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    feats, rb = stage_inputs(**prep.batch(
        [make_scene(seed=s)[0] for s in range(8)]), device=device)
    return check_stream_convs(model.backbone, feats, rb, 8,
                              model.sparse_shape, torch.bfloat16,
                              "b8 bf16 int32",
                              streamed_convs(SERVING_CAPS, 8, torch.bfloat16))


def phase_serving(model, cfg, spec, device):
    """The main path; returns the kernel launches it made."""
    anchors = builder.build_anchors(cfg)
    pcfg = builder.build_predict_config(cfg)
    scenes = [make_scene(seed=s)[0] for s in range(4)]
    server1 = ExactBatchServer(model, anchors, pcfg, spec, batch_size=1,
                               device=device)
    server4 = ExactBatchServer(model, anchors, pcfg, spec, batch_size=4,
                               device=device)

    # host prep alone, steady state (its buffer ring filled first)
    for pts in scenes:
        server1.fast_prep(pts)
    t0 = time.perf_counter()
    for pts in scenes:
        server1.fast_prep(pts)
    prep_ms = (time.perf_counter() - t0) / len(scenes) * 1e3

    requests = [("b1 prior", server1, [scenes[i % 4]]) for i in range(12)]
    requests += [("b4 prior", server4, scenes), ("b1 no prior", server1,
                                                 scenes[:1])]
    results, lat = [], []
    _reset_counts()
    for n, (name, server, batch) in enumerate(requests):
        if name == "b1 no prior":
            set_prior(model, False)
        before = sc.fused_sparse_conv.launches
        nms_before = nms_cuda.rotated_nms.launches
        t0 = time.perf_counter()
        out = server(batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        launched = sc.fused_sparse_conv.launches - before
        if sc.fused_sparse_conv_stream.launches:
            raise AssertionError(f"{name}: the stream kernel ran at batch "
                                 f"{len(batch)}")
        nms = nms_cuda.rotated_nms.launches - nms_before
        if nms != 2:
            raise AssertionError(f"{name}: {nms} rotated NMS launches, "
                                 "want 2")
        results.append((name, out, launched))
        if name == "b1 prior" and n > 0:  # request 0 is the warm-up
            lat.append(dt)
        print(f"request {n:2d} {name:11s}: {dt:8.3f} ms, {launched} kernel "
              f"launches, valid detections "
              f"{out[2].sum(dim=1).tolist()}")
    counts = _counts()  # raises if a comparison entry ran on the main path
    launches = counts["fused_sparse_conv"]
    set_prior(model, True)

    for name, (boxes, scores, valid), launched in results:
        b = 4 if name.startswith("b4") else 1
        if launched != 14:
            raise AssertionError(f"{name}: {launched} launches, want 14")
        post = pcfg.nms_post_max_size
        if (boxes.shape != (b, post, 7) or scores.shape != (b, post)
                or valid.shape != (b, post)):
            raise AssertionError(f"{name}: shapes {boxes.shape} "
                                 f"{scores.shape} {valid.shape}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError(f"{name}: non-finite outputs")
    if launches != 14 * len(requests):
        raise AssertionError(f"{launches} launches for {len(requests)} "
                             "requests")
    print(f"serving: {len(requests)} requests over {len(anchors)} anchors, "
          f"stats b1 {server1.stats} b4 {server4.stats}; batch-1 latency p50 "
          f"{np.percentile(lat, 50):.3f} ms p90 {np.percentile(lat, 90):.3f}"
          f" ms over {len(lat)} requests; host prep {prep_ms:.3f} ms/scene; "
          f"rotated NMS launches {counts['rotated_nms']} (2 a request)")
    return counts, pcfg


def _want_launches(caps, batch, dtype):
    """(K1, K3) launches of one request at these caps."""
    k3 = len(streamed_convs(caps, batch, dtype))
    return 14 - k3, k3


def phase_serving_b8(model, cfg, spec, device):
    """Batch-8 serving, the main path at throughput: one warm-up request,
    then B8_REQUESTS requests of eight ray-cast scans. Returns the launches
    {K1, K3, rotated NMS} of the timed requests."""
    anchors = builder.build_anchors(cfg)
    pcfg = builder.build_predict_config(cfg)
    server = ExactBatchServer(model, anchors, pcfg, spec, batch_size=8,
                              device=device)
    scenes = [make_scene(seed=s)[0] for s in range(8)]
    server(scenes)  # warm-up: first-call allocations
    torch.cuda.synchronize()
    preps = []
    for _ in range(3):  # host prep alone, its buffer ring already filled
        t0 = time.perf_counter()
        server.fast_prep.batch(scenes)
        preps.append((time.perf_counter() - t0) * 1e3)
    _reset_counts()
    lat = []
    for n in range(B8_REQUESTS):
        k1, k3, nms = (sc.fused_sparse_conv.launches,
                       sc.fused_sparse_conv_stream.launches,
                       nms_cuda.rotated_nms.launches)
        fast = server.stats["fast"]
        t0 = time.perf_counter()
        boxes, scores, valid = server(scenes)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        got = (sc.fused_sparse_conv.launches - k1,
               sc.fused_sparse_conv_stream.launches - k3,
               nms_cuda.rotated_nms.launches - nms)
        caps = SERVING_CAPS if server.stats["fast"] > fast else TRAIN_CAPS
        want = _want_launches(caps, 8, torch.bfloat16) + (2,)
        print(f"request b8 {n}: {lat[-1]:8.3f} ms, K1 {got[0]} K3 {got[1]} "
              f"rotated NMS {got[2]} launches, valid detections "
              f"{valid.sum(dim=1).tolist()}")
        if got != want:
            raise AssertionError(f"b8 request {n}: launches {got}, want "
                                 f"{want}")
        post = pcfg.nms_post_max_size
        if boxes.shape != (8, post, 7) or scores.shape != (8, post):
            raise AssertionError(f"b8: shapes {boxes.shape} {scores.shape}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError("b8: non-finite outputs")
    counts = {k: v for k, v in _counts().items()
              if k in ("fused_sparse_conv", "fused_sparse_conv_stream",
                       "rotated_nms")}
    p50 = float(np.percentile(lat, 50))
    print(f"serving b8: {B8_REQUESTS} requests, stats {server.stats}, p50 "
          f"{p50:.3f} ms, p90 {np.percentile(lat, 90):.3f} ms, "
          f"{8e3 / p50:.1f} scenes/s, host prep of the 8 scans "
          f"{np.median(preps):.3f} ms; launches per request K1 "
          f"{counts['fused_sparse_conv'] // B8_REQUESTS} K3 "
          f"{counts['fused_sparse_conv_stream'] // B8_REQUESTS} rotated NMS "
          f"{counts['rotated_nms'] // B8_REQUESTS}")
    return counts


def phase_head_parity(spec, device, pcfg):
    """f32 model, TF32 off: head outputs of the kernel path vs the twin
    path on one batch-1 request (K1 only) and one batch-8 request (K1 and
    K3); also reports which NMS capacity each score regime takes."""
    model, _ = build_model("se_ssd_kitti_car.py", device, prior=True)
    prep = HostPreprocessor(spec, SERVING_CAPS)
    scenes = [make_scene(seed=s)[0] for s in range(8)]
    for batch, prior in ((1, True), (1, False), (8, True)):
        p = prep(scenes[0]) if batch == 1 else prep.batch(scenes)
        feats, rb = stage_inputs(**p, device=device)
        ones = torch.ones(feats.shape[0], dtype=torch.int32, device=device)
        with torch.inference_mode():
            set_prior(model, prior)
            k3 = sc.fused_sparse_conv_stream.launches
            k = model(feats[:, None, :], ones, rb, batch)[0]
            k3 = sc.fused_sparse_conv_stream.launches - k3
            if k3 != _want_launches(SERVING_CAPS, batch, torch.float32)[1]:
                raise AssertionError(f"b{batch} f32: {k3} K3 launches")
            r = model(feats[:, None, :], ones, rb, batch,
                      conv=sc.fused_sparse_conv_ref)[0]
            for name in k:
                err = float((k[name] - r[name]).abs().max()
                            / r[name].abs().max())
                if not err <= 1e-3:
                    raise AssertionError(f"head {name}: rel_err {err:.3e}")
            n_above = int((torch.sigmoid(k["cls_preds"]).amax(-1)
                           >= pcfg.score_threshold).sum())
            branch = "small" if n_above <= pcfg.nms_pre_small else "full"
            print(f"head parity f32 b{batch} (prior "
                  f"{'on' if prior else 'off'}, {k3} K3 launches): kernel "
                  f"vs twin within 1e-3; {n_above} anchors above "
                  f"{pcfg.score_threshold} -> {branch} NMS capacity")


# (rulebook kind, chain index, output stage) of each backbone conv in order
CONV_CHAIN = [c for stage, (_, n_subm, dk, _, _) in enumerate(PLAN)
              for c in ([("down", stage - 1, stage)] if dk else [])
              + [("subm", stage, stage)] * n_subm]
TRAIN_BOUNDS = {torch.float32: (1e-4, 1e-4, 1e-3),
                torch.bfloat16: (2e-2, 2e-2, 2e-2)}  # fwd, dfeat, dw
TRAIN_STEPS = 6


def first_batch(trainer):
    """The loader's first batch on the device, through the trainer's
    saturation guard."""
    batches = iter(trainer.train_loader)
    try:
        batch = next(batches)
        trainer._check_train_saturation(batch)
        return trainer._device_batch(batch)
    finally:
        batches.close()


def _rel(got, want):
    peak = float(want.float().abs().max())
    if not peak > 0:
        raise AssertionError("all-zero twin output: a vacuous check")
    return float((got.float() - want.float()).abs().max()) / peak, \
        float((got.float() - want.float()).abs().max())


DW_CHUNK_SWEEP = (1024, 2048, 4096, 8192)  # chunk rows of dW's split-K


class DwSkips:
    """(chunk, tap) pairs no row of a chunk hits and (step, tap) pairs no
    row of a 64-row step hits, summed over convs: what the tensor-core dW
    neither reads nor multiplies; and the f32 partials' bytes (written
    once, read once by the ordered reduce)."""

    def __init__(self):
        self.chunks = TileSkips()
        self.steps = TileSkips()
        self.partial_bytes = 0

    def add(self, rb, miss: int, cin: int, cout: int, chunk_rows: int):
        chunk = self.chunks.add(rb, miss, chunk_rows)
        step = self.steps.add(rb, miss)
        moved = _partial_bytes(rb, cin, cout, chunk_rows)
        self.partial_bytes += moved
        return chunk, step, moved


def _partial_bytes(rb, cin: int, cout: int, chunk_rows: int) -> int:
    """The bytes of dW's f32 partials [chunks, K, Cin, Cout] for rulebook
    ``rb``: written once by the partial kernel and read once by the
    ordered reduce."""
    chunks = -(-rb.shape[0] // chunk_rows)
    return 2 * chunks * rb.shape[1] * cin * cout * 4


class PerLaunch:
    """A kernel's launches timed on the f32 chains: summed device ms of the
    kernel and its twin on the same calls; their bound and count (dW also
    its bound with the f32 partials written and read back,
    ``bound_partials``)."""

    def __init__(self):
        self.n = 0
        self.ms = self.plain_ms = 0.0
        self.bound = Bound()
        self.bound_partials = Bound()
        self.bodies = set()

    def add(self, body, ms, plain_ms):
        self.n += 1
        self.ms += ms
        self.plain_ms += plain_ms
        self.bodies.add(body)

    def row(self) -> dict:
        """Per-launch means (the kernel table's f32 row)."""
        n = max(self.n, 1)
        row = {"tile": sorted(self.bodies), "launches_timed": self.n,
               "ms_per_launch": self.ms / n,
               "plain_ms_per_launch": self.plain_ms / n,
               "bound_ms_per_launch": self.bound.ms() / n,
               "bound_by": self.bound.by()}
        if self.bound_partials.ms() > 0:
            row["bound_with_partials_ms_per_launch"] = \
                self.bound_partials.ms() / n
        return row


def _train_body(dtype, i: int, name: str) -> str:
    """The body K4 ("fwd"), dFeat and dW take on training conv i: the
    tensor-core ones in bf16, in f32 through 3xTF32, and the direct ones
    for the first conv's 4-channel side."""
    if i == 0:
        return "direct"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def _direct_conv0(direct, x, rbk, w, mask, dout, inv, dtype, tag,
                  plan) -> str:
    """The first conv's K4 and, on the student's chain (the step's), its
    dFeat (16 -> 4) and dW on the direct bodies: the same bits on a second
    run, and timed with the twins (device-time medians of 10) into
    ``direct``. The main loop holds them to the twins."""
    n_in = x.shape[0]
    calls = [("sparse_conv_fwd", lambda: kt.sparse_conv_fwd(x, rbk, w, mask),
              lambda: kt.sparse_conv_fwd_ref(x, rbk, w, mask),
              (x, rbk, w, mask), w.shape[1], w.shape[2])]
    if plan == "student":
        calls += [
            ("sparse_conv_dfeat", lambda: kt.sparse_conv_dfeat(dout, inv, w),
             lambda: kt.sparse_conv_dfeat_ref(dout, inv, w), (dout, inv, w),
             w.shape[2], w.shape[1]),
            ("sparse_conv_dw", lambda: kt.sparse_conv_dw(x, rbk, dout),
             lambda: kt.sparse_conv_dw_ref(x, rbk, dout), (x, rbk, dout),
             w.shape[1], w.shape[2])]
    parts = []
    for name, kern, twin, ins, cin, cout in calls:
        got = kern()
        direct.check(f"subm0a {name} {tag}", got, kern())
        one = Bound()
        one.add(ins + (got,), hits(rbk, n_in), cin, cout, dtype)
        parts.append(f"{name[12:]} " + direct.add(
            name, tag, median_ms(kern, 10), median_ms(twin, 10), one))
    return "; first conv: " + "; ".join(parts)


@torch.no_grad()
def phase_train_kernels(trainer, db):
    """K4 / K5 against their twins on every sparse conv of both plans.
    Returns (max abs error per kernel, [summed kernel ms, summed twin ms]
    per kernel, Bound per kernel, {"tiles": TileSkips} of the forward and
    of dFeat, {"skips": DwSkips, "sweep": {chunk rows: summed ms}} of dW)
    with the times and bounds of the bf16 student chain, and {kernel:
    PerLaunch} of the f32 chains: K4 on the student's and the teacher's
    convs, dFeat and dW on the student's (the step's); and a Direct of the
    first conv on both chains in both types (``_direct_conv0``)."""
    model = trainer.state.student
    blocks = model.backbone.blocks()
    worst = {"fwd": 0.0, "dfeat": 0.0, "dw": 0.0}
    ms = {k: [0.0, 0.0] for k in worst}
    bounds = {k: Bound() for k in worst}
    f32 = {k: PerLaunch() for k in worst}
    fwd_tile = {"tiles": TileSkips()}
    dfeat_tile = {"tiles": TileSkips()}
    dw_tile = {"skips": DwSkips(),
               "sweep": dict.fromkeys(DW_CHUNK_SWEEP, 0.0)}
    direct = Direct()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for plan, sfx, n in (("student", "", 10), ("teacher", "_raw", 14)):
            rb = db["inputs" + sfx]
            vox = db["voxels" + sfx]
            b, v = vox.shape[:2]
            feats = model.reader(vox.reshape(b * v, *vox.shape[2:]),
                                 db["num_points" + sfx].reshape(b * v))
            x = feats[rb["perm"].long()]
            x = torch.where((rb["ids"][0] < sp.SENTINEL)[:, None], x,
                            0.0).to(dtype)
            timed = dtype == torch.bfloat16 and plan == "student"
            tag = f"{plan} {str(dtype).replace('torch.', '')} " \
                  f"{str(rb['subm'][0].dtype).replace('torch.', '')}"
            for i in range(n):
                conv = blocks[i][0]
                kind, idx, out_stage = CONV_CHAIN[i]
                rbk = rb[kind][idx]
                mask = rb["ids"][out_stage] < sp.SENTINEL
                w = conv.weight.detach().reshape(
                    -1, *conv.weight.shape[-2:]).to(dtype).contiguous()
                inv = sp.inverse_rulebook(rbk, x.shape[0])
                dout = torch.randn(rbk.shape[0], w.shape[2], device="cuda",
                                   generator=gen)
                dout = torch.where(mask[:, None], dout, 0.0).to(dtype)
                runs = {"fwd": (lambda: kt.sparse_conv_fwd(x, rbk, w, mask),
                                lambda: kt.sparse_conv_fwd_ref(x, rbk, w,
                                                               mask)),
                        "dw": (lambda: kt.sparse_conv_dw(x, rbk, dout),
                               lambda: kt.sparse_conv_dw_ref(x, rbk, dout))}
                # every conv's input gradient, the first's 16 -> 4 (the
                # voxel features', direct body) too
                runs["dfeat"] = (
                    lambda: kt.sparse_conv_dfeat(dout, inv, w),
                    lambda: kt.sparse_conv_dfeat_ref(dout, inv, w))
                insts = {"fwd": sc.conv_instance(
                             "sparse_conv_fwd", dtype, w.shape[1],
                             w.shape[2]),
                         "dfeat": sc.conv_instance(
                             "sparse_conv_dfeat", dtype, w.shape[2],
                             w.shape[1]),
                         "dw": sc.conv_instance(
                             "sparse_conv_dw", dtype, w.shape[1],
                             w.shape[2])}
                for name in ("fwd", "dfeat", "dw"):
                    if insts[name] != _train_body(dtype, i, name):
                        raise AssertionError(
                            f"{CONV_NAMES[i]} {tag}: {name} takes the "
                            f"{insts[name]} body")
                if plan == "student" and i == 1:
                    _one_launch_per_call(x, rbk, w, mask, dout, inv)
                f32_timed = dtype == torch.float32
                line = (f"train conv {i:2d} {CONV_NAMES[i]:6s} "
                        f"{w.shape[1]:2d}->{w.shape[2]:2d} K={w.shape[0]:2d} "
                        f"rows {rbk.shape[0]:6d} {tag}:")
                y = None
                for name, (kern, twin) in runs.items():
                    got, want = kern(), twin()
                    torch.cuda.synchronize()
                    if not torch.isfinite(got.float()).all():
                        raise AssertionError(f"{CONV_NAMES[i]} {name} {tag}:"
                                             " non-finite")
                    rel, diff = _rel(got, want)
                    worst[name] = max(worst[name], diff)
                    line += f" {name} {rel:.1e}"
                    bound = TRAIN_BOUNDS[dtype][("fwd", "dfeat",
                                                 "dw").index(name)]
                    if not rel <= bound:
                        raise AssertionError(f"{CONV_NAMES[i]} {name} {tag}"
                                             f": rel_err {rel:.3e} > {bound}")
                    if name == "dw":
                        again = kern()
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"{CONV_NAMES[i]} dw {tag}: "
                                                 "two runs differ")
                    moved = {"fwd": (x, rbk, w, mask),
                             "dw": (x, rbk, dout),
                             "dfeat": (dout, inv, w)}[name] + (got,)
                    args = (moved, hits(rbk, x.shape[0]), w.shape[1],
                            w.shape[2], dtype, insts[name])
                    if (timed or f32_timed) and name == "dfeat" and i == 0:
                        # off the step's path: timed apart, not summed
                        if plan == "student":
                            line += (f" ({median_ms(kern, 10):.4f} vs twin "
                                     f"{median_ms(twin, 10):.4f} ms, "
                                     f"{insts[name]})")
                    elif f32_timed and (name == "fwd" or plan == "student"):
                        k_ms, r_ms = median_ms(kern, 10), median_ms(twin, 10)
                        f32[name].add(insts[name], k_ms, r_ms)
                        f32[name].bound.add(*args)
                        if name == "dw":  # the partials, written and read
                            f32[name].bound_partials.add(
                                *args, extra_bytes=_partial_bytes(
                                    rbk, w.shape[1], w.shape[2],
                                    kt.DW_CHUNK_ROWS))
                        line += (f" ({insts[name]} {k_ms:.4f} vs twin "
                                 f"{r_ms:.4f} ms)")
                    elif timed:
                        k_ms, r_ms = median_ms(kern, 10), median_ms(twin, 10)
                        ms[name][0] += k_ms
                        ms[name][1] += r_ms
                        bounds[name].add(*args)
                        line += f" ({k_ms:.4f} vs twin {r_ms:.4f} ms"
                        if name == "fwd":
                            skipped = fwd_tile["tiles"].add(rbk, x.shape[0])
                            line += f", taps skipped {skipped:.3f}"
                        if name == "dfeat":
                            dfeat_tile["tiles"].add(inv, rbk.shape[0])
                            one = TileSkips()
                            one.add(inv, rbk.shape[0])
                            line += (f", taps skipped {one.share():.3f}, "
                                     f"rows zero-filled "
                                     f"{one.fill_share():.3f}")
                        if name == "dw":
                            line += _dw_detail(x, rbk, dout, w, dw_tile)
                        line += ")"
                    if name == "fwd":
                        y = got
                if i == 0:
                    line += _direct_conv0(direct, x, rbk, w, mask, dout, inv,
                                          dtype, tag, plan)
                print(line)
                x = torch.relu(y)
    skips = dw_tile["skips"]
    card = card_line()
    print("train kernels vs twin: all convs of both plans within bounds, dW "
          "the same bits on two runs; bf16 student chain sums " + ", ".join(
              f"{k} kernel {v[0]:.4f} ms twin {v[1]:.4f} ms bound "
              f"{bounds[k].ms():.4f} ms ({bounds[k].by()})"
              for k, v in ms.items())
          + f"; fwd taps skipped "
          f"{fwd_tile['tiles'].share():.3f} of {fwd_tile['tiles'].pairs} "
          f"(tile, tap) pairs, gathered rows zero-filled "
          f"{fwd_tile['tiles'].fill_share():.3f}; dfeat taps skipped "
          f"{dfeat_tile['tiles'].share():.3f} of "
          f"{dfeat_tile['tiles'].pairs} (tile, tap) pairs of the inverse "
          f"rulebooks, gathered rows zero-filled "
          f"{dfeat_tile['tiles'].fill_share():.3f}; dw "
          f"(chunk, tap) pairs skipped {skips.chunks.share():.3f} of "
          f"{skips.chunks.pairs}, (step, tap) pairs skipped "
          f"{skips.steps.share():.3f} of {skips.steps.pairs}, partials "
          f"{skips.partial_bytes / 1e6:.2f} MB moved; dw by chunk rows "
          + ", ".join(f"{c}: {t:.4f} ms" for c, t in dw_tile["sweep"].items()))
    for name, per in f32.items():
        r = per.row()
        print(f"train kernels f32 {name}: {r['launches_timed']} launches "
              f"timed ({', '.join(r['tile'])}), per launch "
              f"{r['ms_per_launch']:.4f} ms, twin "
              f"{r['plain_ms_per_launch']:.4f} ms, bound "
              f"{r['bound_ms_per_launch']:.4f} ms ({r['bound_by']}) [{card}]")
    return worst, ms, bounds, fwd_tile, dfeat_tile, dw_tile, f32, direct


def _one_launch_per_call(x, rbk, w, mask, dout, inv):
    """One ``sparse_conv_fwd`` or ``sparse_conv_dfeat`` call makes one
    launch and one device allocation, its output: the weights are read as
    they lie (transposed and, in f32, split into TF32 parts inside the
    kernel), with no copy or packing launch."""
    def allocs():
        return torch.cuda.memory_stats()["allocation.all.allocated"]

    got, want = {}, {"fwd": [1, 1], "dfeat": [1, 1]}
    calls = [("fwd", kt.sparse_conv_fwd, (x, rbk, w, mask)),
             ("dfeat", kt.sparse_conv_dfeat, (dout, inv, w))]
    for name, fn, call in calls:
        torch.cuda.synchronize()
        counts = [allocs(), fn.launches]
        fn(*call)
        got[name] = [allocs() - counts[0], fn.launches - counts[1]]
    if got != want:
        raise AssertionError(f"one call: (allocations, launches) {got}")
    print(f"{str(x.dtype)[6:]} {', '.join(want)}: one call, one launch, one "
          "allocation (its output)")


def _dw_detail(x, rbk, dout, w, dw_tile) -> str:
    """The skipped shares, the partials' bytes and the time at each chunk
    size of one bf16 conv's dW; added to ``dw_tile``."""
    chunk, step, moved = dw_tile["skips"].add(
        rbk, x.shape[0], w.shape[1], w.shape[2], kt.DW_CHUNK_ROWS)
    sweep = []
    for rows in DW_CHUNK_SWEEP:
        t = median_ms(lambda r=rows: kt.sparse_conv_dw(x, rbk, dout, r), 10)
        dw_tile["sweep"][rows] += t
        sweep.append(f"{rows}: {t:.4f}")
    return (f", (chunk, tap) skipped {chunk:.3f}, "
            f"(step, tap) skipped {step:.3f}, partials {moved / 1e6:.2f} MB; "
            f"by chunk rows {', '.join(sweep)} ms")


KERNEL_FNS = (sc.fused_sparse_conv, sc.fused_sparse_conv_stream,
              kt.sparse_conv_fwd, kt.sparse_conv_dfeat, kt.sparse_conv_dw,
              ablate.sparse_conv_ablate, ablate.sparse_conv_ablate_mma,
              ablate.empty_launch, nms_cuda.rotated_nms)
# the entry kept for same-call comparisons (K1 at a forced cluster size):
# never on a main path
COMPARISON_FNS = (sc.fused_sparse_conv_at_split,)


def _reset_counts():
    for fn in KERNEL_FNS + COMPARISON_FNS:
        fn.launches = 0


def _counts() -> dict:
    """The main-path kernels' launches since ``_reset_counts``; raises if a
    comparison entry was launched in that time."""
    stray = {fn.__name__: fn.launches for fn in COMPARISON_FNS
             if fn.launches}
    if stray:
        raise AssertionError(f"comparison entries on the main path: {stray}")
    return {fn.__name__: fn.launches for fn in KERNEL_FNS}


def _no_saturation(trainer, what: str):
    """A training phase fails where its trainer saw a saturated chain."""
    if trainer.saturated_batches:
        raise AssertionError(f"{what}: {trainer.saturated_batches} batch(es) "
                             f"saturated a stage at caps "
                             f"{trainer.stage_capacity}")


def phase_train(trainer):
    """The main training path; returns its launch counts."""
    state = trainer.state
    start = [p.detach().clone() for p in state.student.parameters()]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(max_steps=TRAIN_STEPS - 1)
    tea0 = [p.detach().clone() for p in state.teacher.parameters()]
    s = state.step
    trainer.run(max_steps=TRAIN_STEPS)
    hist = trainer.history
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    _no_saturation(trainer, "training")

    for h in hist:
        bad = [k for k, v in h.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {h['step']}: non-finite {bad}")
        print(f"train step {h['step']}: {h['step_time'] * 1e3:9.3f} ms, "
              f"data {h['data_time'] * 1e3:9.3f} ms, loss {h['loss']:.5g} "
              f"(cls {h['cls_loss_reduced']:.4g}, ious {h['ious_loss']:.4g}"
              f", dir {h['dir_loss_reduced']:.4g}, iou_pred "
              f"{h['iou_pred_loss']:.4g}, consistency "
              f"{h['consistency_loss']:.4g}), grad_norm "
              f"{h['grad_norm']:.4g}, num_pos {h['num_pos']:.1f}")
    want = {"fused_sparse_conv": 0, "fused_sparse_conv_stream": 0,
            "sparse_conv_fwd": 24 * TRAIN_STEPS,
            "sparse_conv_dfeat": 9 * TRAIN_STEPS,
            "sparse_conv_dw": 10 * TRAIN_STEPS,
            "sparse_conv_ablate": 0, "sparse_conv_ablate_mma": 0,
            "empty_launch": 0, "rotated_nms": 0}
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    moved = max(float((p.detach() - p0).abs().max()) for p, p0 in
                zip(state.student.parameters(), start))
    if not moved > 0:
        raise AssertionError("the student did not move")
    alpha = min(1 - 1 / (s + 1), trainer.cfg.get("ema_decay_cap", 0.999))
    ema_err = max(float((e - (alpha * e0 + (1 - alpha) * p.detach()))
                        .abs().max())
                  for e, e0, p in zip(state.teacher.parameters(), tea0,
                                      state.student.parameters()))
    if not ema_err <= 1e-5:
        raise AssertionError(f"teacher off the EMA formula by {ema_err}")
    steady = hist[1:]
    step_ms = float(np.median([h["step_time"] for h in steady])) * 1e3
    data = sum(h["data_time"] for h in steady)
    share = data / (data + sum(h["step_time"] for h in steady))
    # the loop reads the device back only at log points and epoch ends, so
    # a step's step_time is the mean of the steps read back with it
    print(f"training: {len(hist)} steps at batch 4, stage caps "
          f"{trainer.stage_capacity} (no batch saturated), step median "
          f"{step_ms:.3f} ms (steps 2-{len(hist)}, means over each "
          f"read-back), data-time share "
          f"{share:.3f}, peak device memory {peak / 2 ** 30:.3f} GiB, "
          f"launches per step fwd {counts['sparse_conv_fwd'] // len(hist)}"
          f" dfeat {counts['sparse_conv_dfeat'] // len(hist)} dw "
          f"{counts['sparse_conv_dw'] // len(hist)}; student moved "
          f"{moved:.3e}, teacher vs EMA formula {ema_err:.1e}")
    return counts


def phase_step_parity(trainer):
    """One f32 step through the kernels, K4 through its plain twin
    (``kt.sparse_conv_fwd_ref``, so the forward and its ReLU masks are the
    twin step's) and dFeat and dW through the card's 3xTF32 kernels, and
    through the twins from the same state on the same batch."""
    db = first_batch(trainer)
    states, grads, metrics = [trainer.state], [], []
    twin_state = copy.deepcopy(trainer.state)
    twin_state.optimizer.params = list(twin_state.student.parameters())
    states.append(twin_state)
    kernels = pins.swapped(sparse_conv_fwd=kt.sparse_conv_fwd_ref)
    for state, ctx in zip(states, (kernels, pins.twins())):
        step = state.optimizer.step
        got = {}

        def capture(gs, step=step, got=got):
            got.update(zip([n for n, _ in
                            state.student.named_parameters()],
                           [g.detach().clone() for g in gs]))
            return step(gs)

        state.optimizer.step = capture
        try:
            with ctx:
                m = trainer.train_step(state, db, 0.5)
        finally:
            # the class's step again: a deep copy of this state must not
            # carry a closure that steps this optimizer
            del state.optimizer.step
        torch.cuda.synchronize()
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(got)
    worst_m = max(abs(metrics[0][k] - v) / (abs(v) + 1e-6)
                  for k, v in metrics[1].items())
    worst_g, worst_name = 0.0, ""
    for name, g in grads[1].items():
        peak = float(g.abs().max())
        if peak == 0:
            if grads[0][name].abs().max() != 0:
                raise AssertionError(f"{name}: kernel gradient nonzero")
            continue
        err = float((grads[0][name] - g).abs().max()) / peak
        if err > worst_g:
            worst_g, worst_name = err, name
    print(f"step parity f32 (K4 on its twin): loss "
          f"{metrics[0]['loss']:.6g} vs twin "
          f"{metrics[1]['loss']:.6g}; worst loss term rel {worst_m:.2e}; "
          f"worst gradient {worst_g:.2e} of its max ({worst_name})")
    if not worst_m <= 1e-4:
        raise AssertionError(f"loss terms differ by {worst_m:.3e}")
    if not worst_g <= 1e-3:
        raise AssertionError(f"gradient {worst_name} differs by {worst_g}")


def phase_step_parity_pinned(trainer):
    """One f32 step through the kernels as the training step runs them (K4
    through 3xTF32) against the same step through the twins, each from a
    copy of the trainer's state on the same batch, with the twin step's
    choices of ``pins.PINNED`` (every ReLU mask, student and teacher, and
    the rectangle ODIoU's diagonal takes) replayed into the kernel step
    (``StepPins``): loss terms within 1e-4 relative, each gradient within
    1e-3 of its max, the bounds of phase 6. The free reading (no replay)
    and the flipped ReLU elements per call are printed, not gated."""
    db = first_batch(trainer)
    card = card_line()
    choices = pins.StepPins(pins.PINNED)
    with choices.record():
        twin = pins.step(trainer, db, pins.twins())
    free = pins.compare(pins.step(trainer, db, choices.replay(pin=())), twin)
    flips = choices.summary()
    pinned = pins.compare(pins.step(trainer, db, choices.replay()), twin)
    relu, rect = flips["relu"], flips["argmin"]
    print(f"step parity f32, free (ungated): {pins.describe(free)}; ReLU "
          f"elements flipped {relu['flipped']} in {relu['calls_flipped']} of "
          f"{relu['calls']} calls, per call {relu['per_call']}; ODIoU "
          f"rectangles flipped {rect['flipped']} [{card}]")
    print(f"step parity f32, {', '.join(pins.PINNED)} pinned from the twin "
          f"step: {pins.describe(pinned)} [{card}]")
    if not pinned["ok"]:
        raise AssertionError(f"pinned step parity: {pins.describe(pinned)}")


def _same_tensors(a, b) -> bool:
    """Nested dicts / lists of tensors equal in dtype, shape and bits."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same_tensors, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_packed_step(trainer):
    """One f32 step on a packed batch (``train_step.pack_batch``, the
    Trainer's default) against the step on the same batch unpacked, from
    the same state. The batch's voxels are rounded through f16 first (the
    one field packing rounds), so ``unpack_batch`` on the card must give
    the unpacked batch's tensors bit for bit, and the two steps the same
    loss terms (1e-6 relative; 1e-5 for the gradient norm, whose backward
    sums may take another order between two runs)."""
    batches = iter(trainer.train_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    trainer._check_train_saturation(batch)
    for sfx in trainer.suffixes:
        batch["voxels" + sfx] = batch["voxels" + sfx].astype(
            np.float16).astype(np.float32)
    packed = pack_batch(batch)
    plain_db, packed_db = (trainer._device_batch(b) for b in (batch, packed))
    if not _same_tensors(unpack_batch(packed_db), plain_db):
        raise AssertionError("unpack_batch on the card differs from the "
                             "unpacked batch")

    def wire(db):
        return sum(v.numel() * v.element_size() for k, v in db.items()
                   if isinstance(v, torch.Tensor) and k != "anchors")

    metrics = []
    for db in (packed_db, plain_db):
        state = copy.deepcopy(trainer.state)
        state.optimizer.params = list(state.student.parameters())
        m = trainer.train_step(state, db, 0.5)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    worst = {k: abs(metrics[0][k] - v) / (abs(v) + 1e-12)
             for k, v in metrics[1].items()}
    loss_worst = max(v for k, v in worst.items() if k != "grad_norm")
    print(f"packed step f32: {wire(packed_db) / 1e6:.2f} MB of step "
          f"fields staged vs {wire(plain_db) / 1e6:.2f} MB unpacked; "
          f"unpack on the card bit-equal; loss {metrics[0]['loss']:.6g} vs "
          f"{metrics[1]['loss']:.6g}, worst loss term rel {loss_worst:.2e}, "
          f"grad_norm rel {worst['grad_norm']:.2e}")
    if not (loss_worst <= 1e-6 and worst["grad_norm"] <= 1e-5):
        raise AssertionError(f"packed step differs: {worst}")


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def phase_eval_kernels(trainer):
    """K3 on the 11 streamed convs of the first batch-4 eval batch, and K1
    timed on the 3 it keeps resident (``check_stream_convs``; the result's
    "k1_f32" is their PerLaunch)."""
    batches = iter(trainer.val_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    dev = trainer.device
    host_rb = trainer._eval_inputs(batch)
    vox = batch["voxels"]
    b, v = vox.shape[:2]
    full = saturated_stages(host_rb, [c * b for c in trainer.stage_capacity])
    if full:
        raise AssertionError(f"eval batch saturates stages {full} at caps "
                             f"{trainer.stage_capacity}")
    rb = {k: ([_put(a, dev) for a in x] if isinstance(x, list)
              else _put(x, dev))
          for k, x in host_rb.items()}
    model = trainer.state.student
    with torch.inference_mode():
        feats = model.reader(_put(vox, dev).reshape(b * v, *vox.shape[2:]),
                             _put(batch["num_points"], dev).reshape(b * v))
    k1 = PerLaunch()
    out = check_stream_convs(
        model.backbone, feats, rb, b, model.sparse_shape, torch.float32,
        "eval b4 f32 int32",
        streamed_convs(trainer.stage_capacity, b, torch.float32),
        resident=k1)
    out["k1_f32"] = k1
    return out


def _table_diff(a, b) -> list:
    """The entries in which two AP tables differ, NaN equal to NaN."""
    def flat(r):
        return {(c, m, d, k): float(v) for c, t in r.items()
                for m, ds in t.items() for d, ks in ds.items()
                for k, v in ks.items()}

    fa, fb = flat(a), flat(b)
    if fa.keys() != fb.keys():
        return sorted(set(fa) ^ set(fb))
    return [(k, fa[k], fb[k]) for k in fa
            if not (fa[k] == fb[k] or (math.isnan(fa[k])
                                       and math.isnan(fb[k])))]


def _detections_diff(a, b) -> list:
    """The images whose detections differ between two per-image lists (as
    ``Trainer.val_detections``): image ids in dataset order, boxes, scores
    and labels bit for bit."""
    def image(d):
        return d["metadata"]["image_idx"] if d["metadata"] else None

    if [image(d) for d in a] != [image(d) for d in b]:
        return [("image ids", [image(d) for d in a], [image(d) for d in b])]
    keys = ("box3d_lidar", "scores", "label_preds")
    return [(image(x), k) for x, y in zip(a, b) for k in keys
            if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k])]


def _ap_line(results) -> str:
    car = results["Car"]
    return ", ".join(f"{m} AP40 moderate {car[m][1]['AP40']:.4f}"
                     for m in ("bbox", "bev", "3d"))


def phase_eval(trainer, root, tmp):
    """The evaluation path: validate() over the val split, then the saved
    checkpoint through ``python -m sessd_torch.tools.test``. Both run with
    PyTorch's default TF32 settings (the tool's), so the neck's cuDNN convs
    compute the same bits in both processes. Returns the launches {K1, K3}
    of validate()."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _reset_counts()
        t0 = time.perf_counter()
        results = trainer.validate()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    per_gpu = trainer.cfg.data["samples_per_gpu"]
    n = -(-len(trainer.val_dataset) // per_gpu)
    k1, k3 = _want_launches(trainer.stage_capacity, per_gpu, torch.float32)
    want = {"fused_sparse_conv": k1 * n, "fused_sparse_conv_stream": k3 * n,
            "sparse_conv_fwd": 0, "sparse_conv_dfeat": 0,
            "sparse_conv_dw": 0, "sparse_conv_ablate": 0,
            "sparse_conv_ablate_mma": 0, "empty_launch": 0,
            "rotated_nms": 2 * n}
    if counts != want:
        raise AssertionError(f"validate launches {counts}, want {want}")
    if results is None or set(results) != {"Car"}:
        raise AssertionError(f"validate gave {results}")
    aps = [x for m in results["Car"].values() for d in m.values()
           for x in d.values()]
    if not all(math.isfinite(x) for x in aps):
        raise AssertionError("non-finite AP")
    print(f"eval: validate() over {len(trainer.val_dataset)} frames in "
          f"{n} batches of 4, {secs:.3f} s ({secs / n * 1e3:.1f} ms/batch "
          f"with the loader), launches per batch K1 "
          f"{counts['fused_sparse_conv'] // n} K3 "
          f"{counts['fused_sparse_conv_stream'] // n} rotated NMS "
          f"{counts['rotated_nms'] // n}; {_ap_line(results)}")

    trainer.save_checkpoint()
    out = os.path.join(tmp, "eval_results.pkl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        # the trainer's own config file: the same caps
        [sys.executable, "-m", "sessd_torch.tools.test", trainer.cfg.filename,
         "--work_dir", trainer.work_dir, "--data-root", root, "--out", out],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"tools.test exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    with open(out, "rb") as f:
        theirs = pickle.load(f)
    diff = _table_diff(theirs, results)
    if diff:
        raise AssertionError(f"tools.test AP differs from validate(): {diff}")
    print(f"eval: tools.test on the epoch-{trainer.epoch} checkpoint in "
          f"{time.perf_counter() - t0:.1f} s gave the same AP tables and "
          f"wrote {os.path.basename(out)}")
    return counts


# --- device inputs: voxelize and the rulebook chain on the card -----------

DEVICE_STEPS = 4
HEAD_BOUNDS = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


def _chain_diff(host: dict, dev: dict) -> list:
    """The arrays in which a device chain differs from a host one in dtype,
    shape or values."""
    bad = []
    for k in ("perm", "ids", "subm", "down"):
        hs = host[k] if isinstance(host[k], list) else [host[k]]
        ds = dev[k] if isinstance(dev[k], list) else [dev[k]]
        if len(hs) != len(ds):
            bad.append(f"{k}: {len(ds)} arrays, host {len(hs)}")
            continue
        for i, (h, d) in enumerate(zip(hs, ds)):
            h, d = np.asarray(h), d.cpu().numpy()
            if d.dtype != h.dtype or d.shape != h.shape \
                    or not np.array_equal(d, h):
                bad.append(f"{k}[{i}] {d.dtype}{d.shape} vs host "
                           f"{h.dtype}{h.shape}")
    return bad


def _host_coords(prep, scenes):
    """The coords [B*cap0, 4] bzyx and mask HostPreprocessor builds its
    chain from (its C++ voxelizer, each scene at the head of its block)."""
    spec, cap0 = prep.spec, prep.caps[0]
    coords = np.zeros((len(scenes) * cap0, 4), np.int32)
    valid = np.zeros((len(scenes) * cap0,), bool)
    for s, pts in enumerate(scenes):
        _, zyx, _ = prep.native.voxelize(
            pts, spec.point_cloud_range, spec.voxel_size, spec.max_points,
            min(spec.max_voxels, cap0))
        coords[s * cap0:s * cap0 + len(zyx)] = np.c_[
            np.full(len(zyx), s, np.int32), zyx]
        valid[s * cap0:s * cap0 + len(zyx)] = True
    return coords, valid


def _serving_chains(spec, scenes, device):
    """build_device_chain against HostPreprocessor's C++ chain on the same
    coords: each scene at batch 1 and 8 batches of 8 at SERVING_CAPS."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    requests = [[s] for s in scenes] + [
        [scenes[(r + j) % len(scenes)] for j in range(8)]
        for r in range(len(scenes))]
    dtypes = set()
    for n, batch in enumerate(requests):
        b = len(batch)
        host = (prep(batch[0]) if b == 1 else prep.batch(batch))["rulebooks"]
        coords, valid = _host_coords(prep, batch)
        dev, _ = sp.build_device_chain(
            _put(coords, device), _put(valid, device),
            (b,) + spec.sparse_shape, [c * b for c in SERVING_CAPS])
        bad = _chain_diff(host, dev)
        if bad:
            raise AssertionError(f"serving request {n} (batch {b}): device "
                                 f"chain differs from the host's: {bad}")
        dtypes.add((b, str(dev["subm"][0].dtype).replace("torch.", "")))
    print(f"device chain == host C++ chain (dtype, shape, values) on "
          f"{len(requests)} serving requests: {len(scenes)} at batch 1, "
          f"{len(scenes)} at batch 8, SERVING_CAPS; dtypes {sorted(dtypes)} "
          f"(batch 8: int32, stage-0 lookups by binary search)")
    return len(requests)


def _voxel_count(prep, pts) -> int:
    """Distinct in-range voxels of a scan, before any cap."""
    spec = prep.spec
    return len(prep.native.voxelize(pts, spec.point_cloud_range,
                                    spec.voxel_size, spec.max_points,
                                    10 ** 7)[1])


def _points_serving(spec, scenes, device):
    """Batch-1 points-in serving against host prep, f32 and bf16; returns
    (launch counts, timing line values)."""
    prep = HostPreprocessor(spec, SERVING_CAPS)
    counts = [_voxel_count(prep, pts) for pts in scenes]
    fits = [i for i, c in enumerate(counts) if c <= spec.max_voxels]
    over = [i for i, c in enumerate(counts) if c > spec.max_voxels]
    print(f"points-in serving: voxels per scene {counts}; scenes over "
          f"max_voxels={spec.max_voxels} (lowest-id survivors on the card, "
          f"FCFS on the host): {over or 'none'}")
    if not fits:
        raise AssertionError("no scene fits max_voxels: nothing to compare")
    stats = {}
    for config, dtype in (("se_ssd_kitti_car.py", torch.float32),
                          ("se_ssd_kitti_car_bf16.py", torch.bfloat16)):
        model, cfg = build_model(config, device, prior=True)
        anchors = builder.build_anchors(cfg)
        pcfg = builder.build_predict_config(cfg)
        infer = make_points_infer_fn(model, anchors, pcfg, spec,
                                     SERVING_CAPS, device)
        host_infer = make_infer_fn(model, anchors, pcfg, SERVING_CAPS, 1,
                                   device)
        worst = 0.0
        for i in fits:
            pts = _put(scenes[i], device)
            feats, rb = stage_inputs(**prep(scenes[i]), device=device)
            ones = torch.ones(feats.shape[0], dtype=torch.int32,
                              device=device)
            with torch.inference_mode():
                vox, num, chain, full = infer.stages(pts)
                if full.any():
                    raise AssertionError(f"scene {i}: stages "
                                         f"{full.tolist()} full")
                got = model(vox, num, chain, 1)[0]
                want = model(feats[:, None, :], ones, rb, 1)[0]
            for k in want:
                err = float((got[k].float() - want[k].float()).abs().max()
                            / want[k].float().abs().max())
                worst = max(worst, err)
        tag = str(dtype).replace("torch.", "")
        print(f"points-in head outputs {tag} vs host prep, {len(fits)} "
              f"scenes: worst {worst:.2e} of the max "
              f"(bound {HEAD_BOUNDS[dtype]})")
        if not worst <= HEAD_BOUNDS[dtype]:
            raise AssertionError(f"points-in heads {tag}: {worst:.3e}")
        if dtype == torch.float32:
            set_prior(model, False)  # scores ~0.5: detections to compare
            found = 0
            nms = nms_cuda.rotated_nms.launches
            for i in fits:
                got = infer(scenes[i])
                want = host_infer(**prep(scenes[i]))
                if not (torch.equal(got[2], want[2])
                        and torch.allclose(got[0], want[0], atol=1e-4)
                        and torch.allclose(got[1], want[1], atol=1e-5)):
                    raise AssertionError(f"scene {i}: points-in detections "
                                         "differ from host prep's")
                found += int(got[2].sum())
            if not found:
                raise AssertionError("no detection to compare")
            nms = nms_cuda.rotated_nms.launches - nms
            if nms != 2 * 2 * len(fits):  # points-in and host prep
                raise AssertionError(f"points-in f32: {nms} rotated NMS "
                                     f"launches for {2 * len(fits)} requests")
            print(f"points-in detections f32 (cls bias 0): the same "
                  f"{found} boxes as host prep on {len(fits)} scenes")
            continue
        # bf16 serving: latency, device prep on the card, host prep
        reqs = [scenes[i % len(scenes)] for i in range(2 * len(scenes) + 1)]
        lat = []
        before = sc.fused_sparse_conv.launches
        nms = nms_cuda.rotated_nms.launches
        for n, pts in enumerate(reqs):
            t0 = time.perf_counter()
            out = infer(pts)
            torch.cuda.synchronize()
            if n:  # request 0 is the warm-up
                lat.append((time.perf_counter() - t0) * 1e3)
            if not all(torch.isfinite(t.float()).all() for t in out[:2]):
                raise AssertionError("points-in: non-finite outputs")
        k1 = sc.fused_sparse_conv.launches - before
        nms = nms_cuda.rotated_nms.launches - nms
        if k1 != 14 * len(reqs) or sc.fused_sparse_conv_stream.launches \
                or nms != 2 * len(reqs):
            raise AssertionError(f"points-in: {k1} K1 and {nms} rotated NMS "
                                 f"launches for {len(reqs)} requests")
        dev_ms, host_ms = [], []
        for pts in scenes:
            on_card = _put(pts, device)
            with torch.inference_mode():
                dev_ms.append(median_ms(lambda: infer.stages(on_card), 5))
            prep(pts)
            t0 = time.perf_counter()
            prep(pts)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        stats = {"p50": float(np.percentile(lat, 50)),
                 "p90": float(np.percentile(lat, 90)),
                 "dev_prep": dev_ms, "host_prep": host_ms}
        print(f"points-in serving bf16 b1: {len(lat)} requests, p50 "
              f"{stats['p50']:.3f} ms p90 {stats['p90']:.3f} ms, 14 K1 "
              f"and 2 rotated NMS launches each; device prep (voxelize + "
              f"VFE-ready voxels + chain, CUDA events) per scene "
              f"{', '.join(f'{t:.3f}' for t in dev_ms)} ms; host prep "
              f"(C++ voxelize + VFE + chain) per scene "
              f"{', '.join(f'{t:.3f}' for t in host_ms)} ms")

        # no host sync on the card's half: voxelize, chain, backbone
        pts = _put(scenes[fits[0]], device)
        torch.cuda.synchronize()
        with torch.inference_mode():
            torch.cuda.set_sync_debug_mode("error")
            try:
                vox, num, chain, _ = infer.stages(pts)
                model.backbone(model.reader(vox, num), chain, 1,
                               model.sparse_shape, model.dtype)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        print("no host sync: voxelize_torch, build_device_chain and the "
              "backbone ran under torch.cuda.set_sync_debug_mode('error')")
    return stats


def _device_trainer(config, root, work, device, **values):
    """make_trainer's Trainer with ``data.host_rulebooks`` off."""
    path = write_config(config, f"{work}.py",
                        **{"stage_capacity": ACCEPT_CAPS, **values})
    with open(path, "a") as f:
        f.write("data = dict(data, host_rulebooks=False)\n")
    trainer = Trainer(load_train_config(path, root), work_dir=work,
                      seed=SEED, device=device)
    if trainer.host_inputs or trainer.train_loader.batch_transform:
        raise AssertionError("host_rulebooks=False left host chains on")
    return trainer


def _host_device_batch(trainer, batch):
    """The step's device batch with the loader's host chains added."""
    db = trainer._device_batch(batch)
    host = trainer.state.student.host_transform(trainer.stage_capacity,
                                                trainer.suffixes)(batch)
    for sfx in trainer.suffixes:
        db["inputs" + sfx] = {
            k: ([_put(a, trainer.device) for a in v] if isinstance(v, list)
                else _put(v, trainer.device))
            for k, v in host["inputs" + sfx].items()}
    return db, host


def _check_batch_chains(trainer, batch, host, what):
    b = batch["voxels"].shape[0]
    for sfx in trainer.suffixes:
        with torch.inference_mode():
            chain, _ = trainer.state.student.device_inputs(
                _put(batch["coords" + sfx], trainer.device),
                _put(batch["voxel_mask" + sfx], trainer.device), b)
        bad = _chain_diff(host["inputs" + sfx], chain)
        if bad:
            raise AssertionError(f"{what} chain{sfx or ' (student)'}: "
                                 f"{bad}")


def _index_types(trainer, batch):
    """One bf16 training forward and backward of the student on the
    batch-1 device chain of the batch's first scan (int16 at ACCEPT_CAPS)
    and on its int32 copy: outputs and every sparse conv's weight gradient
    bit-equal (K4, dFeat over the inverse rulebooks, dW)."""
    model, dev = trainer.state.student.train(), trainer.device
    chain, _ = model.device_inputs(_put(batch["coords"][:1], dev),
                                   _put(batch["voxel_mask"][:1], dev), 1)
    if chain["subm"][0].dtype != torch.int16:
        raise AssertionError(f"batch-1 chain is {chain['subm'][0].dtype}")
    chain32 = {k: ([a.int() for a in v] if isinstance(v, list) else v.int())
               for k, v in chain.items()}
    weights = [conv.weight for conv, _ in model.backbone.blocks()]
    got = []
    for rb in (chain, chain32):
        voxels = _put(batch["voxels"][0], dev).requires_grad_(True)
        before = kt.sparse_conv_dfeat.launches
        out = model(voxels, _put(batch["num_points"][0], dev), rb, 1,
                    train=True)[0]
        loss = sum(v.float().square().mean() for v in out.values())
        grads = torch.autograd.grad(loss, [voxels] + weights,
                                    allow_unused=True)
        # 9 convs' input gradients and the first conv's 16 -> 4
        if kt.sparse_conv_dfeat.launches - before != 10:
            raise AssertionError("the voxels' gradient did not run dFeat "
                                 "on the first conv")
        got.append([out["box_preds"].detach(), *grads])
    if not torch.isfinite(got[0][1]).all() or not got[0][1].any():
        raise AssertionError("voxel gradient not finite or all zero")
    if not all(a is b or torch.equal(a, b) for a, b in zip(*got)):
        raise AssertionError("int16 and int32 device chains train apart")
    print("device chain int16 (batch 1) and its int32 copy: training "
          "forward, the voxels' gradient (dFeat 16 -> 4 on the first conv) "
          "and the sparse convs' weight gradients bit-equal")


def _device_train(root, tmp, device):
    """bf16 batch-4 training on device chains at ACCEPT_CAPS; returns its
    launch counts."""
    trainer = _device_trainer("se_ssd_kitti_car_bf16.py", root,
                              f"{tmp}/work_device", device)
    batches = iter(trainer.train_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    # the first step on device chains and on host chains, same state
    db_host, _ = _host_device_batch(trainer, batch)
    db_dev = trainer._device_batch(batch)
    cw = sigmoid_rampup(0, trainer.cfg.get("consistency_rampup_epochs", 15))
    metrics = []
    for db in (db_dev, db_host):
        state = copy.deepcopy(trainer.state)
        state.optimizer.params = list(state.student.parameters())
        m = trainer.train_step(state, db, cw)
        metrics.append({k: float(v) for k, v in m.items()
                        if k != "saturated"})
    torch.cuda.synchronize()
    terms = [k for k in metrics[1] if k.endswith("loss")]
    worst = max(abs(metrics[0][k] - metrics[1][k])
                / (abs(metrics[1][k]) + 1e-6) for k in terms)
    print(f"device-chain step vs host-chain step (bf16, same batch and "
          f"state): {len(terms)} loss terms, worst rel {worst:.2e}; "
          f"grad_norm {metrics[0]['grad_norm']:.6g} vs "
          f"{metrics[1]['grad_norm']:.6g}")
    if not worst <= 1e-4:
        raise AssertionError(f"device-chain loss terms differ by {worst}")

    # the run; each batch it trained on is held against its host chains
    seen = []
    stage = trainer._device_batch

    def keep(batch):
        seen.append(batch)
        return stage(batch)

    trainer._device_batch = keep
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(max_steps=DEVICE_STEPS)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    trainer._device_batch = stage
    _finite_history(trainer, "device-chain training")
    _no_saturation(trainer, "device-chain training")
    want = {"sparse_conv_fwd": 24, "sparse_conv_dfeat": 9,
            "sparse_conv_dw": 10}
    if any(counts[k] != n * DEVICE_STEPS for k, n in want.items()) or \
            counts["fused_sparse_conv"] or counts["fused_sparse_conv_stream"]:
        raise AssertionError(f"device-chain training launches {counts}")
    for n, batch in enumerate(seen):
        host = trainer.state.student.host_transform(
            trainer.stage_capacity, trainer.suffixes)(batch)
        _check_batch_chains(trainer, batch, host, f"training batch {n}")
    _index_types(trainer, seen[0])
    print(f"device-chain training (bf16 b4, {ACCEPT_CAPS}, no batch "
          f"saturated): {_step_summary(trainer, peak)}; chains of all "
          f"{len(seen)} batches (student and teacher) == host C++ chains; "
          f"launches per step fwd 24 dfeat 9 dw 10")
    del trainer
    torch.cuda.empty_cache()
    return counts


def _device_eval(root, tmp, device):
    """f32 validate() on device chains (hybrid plan, K4); returns its
    launch counts."""
    trainer = _device_trainer("se_ssd_kitti_car.py", root,
                              f"{tmp}/work_device_f32", device)
    batches = iter(trainer.val_loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    b, v = batch["voxels"].shape[:2]
    model = trainer.state.student.eval()
    host = model.host_transform(trainer.stage_capacity)(batch)
    rb = {k: ([_put(a, device) for a in x] if isinstance(x, list)
              else _put(x, device)) for k, x in host["inputs"].items()}
    vox = _put(batch["voxels"], device).reshape(b * v, *batch["voxels"]
                                                .shape[2:])
    num = _put(batch["num_points"], device).reshape(b * v)
    with torch.inference_mode():
        chain, full = model.device_inputs(_put(batch["coords"], device),
                                          _put(batch["voxel_mask"], device),
                                          b)
        hyb = model(vox, num, chain, b, train=True)[0]
        ref = model(vox, num, rb, b)[0]
    if full.any() or _chain_diff(host["inputs"], chain):
        raise AssertionError("eval batch: device chain saturated or off the "
                             "host's")
    worst = max(float((hyb[k] - ref[k]).abs().max() / ref[k].abs().max())
                for k in ref)
    print(f"device-chain eval f32: hybrid plan (dense_from_stage "
          f"{model.dense_from_stage}, K4 + cuDNN) head outputs vs the host "
          f"chain's all-sparse plan (K1/K3) on val batch 0: worst "
          f"{worst:.2e} of the max")
    if not worst <= 1e-3:
        raise AssertionError(f"device-chain eval heads differ by {worst}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _reset_counts()
        t0 = time.perf_counter()
        results = trainer.validate()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    n = -(-len(trainer.val_dataset) // trainer.cfg.data["samples_per_gpu"])
    # the sparse convs of the plan: stages 0-2 and the strided conv into 3
    k4 = sum((1 if dk else 0) + (n_subm if stage < model.dense_from_stage
                                 else 0)
             for stage, (_, n_subm, dk, _, _) in enumerate(PLAN)
             if stage <= model.dense_from_stage)
    want = {k: 0 for k in counts}
    want["sparse_conv_fwd"] = k4 * n
    want["rotated_nms"] = 2 * n
    if counts != want:
        raise AssertionError(f"device-chain validate launches {counts}, "
                             f"want {want}")
    if results is None or trainer._eval_sat_warned:
        raise AssertionError("device-chain validate: no result, or a "
                             "saturated eval chain")
    print(f"device-chain eval: validate() over {len(trainer.val_dataset)} "
          f"frames in {n} batches, {secs:.3f} s ({secs / n * 1e3:.1f} "
          f"ms/batch with the loader), {k4} K4 launches per batch; "
          f"{_ap_line(results)}")
    del trainer
    torch.cuda.empty_cache()
    return counts


def phase_device_inputs(spec, root, tmp, device):
    """The inputs built on the card; returns the phase's launch counts."""
    scenes = [make_scene(seed=s)[0] for s in range(8)]
    _serving_chains(spec, scenes, device)
    _reset_counts()
    _points_serving(spec, scenes, device)
    serving = _counts()
    train = _device_train(root, tmp, device)
    evals = _device_eval(root, tmp, device)
    _reset_counts()
    get_flops.main(["se_ssd_kitti_car.py", "--device", str(device)])
    time_analyze.main(["--device", str(device)])
    tools = _counts()
    return {k: serving[k] + train[k] + evals[k] + tools[k] for k in serving}


ABLATE_BOUND = 2e-2  # bf16 inputs and outputs, f32 sums


def phase_ablation(device):
    """S1 and S2 through their scripts, then each against its plain
    version, then K1 at one, two and four CTAs per tile on S1's batch-1
    convs. Returns the launches of the scripts' run (the main path of
    these kernels), the times, errors and bounds."""
    inputs = bench_ablate.make_inputs(device)
    chain = bench_ablate.chain_inputs(device)
    _reset_counts()
    s1_ms = bench_ablate.run(inputs)
    mma_ms = bench_ablate.run_mma(inputs)
    chain_ms = bench_ablate.run_chain(chain)
    s2 = bench_launch.run()
    counts = _counts()
    for name in ("sparse_conv_ablate", "sparse_conv_ablate_mma",
                 "empty_launch"):
        if not counts[name]:
            raise AssertionError(f"the scripts launched no {name}")
    splits = bench_ablate.k1_at_splits(chain)

    feats, rb, w2, _ = bench_ablate.variant_args(inputs, "full")
    full = ablate.sparse_conv_ablate(feats, rb, w2, "full")
    in_order = ablate.scalar_tile_sum(feats, rb, w2)
    torch.cuda.synchronize()
    if not torch.equal(full.view(torch.int16), in_order.view(torch.int16)):
        raise AssertionError("S1 full differs from the scalar tile's "
                             "in-order sum")
    worst, plain_ms = 0.0, None
    for name in bench_ablate.VARIANTS:
        args = bench_ablate.variant_args(inputs, name)
        got = ablate.sparse_conv_ablate(*args)
        want = ablate.sparse_conv_ablate_ref(*args)
        torch.cuda.synchronize()
        rel, diff = _rel(got, want)
        worst = max(worst, diff)
        print(f"S1 {name:10s}: {s1_ms[name]:.4f} ms, rel_err vs plain "
              f"{rel:.2e}")
        if not (rel <= ABLATE_BOUND and torch.isfinite(got.float()).all()):
            raise AssertionError(f"S1 {name}: rel_err {rel:.3e}")
        if name == "full":
            plain_ms = queued_device_ms(
                lambda a=args: ablate.sparse_conv_ablate_ref(*a), 10)
    bound = Bound()
    bound.add((feats, rb, w2, full), hits(rb, feats.shape[0]), 16, 16,
              torch.bfloat16)
    for label, d in bench_ablate.differences(s1_ms).items():
        print(f"S1 {label}: {d:.4f} ms")

    # the tensor-core tile: full is bf16 K4 bit for bit on every shape,
    # every mode matches its plain version
    mma_worst = 0.0
    shapes = {"16->16": {v: bench_ablate.mma_variant_args(inputs, v)
                         for v in bench_ablate.MMA_VARIANTS}}
    shapes.update({conv: {m: (*args, m) for m in ablate.MMA_MODES}
                   for conv, args in chain.items()})
    for shape, variants in shapes.items():
        f, r, w, _ = variants["full"]
        k4 = kt.sparse_conv_fwd(f, r, w)
        for name, args in variants.items():
            got = ablate.sparse_conv_ablate_mma(*args)
            want = ablate.sparse_conv_ablate_mma_ref(*args)
            torch.cuda.synchronize()
            if name == "full" and not torch.equal(got.view(torch.int16),
                                                  k4.view(torch.int16)):
                raise AssertionError(f"S1 mma full {shape} differs from "
                                     "bf16 K4")
            if args[3] in ("copy_only", "fixed"):
                if got.any():
                    raise AssertionError(f"S1 mma {name} {shape}: nonzero")
                continue
            rel, diff = _rel(got, want)
            mma_worst = max(mma_worst, diff)
            if not (rel <= ABLATE_BOUND and torch.isfinite(got.float()).all()):
                raise AssertionError(f"S1 mma {name} {shape}: rel_err "
                                     f"{rel:.3e}")
    mma_plain_ms = queued_device_ms(
        lambda: ablate.sparse_conv_ablate_mma_ref(feats, rb, w2, "full"), 10)
    print("S1 tensor-core tile, 16->16: " + ", ".join(
        f"{n} {t:.4f}" for n, t in mma_ms.items()) + " ms")
    for label, d in bench_ablate.differences(
            mma_ms, bench_ablate.MMA_DIFFERENCES).items():
        print(f"S1 mma {label}: {d:.4f} ms")
    for conv, row in chain_ms.items():
        f, r, w = chain[conv]
        flags, skipped = sp.tile_tap_hits(r, f.shape[0])
        print(f"S1 tensor-core tile, batch-1 {conv} {w.shape[1]}->"
              f"{w.shape[2]} K={w.shape[0]} tiles {flags.shape[0]} "
              f"({int(flags.any(1).sum())} with a hit, taps skipped "
              f"{skipped:.3f}): " + ", ".join(
                  f"{m} {t:.4f}" for m, t in row.items())
              + " ms; K1 " + ", ".join(
                  f"S={k} {splits[conv][k]:.4f}"
                  for k in bench_ablate.SPLITS)
              + f" ms (rule S={splits[conv]['rule']})")
        for label, d in bench_ablate.differences(
                row, bench_ablate.MMA_DIFFERENCES_CHAIN).items():
            print(f"S1 mma {conv} {label}: {d:.4f} ms")

    out = torch.ones((bench_launch.NPAD, bench_launch.COUT),
                     dtype=torch.bfloat16, device=device)
    ablate.empty_launch(out, 256)
    torch.cuda.synchronize()
    s2_worst = float(out.float().abs().max())
    if s2_worst != 0:
        raise AssertionError(f"S2 left {s2_worst} in its output")
    s2_bound = Bound()
    s2_bound.add((out,), 0, 16, 16, torch.bfloat16)
    for block, r in s2["empty"].items():
        print(f"S2 {block:4d} rows/block: (a) host {r['a_host']['issue_us']:.2f}"
              f" us/call issued, {r['a_host']['synced_us']:.2f} synced; (b) "
              f"device {r['b_device_us']:.2f} us/launch; (c) one C call: host"
              f" {r['c_host']['issue_us']:.2f} us/launch, device "
              f"{r['c_device_us']:.2f} us/launch")
    g = s2["glue"]
    print(f"S2 (d) sparse_conv_fwd N={bench_launch.GLUE_N}: wrapper host "
          f"{g['wrapper_host']['issue_us']:.2f} us/call issued, device "
          f"{g['wrapper_device_us']:.2f} us; bare C launches host "
          f"{g['bare_host']['issue_us']:.2f} us/launch, device "
          f"{g['bare_device_us']:.2f} us")
    res = {"counts": counts, "s1_ms": s1_ms, "s1_worst": worst,
           "s1_plain_ms": plain_ms, "s1_bound": bound, "mma_ms": mma_ms,
           "mma_worst": mma_worst, "mma_plain_ms": mma_plain_ms,
           "chain_ms": chain_ms, "k1_at_split_ms": splits,
           "s2_ms": s2["empty"][256]["b_device_us"] / 1e3,
           "s2_worst": s2_worst,
           "s2_plain_ms": queued_device_ms(
               lambda: ablate.empty_launch_ref(out), 10),
           "s2_library_ms": queued_device_ms(lambda: out.zero_(), 10),
           "s2_bound": s2_bound}
    print(f"ablation: S1 full equals the scalar tile's in-order sum "
          f"bit for bit, the tensor-core full bf16 K4 bit for bit on all "
          f"four shapes, every mode within {ABLATE_BOUND} of its plain "
          f"version (full plain {plain_ms:.4f} ms, tensor-core full plain "
          f"{mma_plain_ms:.4f} ms, bound {bound.ms():.4f} ms "
          f"({bound.by()})); "
          f"S2 wrote zeros, {res['s2_ms'] * 1e3:.2f} us/launch on the "
          f"device (plain {res['s2_plain_ms'] * 1e3:.2f} us, out.zero_() "
          f"{res['s2_library_ms'] * 1e3:.2f} us, bound "
          f"{s2_bound.ms() * 1e3:.3f} us); launches S1 "
          f"{counts['sparse_conv_ablate']} (scalar) + "
          f"{counts['sparse_conv_ablate_mma']} (tensor-core) S2 "
          f"{counts['empty_launch']}")
    return res


def write_config(config, path, **values) -> str:
    """Write ``path``: a config file that runs the shipped ``config``, under
    that file's name so its own includes resolve, then sets ``values`` as a
    config file does (``Config`` has no ``__setattr__``), so ``cfg.get``
    reads them and the file can go to ``tools.test`` as it is."""
    with open(path, "w") as f:
        f.write(f"__file__ = {str(builder.CONFIG_DIR / config)!r}\n"
                "exec(compile(open(__file__).read(), __file__, 'exec'))\n"
                + "".join(f"{k} = {v!r}\n" for k, v in values.items()))
    return path


def make_trainer(config, root, work, device, **values):
    """A Trainer of the shipped ``config`` on the synthetic root at
    ACCEPT_CAPS, with ``values`` set, through a config file written beside
    the work dir (``<work>.py``, ``write_config``)."""
    path = write_config(config, f"{work}.py",
                        **{"stage_capacity": ACCEPT_CAPS, **values})
    cfg = load_train_config(path, root)
    return Trainer(cfg, work_dir=work, seed=SEED, device=device)


def _bf16_trainer(config, root, work, epochs, device):
    return make_trainer(config, root, work, device, precision="bfloat16",
                        total_epochs=epochs)


def phase_warm_start(root, tmp, device="cuda"):
    """CIA-SSD -> SE-SSD ``load_from``, then ``resume`` of the SE-SSD run.
    Returns the launches of the two training runs."""
    _reset_counts()
    cia = _bf16_trainer("cia_ssd_kitti_car.py", root, f"{tmp}/work_cia", 1,
                        device)
    cia.run()
    _no_saturation(cia, "warm start: CIA-SSD")
    cia_state = {k: v.detach().clone()
                 for k, v in mesh.state_tensors(cia.state).items()}
    cia_counts = (cia.state.optimizer.count, cia.state.optimizer.sched_count)
    del cia

    se = _bf16_trainer("se_ssd_kitti_car_bf16.py", root, f"{tmp}/work_se", 1,
                       device)
    se.load_from(f"{tmp}/work_cia")
    opt = se.state.optimizer
    got = mesh.state_tensors(se.state)
    for k, v in got.items():
        src = "student." + k.split(".", 1)[1] if k.startswith("teacher.") \
            else k
        if not torch.equal(v.cpu(), cia_state[src].cpu()):
            raise AssertionError(f"load_from: {k} differs from the CIA {src}")
    if (opt.sched_count, opt.count, se.state.step) != (0, 2, 0) \
            or cia_counts != (2, 2):
        raise AssertionError(f"load_from: sched_count {opt.sched_count}, "
                             f"count {opt.count}, step {se.state.step} "
                             f"(CIA counts {cia_counts})")
    se.run()
    _no_saturation(se, "warm start: SE-SSD")
    hist = se.history
    bad = [(h["step"], k) for h in hist for k, v in h.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if len(hist) != 2 or bad:
        raise AssertionError(f"SE-SSD after load_from: {len(hist)} steps, "
                             f"non-finite {bad}")
    counts = _counts()
    lr0 = hist[0]["lr"]
    if lr0 != se.lr_fn(0):
        raise AssertionError(f"first SE-SSD step applied lr {lr0}, want the "
                             f"restarted schedule's {se.lr_fn(0)}")

    again = _bf16_trainer("se_ssd_kitti_car_bf16.py", root,
                          f"{tmp}/work_se", 1, device)
    again.resume()
    o1, o2 = se.state.optimizer, again.state.optimizer
    want = (se.epoch, se.state.step, o1.count, o1.sched_count)
    have = (again.epoch, again.state.step, o2.count, o2.sched_count)
    if have != want:
        raise AssertionError(f"resume: (epoch, step, count, sched_count) "
                             f"{have}, want {want}")
    mine = mesh.state_tensors(se.state)
    theirs = mesh.state_tensors(again.state)
    diff = [k for k in mine if not torch.equal(mine[k], theirs[k])]
    if diff:
        raise AssertionError(f"resume: {len(diff)} tensors differ, e.g. "
                             f"{diff[:3]}")
    print(f"warm start: CIA-SSD 1 epoch (2 steps) -> load_from: teacher = "
          f"student = CIA student, moments equal, sched_count 0, count 2, "
          f"step 0; SE-SSD 2 steps (lr {lr0:.3g} = schedule(0), loss "
          f"{hist[-1]['loss']:.5g}); resume: epoch {have[0]}, step "
          f"{have[1]}, counts {have[2]}/{have[3]}, {len(mine)} tensors "
          f"equal; launches {counts}")
    return counts


PILLAR_REQUESTS = 12
SPLIT_REPS = 10


def _pillar_split(model, p, anchors, pcfg, device) -> dict:
    """Where a batch-1 pillar request's time goes after host prep: the
    host-to-device copy, the PFN, the scatter, the RPN, the head and
    predict, each run alone and synchronized, medians of SPLIT_REPS."""
    anchors = torch.from_numpy(anchors).to(device)
    times = {k: [] for k in ("h2d", "pfn", "scatter", "rpn", "head",
                             "predict")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    ny, nx = model.grid_size
    with torch.inference_mode():
        for _ in range(SPLIT_REPS + 1):
            vox, npts, coords, valid = timed("h2d", lambda: [
                torch.from_numpy(a).to(device) for a in (
                    p["voxels"], p["num_points"], p["pillars"]["coords"],
                    p["pillars"]["valid"])])
            feats = timed("pfn", lambda: model.reader(vox, npts, coords,
                                                      valid))
            bev = timed("scatter", lambda: pillar_scatter(
                feats, coords, valid, 1, ny, nx))
            x = timed("rpn", lambda: model.neck(bev))
            preds = timed("head", lambda: model.bbox_head(x)[0])
            timed("predict", lambda: predict_batch(
                {k: v.float() for k, v in preds.items()}, anchors, pcfg))
    return {k: float(np.median(v[1:])) for k, v in times.items()}


def phase_pillar_serving(tmp, device):
    """PointPillars (``point_pillars_kitti_car.py``, full width: 12,000
    pillars x 100 points on the 496 x 432 grid, 107,136 anchors), seeded
    random weights, batch 1 through ``PillarPreprocessor`` and
    ``make_pillar_infer_fn``: bf16 latency on ``make_scene(0-3)`` with the
    cls bias at the focal prior, then with the bias at 0; then the f32
    model (TF32 off) on the card against the same module's f32 run on the
    CPU: head outputs within 1e-3 of the max, and as many valid detections
    (> 0) as the CPU's and as the CPU's decode of the card's head
    outputs."""
    cfg = load_train_config(write_config(
        "point_pillars_kitti_car.py", f"{tmp}/pillars_bf16.py",
        precision="bfloat16"))
    model = builder.build_detector(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    set_prior(model, True)
    model.to(device)
    spec = builder.build_voxelizer(cfg.voxel_generator)
    anchors = builder.build_anchors(cfg)
    pcfg = builder.build_predict_config(cfg)
    prep = PillarPreprocessor(spec)
    infer = make_pillar_infer_fn(model, anchors, pcfg, 1, device)
    scenes = [make_scene(seed=s)[0] for s in range(4)]
    _reset_counts()

    for pts in scenes:  # warm the host allocations
        prep(pts)
    t0 = time.perf_counter()
    for pts in scenes:
        prep(pts)
    prep_ms = (time.perf_counter() - t0) / len(scenes) * 1e3
    lat, pillars = [], []
    nms = nms_cuda.rotated_nms.launches
    for n in range(PILLAR_REQUESTS + 1):
        if n == PILLAR_REQUESTS:
            set_prior(model, False)
        pts = scenes[n % 4]
        t0 = time.perf_counter()
        p = prep(pts)
        boxes, scores, valid = infer(p)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if n and n < PILLAR_REQUESTS:  # request 0 is the warm-up
            lat.append(dt)
        pillars.append(int(p["pillars"]["valid"].sum()))
        post = pcfg.nms_post_max_size
        if boxes.shape != (1, post, 7) or scores.shape != (1, post):
            raise AssertionError(f"pillars: shapes {boxes.shape} "
                                 f"{scores.shape}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError("pillars: non-finite outputs")
    nms = nms_cuda.rotated_nms.launches - nms
    if nms != 2 * (PILLAR_REQUESTS + 1):
        raise AssertionError(f"pillars serving: {nms} rotated NMS launches "
                             f"for {PILLAR_REQUESTS + 1} requests")
    bf16_valid = int(valid.sum())
    if not bf16_valid > 0:
        raise AssertionError("pillars bf16, prior off: no detections")
    set_prior(model, True)
    split = _pillar_split(model, prep(scenes[0]), anchors, pcfg, device)
    print(f"pillars serving bf16 b1: {len(anchors)} anchors, "
          f"{min(pillars)}-{max(pillars)} pillars per scene, p50 "
          f"{np.percentile(lat, 50):.3f} ms p90 {np.percentile(lat, 90):.3f}"
          f" ms over {len(lat)} requests (host prep included), host prep "
          f"{prep_ms:.3f} ms/scene, 2 rotated NMS launches a request; prior "
          f"off: {bf16_valid} valid detections")
    print("pillars b1 bf16 split (prior on; host-clock medians of "
          f"{SPLIT_REPS}, each stage synchronized): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))

    f32 = builder.build_detector(builder.load_config(
        "point_pillars_kitti_car.py"))
    f32.load_state_dict(model.state_dict())
    set_prior(f32, False)
    p = prep(scenes[0])
    out = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        f32.to(dev).eval()
        with torch.inference_mode():
            preds = f32(torch.from_numpy(p["voxels"]).to(dev),
                        torch.from_numpy(p["num_points"]).to(dev),
                        {k: torch.from_numpy(v).to(dev)
                         for k, v in p["pillars"].items()}, 1)[0]
        out[name] = {k: v.float().cpu() for k, v in preds.items()}
    worst = max(float((out["card"][k] - out["cpu"][k]).abs().max()
                      / out["cpu"][k].abs().max()) for k in out["cpu"])
    if not worst <= 1e-3:
        raise AssertionError(f"pillars f32 head, card vs CPU: {worst:.3e}")
    card = predict_batch({k: v.to(device) for k, v in out["card"].items()},
                         torch.from_numpy(anchors).to(device), pcfg)
    host = predict_batch(out["card"], torch.from_numpy(anchors), pcfg)
    full_host = int(predict_batch(out["cpu"], torch.from_numpy(anchors),
                                  pcfg)["valid"].sum())
    n_card, n_host = int(card["valid"].sum()), int(host["valid"].sum())
    if not n_card == n_host == full_host > 0:
        raise AssertionError(f"pillars f32 detections: card {n_card}, CPU "
                             f"{full_host}, CPU on the card's head outputs "
                             f"{n_host}")
    print(f"pillars f32 b1 (prior off): head card vs CPU within 1e-3 "
          f"(worst {worst:.2e}); {n_card} valid detections on the card, "
          f"{n_host} from the CPU's decode of the card's head outputs, "
          f"{full_host} from the CPU's own forward")
    counts = _counts()
    counts.pop("rotated_nms")  # the NMS pair of every decode on the card
    if any(counts.values()):
        raise AssertionError(f"pillars serving launched sparse kernels: "
                             f"{counts}")
    del model, f32
    torch.cuda.empty_cache()


BOX_SCALE = 0.05


def phase_dinms(spec, device):
    """DI-NMS on the card: one batch-1 SE-SSD Car request (f32, TF32 off)
    decoded with the weights set as a trained head's outputs fall: the cls
    bias at 0, so every anchor passes 0.3; the IoU head's bias at 1, raw IoU
    predictions near 1; the box head's weights scaled by BOX_SCALE, so
    boxes land near their anchors and overlap in clusters, where leaders
    pass cnt > 2.6. The request is decoded with
    ``nms_type="rotate_weighted_nms"``; ``rotate_weighted_nms`` on the
    decoded boxes against the port's host oracle (``core/nms_np.py``) on
    the same boxes: the same leaders kept (> 0; the card keeps the first
    nms_post_max_size in pick order), boxes within 1e-4 and scores within
    1e-5 (plus 1e-4 relative, the oracle sums in float64). The forward
    launches K1 and K3 as often as the stream rule gives; returns those
    launches."""
    model, cfg = build_model("se_ssd_kitti_car.py", device, prior=False)
    with torch.no_grad():
        task = model.bbox_head.tasks[0]
        task.conv_iou.bias.fill_(1.0)
        task.conv_box.weight.mul_(BOX_SCALE)
    anchors = torch.from_numpy(builder.build_anchors(cfg)).to(device)
    pcfg = builder.build_predict_config(cfg)._replace(
        nms_type="rotate_weighted_nms")
    prep = HostPreprocessor(spec, SERVING_CAPS)
    feats, rb = stage_inputs(**prep(make_scene(seed=0)[0]), device=device)
    ones = torch.ones(feats.shape[0], dtype=torch.int32, device=device)
    _reset_counts()
    with torch.inference_mode():
        preds = {k: v.float() for k, v in
                 model(feats[:, None, :], ones, rb, 1)[0].items()}
        counts = _counts()
        k1, k3 = _want_launches(SERVING_CAPS, 1, model.dtype)
        want = dict({n: 0 for n in counts}, fused_sparse_conv=k1,
                    fused_sparse_conv_stream=k3)
        if counts != want:
            raise AssertionError(f"DI-NMS request launches {counts}, want "
                                 f"{want}")
        t0 = time.perf_counter()
        dets = predict_batch(preds, anchors, pcfg)
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t0) * 1e3
        if nms_cuda.rotated_nms.launches:
            raise AssertionError("predict_batch with DI-NMS launched the "
                                 "rotated NMS pair")
        one = {k: v[0] for k, v in preds.items()}
        boxes = box_torch.second_box_decode(one["box_preds"], anchors)
        scores, labels = torch.sigmoid(one["cls_preds"]).max(dim=-1)
        iou_r = ((one["iou_preds"][:, 0] + 1.0) * 0.5).clamp(0.0, 1.0)
        nms_scores = torch.where(scores >= pcfg.score_threshold,
                                 scores * iou_r.pow(pcfg.iou_rectify_pow),
                                 -torch.inf)
        dirs = one["dir_cls_preds"].argmax(dim=-1)
        boxes5 = boxes[:, box_torch.BEV5_COLUMNS]
        t0 = time.perf_counter()
        got = rotate_weighted_nms(boxes, boxes5, dirs, labels, nms_scores,
                                  one["iou_preds"][:, 0], anchors,
                                  pre_max_size=pcfg.nms_pre_max_size,
                                  post_max_size=pcfg.nms_post_max_size)
        torch.cuda.synchronize()
        nms_ms = (time.perf_counter() - t0) * 1e3
    got = [t.cpu().numpy() for t in got]
    host = {k: v.cpu().numpy() for k, v in dict(
        boxes=boxes, boxes5=boxes5, dirs=dirs, labels=labels,
        scores=nms_scores, iop=one["iou_preds"][:, 0], anchors=anchors)
        .items()}
    order = np.argsort(-host["scores"], kind="stable")[:pcfg.nms_pre_max_size]
    order = order[np.isfinite(host["scores"][order])]
    h = {k: v[order] for k, v in host.items()}
    t0 = time.perf_counter()
    damped = nms_np.centerness_damp(h["boxes"], h["anchors"], h["scores"])
    ref_b, ref_d, ref_l, ref_s, _ = nms_np.rotate_weighted_nms_np(
        h["boxes"], h["boxes5"], h["dirs"], h["labels"], damped, h["iop"])
    host_s = time.perf_counter() - t0
    # the card keeps the first nms_post_max_size leaders in pick order
    m = int(got[4].sum())
    if not m == min(len(ref_b), pcfg.nms_post_max_size) > 0:
        raise AssertionError(f"DI-NMS kept {m} on the card, {len(ref_b)} on "
                             "the host")
    np.testing.assert_allclose(got[0][:m], ref_b[:m], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3][:m], ref_s[:m], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[1][:m], ref_d[:m])
    np.testing.assert_array_equal(got[2][:m], ref_l[:m])
    n_valid = int(dets["valid"].sum())
    if not n_valid > 0:
        raise AssertionError("predict with DI-NMS: no detections")
    print(f"DI-NMS b1 f32: {len(order)} candidates, {len(ref_b)} leaders "
          f"kept on the host, the first {m} (nms_post_max_size) equal on the"
          f" card: boxes within 1e-4 (worst "
          f"{np.abs(got[0][:m] - ref_b[:m]).max():.2e}), scores within 1e-5 "
          f"(worst {np.abs(got[3][:m] - ref_s[:m]).max():.2e}); card DI-NMS "
          f"{nms_ms:.1f} ms, host oracle {host_s:.1f} s; predict_batch "
          f"with DI-NMS {predict_ms:.1f} ms, {n_valid} valid detections; "
          f"the forward launched K1 {k1} and K3 {k3} times")
    del model
    torch.cuda.empty_cache()
    return counts


def _step_summary(trainer, peak) -> str:
    hist = trainer.history
    steady = hist[1:]
    step_ms = float(np.median([h["step_time"] for h in steady])) * 1e3
    data = sum(h["data_time"] for h in steady)
    share = data / (data + sum(h["step_time"] for h in steady))
    return (f"{len(hist)} steps, step median {step_ms:.3f} ms (steps "
            f"2-{len(hist)}), data-time share {share:.3f}, peak device "
            f"memory {peak / 2 ** 30:.3f} GiB, last loss "
            f"{hist[-1]['loss']:.5g}")


def _finite_history(trainer, what):
    bad = [(h["step"], k) for h in trainer.history for k, v in h.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite {bad}")


PILLAR_STEPS = 4


def phase_pillar_train(root, tmp, device):
    """A PointPillars Trainer (bf16, batch 2, no rulebooks) on the 8-frame
    root: one epoch of 4 steps, which ends in ``validate()``, then
    ``python -m sessd_torch.tools.test`` on its checkpoint, which must give
    the same AP tables. No sparse conv kernel launches."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer("point_pillars_kitti_car.py", root,
                           f"{tmp}/work_pillars", device,
                           precision="bfloat16", total_epochs=1)
    if (not isinstance(trainer.state.student, PointPillars)
            or len(trainer.train_loader) != PILLAR_STEPS):
        raise AssertionError(f"pillars trainer: {len(trainer.train_loader)}"
                             " steps per epoch")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # tools.test's setting
    try:
        results = trainer.run()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    peak = torch.cuda.max_memory_allocated()
    counts = _counts()
    n_val = -(-len(trainer.val_dataset) // trainer.cfg.data["samples_per_gpu"])
    if counts.pop("rotated_nms") != 2 * n_val:
        raise AssertionError(f"pillars validate: want 2 rotated NMS launches "
                             f"for each of {n_val} batches")
    if any(counts.values()):
        raise AssertionError(f"pillars launched sparse kernels: {counts}")
    _finite_history(trainer, "pillars training")
    if len(trainer.history) != PILLAR_STEPS or set(results) != {"Car"}:
        raise AssertionError(f"pillars: {len(trainer.history)} steps, "
                             f"validate gave {results}")
    print(f"pillars training bf16 b2: {_step_summary(trainer, peak)}; "
          f"{_ap_line(results)}")
    out = os.path.join(tmp, "pillars_eval.pkl")
    proc = subprocess.run(
        [sys.executable, "-m", "sessd_torch.tools.test", trainer.cfg.filename,
         "--work_dir", trainer.work_dir, "--data-root", root, "--out", out],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"pillars tools.test exited {proc.returncode}:"
                             f"\n{proc.stderr[-4000:]}")
    with open(out, "rb") as f:
        diff = _table_diff(pickle.load(f), results)
    if diff:
        raise AssertionError(f"pillars tools.test AP differs: {diff}")
    print("pillars eval: tools.test on the epoch-1 checkpoint gave the same "
          "AP tables")
    del trainer
    torch.cuda.empty_cache()


C3_STEPS = 4


def phase_3class(root, tmp, device):
    """The 3-class SE-SSD config (supervised, 6 anchors per location,
    211,200 anchors) at ACCEPT_CAPS: a bf16 Trainer takes 4 steps at batch
    4 (2 epochs of the 8-frame root) with exactly 10 forward, 9
    input-gradient and 10 weight-gradient launches per step and no
    saturated batch; then an f32 Trainer of the same config resumes its
    checkpoint and runs ``validate()`` with the K1 and K3 launches per batch
    the stream rule gives. Returns the launches of both."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer("se_ssd_kitti_3class.py", root, f"{tmp}/work_c3",
                           device, precision="bfloat16", total_epochs=2)
    trainer.run(max_steps=C3_STEPS)
    peak = torch.cuda.max_memory_allocated()
    train_counts = _counts()
    _no_saturation(trainer, "3-class training")
    _finite_history(trainer, "3-class training")
    want = {"sparse_conv_fwd": 10 * C3_STEPS,
            "sparse_conv_dfeat": 9 * C3_STEPS,
            "sparse_conv_dw": 10 * C3_STEPS}
    got = {k: train_counts[k] for k in want}
    if got != want or train_counts["fused_sparse_conv"] \
            or train_counts["fused_sparse_conv_stream"] \
            or train_counts["rotated_nms"]:
        raise AssertionError(f"3-class training launches {train_counts}")
    summary = _step_summary(trainer, peak)
    del trainer
    torch.cuda.empty_cache()

    trainer = make_trainer("se_ssd_kitti_3class.py", root, f"{tmp}/work_c3",
                           device, total_epochs=2)
    trainer.resume()
    if trainer.state.step != C3_STEPS:
        raise AssertionError(f"3-class resume: step {trainer.state.step}")
    shapes = []
    hook = trainer.state.student.bbox_head.register_forward_hook(
        lambda m, i, o: shapes.append(tuple(o[0]["cls_preds"].shape)))
    _reset_counts()
    try:
        results = trainer.validate()
    finally:
        hook.remove()
    eval_counts = _counts()
    per_gpu = trainer.cfg.data["samples_per_gpu"]
    n = -(-len(trainer.val_dataset) // per_gpu)
    k1, k3 = _want_launches(trainer.stage_capacity, per_gpu, torch.float32)
    got = (eval_counts["fused_sparse_conv"], eval_counts["fused_sparse_conv_stream"])
    if got != (k1 * n, k3 * n) or eval_counts["sparse_conv_fwd"] \
            or eval_counts["rotated_nms"] != 2 * n:
        raise AssertionError(f"3-class validate launches {eval_counts}")
    if set(shapes) != {(per_gpu, len(trainer.anchors), 3)}:
        raise AssertionError(f"3-class cls_preds shapes {set(shapes)}")
    if results is None or set(results) != {"Car", "Pedestrian", "Cyclist"}:
        raise AssertionError(f"3-class validate gave {results}")
    _no_saturation(trainer, "3-class eval")
    print(f"3-class training bf16 b4: {summary}; launches per step fwd "
          f"{want['sparse_conv_fwd'] // C3_STEPS} dfeat "
          f"{want['sparse_conv_dfeat'] // C3_STEPS} dw "
          f"{want['sparse_conv_dw'] // C3_STEPS}, no batch saturated")
    print(f"3-class eval f32: cls_preds {list(shapes[0])}, {n} batches, "
          f"launches per batch K1 {k1} K3 {k3} rotated NMS 2; "
          f"{_ap_line(results)}")
    del trainer
    torch.cuda.empty_cache()
    return {k: train_counts[k] + eval_counts[k] for k in train_counts}



# ---------------------------------------------------------------------------
# data parallel: ranks in processes of their own, through the tools

DP_WORLD = 2
DP_EPOCHS = 3  # one step per rank per epoch: 8 frames, 4 scenes per rank
SYNC_BOUND = 1e-5  # synced BN moments vs the gathered rows', of max|moment|


def rank_worker(spec: dict):
    """One rank of the data-parallel phases, in a process of its own
    (``chip_smoke.py --rank-worker SPEC``): ``main(argv)`` of
    ``sessd_torch.tools.train`` or ``tools.test``, with ``--coordinator``
    among the flags. Records this rank's kernel launches (those of the
    training steps apart from those of the final validation), its peak
    device memory, its ``Trainer.rank_report()``, and the first masked
    BatchNorm's synced moments beside the rows it normalized; writes them
    to ``spec["report"]`` (JSON) and the rows to ``spec["rows"]``, and the
    per-image detections of its last validation, where it has them (rank
    0), to ``spec["dets"]`` (pickle)."""
    from sessd_torch.models import layers
    from sessd_torch.tools import test as test_cli
    from sessd_torch.tools import train as train_cli

    first = {}
    batch_stats = layers.BatchNorm._batch_stats

    def capture(self, xf, mask):
        mean, var = batch_stats(self, xf, mask)
        if mask is not None and xf.dim() == 2 and not first:
            first.update(rows=xf[mask.reshape(-1).bool()].detach().cpu(),
                         mean=mean.detach().cpu(), var=var.detach().cpu())
        return mean, var

    layers.BatchNorm._batch_stats = capture
    phases = {}
    validate = Trainer.validate

    def counted_validate(self, *a, **k):
        phases["train"] = _counts()
        _reset_counts()
        return validate(self, *a, **k)

    Trainer.validate = counted_validate
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if spec["tool"] == "train":
        trainer = train_cli.main(spec["argv"])
    else:
        trainer, _ = test_cli.main(spec["argv"])
    torch.cuda.synchronize()
    phases["eval" if phases else "train"] = _counts()
    report = dict(trainer.rank_report(),
                  wall_s=time.perf_counter() - t0,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  launches=phases, collectives=dict(mesh.collectives))
    if first:
        torch.save(first, spec["rows"])
    if trainer.val_detections is not None:
        with open(spec["dets"], "wb") as f:
            pickle.dump(trainer.val_detections, f)
    with open(spec["report"], "w") as f:
        json.dump(report, f)


def _run_ranks(tool, argv, tmp, tag):
    """``DP_WORLD`` rank workers of ``tool`` with ``argv`` ("{rank}" is the
    rank) on cuda:0 over gloo; returns (reports, stdout per rank)."""
    port = mesh.free_port()
    procs, specs = [], []
    for r in range(DP_WORLD):
        spec = {"tool": tool, "report": f"{tmp}/{tag}_{r}.json",
                "rows": f"{tmp}/{tag}_{r}_rows.pt",
                "dets": f"{tmp}/{tag}_{r}_dets.pkl",
                "log": f"{tmp}/{tag}_{r}.log",
                "argv": [a.replace("{rank}", str(r)) for a in argv] + [
                    "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                    str(DP_WORLD), "--process-id", str(r), "--dist-backend",
                    "gloo", "--device", "cuda:0"]}
        specs.append(spec)
        with open(spec["log"], "w") as log, \
                open(spec["log"] + ".err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 json.dumps(spec)], stdout=log, stderr=err,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    # a rank that fails leaves the others waiting in a collective: stop
    # them all then
    deadline = time.monotonic() + 600
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for spec in specs:
        with open(spec["log"]) as f:
            outs.append(f.read())
    bad = [(r, p.returncode, open(s["log"] + ".err").read()[-3000:])
           for r, (p, s) in enumerate(zip(procs, specs)) if p.returncode]
    if bad:
        raise AssertionError(f"{tag}: ranks failed: {bad}")
    reports = []
    for spec in specs:
        with open(spec["report"]) as f:
            reports.append(json.load(f))
        if os.path.exists(spec["rows"]):
            reports[-1]["first_bn"] = torch.load(spec["rows"],
                                                 weights_only=True)
        if os.path.exists(spec["dets"]):
            with open(spec["dets"], "rb") as f:
                reports[-1]["detections"] = pickle.load(f)
    return reports, outs


def _check_synced_moments(reports):
    """The first masked BatchNorm's synced (mean, var) on every rank against
    those of all ranks' masked rows together (f64)."""
    rows = torch.cat([r["first_bn"]["rows"] for r in reports]).double()
    mean, var = rows.mean(0), rows.var(0, unbiased=False)
    worst = 0.0
    for r in reports:
        for got, want in ((r["first_bn"]["mean"], mean),
                          (r["first_bn"]["var"], var)):
            err = float((got.double() - want).abs().max()
                        / want.abs().max())
            worst = max(worst, err)
    if not worst <= SYNC_BOUND:
        raise AssertionError(f"synced BN moments off the gathered rows' by "
                             f"{worst:.3e} of max")
    return rows.shape, worst


def phase_data_parallel(root, tmp, card):
    """Two ranks on cuda:0 through ``tools.train --coordinator``, gloo: the
    bf16 SE-SSD config at ACCEPT_CAPS, 4 scenes per rank, DP_EPOCHS epochs
    of one step per rank (each rank a half of the 8 frames), a checkpoint
    per epoch and the final validation over the ranks. Returns (rank 0's
    work dir, the config file, the launches of both ranks)."""
    cfg = write_config("se_ssd_kitti_car_bf16.py", f"{tmp}/dp.py",
                       stage_capacity=ACCEPT_CAPS, total_epochs=DP_EPOCHS)
    reports, outs = _run_ranks(
        "train", [cfg, "--data-root", root, "--work_dir",
                  f"{tmp}/work_dp_{{rank}}"], tmp, "dp")
    h = [r["history"] for r in reports]
    for r, rep in enumerate(reports):
        if (rep["rank"], rep["world"]) != (r, DP_WORLD) \
                or rep["step"] != DP_EPOCHS or len(rep["history"]) != \
                DP_EPOCHS:
            raise AssertionError(f"rank {r}: {rep['rank']}/{rep['world']} "
                                 f"took {rep['step']} steps")
        if rep["saturated"]:
            raise AssertionError(f"rank {r}: {rep['saturated']} saturated "
                                 f"batch(es)")
        bad = [(s["step"], k) for s in rep["history"] for k, v in s.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"rank {r}: non-finite {bad}")
    keys = [k for k in h[0][0] if k not in ("data_time", "step_time")]
    if any([s[k] for s in h[r] for k in keys] != [s[k] for s in h[0]
                                                for k in keys]
           for r in range(1, DP_WORLD)):
        raise AssertionError("the ranks' losses differ")
    if len({rep["digest"] for rep in reports}) != 1:
        raise AssertionError(f"final states differ: "
                             f"{[rep['digest'][:12] for rep in reports]}")
    lead = f"{tmp}/work_dp_0"
    written = [os.listdir(f"{tmp}/work_dp_{r}") for r in range(DP_WORLD)]
    if not os.path.exists(f"{lead}/checkpoints/epoch_{DP_EPOCHS}.pt") \
            or any(written[1:]) \
            or not os.path.exists(f"{lead}/eval_results.json"):
        raise AssertionError(f"work dirs hold {written}")
    want = {"sparse_conv_fwd": 24 * DP_EPOCHS,
            "sparse_conv_dfeat": 9 * DP_EPOCHS,
            "sparse_conv_dw": 10 * DP_EPOCHS}
    n_eval = _rank_batches(cfg, root)
    for r, rep in enumerate(reports):
        got = {k: rep["launches"]["train"][k] for k in want}
        if got != want or rep["launches"]["train"]["fused_sparse_conv"] \
                or rep["launches"]["train"]["rotated_nms"]:
            raise AssertionError(f"rank {r} training launches "
                                 f"{rep['launches']['train']}, want {want}")
        if rep["launches"]["eval"]["rotated_nms"] != 2 * n_eval:
            raise AssertionError(f"rank {r} validation launches "
                                 f"{rep['launches']['eval']}, want 2 rotated "
                                 f"NMS for each of {n_eval} batch(es)")
    shape, worst = _check_synced_moments(reports)
    for r, rep in enumerate(reports):
        steps = rep["history"][1:]
        ms = float(np.median([s["step_time"] for s in steps])) * 1e3
        per_step = {k: v // DP_EPOCHS for k, v in
                    rep["collectives"].items() if k in ("bn", "grad",
                                                        "metrics")}
        fwd, dfeat, dw = (rep["launches"]["train"][k] // DP_EPOCHS
                          for k in want)
        print(f"data parallel rank {r}/{DP_WORLD} (gloo, both on cuda:0, "
              f"bf16 b4 per rank): step median {ms:.3f} ms (steps "
              f"2-{DP_EPOCHS}), peak device memory {rep['peak_gib']:.3f} "
              f"GiB, wall {rep['wall_s']:.1f} s, losses "
              f"{[round(s['loss'], 5) for s in rep['history']]}, launches "
              f"per step fwd {fwd} dfeat {dfeat} dw {dw}, collectives per "
              f"step {per_step}; {card}")
    print(f"data parallel: {DP_WORLD} ranks bit-equal after {DP_EPOCHS} "
          f"steps (digest {reports[0]['digest'][:12]}), equal losses, no "
          f"saturated batch, only rank 0 wrote checkpoints and "
          f"eval_results.json; first masked BN's synced moments vs the "
          f"{shape[0]} gathered rows x {shape[1]} channels: {worst:.2e} of "
          f"max")
    counts = {k: sum(rep["launches"][p][k] for rep in reports
                     for p in rep["launches"])
              for k in reports[0]["launches"]["train"]}
    return lead, cfg, counts


NCCL_STEPS = 2


def _copy_state(dst, src):
    """``src``'s TrainState into ``dst``'s, in place."""
    dst.student.load_state_dict(src.student.state_dict())
    dst.teacher.load_state_dict(src.teacher.state_dict())
    dst.optimizer.load_state_dict(src.optimizer.state_dict())
    dst.step = src.step


def phase_data_parallel_nccl(root, tmp, device):
    """One rank over NCCL (f32, TF32 off): a Trainer in a process group of
    one against a Trainer outside any group, from the same seed on the same
    batches, NCCL_STEPS steps, each from the outside trainer's state before
    it; the loss terms within 1e-4 relative. (The group's masked
    BatchNorm combines each rank's moments pairwise, which in a group of
    one gives the local moments bit for bit; its backward and the
    collectives sum in another order. Chained, the second step would
    differ by more: Adam's first step moves a parameter whose gradient is
    within rounding of 0 by about lr either way.) The group's collectives
    (BN syncs, gradient and metric buckets, the state broadcast, the
    checkpoint barrier) run on the card."""
    import torch.distributed as dist

    _reset_counts()
    ref = make_trainer("se_ssd_kitti_car.py", root, f"{tmp}/work_nccl_ref",
                       device)
    mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                          backend="nccl", device=device)
    try:
        mesh.collectives.clear()
        dp = make_trainer("se_ssd_kitti_car.py", root,
                          f"{tmp}/work_nccl_dp", device)
        for n in range(1, NCCL_STEPS + 1):
            _copy_state(dp.state, ref.state)
            ref.run(max_steps=n)
            dp.run(max_steps=n)
        torch.cuda.synchronize()
        coll = dict(mesh.collectives)
        group = dp.group
    finally:
        dist.destroy_process_group()
    counts = _counts()
    if ref.group is not None or group is None \
            or coll.get("grad") != NCCL_STEPS:
        raise AssertionError(f"groups {ref.group}, {group}; collectives "
                             f"{coll}")
    worst = 0.0
    for a, b in zip(ref.history, dp.history):
        for k, v in a.items():
            if k in ("step", "epoch", "lr", "data_time", "step_time"):
                continue
            err = abs(b[k] - v)
            if not (err <= 1e-4 * abs(v) or err <= 1e-7):
                raise AssertionError(f"NCCL step {a['step']} {k}: {b[k]} vs "
                                     f"{v}")
            worst = max(worst, err / abs(v) if err > 1e-7 else 0.0)
    if len(dp.history) != NCCL_STEPS:
        raise AssertionError(f"NCCL: {len(dp.history)} steps")
    _no_saturation(dp, "data parallel NCCL")
    print(f"data parallel NCCL: 1 rank, {NCCL_STEPS} f32 steps, loss terms "
          f"within {worst:.2e} relative of the trainer outside a group; "
          f"collectives {coll}; step times "
          f"{[round(h['step_time'] * 1e3, 3) for h in dp.history]} ms vs "
          f"{[round(h['step_time'] * 1e3, 3) for h in ref.history]} ms")
    del ref, dp
    torch.cuda.empty_cache()
    return counts


def _rank_batches(cfg, root, world=DP_WORLD) -> int:
    """Validation batches of one rank of ``world`` under config file
    ``cfg``: its share of the val split in batches of ``samples_per_gpu``
    (the last padded)."""
    conf = load_train_config(cfg, root)
    per_rank = -(-len(builder.build_dataset(conf, "val")) // world)
    return -(-per_rank // conf.data["samples_per_gpu"])


def phase_multiprocess_eval(root, tmp, lead, cfg):
    """Two ranks of ``tools.test --coordinator`` (gloo, cuda:0) on the
    data-parallel checkpoint against one process's ``tools.test`` of it
    (PyTorch's default TF32 settings in both, the tool's): rank 0's table
    equal entry for entry and its merged per-image detections bit for bit,
    rank 1's output without either, K1 and K3 launches per rank as the
    stream rule gives. Each rank names its own work dir, and rank 1's
    holds no checkpoint: it evaluates the one rank 0 sends. Both sides run
    batches of ``samples_per_gpu`` (eval pads the last), so each K1 launch
    has the same rows and cluster size S on both; K1 deals tap k to rank k
    mod S, so a scan's bits do not depend on the scans beside it. Returns
    the launches of both ranks."""
    from sessd_torch.tools import test as test_cli

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _reset_counts()
        t0 = time.perf_counter()
        trainer, single = test_cli.main([cfg, "--work_dir", lead,
                                         "--data-root", root])
        single_s = time.perf_counter() - t0
        single_counts = _counts()
        single_dets = trainer.val_detections
        del trainer
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = f"{tmp}/mp_eval_{{rank}}.pkl"
    reports, outs = _run_ranks(
        "test", [cfg, "--work_dir", f"{tmp}/work_dp_{{rank}}", "--data-root",
                 root, "--out", out],
        tmp, "mp_eval")
    with open(out.format(rank=0), "rb") as f:
        merged = pickle.load(f)
    diff = _table_diff(merged, single)
    if diff:
        raise AssertionError(f"multi-process AP differs: {diff}")
    diff = _detections_diff(reports[0]["detections"], single_dets)
    if diff or "detections" in reports[1]:
        raise AssertionError(f"multi-process detections differ: {diff[:5]}")
    n_boxes = sum(len(d["scores"]) for d in single_dets)
    if os.path.exists(out.format(rank=1)) or "AP11@" in outs[1] \
            or "AP11@" not in outs[0]:
        raise AssertionError("rank 1 printed or wrote a table, or rank 0 "
                             "none")
    conf = load_train_config(cfg, root)
    per_gpu = conf.data["samples_per_gpu"]
    n = _rank_batches(cfg, root)
    n_single = _rank_batches(cfg, root, world=1)
    if single_counts["rotated_nms"] != 2 * n_single:
        raise AssertionError(f"tools.test launches {single_counts}, want 2 "
                             f"rotated NMS for each of {n_single} batches")
    k1, k3 = _want_launches(ACCEPT_CAPS, per_gpu, torch.bfloat16)
    for r, rep in enumerate(reports):
        got = rep["launches"]["eval"]
        if (got["fused_sparse_conv"], got["fused_sparse_conv_stream"],
                got["rotated_nms"]) != (k1 * n, k3 * n, 2 * n) \
                or got["sparse_conv_fwd"]:
            raise AssertionError(f"rank {r} eval launches {got}")
        print(f"multi-process eval rank {r}/{DP_WORLD}: {n} batch(es) of "
              f"{per_gpu}, launches K1 {got['fused_sparse_conv']} K3 "
              f"{got['fused_sparse_conv_stream']} rotated NMS "
              f"{got['rotated_nms']}, wall {rep['wall_s']:.1f}"
              f" s, peak device memory {rep['peak_gib']:.3f} GiB")
    print(f"multi-process eval: rank 0's AP tables equal one process's "
          f"tools.test ({single_s:.1f} s) entry for entry, its merged "
          f"detections bit for bit ({len(single_dets)} images, {n_boxes} "
          f"boxes, in dataset order); rank 1 printed none; "
          f"{_ap_line(merged)}")
    counts = {k: single_counts[k] + sum(rep["launches"]["eval"][k]
                                        for rep in reports)
              for k in single_counts}
    return counts



ACCEPT_ARGS = ("8", "4", "1", "1", "1")


def phase_acceptance(tmp):
    """The acceptance script's path at a tiny recipe, in a subprocess."""
    out = os.path.join(tmp, "acceptance.json")
    proc = subprocess.run(
        [sys.executable, "-m", "sessd_torch.scripts.acceptance_ap",
         *ACCEPT_ARGS, "--out", out], capture_output=True, text=True,
        timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"acceptance_ap exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    with open(out) as f:
        rec = json.load(f)
    floor = rec["floor"]
    traj = {s: rec[s]["ap_trajectory"] for s in ("stage_cia", "stage_sessd")}
    # stage A: its final val; stage B: final val + the teacher's
    if [len(t) for t in traj.values()] != [1, 2] or not math.isfinite(
            floor["value"]) or floor["required"] != 70.0:
        raise AssertionError(f"acceptance record: floor {floor}, "
                             f"trajectories {traj}")
    print(f"acceptance path ({' '.join(ACCEPT_ARGS)}): {rec['total_steps']} "
          f"steps, floor {floor['metric']} {floor['value']} (required "
          f"{floor['required']}), trajectory rows "
          f"{[len(t) for t in traj.values()]}, timing "
          f"{rec['stage_sessd']['timing']}, wall {rec['wall_s']} s")


# f32 operations of one IoU pair in csrc/rotated_nms.cu (iou_pair): two
# clips of 4 edges, each edge 2 (its vector) + 4 half-planes x 12 (edge 2,
# s0 5, sd 3, negation, division) + 8 (u, v) + 4 (the cross product
# halved), 3 sums a clip; then the intersection's sum, the union's two and
# the division. Comparisons and min/max are not counted.
NMS_PAIR_FLOPS = 2 * (4 * (2 + 4 * 12 + 8 + 4) + 3) + 4


def nms_inputs(pre: int, live: int, device, seed=SEED):
    """Batch 8 of ``pre`` car-sized [7] boxes in groups of about six within
    0.6 m, with ``live`` valid scores a scene (the rest -inf), each scene in
    its stable descending score order, as ``predict_batch`` hands them to
    the NMS."""
    rng = np.random.RandomState(seed)
    n = 8 * pre
    # each scene's boxes around its own pre // 6 centers
    at = rng.randint(0, max(1, pre // 6), n) + np.repeat(np.arange(8) * pre,
                                                          pre)
    cx, cy = rng.uniform(0, 70, n)[at], rng.uniform(-35, 35, n)[at]
    boxes = np.stack([cx + rng.normal(0, 0.6, n), cy + rng.normal(0, 0.6, n),
                      rng.uniform(-1.2, -0.8, n), 1.6 + rng.normal(0, 0.05, n),
                      3.9 + rng.normal(0, 0.1, n), np.full(n, 1.5),
                      rng.uniform(-np.pi, np.pi, n)], 1).reshape(8, pre, 7)
    scores = rng.rand(8, pre)
    scores[:, live:] = -np.inf
    scores = torch.from_numpy(scores.astype(np.float32)).to(device)
    top, order = nms_score_order(scores, pre)
    rows = order[..., None].expand(-1, -1, 7)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(device)
    return boxes.gather(1, rows).contiguous(), top.contiguous()


def phase_nms(device):
    """Phase 22: the rotated-NMS pair at serving's shapes against its twin,
    timed beside its bound; returns the kernels line's rows by pre."""
    rows = {}
    for pre, live in ((256, 70), (1000, 1000)):
        boxes, scores = nms_inputs(pre, live, device)
        got = nms_cuda.rotated_nms(boxes, scores, 100, 0.01)
        want = nms_cuda.rotated_nms_ref(boxes, scores, 100, 0.01)
        # kept ranks and validity flags as integers: 0 where they agree
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        if err:
            raise AssertionError(f"rotated NMS at pre {pre}: the kernel "
                                 f"pair's kept ranks differ from the twin's "
                                 f"by up to {err}")
        ms = median_ms(lambda: nms_cuda.rotated_nms(boxes, scores, 100, 0.01))
        plain = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nms_cuda.rotated_nms_ref(boxes, scores, 100, 0.01)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        # the greedy needs the IoU of each pair of valid boxes
        valid = (scores > -torch.inf).sum(dim=1)
        pairs = int((valid * (valid - 1) // 2).sum())
        words = (pre + 63) // 64
        bound = Bound()
        # boxes and scores read; the mask written, then read by the scan;
        # int64 ranks and bool flags written
        moved = (4 * (boxes.numel() + scores.numel()) + 2 * 8 * pre * words * 8
                 + 8 * min(pre, 100) * 9)
        bound.seconds = {"bytes": moved / HBM_BYTES_PER_S,
                         "operations": pairs * NMS_PAIR_FLOPS
                         / PEAK_FLOPS[torch.float32]}
        rows[pre] = {"ms": ms, "plain_ms": float(np.median(plain)),
                     "bound_ms": bound.ms(), "bound_by": bound.by(),
                     "iou_pairs": pairs, "max_abs_err": float(err),
                     "kept": int(got[1].sum())}
        print(f"rotated NMS, batch 8, pre {pre}, {live} valid a scene: pair "
              f"{ms:.4f} ms, twin {rows[pre]['plain_ms']:.2f} ms (host "
              f"clock), bound {bound.ms():.5f} ms ({bound.by()}, {pairs} IoU "
              f"pairs), share {100 * bound.ms() / ms:.2f}%, "
              f"{rows[pre]['kept']} kept, largest difference from the twin "
              f"{err}; {card_line()}")
    return rows


def phase_centerpoint(device):
    """Phase 23: CenterPoint's new kernel instances and the NMS at pre
    4096, each against its twin, timed beside its bound."""
    rng = np.random.RandomState(SEED)

    def conv_inputs(n, cin, cout, taps=27, hit=0.3):
        rb = rng.randint(0, n, (n, taps))
        rb[rng.rand(n, taps) > hit] = n
        rb[:, taps // 2] = np.arange(n)  # a submanifold conv's centre tap
        f = torch.from_numpy(rng.randn(n, cin).astype(np.float32))
        w = torch.from_numpy((rng.randn(taps, cin, cout)
                              / np.sqrt(taps * cin)).astype(np.float32))
        b = torch.from_numpy((rng.randn(cout) * 0.3).astype(np.float32))
        return f, torch.from_numpy(rb.astype(np.int32)), w, b

    def row(name, got, want, ms, bound):
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        if err > 2e-2:
            raise AssertionError(f"{name}: {err:.3g} of the twin's max")
        print(f"CenterPoint {name}: {ms:.4f} ms, bound {bound.ms():.4f} ms "
              f"({bound.by()}), share {100 * bound.ms() / ms:.2f}%, "
              f"{err:.2e} of the twin's max; {card_line()}")

    n = 120000
    for cin, cout in sc.WIDE_PAIRS:
        f, rb, w, b = conv_inputs(n, cin, cout)
        args = (f.to(device, torch.bfloat16), rb.to(device),
                w.to(device, torch.bfloat16), b.to(device), n)
        want = sc.fused_sparse_conv_ref(*args)
        bound = Bound()
        bound.add([args[0], args[1], args[2], want], hits(args[1], n), cin,
                  cout, torch.bfloat16)
        for name, fn in (("K1", sc.fused_sparse_conv),
                         ("K3", sc.fused_sparse_conv_stream)):
            row(f"{name} {cin} -> {cout} ({n} rows)", fn(*args), want,
                median_ms(lambda: fn(*args)), bound)
    # the residual blocks' store: the identity added before the ReLU, at
    # each width of the backbone, at its stage's rows in a batch of 4 scans
    for c, n in ((16, 430000), (32, 350000), (64, 150000), (128, 60000)):
        f, rb, w, b = conv_inputs(n, c, c)
        res = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(
            device, torch.bfloat16)
        args = (f.to(device, torch.bfloat16), rb.to(device),
                w.to(device, torch.bfloat16), b.to(device), n)
        want = sc.fused_sparse_conv_ref(*args, residual=res)
        bound = Bound()
        bound.add([args[0], args[1], args[2], res, want], hits(args[1], n),
                  c, c, torch.bfloat16)
        for name, fn in (("K1", sc.fused_sparse_conv),
                         ("K3", sc.fused_sparse_conv_stream)):
            row(f"{name} {c} -> {c} residual ({n} rows)",
                fn(*args, residual=res), want,
                median_ms(lambda: fn(*args, residual=res)), bound)
    n = 800000
    f, rb, w, b = conv_inputs(n, 5, 16, hit=0.15)
    want = sc.fused_sparse_conv_ref(f.to(device, torch.bfloat16),
                                    rb.to(device),
                                    w.to(device, torch.bfloat16),
                                    b.to(device), n)
    args = (torch.nn.functional.pad(f, (0, 11)).to(device, torch.bfloat16),
            rb.to(device),
            torch.nn.functional.pad(w, (0, 0, 0, 11)).to(device,
                                                         torch.bfloat16),
            b.to(device), n)
    bound = Bound()
    bound.add([f, rb, w, want], hits(args[1], n), 5, 16, torch.bfloat16)
    for name, fn in (("K1", sc.fused_sparse_conv),
                     ("K3", sc.fused_sparse_conv_stream)):
        row(f"{name} first conv 5 (padded to 16) -> 16 ({n} rows)",
            fn(*args), want, median_ms(lambda: fn(*args)), bound)
    boxes, scores = nms_inputs(4096, 2800, device)
    boxes, scores = boxes[:4].contiguous(), scores[:4].contiguous()
    got = nms_cuda.rotated_nms(boxes, scores, 500, 0.7)
    want = nms_cuda.rotated_nms_ref(boxes, scores, 500, 0.7)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("rotated NMS at pre 4096: the pair's kept ranks "
                             "differ from the twin's")
    ms = median_ms(lambda: nms_cuda.rotated_nms(boxes, scores, 500, 0.7))
    bound = Bound()
    pairs = 4 * 2800 * 2799 // 2
    bound.seconds = {"bytes": (4 * (boxes.numel() + scores.numel())
                               + 2 * 8 * 4 * 4096 * 64) / HBM_BYTES_PER_S,
                     "operations": pairs * NMS_PAIR_FLOPS
                     / PEAK_FLOPS[torch.float32]}
    print(f"CenterPoint rotated NMS, batch 4, pre 4096, 2800 valid a scene: "
          f"pair {ms:.4f} ms, bound {bound.ms():.4f} ms ({bound.by()}), "
          f"share {100 * bound.ms() / ms:.2f}%, {int(got[1].sum())} kept, "
          f"equal to the twin; {card_line()}")


FOLD_BATCHES = 8


def _bev_nchw(dense):
    b, d, h, w, c = dense.shape
    return dense.permute(0, 4, 1, 2, 3).reshape(b, c * d, h, w)


@contextlib.contextmanager
def unfolded_path():
    """The serving path as it ran before the BatchNorm fold: every
    ``layers.Sequential`` as ``nn.Sequential`` (each BatchNorm its own
    passes), eval conv weights NCHW, the backbone's BEV map NCHW."""
    saved = (layers.Sequential.forward, layers._eval_layout, bb.bev_nhwc)
    layers.Sequential.forward = torch.nn.Sequential.forward
    layers._eval_layout = lambda module: False
    bb.bev_nhwc = _bev_nchw
    try:
        yield
    finally:
        (layers.Sequential.forward, layers._eval_layout,
         bb.bev_nhwc) = saved


def _random_bn(model, seed: int):
    """Every BatchNorm's scale and variance in [0.5, 1.5), shift and mean
    at 0.2 x N(0, 1), so that the fold is not the identity's."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)


def _ground_surface(batch, shape, cap0, side=210, seed=SEED):
    """coords [batch, cap0, 3] (z, y, x) and valid [batch, cap0]: per scan
    a side x side patch of ground at a random place of the grid, each site
    at a ramp's height and one or two voxels above it (~2.5 a site)."""
    rng = np.random.RandomState(seed)
    d, h, w = shape
    coords = np.zeros((batch, cap0, 3), np.int64)
    valid = np.zeros((batch, cap0), bool)
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    z = d // 3 + (yy + xx).reshape(-1) * 4 // (2 * side)
    for b in range(batch):
        yx = np.stack([yy.reshape(-1) + rng.randint(0, h - side),
                       xx.reshape(-1) + rng.randint(0, w - side)], 1)
        up = z + rng.randint(1, 3, z.shape)
        zyx = np.unique(np.concatenate(
            [np.concatenate([z[:, None], yx], 1),
             np.concatenate([up[:, None], yx], 1)]), axis=0)[:cap0]
        coords[b, :len(zyx)] = zyx
        valid[b, :len(zyx)] = True
    return torch.from_numpy(coords), torch.from_numpy(valid)


def _kernel_ms(fn, batches: int):
    """{kernel name: [launches, ms]} a call of ``fn`` on the card over
    ``batches`` profiled calls, after 3 warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = out.setdefault(e.name, [0.0, 0.0])
            row[0] += 1 / batches
            row[1] += (e.time_range.end - e.time_range.start) / 1e3 / batches
    return out


def _host_ms(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


FOLD_GROUPS = {
    "transposes": lambda k: "nchwToNhwc" in k or "nhwcToNchw" in k,
    "broadcast elementwise": lambda k: "at::native::elementwise_kernel<" in k,
    "ReLU": lambda k: "launch_clamp_scalar" in k,
}


def _fold_report(tag, infer, inputs, model, pairs):
    """Phase 24's lines for one model: the folded batch against the
    unfolded one."""
    seen = {}
    hooks = [model.neck.register_forward_hook(
                 lambda m, i, o: seen.__setitem__("bev", i[0])),
             model.bbox_head.register_forward_hook(
                 lambda m, i, o: seen.__setitem__("head", o[0]))]
    try:
        profiling.reset()
        profiling.enable()
        try:
            infer(*inputs)
            _, counts = profiling.records()
        finally:
            profiling.disable()
            profiling.reset()
        folded_n = sum(v for _, n, v in counts if n == "conv_bn_folded")
        heads, bev = seen["head"], seen["bev"]
        with unfolded_path():
            infer(*inputs)
            plain_heads = seen["head"]
            plain = _kernel_ms(lambda: infer(*inputs), FOLD_BATCHES)
            plain_host = _host_ms(lambda: infer(*inputs))
        folded = _kernel_ms(lambda: infer(*inputs), FOLD_BATCHES)
        folded_host = _host_ms(lambda: infer(*inputs))
    finally:
        for h in hooks:
            h.remove()
    m32 = copy.deepcopy(model).float()
    with torch.no_grad(), unfolded_path():
        want = m32.bbox_head(m32.neck(bev.float().contiguous()))[0]
    del m32

    def total(rows, i):
        return sum(r[i] for r in rows.values())

    print(f"BN fold {tag}: host {folded_host:.3f} ms a batch folded, "
          f"{plain_host:.3f} unfolded; device {total(folded, 1):.3f} ms "
          f"({total(folded, 0):.0f} launches) folded, {total(plain, 1):.3f} "
          f"ms ({total(plain, 0):.0f}) unfolded; conv_bn_folded "
          f"{folded_n} a batch; {card_line()}")
    for group, match in FOLD_GROUPS.items():
        a = [sum(r[i] for k, r in plain.items() if match(k)) for i in (0, 1)]
        b = [sum(r[i] for k, r in folded.items() if match(k)) for i in (0, 1)]
        print(f"  {group}: {a[0]:.0f} launches {a[1]:.4f} ms a batch "
              f"unfolded -> {b[0]:.0f} launches {b[1]:.4f} ms folded")
    delta = {k: folded.get(k, [0, 0])[1] - plain.get(k, [0, 0])[1]
             for k in set(folded) | set(plain)}
    for k in sorted(delta, key=lambda k: abs(delta[k]), reverse=True)[:8]:
        print(f"  {delta[k]:+.4f} ms a batch ({plain.get(k, [0])[0]:.0f} -> "
              f"{folded.get(k, [0])[0]:.0f} launches) {k[:110]}")
    def gap(got, ref):
        return float(torch.linalg.vector_norm(got.float() - ref)
                     / torch.linalg.vector_norm(ref))

    gaps = {k: gap(v, want[k]) for k, v in heads.items()}
    print("  heads' relative L2 distance from the f32 neck and head on the "
          "same BEV map (TF32 off), folded / unfolded: "
          + ", ".join(f"{k} {g:.2e} / {gap(plain_heads[k], want[k]):.2e}"
                      for k, g in gaps.items()))
    # cuDNN writes a one-channel output of a window wider than 1x1 (the
    # center head's height) through one transpose, on either path
    one = sum(isinstance(m, layers.Conv2d) and m.out_channels == 1
              and m.kernel_size != (1, 1) for m in model.modules())
    left = {k: r for k, r in folded.items() if FOLD_GROUPS["transposes"](k)}
    if sum(r[0] for r in left.values()) != one:
        raise AssertionError(f"{tag}: layout transposes in the folded "
                             f"batch: {left}, want {one}")
    if folded_n != pairs:
        raise AssertionError(f"{tag}: conv_bn_folded {folded_n}, want "
                             f"{pairs}")
    if max(gaps.values()) > BOUNDS[torch.bfloat16]:
        raise AssertionError(f"{tag}: heads {gaps}")


def phase_bn_fold(device):
    """Phase 24: one serving batch of each model, folded NHWC against the
    unfolded NCHW path."""
    model, cfg = build_model("se_ssd_kitti_car_bf16.py", device, prior=True)
    _random_bn(model, SEED)
    spec = builder.build_voxelizer(cfg.voxel_generator)
    prep = HostPreprocessor(spec, SERVING_CAPS)
    batch = prep.batch([make_scene(seed=s)[0] for s in range(8)])
    staged = stage_inputs(batch["feats"], batch["rulebooks"], device)
    infer = make_infer_fn(model, builder.build_anchors(cfg),
                          builder.build_predict_config(cfg), SERVING_CAPS, 8,
                          device)
    _fold_report("SE-SSD b8", infer, staged, model, 14)
    del model, infer, staged

    cfg = builder.load_config("centerpoint_waymo_bf16.py")
    model = builder.build_detector(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    _random_bn(model, SEED + 1)
    model = model.to(device).eval()
    caps, b = model.stage_capacity, 4
    coords, valid = _ground_surface(b, model.sparse_shape, caps[0])
    chain, sat = model.device_inputs(coords.to(device), valid.to(device), b)
    print(f"CenterPoint surface: {int(valid.sum()) // b} voxels a scan, "
          f"saturated stages {sat.nonzero().flatten().tolist()}")
    feats = torch.randn(b * caps[0], 5, device=device,
                        generator=torch.Generator(device).manual_seed(SEED))
    infer = make_infer_fn(model, None, builder.build_predict_config(cfg),
                          caps, b, device)
    _fold_report("CenterPoint b4", infer, (feats, chain), model, 20)
    del model, infer
    torch.cuda.empty_cache()


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")


WCONV = "sessd_tpu/ops/pallas/wconv.py"


def _entry(name, source, replaces, launches, max_abs, ms, plain_ms, bound,
           library_ms=None):
    """One row of the kernels line; ``replaces`` is the TPU kernel's
    file:line. ``library_ms`` stays None where no one PyTorch call computes
    the kernel's function (a rulebook gather-GEMM)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound.ms(), "bound_by": bound.by(),
            "library_ms": library_ms}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    with phase("build"):
        phase_build()
    model, cfg = build_model("se_ssd_kitti_car_bf16.py", device, prior=True)
    spec = builder.build_voxelizer(cfg.voxel_generator)
    with phase("kernels"):
        max_abs, k1_ms, k1_bound, k1_direct = phase_kernels(model, spec,
                                                            device)
        b8 = phase_stream_serving(model, spec, device)
    with phase("serving b1/b4"):
        serving_counts, pcfg = phase_serving(model, cfg, spec, device)
        launches = serving_counts["fused_sparse_conv"]
    with phase("serving b8"):
        b8_counts = phase_serving_b8(model, cfg, spec, device)
    with phase("head parity"):
        phase_head_parity(spec, device, pcfg)
    with phase("pillar plan"):
        phase_pillar_plan(model, spec, device, card)
    with phase("rotated NMS"):
        nms_rows = phase_nms(device)
    with phase("CenterPoint instances"):
        phase_centerpoint(device)
    with phase("BN fold"):
        phase_bn_fold(device)

    tmp = tempfile.mkdtemp(prefix="sessd_smoke_")
    try:
        with phase("checkpoint import"):
            phase_checkpoint_import(model, cfg, spec, device, tmp)
        del model
        torch.cuda.empty_cache()
        with phase("pillars serving"):
            phase_pillar_serving(tmp, device)
        with phase("DI-NMS"):
            dinms_counts = phase_dinms(spec, device)
        root = f"{tmp}/kitti"
        t0 = time.perf_counter()
        make_synthetic_root(root, num_frames=8, num_cars=10)
        print(f"synthetic KITTI root: 8 frames in "
              f"{time.perf_counter() - t0:.1f} s")
        with phase("training"):
            trainer = make_trainer("se_ssd_kitti_car_bf16.py", root,
                                   f"{tmp}/work_bf16", device)
            (worst, train_ms, train_bounds, fwd_tile, dfeat_tile, dw_tile,
             train_f32, train_direct) = phase_train_kernels(
                trainer, first_batch(trainer))
            _no_saturation(trainer, "training kernels")
            counts = phase_train(trainer)
            del trainer
            torch.cuda.empty_cache()
        with phase("step parity"):
            trainer = make_trainer("se_ssd_kitti_car.py", root,
                                   f"{tmp}/work_f32", device)
            # both gates from the fresh state: the pinned one on copies,
            # then phase 6, which steps the trainer's own state
            phase_step_parity_pinned(trainer)
            phase_step_parity(trainer)
            _no_saturation(trainer, "step parity")
        with phase("packed step"):
            phase_packed_step(trainer)
        with phase("eval"):
            ev = phase_eval_kernels(trainer)
            eval_counts = phase_eval(trainer, root, tmp)
            del trainer
            torch.cuda.empty_cache()
        with phase("device inputs"):
            dev_counts = phase_device_inputs(spec, root, tmp, device)
        with phase("ablation"):
            abl = phase_ablation(device)
        with phase("warm start / resume"):
            phase_warm_start(root, tmp)
        with phase("acceptance"):
            phase_acceptance(tmp)
        with phase("pillars training"):
            phase_pillar_train(root, tmp, device)
        with phase("3-class"):
            c3_counts = phase_3class(root, tmp, device)
        with phase("data parallel"):
            lead, dp_cfg, dp_counts = phase_data_parallel(root, tmp, card)
        with phase("data parallel NCCL"):
            nccl_counts = phase_data_parallel_nccl(root, tmp, device)
        with phase("multi-process eval"):
            mp_counts = phase_multiprocess_eval(root, tmp, lead, dp_cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the device-input, 3-class and data-parallel phases' launches (every
    # rank's)
    late_counts = {k: dev_counts[k] + c3_counts[k] + dp_counts[k]
                   + nccl_counts[k] + mp_counts[k] for k in c3_counts}

    k1_launches = (launches + b8_counts["fused_sparse_conv"]
                   + dinms_counts["fused_sparse_conv"]
                   + eval_counts["fused_sparse_conv"]
                   + late_counts["fused_sparse_conv"])
    k3_launches = (b8_counts["fused_sparse_conv_stream"]
                   + dinms_counts["fused_sparse_conv_stream"]
                   + eval_counts["fused_sparse_conv_stream"]
                   + late_counts["fused_sparse_conv_stream"])
    nms_launches = (serving_counts["rotated_nms"] + b8_counts["rotated_nms"]
                    + dinms_counts["rotated_nms"] + eval_counts["rotated_nms"]
                    + late_counts["rotated_nms"])
    print(f"main-path launches: K1 {launches} (b1/b4) + "
          f"{b8_counts['fused_sparse_conv']} (b8) + "
          f"{dinms_counts['fused_sparse_conv']} (DI-NMS) + "
          f"{eval_counts['fused_sparse_conv']} (eval) + "
          f"{late_counts['fused_sparse_conv']} (device inputs, 3-class eval "
          f"and data parallel); K3 "
          f"{b8_counts['fused_sparse_conv_stream']} (b8) + "
          f"{dinms_counts['fused_sparse_conv_stream']} (DI-NMS) + "
          f"{eval_counts['fused_sparse_conv_stream']} (eval) + "
          f"{late_counts['fused_sparse_conv_stream']} (device inputs, 3-class "
          f"eval and data parallel); "
          f"K4/dFeat/dW {counts['sparse_conv_fwd']}/"
          f"{counts['sparse_conv_dfeat']}/{counts['sparse_conv_dw']} (SE-SSD)"
          f" + {late_counts['sparse_conv_fwd']}/"
          f"{late_counts['sparse_conv_dfeat']}/{late_counts['sparse_conv_dw']}"
          f" (device inputs, 3-class and data parallel); "
          f"rotated NMS {nms_launches} (2 a batch: "
          f"{serving_counts['rotated_nms']} b1/b4, "
          f"{b8_counts['rotated_nms']} b8, {eval_counts['rotated_nms']} eval"
          f", {late_counts['rotated_nms']} device inputs, 3-class and data "
          f"parallel; DI-NMS {dinms_counts['rotated_nms']}); "
          f"eval K3 sums "
          f"K3 {ev['ms']:.4f} ms K1 {ev['k1_ms']:.4f} ms, twin "
          f"{ev['plain_ms']:.4f} ms bound {ev['bound'].ms():.4f} ms")
    # times: K1 the 14 b1 bf16 convs, K3 the 7 streamed convs of a b8 bf16
    # request, K4/K5 the bf16 student chain at b4
    kernels = [
        _entry("fused_sparse_conv", "sessd_torch/csrc/sparse_conv.cu",
               f"{WCONV}:253", k1_launches, max_abs, k1_ms["ms"],
               k1_ms["plain_ms"], k1_bound),
        _entry("fused_sparse_conv_stream",
               "sessd_torch/csrc/sparse_conv_stream.cu", f"{WCONV}:277",
               k3_launches, max(b8["worst"], ev["worst"]), b8["ms"],
               b8["plain_ms"], b8["bound"])]
    kernels[0].update(
        tile="gather_mma.cuh: gather_mma_tile (wgmma) + cluster tap split; "
             "f32 3xTF32 at one CTA per tile; Cin = 4: gather_direct.cuh: "
             "gather_direct")
    kernels[1].update(covers=f"{WCONV}:350",
                      skipped_tap_share=b8["tiles"].share(),
                      tile="gather_mma.cuh: gather_mma_tile (wgmma; f32 "
                           "3xTF32)")
    for name, key, line in (("sparse_conv_fwd", "fwd", 51),
                            ("sparse_conv_dfeat", "dfeat", 67),
                            ("sparse_conv_dw", "dw", 67)):
        kernels.append(_entry(
            name, "sessd_torch/csrc/sparse_conv_train.cu", f"{WCONV}:{line}",
            counts[name] + late_counts[name], worst[key], train_ms[key][0],
            train_ms[key][1], train_bounds[key]))
    kernels[2].update(tile="gather_mma.cuh: gather_mma_tile (wgmma; f32 "
                           "3xTF32); Cin = 4: gather_direct.cuh: "
                           "gather_direct",
                      skipped_tap_share=fwd_tile["tiles"].share())
    # f32: per-launch means on the f32 paths (K4 the 24 convs of both
    # training chains, dFeat the step's 9, dW the student's 10; K1 the 3
    # resident and K3 the 11 streamed convs of a batch-4 f32 eval batch)
    n_k3 = len(ev["streamed"])
    k3_f32 = {"tile": [ev["body"]], "launches_timed": n_k3,
              "ms_per_launch": ev["ms"] / n_k3,
              "plain_ms_per_launch": ev["plain_ms"] / n_k3,
              "bound_ms_per_launch": ev["bound"].ms() / n_k3,
              "bound_by": ev["bound"].by(),
              "k1_ms_per_launch": ev["k1_ms"] / n_k3,
              "max_abs_vs_k1": ev["vs_k1"]}
    kernels[0]["f32"] = dict(ev["k1_f32"].row(), max_abs_err=ev["k1_worst"])
    kernels[1]["f32"] = k3_f32
    for row, key in zip(kernels[2:5], ("fwd", "dfeat", "dw")):
        row["f32"] = train_f32[key].row()
    kernels[3].update(
        tile="gather_mma.cuh: gather_mma_tile (wgmma, K-major B); 16 -> 4: "
             "gather_direct.cuh: gather_direct (W_T)",
        skipped_tap_share=dfeat_tile["tiles"].share(),
        zero_filled_row_share=dfeat_tile["tiles"].fill_share())
    skips = dw_tile["skips"]
    kernels[4].update(
        tile="sparse_conv_train.cu: dw_mma_partial (mma.sync m16n8k16; "
             "f32 3xTF32 on m16n8k8); Cin = 4: dw_direct_partial",
        skipped_chunk_tap_share=skips.chunks.share(),
        skipped_step_tap_share=skips.steps.share(),
        partial_bytes=skips.partial_bytes,
        ms_by_chunk_rows=dw_tile["sweep"])
    # the first conv's 4-channel side on the direct bodies: per call (K1 at
    # batch 1 and 4 in both types, K4 on both training chains, dFeat and dW
    # on the student's) its ms, the twin's and the call's bound
    kernels[0]["cin4"] = k1_direct.rows["fused_sparse_conv"]
    for row, name in zip(kernels[2:5], ("sparse_conv_fwd", "sparse_conv_dfeat",
                                        "sparse_conv_dw")):
        row["cin4"] = train_direct.rows[name]
    # S1: the tensor-core full mode's time, the scalar copy's as the old
    # tile; S2: device time per launch at 256 rows
    kernels += [
        _entry("sparse_conv_ablate_mma",
               "sessd_torch/csrc/sparse_conv_ablate.cu",
               "scripts/bench_wconv_ablate.py:51",
               abl["counts"]["sparse_conv_ablate_mma"], abl["mma_worst"],
               abl["mma_ms"]["full"], abl["mma_plain_ms"], abl["s1_bound"]),
        _entry("empty_launch", "sessd_torch/csrc/sparse_conv_ablate.cu",
               "scripts/bench_wconv_ablate2.py:72",
               abl["counts"]["empty_launch"], abl["s2_worst"],
               abl["s2_ms"], abl["s2_plain_ms"], abl["s2_bound"],
               library_ms=abl["s2_library_ms"])]
    kernels[-2].update(
        tile="gather_mma.cuh: gather_mma_tile (wgmma) in each TileMode",
        old_tile="sparse_conv_ablate (scalar-tile copy)",
        old_tile_ms=abl["s1_ms"]["full"],
        old_tile_launches=abl["counts"]["sparse_conv_ablate"],
        old_tile_max_abs_err=abl["s1_worst"], mma_ms=abl["mma_ms"],
        chain_ms=abl["chain_ms"], k1_at_split_ms=abl["k1_at_split_ms"])
    # the rotated NMS pair: replaces no Pallas kernel (XLA code in the JAX
    # package); no PyTorch call computes a rotated NMS. Its launches are the
    # main-path phases'; its time and bound at serving's shape (pre 256)
    nms_row = nms_rows[256]
    kernels.append({
        "name": "rotated_nms", "route": "cuda",
        "source": "sessd_torch/csrc/rotated_nms.cu",
        "replaces": None, "launches": nms_launches,
        "max_abs_err": max(r["max_abs_err"] for r in nms_rows.values()),
        "ms": nms_row["ms"], "plain_ms": nms_row["plain_ms"],
        "bound_ms": nms_row["bound_ms"], "bound_by": nms_row["bound_by"],
        "library_ms": None,
        "tile": "rotated_nms_mask_kernel (16 x 64 IoU tiles, 16 threads a "
                "row, valid rows and columns only) + rotated_nms_scan_kernel "
                "(a warp a scene)",
        "by_pre": nms_rows})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(json.loads(sys.argv[2]))
    else:
        main()
