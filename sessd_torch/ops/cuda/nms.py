"""Rotated-BEV greedy NMS over every scene of a batch: the CUDA kernel
pair's wrapper (``sessd_torch/csrc/rotated_nms.cu``) and its plain PyTorch
twin.

It replaces no Pallas kernel: the JAX package's rotated NMS is XLA code.
The serving pass's profile put most of a batch's device idle in the host
issuing a per-scene ``core.nms.rotate_nms`` (its broadcast IoU passes and
a host read per fixpoint pass); the pair runs all scenes in two launches
with no host read. Its bound is the upper triangle's IoU arithmetic plus
the sequential scan. The kernels build with the sparse convs' library
(``sparse_conv.build``) at the first CUDA call.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.box_torch import BEV5_COLUMNS
from ...core.nms import nms_sorted
from ...utils.profiling import count
from . import sparse_conv

MAX_PRE = 4096  # csrc/rotated_nms.cu: kMaxWords words of 64 ranks


def rotated_nms_ref(boxes: torch.Tensor, scores: torch.Tensor,
                    post_max_size: int, iou_threshold: float):
    """Plain PyTorch twin (any device): ``core.nms.nms_sorted`` scene by
    scene, the per-scene ``rotate_nms`` after its sort, over the rows up
    to a scene's last live score (the rows after it are padding, never
    kept: the result is the whole scene's), padded to min(pre, post)
    slots."""
    b, pre = scores.shape
    slots = min(pre, post_max_size)
    keep = torch.zeros((b, slots), dtype=torch.int64, device=boxes.device)
    valid = torch.zeros((b, slots), dtype=torch.bool, device=boxes.device)
    for i in range(b):
        live = torch.nonzero(scores[i] > -torch.inf)
        n = int(live.max()) + 1 if len(live) else 0
        if n:
            k, v = nms_sorted(boxes[i, :n][:, BEV5_COLUMNS], scores[i, :n],
                              post_max_size, iou_threshold)
            keep[i, :len(k)], valid[i, :len(v)] = k, v
    return keep, valid


def _check(boxes, scores):
    if scores.device != boxes.device:
        raise ValueError(f"scores on {scores.device}, boxes on "
                         f"{boxes.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"want float32 boxes and scores (are {boxes.dtype}, "
                         f"{scores.dtype})")
    if (boxes.dim() != 3 or boxes.shape[-1] != 7
            or scores.shape != boxes.shape[:2]):
        raise ValueError(f"want boxes [B, pre, 7], scores [B, pre]: got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}")
    b, pre = scores.shape
    if not (0 < b <= 65535 and 0 < pre <= MAX_PRE):
        raise ValueError(f"batch {b} outside (0, 65535] or pre {pre} "
                         f"outside (0, {MAX_PRE}]")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")


def rotated_nms(boxes: torch.Tensor, scores: torch.Tensor,
                post_max_size: int, iou_threshold: float,
                mask: Optional[torch.Tensor] = None):
    """Greedy rotated-BEV NMS of each scene's boxes, already in descending
    score order.

    boxes [B, pre, 7] (x, y, z, w, l, h, r) f32, scores [B, pre] f32 (-inf:
    padding). Returns (keep [B, min(pre, post)] int64: the kept ranks into
    the rows in order, 0 past the last kept; valid [B, min(pre, post)]
    bool), equal to ``core.nms.nms_sorted`` on each scene. CPU tensors take the twin; CUDA tensors launch the mask
    and scan kernels on the current stream (two launches, counted in
    ``rotated_nms.launches``, and ``nms_kernel`` on the span recorder) or
    raise. ``mask``, where given, is the pair's scratch, [B, pre, ceil(pre
    / 64)] int64 on the card: after the call bit j % 64 of word j // 64 of
    row i is set where rows i and j are valid, j > i and their BEV IoU
    exceeds the threshold."""
    if boxes.device.type == "cpu":
        return rotated_nms_ref(boxes, scores, post_max_size, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"no kernel for device {boxes.device}")
    _check(boxes, scores)
    b, pre = scores.shape
    words = (pre + 63) // 64
    dev = boxes.device
    if mask is None:
        mask = torch.empty((b, pre, words), dtype=torch.int64, device=dev)
    elif (mask.shape != (b, pre, words) or mask.dtype != torch.int64
          or mask.device != dev or not mask.is_contiguous()):
        raise ValueError(f"want a contiguous int64 mask {(b, pre, words)} on "
                         f"{dev}")
    lib = sparse_conv.build()
    slots = min(pre, post_max_size)
    keep = torch.empty((b, slots), dtype=torch.int64, device=dev)
    valid = torch.empty((b, slots), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sessd_rotated_nms(
            boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), valid.data_ptr(), b, pre, slots, iou_threshold,
            torch.cuda.current_stream().cuda_stream)
    sparse_conv.raise_on_error(lib, rc, f"rotated_nms (B={b}, pre={pre})")
    rotated_nms.launches += 2
    count("nms_kernel")
    return keep, valid


rotated_nms.launches = 0
