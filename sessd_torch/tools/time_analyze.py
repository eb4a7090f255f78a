"""Micro-benchmarks of the hot functions (port of ``tools/time_analyze.py``):

    python -m sessd_torch.tools.time_analyze [--n 1000] [--iters 10]
        [--device cuda]

The rotated BEV IoU matrix (n x n), ``rotate_nms`` over n boxes, the
voxelizer on 18k points on the device against the host (numpy and C++),
``odiou_3d`` over n pairs, and the rulebook chain of one ``make_scene``
scan at SERVING_CAPS built on the device (``build_device_chain``, from
``voxelize_torch``'s coords) against the host C++ chain
(``HostPreprocessor``'s builder on the C++ voxelizer's coords). Device
times are CUDA-event means over ``iters`` calls after a warm-up call; host
times, and every time with ``--device cpu``, host-clock medians.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.nms import rotate_nms
from ..core.odiou import odiou_3d
from ..core.rotated_iou import iou_bev_matrix
from ..core.rotated_iou_np import iou_bev_matrix as iou_bev_matrix_np
from ..data.rulebooks import DOWNS
from ..ops.sparse import build_device_chain
from ..ops.voxelize import KITTI_VOXELIZER, voxelize_np, voxelize_torch
from ..serve import SERVING_CAPS
from ..utils.native import ensure_native
from ..utils.synth_scene import make_scene


def host_ms(fn, iters: int = 10) -> float:
    """Median host-clock ms of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def timeit(fn, device, iters: int = 10) -> float:
    """ms per ``fn()``: on a CUDA device the mean over ``iters`` calls
    between CUDA events after one warm-up call, else ``host_ms``."""
    if device.type != "cuda":
        return host_ms(fn, iters)
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev, n, iters = torch.device(args.device), args.n, args.iters
    out = {}

    def timed(fn):
        return timeit(fn, dev, iters=iters)

    def report(key, ms, text):
        out[key] = ms
        print(f"{text}: {ms:.3f} ms")

    rng = np.random.RandomState(0)
    boxes5 = np.stack([rng.uniform(0, 70, n), rng.uniform(-40, 40, n),
                       rng.uniform(1.5, 1.8, n), rng.uniform(3.5, 4.5, n),
                       rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    scores = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
    b5 = torch.from_numpy(boxes5).to(dev)
    with torch.inference_mode():
        report("iou_bev", timed(lambda: iou_bev_matrix(b5, b5)),
               f"iou_bev [{n}x{n}] {dev.type}")
        m = min(n, 200)
        report("iou_bev_np", host_ms(lambda: iou_bev_matrix_np(
            boxes5[:m], boxes5[:m]), iters=3),
            f"iou_bev [{m}x{m}] host numpy")
        report("rotate_nms", timed(lambda: rotate_nms(
            b5, scores, pre_max_size=n, post_max_size=100,
            iou_threshold=0.01)), f"rotate_nms [{n}] {dev.type}")

        pts = np.concatenate(
            [rng.uniform(0, 70, (18000, 1)), rng.uniform(-40, 40, (18000, 1)),
             rng.uniform(-2, 0.5, (18000, 1)), rng.rand(18000, 1)],
            1).astype(np.float32)
        pts_d = torch.from_numpy(pts).to(dev)
        report("voxelize", timed(lambda: voxelize_torch(
            pts_d, KITTI_VOXELIZER)), f"voxelize 18k pts {dev.type}")
        report("voxelize_np", host_ms(lambda: voxelize_np(
            pts, KITTI_VOXELIZER), iters=3), "voxelize 18k pts host numpy")
        native = ensure_native()
        spec = KITTI_VOXELIZER
        report("voxelize_cpp", host_ms(lambda: native.voxelize(
            pts, spec.point_cloud_range, spec.voxel_size, spec.max_points,
            spec.max_voxels), iters), "voxelize 18k pts host C++")

        b7 = torch.cat([b5[:, :2], torch.zeros_like(b5[:, :1]), b5[:, 2:4],
                        torch.full_like(b5[:, :1], 1.5), b5[:, 4:]], 1)
        report("odiou", timed(lambda: odiou_3d(b7, b7)),
               f"odiou [{n}] {dev.type}")

        # one scan's chain at SERVING_CAPS, each from its own voxelizer
        scan = make_scene(seed=0)[0]
        _, zyx, _, _ = voxelize_torch(torch.from_numpy(scan).to(dev), spec)
        bzyx = torch.cat([torch.zeros_like(zyx[:, :1]), zyx], 1)
        shape = (1,) + spec.sparse_shape
        report("chain", timed(lambda: build_device_chain(
            bzyx, zyx[:, 0] >= 0, shape, SERVING_CAPS)),
            f"rulebook chain, scan 0 at {SERVING_CAPS}, {dev.type}")
        cap0 = SERVING_CAPS[0]
        _, host_zyx, _ = native.voxelize(
            scan, spec.point_cloud_range, spec.voxel_size, spec.max_points,
            min(spec.max_voxels, cap0))
        coords = np.zeros((cap0, 4), np.int32)
        coords[:len(host_zyx), 1:] = host_zyx
        valid = np.arange(cap0) < len(host_zyx)
        report("chain_cpp", host_ms(lambda: native.build_rulebooks(
            coords, valid, shape, list(SERVING_CAPS), DOWNS,
            out_dtype=np.int16), iters), "rulebook chain, scan 0, host C++")
    return out


if __name__ == "__main__":
    main()
