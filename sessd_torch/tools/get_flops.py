"""FLOPs of one forward pass (port of ``tools/get_flops.py``):

    python -m sessd_torch.tools.get_flops CONFIG [--batch 1] [--voxels 16000]
        [--device cuda]

CONFIG is a config file or the name of a shipped one. Seed-0 random voxels
and coordinates (as the JAX tool draws them), the model at seed-0 random
weights, its rulebook chain built on the device (``build_device_chain`` at
the config's stage capacities), then ``utils.flops.count_model_flops``
through the serving plan. Prints the parameter count and the GFLOPs:
sparse (2 x hits x Cin x Cout per conv), dense and total. A config without
a sparse backbone (PointPillars) takes the same random voxels as pillars.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import builder
from ..models.detector import VoxelNet
from ..models.pillars import pillar_inputs
from ..ops.sparse import build_device_chain
from ..utils.flops import count_model_flops
from .train import load


def flops_report(cfg, batch: int = 1, voxels: int = 16000,
                 device="cuda") -> dict:
    """{"params", "flops", "gflops", "sparse_flops", "dense_flops",
    "sparse_bytes", "sparse_convs"} of one forward of ``cfg``'s model."""
    device = torch.device(device)
    model = builder.build_detector(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device).eval()
    vox = builder.build_voxelizer(cfg.voxel_generator)
    d, h, w = vox.sparse_shape
    rng = np.random.RandomState(0)
    n = batch * voxels
    feats = rng.randn(n, vox.max_points, 4).astype(np.float32)
    coords = np.stack([rng.randint(0, batch, n), rng.randint(0, d, n),
                       rng.randint(0, h, n), rng.randint(0, w, n)],
                      1).astype(np.int32)
    num_points = rng.randint(1, vox.max_points + 1, n).astype(np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if isinstance(model, VoxelNet):
        caps = [c * batch for c in model.stage_capacity]
        third, _ = build_device_chain(put(coords), put(np.ones(n, bool)),
                                      (batch,) + vox.sparse_shape, caps)
    else:  # pillars: the same draws, at their (y, x)
        zyx = coords[:, 1:].reshape(batch, voxels, 3) * [0, 1, 1]
        third = {k: put(a) for k, a in pillar_inputs(
            zyx.astype(np.int32), np.ones((batch, voxels), bool)).items()}
    out = count_model_flops(model, put(feats), put(num_points), third, batch)
    out["params"] = sum(p.numel() for p in model.parameters())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--voxels", type=int, default=16000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = flops_report(load(args.config), args.batch, args.voxels,
                       args.device)
    print(f"params: {out['params'] / 1e6:.2f} M")
    print(f"forward: {out['gflops']:.2f} GFLOPs (sparse "
          f"{out['sparse_flops'] / 1e9:.2f} over {out['sparse_convs']} "
          f"convs, {out['sparse_bytes'] / 1e9:.3f} GB moved; dense "
          f"{out['dense_flops'] / 1e9:.2f})")
    return out


if __name__ == "__main__":
    main()
