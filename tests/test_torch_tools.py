"""The FLOPs and timing tools on the CPU at a small size:
``utils.flops.count_model_flops`` (the sparse count against a numpy count
of the chain's hits, the dense count against an analytic count of the
neck's and head's convs), ``tools.get_flops`` (its parameter count equal to
the JAX model's, its lines printed) and ``tools.time_analyze --device
cpu``."""
import math

import jax
import numpy as np
import torch
from torch import nn

from sessd_torch.models.backbone import PLAN
from sessd_torch.tools import get_flops, time_analyze
from sessd_torch.utils.flops import count_model_flops
from tests.test_torch_common import (host_inputs, jax_voxelnet_variables,
                                     port_voxelnet, to_torch)
import test_torch_threads  # noqa: F401 (torch's threads under xdist)

# a 32 x 32 x 40 voxel grid cut from the shipped Car config
TINY = """
_base = "{BASE}"
exec(compile(open(_base).read(), _base, "exec"))
voxel_generator = dict(voxel_generator, range=[0, -6.4, -3.0, 12.8, 6.4, 1.0],
                       voxel_size=[0.4, 0.4, 0.1], max_voxel_num=3000)
stage_capacity = (3000, 3000, 2400, 1600, 1000)
"""


def _chain_counts(rb, b):
    """numpy: 2 x hits x Cin x Cout over the 14 convs of the serving plan,
    each conv's rulebook and input rows from the chain."""
    flops, cin = 0, 4
    for stage, (feats, n_subm, dk, _, _) in enumerate(PLAN):
        maps = [(rb["down"][stage - 1], rb["ids"][stage - 1])] if dk else []
        if n_subm:
            maps += [(rb["subm"][stage], rb["ids"][stage])] * n_subm
        for m, ids_in in maps:
            m = np.asarray(m)
            flops += 2 * int((m != len(ids_in)).sum()) * cin * feats
            cin = feats
    return flops


def _analytic_dense(model, bev_shape):
    """2 x MACs of every Conv2d / ConvTranspose2d of the neck and head,
    from the shapes their forward sees (biases not counted, as
    FlopCounterMode counts them)."""
    total = []

    def hook(m, inp, out):
        w = m.weight
        if isinstance(m, nn.ConvTranspose2d):
            b, cin, h, wd = inp[0].shape
            total.append(2 * b * h * wd * cin * w.shape[1] * w[0, 0].numel())
        else:
            b, cout, h, wd = out.shape
            total.append(2 * b * h * wd * cout * w[0].numel())

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.no_grad():
        model.bbox_head(model.neck(torch.zeros(bev_shape)))
    for h in hooks:
        h.remove()
    return sum(total)


def test_count_model_flops_sparse_and_dense():
    b = 2
    feats, coords, valid, rb = host_inputs(11, b=b)
    model = port_voxelnet(jax_voxelnet_variables())
    chain = {k: ([to_torch(a) for a in v] if isinstance(v, list)
                 else to_torch(v)) for k, v in rb.items()}
    out = count_model_flops(model, to_torch(feats)[:, None],
                            torch.ones(len(feats), dtype=torch.int32), chain,
                            b)
    assert out["sparse_convs"] == 14
    assert out["sparse_flops"] == _chain_counts(rb, b) > 0
    d, h, w = model.sparse_shape
    d4 = 2  # depth after the four strided convs of a 41-deep grid
    assert out["dense_flops"] == _analytic_dense(
        model, (b, 64 * d4, h // 8, w // 8)) > 0
    assert out["flops"] == out["sparse_flops"] + out["dense_flops"]
    assert math.isclose(out["gflops"], out["flops"] / 1e9)
    # bytes: per conv features in, rulebook, weights, bias, features out
    assert out["sparse_bytes"] > sum(np.asarray(a).nbytes
                                     for a in rb["subm"] + rb["down"])


def test_get_flops_params_equal_jax(tmp_path, capsys):
    """The tool on a cut grid (the parameters do not depend on it): its
    parameter count is the JAX VoxelNet's, and it prints both lines."""
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY.replace("{BASE}", str(
        get_flops.builder.CONFIG_DIR / "se_ssd_kitti_car.py")))
    out = get_flops.main([str(cfg), "--batch", "2", "--voxels", "400",
                          "--device", "cpu"])
    want = sum(int(np.prod(np.shape(p))) for p in jax.tree_util.tree_leaves(
        jax_voxelnet_variables()["params"]))
    assert out["params"] == want
    assert out["sparse_convs"] == 14 and out["sparse_flops"] > 0
    assert out["dense_flops"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"params: {want / 1e6:.2f} M"
    assert lines[1].startswith(f"forward: {out['gflops']:.2f} GFLOPs (sparse")


def test_time_analyze_cpu(capsys):
    out = time_analyze.main(["--device", "cpu", "--n", "64", "--iters", "1"])
    keys = ("iou_bev", "iou_bev_np", "rotate_nms", "voxelize", "voxelize_np",
            "voxelize_cpp", "odiou", "chain", "chain_cpp")
    assert set(out) == set(keys)
    assert all(math.isfinite(v) and v > 0 for v in out.values())
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(keys)
    assert lines[-2].startswith("rulebook chain, scan 0 at (20000, 22000")
