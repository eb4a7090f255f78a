"""FLOPs of one forward pass (port of ``sessd_tpu/utils/flops.py``;
reference det3d/utils/flops_counter.py, tools/get_flops.py).

The JAX package asks XLA's ``cost_analysis`` of the compiled program. That
count sees the sparse convs in their gather formulation: every row of the
gathered ``[N_out, K*Cin]`` matrix is multiplied, misses included, so its
total is not the same quantity as this module's, and the two packages'
totals are not to be compared.

Here each sparse conv counts the work its rulebook asks for: 2 x hits x Cin
x Cout, a hit being a rulebook entry that reads an input row. That is the
count the kernels' bounds in ``PERF.md`` use, and so are its bytes: the
input features, rulebook, folded weights and bias read once and the output
written once. Everything else (VFE, neck, head) is counted by
``torch.utils.flop_counter.FlopCounterMode``, with the sparse convs kept
out of its view (on the card it cannot see a launch through ctypes anyway;
on the CPU the plain twins' matmuls are taken out of its total).
"""
from __future__ import annotations

import torch


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def count_model_flops(model, *inputs, **kw) -> dict:
    """One forward pass of ``model(*inputs, **kw)`` without autograd.

    Returns {"flops", "gflops"} (the total), "sparse_flops", "dense_flops",
    "sparse_bytes" and "sparse_convs"; the sparse entries are 0 for a model
    without a sparse backbone (PointPillars). For a ``VoxelNet`` the inputs
    are ``forward``'s (voxels, num_points, chain, batch_size), the chain
    from either builder; each sparse conv runs the kernel ``pick_conv``
    gives it."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.backbone import pick_conv
    from ..models.detector import VoxelNet

    sparse = {"flops": 0, "bytes": 0, "convs": 0, "hidden": 0}
    counter = FlopCounterMode(display=False)

    def counted(x, rb, w2, bias, n_in):
        cin, cout = w2.shape[1], w2.shape[2]
        seen = counter.get_total_flops()
        y = pick_conv(cin, n_in, x.dtype)(x, rb, w2, bias, n_in=n_in)
        sparse["hidden"] += counter.get_total_flops() - seen
        sparse["flops"] += 2 * int((rb != n_in).sum()) * cin * cout
        sparse["bytes"] += _nbytes(x, rb, w2, bias, y)
        sparse["convs"] += 1
        return y

    if isinstance(model, VoxelNet):
        kw = dict(kw, conv=counted)
    with torch.inference_mode(), counter:
        model(*inputs, **kw)
    dense = counter.get_total_flops() - sparse["hidden"]
    flops = sparse["flops"] + dense
    return {"flops": flops, "gflops": flops / 1e9,
            "sparse_flops": sparse["flops"], "dense_flops": dense,
            "sparse_bytes": sparse["bytes"], "sparse_convs": sparse["convs"]}
