"""Seeded weights of the SE-SSD Car detector, made on the device in one
draw and handed alike to the program and to the reference.

The distributions are the ones the JAX package's initializers use (and
the port's ``reset_parameters`` repeats): He-uniform sparse kernels over
fan_in = K x Cin, Xavier-uniform neck convs over (fan_in + fan_out), head
convs uniform over sqrt(6 / in_channels), biases 0, BatchNorm at identity
(weight 1, bias 0, running mean 0, running var 1). One
``torch.Generator`` on the device draws every
uniform at once, so the weights depend on the seed and the device kind,
and not on the order of the leaves' allocation.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _bound(name: str, shape) -> Optional[float]:
    """The uniform bound of a leaf, or None for a leaf set to a constant."""
    if name.startswith("backbone.") and len(shape) == 5:
        return math.sqrt(6.0 / (math.prod(shape[:3]) * shape[3]))
    if name.startswith("neck.") and len(shape) == 4:
        s0, s1 = shape[:2]
        return math.sqrt(6.0 / (math.prod(shape) // (s0 * s1) * (s0 + s1)))
    if name.startswith("bbox_head.") and name.endswith(".weight"):
        return math.sqrt(6.0 / shape[1])
    return None


def make_state_dict(template: Dict[str, torch.Tensor], seed: int,
                    device) -> dict:
    """{name: float32 tensor on ``device``} for every entry of ``template``
    (a state dict with the detector's names and shapes)."""
    drawn = [(k, v.shape) for k, v in template.items()
             if _bound(k, v.shape) is not None]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for k, s in drawn:
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s) * _bound(k, s)
        at += n
    for k, v in template.items():
        if k in out:
            continue
        if k.endswith("running_var") or (k.endswith(".weight")
                                         and v.dim() == 1):
            out[k] = torch.ones(v.shape, device=device)
        else:
            out[k] = torch.zeros(v.shape, device=device)
    return out
