"""The serving sparse convs' share of their roofline: the sum over every
K1 and K3 launch of the traced batches of its bound over the device time
of those kernels."""
from portbench.harness import roofline


def read(t):
    if t.extra.get("kind") != "infer":
        return None
    return roofline(t.extra["sparse_bound_s"], t.extra["sparse_s"])
