"""The training sparse convs' share of their roofline: the sum over every
K4, dFeat and dW launch of the traced steps of its bound (2 x hits x Cin x
Cout over the peak, or its inputs read once and outputs written once over
3.35 TB/s, whichever is longer) over the device time of those kernels."""
from portbench.harness import roofline


def read(t):
    if t.extra.get("kind") != "train":
        return None
    return roofline(t.extra["sparse_bound_s"], t.extra["sparse_s"])
