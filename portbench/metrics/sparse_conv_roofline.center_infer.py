"""CenterPoint's serving sparse convs' share of their roofline: the sum
over every K1 and K3 launch of the traced batches (the 21 convs of
SpMiddleResNetFHD) of its bound (2 x hits x Cin x Cout over the peak, or
its inputs, weights and rulebook read once and its output written once
over 3.35 TB/s, whichever is longer; counted on the reference's rulebooks
of those batches, the first conv at its published 5 input channels) over
the device time of those kernels."""
from portbench.harness import roofline


def read(t):
    if t.extra.get("kind") != "center_infer":
        return None
    return roofline(t.extra["sparse_bound_s"], t.extra["sparse_s"])
