"""The 128-channel serving convs' share of their roofline in CenterPoint's
backbone: ``sparse_conv_roofline.center_infer`` over the launches of the
(64, 128) and (128, 128) instances of K1 and K3 alone (the strided conv
into stage 3, its four block convs and the extra conv), found by the
template arguments in the kernels' names."""
from portbench.harness import roofline


def read(t):
    if t.extra.get("kind") != "center_infer":
        return None
    return roofline(t.extra["wide_bound_s"], t.extra["wide_s"])
