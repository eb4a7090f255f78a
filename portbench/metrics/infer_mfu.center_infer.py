"""CenterPoint's whole serving pass's share of the card's peak: the
forward's model FLOPs of each traced batch (the reference's, counted by
FlopCounterMode: 2 x hits x Cin x Cout for each sparse conv on its own
rulebooks, the dense RPN and head as they are) over the traced window and
the peak of the configuration's compute type (bf16 989 TFLOP/s)."""


def read(t):
    if t.extra.get("kind") != "center_infer":
        return None
    return 100.0 * t.extra["model_flops"] / t.window_s / t.extra["peak_flops"]
