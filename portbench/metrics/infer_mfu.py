"""The whole serving pass's share of the card's peak: the forward's model
FLOPs of each traced batch (counted on the reference's rulebooks) over the
traced window and the peak of the configuration's compute type."""


def read(t):
    if t.extra.get("kind") != "infer":
        return None
    return 100.0 * t.extra["model_flops"] / t.window_s / t.extra["peak_flops"]
