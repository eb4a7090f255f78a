"""The whole training step's share of the card's peak: the model FLOPs of
each traced step (teacher forward + 3 x student forward, counted on the
reference's rulebooks) over the traced window and the peak of the
configuration's compute type (bf16 989 TFLOP/s, f32 at TF32's 494.7)."""


def read(t):
    if t.extra.get("kind") != "train":
        return None
    return 100.0 * t.extra["model_flops"] / t.window_s / t.extra["peak_flops"]
