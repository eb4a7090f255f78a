"""Device milliseconds from the head's forward-hook end to the batch's end
(decode, IoU-rectified scores, rotated NMS, direction), by CUDA events,
the mean over every traced batch."""


def read(t):
    if t.extra.get("kind") != "infer":
        return None
    return t.extra["predict_ms"]
