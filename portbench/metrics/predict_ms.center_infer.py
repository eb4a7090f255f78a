"""Device milliseconds from the center head's forward-hook end to the
batch's end (the center decode, the stable sort, the rotated NMS pair at
pre 4096 and the finish, and the detections' copy to the host), by CUDA
events, the mean over every traced batch."""


def read(t):
    if t.extra.get("kind") != "center_infer":
        return None
    return t.extra["predict_ms"]
