"""Scenes a second over an unprofiled stretch of the CenterPoint serving
loop after the traced window, as many batches as that window ran: every
scene whose detections reached the host, over the stretch's host-clock
time. Read beside ``infer_batch_p95_ms``, not held to a bound."""


def read(t):
    if t.extra.get("kind") != "center_infer":
        return None
    return t.extra.get("scenes_per_s")
