"""Scenes a second over an unprofiled stretch of the serving loop, as many
batches as the traced window ran, after it: every scene whose detections
reached the host, over the stretch's host-clock time. The loop is paced by
the host, whose speed differs from process to process on a shared machine,
so this is read beside ``infer_batch_p95_ms`` rather than held to a bound."""


def read(t):
    if t.extra.get("kind") != "infer":
        return None
    return t.extra.get("scenes_per_s")
