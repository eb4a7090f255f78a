"""Host milliseconds a batch of CenterPoint's predict: the program's
``infer.predict`` span less its ``predict.sync`` (the one host read that
picks the NMS capacity), from the span recorder over an unprofiled
stretch of the serving loop before the traced window. None where the
program records no such span."""


def read(t):
    if t.extra.get("kind") != "center_infer":
        return None
    return t.extra.get("predict_host_ms")
