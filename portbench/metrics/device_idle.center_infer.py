"""The share of the CenterPoint cell's traced window (device activity
only) in which no operation ran on the device: 1 - the union of the
device's activity intervals over the window. The profiler slows the host's
issue, so this reads as an upper bound of the untraced window's idle
share, to be compared only with itself."""


def read(t):
    if t.extra.get("kind") != "center_infer":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
