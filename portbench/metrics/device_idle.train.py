"""The share of the traced window in which no operation ran on the device:
1 - the union of the device's activity intervals over the window.

The traced window runs slower than an untraced one (the profiler records
every device activity: a host-paced bf16 step takes about a third longer),
while the device's busy time stays, so on a host-paced cell this share
reads higher than the untraced window's idle share: an upper bound, to be
compared only with itself."""


def read(t):
    if t.extra.get("kind") != "train":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
