"""Device activities (kernels, copies, sets) per training step in the
traced window: the launch path's work, which the host issues one by one."""


def read(t):
    if t.extra.get("kind") != "train" or not t.steps:
        return None
    return t.device_ops / t.steps
