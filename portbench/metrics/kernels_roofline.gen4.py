"""The kernels' share of their roofline, in percent: the least time of
the work the traced recording needed (``portbench.roofline``) over the
summed time of every device operation in the traced span."""


def read(layer):
    t = layer.get("trace")
    if not t or not t["device_s"]:
        return None
    return 100.0 * t["least_s"] / t["device_s"]
