"""The device's idle share of the traced span, in percent: one less the
union of its operations' intervals over the span."""


def read(layer):
    t = layer.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
