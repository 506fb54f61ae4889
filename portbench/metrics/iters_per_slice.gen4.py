"""Optimizer iterations per slice that ran, over the window."""


def read(layer):
    o = layer["offline"]
    return o["iters"] / o["slices_ran"] if o["slices_ran"] else None
