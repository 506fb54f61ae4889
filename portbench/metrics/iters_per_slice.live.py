"""Optimizer iterations per slice (``SliceRecord.iters``) over the window."""


def read(layer):
    it = layer["live"]["iters"]
    return sum(it) / len(it) if it else None
