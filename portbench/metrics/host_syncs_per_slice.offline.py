"""Blocking device reads per slice, as the program counts them
(``stats["host_syncs"]``), over the window."""


def read(layer):
    o = layer["offline"]
    return o["host_syncs"] / o["slices"] if o["slices"] else None
