"""Blocking device reads per slice: ``DVSFlow.host_syncs`` at the
window's end over its slices."""


def read(layer):
    o = layer["live"]
    return o["host_syncs"] / o["slices"] if o["slices"] else None
