"""The pixels the finishes' band pass swept over those of the slices'
dynamic windows, in the traced recording (the program's counters
``finish_px`` and ``window_px``, summed over iterations): 1 where the
finish sweeps only the window the events need."""


def read(layer):
    c = layer.get("program", {}).get("counters", {})
    if not c.get("finish_px") or not c.get("window_px"):
        return None
    return c["finish_px"] / c["window_px"]
