"""How late the feed ran: the 95th percentile over the window's slices of
the time from the due time of a slice's triggering event to the start
of the feed call that delivered it, in milliseconds."""


def read(layer):
    import numpy as np

    w = layer["live"]["queue_wait_ms"]
    return float(np.percentile(w, 95)) if w else None
