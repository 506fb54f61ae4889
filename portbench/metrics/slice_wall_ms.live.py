"""The mean of ``SliceRecord.wall_s`` over the window's slices
(``DVSFlow.recompute``: snapshot, sort, upload, optimizer, final warp,
fetch and write-back), in milliseconds."""


def read(layer):
    w = layer["live"]["wall_ms"]
    return sum(w) / len(w) if w else None
