"""Fixed-capacity SoA event slices as tensors.

Counterpart of ``better_flow_tpu/core/events.py``: a slice of events is a
fixed-capacity set of flat tensors; eviction and noise are masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class EventSlice(NamedTuple):
    """A fixed-capacity slice of events; every field is a flat (N,) tensor.

    x, y  : f32 pixel coordinates (``x`` indexes image rows, ``y`` columns,
            the reference's swapped convention).
    t     : f32 slice-local time in nanoseconds.
    valid : bool, True for real events, False for padding.
    noise : bool, events flagged as noise by a degenerate slice; excluded
            from the images but still present in the buffer.
    """

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    valid: torch.Tensor
    noise: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    @property
    def active(self) -> torch.Tensor:
        """Events that contribute to the images: valid and not noise."""
        return self.valid & ~self.noise


def make_slice(x, y, t, capacity: Optional[int] = None, noise=None,
               device="cpu") -> EventSlice:
    """An EventSlice of host arrays on ``device``, padded to ``capacity``
    with x = y = t = 0, valid = noise = False."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    t = np.asarray(t, np.float32)
    n = x.shape[0]
    noise = np.zeros(n, bool) if noise is None else np.asarray(noise, bool)
    cap = capacity if capacity is not None else n
    if n > cap:
        raise ValueError(f"{n} events exceed capacity {cap}")
    pad = cap - n

    def dev(a, fill=0):
        return torch.from_numpy(
            np.concatenate([a, np.full(pad, fill, a.dtype)])).to(device)

    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return EventSlice(x=dev(x), y=dev(y), t=dev(t),
                      valid=torch.from_numpy(valid).to(device),
                      noise=dev(noise, False))


def bounding_box(ev, comm=None):
    """Integer bbox (x_min, x_max, y_min, y_max) over all valid events,
    noise-flagged ones included (OptimizerRolling::set_cloud,
    optimizer_rolling.h:252-261), as host ints; (0, 0, 0, 0) for an empty
    slice, which the window gate then rejects.  ``ev`` is an ``EventSlice``
    or a sequence of this process's shards of one; with ``comm`` (a
    ``parallel.comm`` communicator) the bbox is reduced over its ranks in
    one all-reduce.  One device read."""
    shards = [ev] if isinstance(ev, EventSlice) else list(ev)
    big = 1 << 30
    rows = []
    for e in shards:
        xi, yi = e.x.to(torch.int32), e.y.to(torch.int32)
        hi = torch.full_like(xi, big)
        # One minimum serves all five: maxima and "any" enter negated.
        rows.append(torch.stack([
            torch.where(e.valid, xi, hi).min(),
            torch.where(e.valid, -xi, hi).min(),
            torch.where(e.valid, yi, hi).min(),
            torch.where(e.valid, -yi, hi).min(),
            -e.valid.any().to(torch.int32)]) if xi.numel() else
            torch.tensor([big, big, big, big, 0], dtype=torch.int32,
                         device=xi.device))
    v = torch.stack(rows).min(dim=0).values
    if comm is not None and comm.size > 1:
        v, = comm.all_reduce_min([v])
    x_min, nx_max, y_min, ny_max, nany = v.tolist()
    if nany == 0:
        return 0, 0, 0, 0
    return x_min, -nx_max, y_min, -ny_max
