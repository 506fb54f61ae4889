"""Merging processed slices into one deduplicated cloud.

Counterpart of ``better_flow_tpu/runtime/accumulate.py``, carried over as
it is (numpy only): that module cannot be imported from here, because
``better_flow_tpu.runtime`` imports JAX.

Reference: DVS_flow::get_accumulated (dvs_flow.h:350-389).  Overlapping
slices contain the same physical events (the ring keeps up to SPAN of
history); the reference walks slices in order, emits each event once, and
tombstones matching events in *later* slices.  "Matching" is Event::operator==
(event.h:40-45): same pixel and timestamps within 0.1 ms — with the scan
bounded to later-slice events whose timestamp does not exceed the emitted
one (the ``e_ - e > 0`` early break, dvs_flow.h:370).  The earliest slice's
flow estimate wins.

Vectorized equivalent: events are keyed by (x, y, timestamp); exact
duplicates keep the first-slice occurrence.  The residual near-match rule
(distinct timestamps within 0.1 ms at the same pixel, later slice, not newer)
is applied to the small set of surviving same-pixel collisions.
"""

from __future__ import annotations

from typing import List

import numpy as np


def merge_slices(slices: List) -> dict:
    if not slices:
        return {
            "x": np.zeros(0, np.float32),
            "y": np.zeros(0, np.float32),
            "timestamp": np.zeros(0, np.int64),
            "u": np.zeros(0, np.float32),
            "v": np.zeros(0, np.float32),
            "noise": np.zeros(0, bool),
        }
    x = np.concatenate([s.x for s in slices])
    y = np.concatenate([s.y for s in slices])
    ts = np.concatenate([s.timestamp for s in slices])
    u = np.concatenate([s.u for s in slices])
    v = np.concatenate([s.v for s in slices])
    noise = np.concatenate([s.noise for s in slices])
    slice_id = np.concatenate(
        [np.full(len(s.x), i, np.int32) for i, s in enumerate(slices)]
    )

    # Stable first-slice-wins dedupe on the exact key.
    order = np.arange(len(x))
    key = np.stack([x.astype(np.int64), y.astype(np.int64), ts], axis=1)
    # lexsort by key then original order so the first occurrence leads
    perm = np.lexsort((order, ts, y, x))
    k = key[perm]
    first = np.ones(len(x), bool)
    if len(x) > 1:
        same = np.all(k[1:] == k[:-1], axis=1)
        first[1:] = ~same
    keep = np.zeros(len(x), bool)
    keep[perm[first]] = True

    # Near-match pass: same pixel, |dt| < 0.1 ms, later slice, not newer.
    surv = np.nonzero(keep)[0]
    sx, sy, sts = x[surv], y[surv], ts[surv]
    pperm = np.lexsort((sts, sy, sx))
    si = surv[pperm]
    px, py, pts, psl = x[si], y[si], ts[si], slice_id[si]
    for a in range(len(si) - 1):
        if not keep[si[a]]:
            continue
        b = a + 1
        while (
            b < len(si)
            and px[b] == px[a]
            and py[b] == py[a]
            and pts[b] - pts[a] < 100_000
        ):
            # one of the pair is from a later slice and not newer in time:
            # the earlier-slice event survives (dvs_flow.h:366-379)
            if keep[si[b]]:
                if psl[b] > psl[a] and pts[b] <= pts[a] + 0:
                    keep[si[b]] = False
                elif psl[a] > psl[b] and pts[a] <= pts[b]:
                    keep[si[a]] = False
            b += 1

    keep_idx = np.nonzero(keep)[0]
    # preserve emission order: slices in order, events in slice order
    keep_idx = keep_idx[np.argsort(keep_idx, kind="stable")]
    return {
        "x": x[keep_idx],
        "y": y[keep_idx],
        "timestamp": ts[keep_idx],
        "u": u[keep_idx],
        "v": v[keep_idx],
        "noise": noise[keep_idx],
    }
