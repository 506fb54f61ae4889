# Frozen copy of better_flow_tpu_torch/io/synthetic.py, kept here so that
# later changes to the program do not change the traffic.
"""Synthetic DVS event streams with known ground-truth flow.

The reference ships no data and no tests; its datasets are external .txt
recordings (bf_viewer.cpp:632-640).  This generator produces statistically
similar streams — events fired from scene edge points undergoing a global
4-parameter motion (translation / rotation / divergence about a centre) —
used for unit tests, golden tests, and the throughput benchmark.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def synthetic_events(
    n_events: int,
    duration_s: float = 0.2,
    res_x: int = 180,
    res_y: int = 240,
    vx: float = 60.0,
    vy: float = -40.0,
    rot: float = 0.0,
    div: float = 0.0,
    n_points: int = 400,
    jitter_px: float = 0.0,
    seed: int = 0,
    margin: float = 0.15,
) -> dict:
    """Generate ``n_events`` events over ``duration_s`` seconds.

    Scene: ``n_points`` texture points drawn inside the central
    (1-2*margin) window, each emitting events at uniformly random times.
    A point at p0 moves as

        p(t) = c + R(rot*t) * (p0 - c) * exp(div*t) + (vx, vy)*t

    so at small t the instantaneous per-event flow is approximately
    (vx, vy) + rot x r + div * r — matching the reference's 4-parameter
    model (event.h:88-96).

    Returns a dict with x, y (float pixels), t_ns (int64, sorted), and the
    ground-truth per-event flow u, v in px/s.
    """
    rng = np.random.default_rng(seed)
    cx, cy = res_x / 2.0, res_y / 2.0
    p0x = rng.uniform(margin * res_x, (1 - margin) * res_x, n_points)
    p0y = rng.uniform(margin * res_y, (1 - margin) * res_y, n_points)

    idx = rng.integers(0, n_points, n_events)
    t = np.sort(rng.uniform(0.0, duration_s, n_events))

    rx = p0x[idx] - cx
    ry = p0y[idx] - cy
    ang = rot * t
    growth = np.exp(div * t)
    cos_a, sin_a = np.cos(ang), np.sin(ang)
    rtx = (cos_a * rx - sin_a * ry) * growth
    rty = (sin_a * rx + cos_a * ry) * growth
    x = cx + rtx + vx * t
    y = cy + rty + vy * t
    if jitter_px > 0:
        x = x + rng.normal(0, jitter_px, n_events)
        y = y + rng.normal(0, jitter_px, n_events)

    # Instantaneous velocity d p / d t at emission time.
    u = vx + (-rot * rty + div * rtx)
    v = vy + (rot * rtx + div * rty)

    keep = (x >= 0) & (x < res_x - 1) & (y >= 0) & (y < res_y - 1)
    return {
        "x": np.floor(x[keep]).astype(np.float64),
        "y": np.floor(y[keep]).astype(np.float64),
        "t_ns": (t[keep] * 1e9).astype(np.int64),
        "u": u[keep],
        "v": v[keep],
        "polarity": rng.integers(0, 2, keep.sum()).astype(np.int8),
    }
