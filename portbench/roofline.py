"""The least time the card could take for the work a run needed.

Frozen from ``chip_smoke.py`` (the port's smoke script:
``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``, ``OPS_*``, ``ops_finish`` and
``bound``), so that later changes there leave the benchmark's yardstick
as it is.  The work is counted from what the inputs need, whatever kernels
do it: every input byte read once and every output byte written once, the
operations per event and per pixel of the port's kernels (an fma counts
two), and each piece of work, which must wait for the one before it, at
the larger of its bytes over the memory rate and its operations over the
f32 rate.
"""

from __future__ import annotations

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device memory rate, and the f32 rate outside the tensor cores (the work
# has no matrix product).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_WARP = 40      # an event's re-warp (28), scaled truncation and window test
OPS_SPLAT = 16     # an accepted event's time weight and its two integer adds
OPS_UV = 4         # the final warp's u, v and noise per event


def ops_finish(pixels: int, scale: int) -> int:
    """The finish on ``pixels`` pixels: a separable box filter of two
    images (8 * (scale // 2) adds), fixed point to f32, normalise (5), the
    centre and all-nine masks (17), the Scharr pair (24) and the nine sums'
    terms (14)."""
    return pixels * (8 * (scale // 2) + 60)


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds: the larger of the bytes at the memory rate and the
    operations at the f32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def slice_least_s(n_events: int, window_pixels: int, iters: int,
                  scale: int) -> float:
    """One slice of ``n_events`` events: its activity rows (each event's
    index read, its flag written: 8 B), ``iters`` optimizer iterations
    (each reads an event's x, y, t, flag and position and writes its new
    position, 32 B, warps and splats it, and finishes the
    ``window_pixels`` pixels of its dynamic window), and the final warp
    (x, y, t, position and flag in, u, v and noise out: 36 B)."""
    n = int(n_events)
    t = bound_s(8 * n, 0)
    per_iter = bound_s(32 * n, n * (OPS_WARP + OPS_SPLAT)
                       + ops_finish(window_pixels, scale))
    t += iters * per_iter
    t += bound_s(36 * n, n * (OPS_WARP + OPS_UV))
    return t
