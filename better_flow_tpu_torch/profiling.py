"""Tracing / profiling — the reference's VERBOSE timers.

The reference instruments with std::clock spans printed under VERBOSE
(optimizer_global.cpp:77-82, optimizer_rolling.h:114-119, SURVEY.md §5).
Here, as in ``better_flow_tpu/profiling.py``: span timers with the same
phase-breakdown prints, the %realtime metric (dvs_flow.h:275-282), and a
``torch.profiler`` context for device traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class Spans:
    """Accumulating named wall-clock spans with a per-run breakdown print.

    >>> spans = Spans()
    >>> with spans("projection"): ...
    >>> spans.report()   # 'Elapsed: ... (Projection: ... Pr image: ...)'
    """

    def __init__(self, verbose: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.verbose = verbose

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values())
        parts = " ".join(
            f"{k}: {v:.4f} sec." for k, v in sorted(self.totals.items())
        )
        line = f"\t Elapsed: {total:.4f} sec. ({parts})"
        if self.verbose:
            print(line)
        return line

    def reset(self):
        self.totals.clear()
        self.counts.clear()


def realtime_factor(slice_span_ns: int, wall_s: float) -> float:
    """%realtime = slice time-span / wall time (dvs_flow.h:275-282)."""
    return (slice_span_ns / 1e9) / wall_s if wall_s > 0 else 0.0


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the host and, where there is a card,
    its CUDA work, written to ``logdir`` as a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto) when the context
    exits; it yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class SliceStats:
    """Rolling perf summary mirroring the --bufferize-file prints
    (bf_motion_compensator.cpp:166-173)."""

    def __init__(self):
        self.rows = []

    def add(self, done: int, total: int, wall_s: float, n_events: int,
            slice_td_ns: int, buffer_td_ns: int):
        self.rows.append((done, total, wall_s, n_events, slice_td_ns, buffer_td_ns))

    def format_last(self) -> str:
        d, t, w, n, st, bt = self.rows[-1]
        return (
            f"{d * 100.0 / max(t, 1):.1f} %\t{d}\t{w:.4f} sec\t{n} events\t"
            f"{st / 1e9:.4f} slice_td\t{bt / 1e9:.4f} buffer_td"
        )

    def summary(self) -> dict:
        if not self.rows:
            return {}
        walls = [r[2] for r in self.rows]
        spans = [r[4] for r in self.rows]
        return {
            "slices": len(self.rows),
            "mean_wall_s": sum(walls) / len(walls),
            "mean_realtime_factor": (
                sum(realtime_factor(s, w) for s, w in zip(spans, walls))
                / len(self.rows)
            ),
        }
