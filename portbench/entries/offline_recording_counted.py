"""Closed-loop offline runs, as ``offline_recording`` makes them, with the
program's own counters of the traced recording.

The window, the traced recording, the reference and the comparison are
``offline_recording.run``'s, unchanged: this entry runs that function from
a copy of its module whose tracer also opens the program's recorder
(``better_flow_tpu_torch.profiling.program_spans``) for the traced
recording alone, from the profiler's start to its stop.  The counters the
recorder took there go to ``layer["program"]["counters"]``:

- ``iters``: the optimizer iterations of the traced recording;
- ``finish_px``: the pixels the finishes' band pass swept, the whole
  scaled image each iteration;
- ``window_px``: the pixels of the slices' dynamic windows, each
  iteration, as ``roofline.slice_least_s`` counts them.

A program whose recorder lacks a counter gives none, and the readers of
the metrics built on it read nothing.  ``layer["program"]["scale"]`` is
the configuration's scale, on which the finish's operations depend.
"""

from __future__ import annotations

import pathlib

from portbench import tracing
from portbench.harness import load_module

BASE = pathlib.Path(__file__).resolve().parent / "offline_recording.py"
COUNTERS = ("iters", "finish_px", "window_px")


class CountedTracer(tracing.Tracer):
    """``tracing.Tracer`` that records the program's spans and counters
    while it traces; ``counters`` holds those of ``COUNTERS`` that the
    program took once it has stopped."""

    def __init__(self):
        super().__init__()
        self._spans = None
        self.counters = {}

    def start(self):
        from better_flow_tpu_torch import profiling

        super().start()
        self._spans = profiling.program_spans()
        rec = self._spans.__enter__()
        self._counters = rec.counters

    def stop(self):
        self._spans.__exit__(None, None, None)
        self._spans = None
        self.counters = {k: int(self._counters[k]) for k in COUNTERS
                         if k in self._counters}
        return super().stop()


def run(run) -> dict:
    base = load_module(BASE, "portbench_entry_offline_recording_counted_base")
    tracers = []

    def tracer():
        tracers.append(CountedTracer())
        return tracers[-1]

    base.Tracer = tracer
    out = base.run(run)
    if tracers:
        out["layer"]["program"] = {
            "counters": tracers[-1].counters,
            "scale": int(run.cell.config["optimizer"]["scale"])}
    return out
