"""A traced span: torch.profiler over a short steady stretch of a run.

``Tracer`` records the harness's own spans (host clock, the labels of
what the harness was doing: staging, slice loop, fetch; feed, waiting for
the due time) beside the profiler's device operations, and reduces the
trace to the device's busy time (the union of its operations' intervals),
the span's length, the summed time of every device operation, the
operations that took the most time, and the idle gaps labelled by the
harness span in progress.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Tuple

ANCHOR = "portbench.anchor"


def _op_name(name: str) -> str:
    """A device operation's short name: a kernel's function name without
    namespace, template arguments and parameters; a memset or a copy as
    the profiler names it."""
    if name.startswith(("Memset", "Memcpy")):
        return name.split(" ")[0]
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or name


class Tracer:
    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []
        self._prof = None
        self._t0_host = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        # One named range at a known host time ties the host clock to the
        # trace's clock.
        with record_function(ANCHOR):
            self._t0_host = time.perf_counter()

    def span(self, label: str, t_start: float, t_end: float):
        """A harness span on the host clock (``time.perf_counter``)."""
        self.spans.append((label, t_start, t_end))

    def stop(self):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        t_end_host = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        anchor = [e for e in events if e.name() == ANCHOR]
        dev = [e for e in events if e.device_type() == DeviceType.CUDA]
        self._prof = None
        if not anchor:
            raise RuntimeError("the trace lost its anchor range")
        a_ns = anchor[0].start_ns()
        to_host = lambda ns: self._t0_host + (ns - a_ns) * 1e-9
        ops = sorted((to_host(e.start_ns()), to_host(e.end_ns()),
                      _op_name(e.name())) for e in dev)
        return reduce(ops, self.spans, self._t0_host, t_end_host)


def reduce(ops, spans, t0: float, t1: float) -> dict:
    """``ops`` (start, end, name) on the host clock, inside [t0, t1]:
    busy_s (their union), window_s, device_s (their summed durations), the
    ten operations by summed time, and idle gaps by the label of the
    harness span holding each gap's midpoint: the totals by label, then
    the longest gaps, ten entries in all."""
    by_name = defaultdict(float)
    busy = 0.0
    device = 0.0
    gaps = []
    cur_s, cur_e = None, None
    last_end = t0
    for s, e, name in ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        by_name[name] += e - s
        device += e - s
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1 > last_end:
        gaps.append((last_end, t1))

    def label(g):
        mid = 0.5 * (g[0] + g[1])
        best = None
        for name, a, b in spans:
            if a <= mid <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "outside the harness spans"

    idle_by = defaultdict(float)
    labelled = [(label(g), g[1] - g[0]) for g in gaps]
    for name, d in labelled:
        idle_by[name] += d
    totals = sorted(idle_by.items(), key=lambda kv: -kv[1])[:5]
    longest = sorted(labelled, key=lambda kv: -kv[1])[:10 - len(totals)]
    idle = [[f"all idle in {k}", v] for k, v in totals] + \
        [[f"one gap in {k}", v] for k, v in longest]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": t1 - t0, "device_s": device,
            "n_ops": len(ops), "device_ops": [[k, v] for k, v in top],
            "idle_gaps": idle}
