"""Tracing / profiling — the reference's VERBOSE timers, and the
program's spans.

The reference instruments with std::clock spans printed under VERBOSE
(optimizer_global.cpp:77-82, optimizer_rolling.h:114-119, SURVEY.md §5).
Here, as in ``better_flow_tpu/profiling.py``: span timers with the same
phase-breakdown prints, the %realtime metric (dvs_flow.h:275-282), and a
``torch.profiler`` context for device traces.

The program records its own spans (cold path, slice loop, optimizer
drive; names in ``PERF.md`` §3) into ``RECORDER`` while
``program_spans()`` is open, and nowhere else: off, each site of the hot
path costs one test of ``RECORDER`` against None, and reads no clock.
Spans are on ``time.perf_counter``; ``device_trace`` writes them into its
trace on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, NamedTuple, Optional

# The recorder that the program's span sites write to: a ``Spans`` while
# ``program_spans()`` is open, else None.
RECORDER: Optional["Spans"] = None

# The cold path's worker thread (``thread_name_prefix``): its spans are
# recorded as that thread's, every other thread's as the caller's ("main").
WORKER = "bf-stage"


class Span(NamedTuple):
    """One closed span: ``id``; ``name``; ``t0`` and ``t1`` on
    ``time.perf_counter``; ``thread``, ``"main"`` or ``WORKER``;
    ``parent``, the id of the span that caused it (None at the top),
    which for work handed to another thread is the span that handed it
    over; ``call``, the id of the top span of the call it belongs to."""

    id: int
    name: str
    t0: float
    t1: float
    thread: str
    parent: Optional[int]
    call: int


def _thread() -> str:
    return WORKER if threading.current_thread().name.startswith(WORKER) \
        else "main"


class Spans:
    """Named wall-clock spans, nested per thread, with a per-run breakdown
    print.

    >>> spans = Spans()
    >>> with spans("projection"): ...
    >>> spans.report()   # 'Elapsed: ... (Projection: ... Pr image: ...)'

    Every span is kept (``records``, ``Span``): a span opened inside
    another on the same thread is its child; ``context()`` hands the
    innermost open span to work another thread does on its behalf
    (``open(..., ctx=)``).  ``totals`` and ``counts`` sum the records by
    name, ``self_times`` less what each span's children on its thread
    cover.  ``counters`` are counts the program takes at the same
    boundaries (``count``); ``launches`` the hand-kernel launches of each
    call (``close(..., launches=)``), by call id.
    """

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.records: list = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.launches: Dict[int, dict] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    @property
    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for r in self.records:
            out[r.name] += r.t1 - r.t0
        return out

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for r in self.records:
            out[r.name] += 1
        return out

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def context(self):
        """(span id, call id) of this thread's innermost open span, or
        (None, None) outside any."""
        stack = self._stack()
        return stack[-1][:2] if stack else (None, None)

    def open(self, name: str, t0: Optional[float] = None, ctx=None) -> int:
        """Open a span at ``t0`` (now when None) under this thread's
        innermost open span, or under ``ctx`` (a ``context()`` of another
        thread).  Returns its id."""
        parent, call = ctx if ctx is not None else self.context()
        sid = next(self._ids)
        self._stack().append((sid, call or sid, name, parent,
                              time.perf_counter() if t0 is None else t0))
        return sid

    def close(self, sid: int, t1: Optional[float] = None,
              launches=None) -> None:
        """Close the open span ``sid`` of this thread at ``t1`` (now when
        None), and drop the spans still open inside it (left open by an
        exception).  ``launches``, the hand-kernel launches of a call
        (``ops.fused_model.LAUNCHES``' difference), are kept by call."""
        stack = self._stack()
        while True:
            top, call, name, parent, t0 = stack.pop()
            if top == sid:
                break
        self.records.append(Span(sid, name, t0, time.perf_counter()
                                 if t1 is None else t1, _thread(), parent,
                                 call))
        if launches is not None:
            self.launches[call] = dict(launches)

    def add(self, name: str, t0: float, t1: float) -> None:
        """A span with no children, [t0, t1], under this thread's innermost
        open span."""
        parent, call = self.context()
        sid = next(self._ids)
        self.records.append(Span(sid, name, t0, t1, _thread(), parent,
                                 call or sid))

    def count(self, name: str, k: int = 1) -> None:
        """Add ``k`` to the counter ``name`` (main thread only)."""
        self.counters[name] += k

    @contextlib.contextmanager
    def __call__(self, name: str):
        sid = self.open(name)
        try:
            yield
        finally:
            self.close(sid)

    def self_times(self) -> Dict[int, float]:
        """Each span's self time by id: its duration less its children's
        on its own thread (children on another thread overlap it)."""
        by_id = {r.id: r for r in self.records}
        out = {r.id: r.t1 - r.t0 for r in self.records}
        for r in self.records:
            p = by_id.get(r.parent)
            if p is not None and p.thread == r.thread:
                out[p.id] -= r.t1 - r.t0
        return out

    def summary(self) -> dict:
        """The spans by name (``n``, ``total_s``, ``self_s``), the
        counters and the calls' launches summed."""
        own = self.self_times()
        spans: Dict[str, dict] = {}
        for r in self.records:
            s = spans.setdefault(r.name, {"n": 0, "total_s": 0.0,
                                          "self_s": 0.0})
            s["n"] += 1
            s["total_s"] += r.t1 - r.t0
            s["self_s"] += own[r.id]
        launches: Dict[str, int] = defaultdict(int)
        for per_call in self.launches.values():
            for k, v in per_call.items():
                launches[k] += v
        return {"spans": spans, "counters": dict(self.counters),
                "launches": dict(launches)}

    def report(self) -> str:
        totals = self.totals
        total = sum(totals.values())
        parts = " ".join(
            f"{k}: {v:.4f} sec." for k, v in sorted(totals.items())
        )
        line = f"\t Elapsed: {total:.4f} sec. ({parts})"
        if self.verbose:
            print(line)
        return line

    def reset(self):
        self.records.clear()
        self.counters.clear()
        self.launches.clear()


@contextlib.contextmanager
def program_spans():
    """Record the program's spans while the context is open: yields the
    ``Spans`` recorder (``RECORDER``), which holds them when it exits.
    The only switch of the program's spans; one recorder at a time."""
    global RECORDER
    if RECORDER is not None:
        raise RuntimeError("the program's spans are already being recorded")
    rec = RECORDER = Spans()
    try:
        yield rec
    finally:
        RECORDER = None


def span(name: str):
    """The recorder's span ``name`` as a context while ``program_spans``
    is open, else a context that does nothing: for sites outside the hot
    path."""
    return contextlib.nullcontext() if RECORDER is None else RECORDER(name)


def realtime_factor(slice_span_ns: int, wall_s: float) -> float:
    """%realtime = slice time-span / wall time (dvs_flow.h:275-282)."""
    return (slice_span_ns / 1e9) / wall_s if wall_s > 0 else 0.0


ANCHOR = "better_flow_tpu_torch.anchor"
# Synchronizes of an idle card that place the program's spans in
# ``device_trace``'s trace.
SYNCS = 32


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the host and, where there is a card,
    its CUDA work, written to ``logdir`` as a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto) when the context
    exits; it yields the profiler.  The program's spans of the context
    (``program_spans``, or the recorder already open) go into the trace
    too, on its clock, as a host track of their own per thread."""
    import torch
    from torch.profiler import record_function

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with contextlib.ExitStack() as stack:
        rec = RECORDER or stack.enter_context(program_spans())
        first = len(rec.records)
        with torch.profiler.profile(activities=acts) as prof:
            # A named range at a known host time ties perf_counter to the
            # trace's clock; on a card, more closely, synchronizes.
            with record_function(ANCHOR):
                t_anchor = time.perf_counter()
            syncs = []
            for _ in range(SYNCS if torch.cuda.is_available() else 0):
                a = time.perf_counter()
                torch.cuda.synchronize()
                syncs.append((a, time.perf_counter()))
            yield prof
    prof.export_chrome_trace(path)
    _add_spans(path, rec.records[first:], t_anchor, syncs)


def _add_spans(path: str, spans, t_anchor: float, syncs) -> None:
    """Write ``spans`` into the Chrome trace at ``path``, placed by the
    trace's records of the synchronizes whose host readings are ``syncs``
    (each record lies between its readings, which bounds the offset of
    the clocks: the middle of the bounds), or else by the anchor range
    (``ANCHOR``, whose start lags the host's reading ``t_anchor`` inside
    it by up to hundreds of microseconds)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    ts0 = next(e["ts"] for e in events if e.get("name") == ANCHOR)
    recs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == "cudaDeviceSynchronize"
                  and e["ts"] >= ts0)[:len(syncs)]
    if syncs and len(recs) == len(syncs):
        lo = max(a * 1e6 - r0 for (a, _), (r0, _) in zip(syncs, recs))
        hi = min(b * 1e6 - r1 for (_, b), (_, r1) in zip(syncs, recs))
        ts0, t_anchor = 0.0, 0.5 * (lo + hi) * 1e-6
    pid = os.getpid()
    tids = {}
    for s in spans:
        if s.thread not in tids:
            tids[s.thread] = tid = 2 ** 30 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {
                               "name": f"program spans ({s.thread})"}})
        events.append({"ph": "X", "name": s.name, "cat": "program",
                       "pid": pid, "tid": tids[s.thread],
                       "ts": ts0 + (s.t0 - t_anchor) * 1e6,
                       "dur": (s.t1 - s.t0) * 1e6,
                       "args": {"id": s.id, "parent": s.parent,
                                "call": s.call}})
    with open(path, "w") as f:
        json.dump(trace, f)


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
