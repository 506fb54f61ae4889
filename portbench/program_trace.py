#!/usr/bin/env python3
"""The program's own spans beside the device trace.

The port records its spans (cold path, slice loop, optimizer drive; names
in ``PERF.md`` §3) while ``better_flow_tpu_torch.profiling.program_spans``
is open.  This module ties them to ``portbench.tracing``'s traced span:

- ``ProgramTracer``, a ``Tracer`` that also places the trace's clocks on
  the host's by ``PROBES`` small kernels on the idle card just after the
  traced span's start and as many just before its end, each waited for:
  each kernel's record, and the runtime's record of the wait, lies
  between the host's readings before its launch and after its wait,
  which bounds the offset between the clocks; the offset is the middle of
  those bounds at each end, interpolated between them, once for the
  device's records and once for the runtime's (each drifts against the
  host's clock in its own way; a named range's start lags the host's
  reading inside it by up to hundreds of microseconds under CUDA tracing,
  so the range marks the span's start only).  Given the program's spans
  (``ProgramTracer.program``), its reduction labels each idle gap by the
  innermost span of the program's main thread that holds it, followed,
  where that span waits on the worker thread (``WAITS``), by the worker's
  innermost span; it also gives the two ends' offsets' disagreement
  (``clock_skew_us``, the drift the interpolation takes out), the share of
  the optimizer's trips whose B2 kernel ended before the trip's blocking
  read did (``causality``), the top-level host operators that started
  inside ``slice`` spans (``torch_ops_in_slices``) and the copies' device
  time by direction (``copies_s``).
- ``METRICS``, six per-layer readings of a traced recording's
  ``layer["program"]`` (``program_layer``).
- A command that runs one cell's set-up, one traced recording with the
  program's spans on (the readings), and then traced recordings in pairs
  with the spans on and off, both under the profiler (their cost):

      python3 portbench/program_trace.py --workload offline-fast-long \\
          --seed <n> --pairs <k> [--out <file.json>]

  It prints the readings, the clock check, the idle time by program label
  and the pairs' walls to standard error, and the whole as one JSON
  object on the last line of standard output (and into ``--out``); it
  exits with 1 where a pair's outputs differ.  It
  needs a CUDA card, and a program that has ``program_spans``: without
  one it exits with 3.

The harness's own runs (``portbench/run.py``) do not use this module.
"""

from __future__ import annotations

import bisect
import pathlib
import sys
import time
from collections import defaultdict
from typing import Optional, Tuple

if __name__ == "__main__":
    T_PROCESS = time.perf_counter()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import tracing  # noqa: E402
from portbench.tracing import ANCHOR, Tracer, _op_name  # noqa: E402

# Small kernels, each waited for: ``PROBES`` at the start and as many at
# the end tie the trace's clocks (the device's records, the runtime's
# records of the host's calls) to the host's.
PROBES = 32
SYNC = "cudaDeviceSynchronize"
# The program's spans in which its main thread waits on its worker.
WAITS = ("cold.wait_stage", "cold.wait_fetch")
# B2, the kernel whose end the optimizer's blocking read waits for.
B2 = "iteration_kernel"
# The program's spans of a whole call: idle time under them and not under
# a span inside them is not attributed.
CALLS = ("cold", "scan")


class ProgramTracer(Tracer):
    def __init__(self):
        super().__init__()
        self.program_spans: Optional[list] = None

    def start(self):
        import torch

        torch.cuda.synchronize()
        self._probe = torch.zeros(1, device="cuda")
        super().start()
        self._probes0 = _probes(self._probe)

    def program(self, records):
        """The program's spans of the traced stretch: records with
        ``name``, ``t0``, ``t1`` and ``thread`` (``"main"`` or the
        worker's) on the host clock."""
        self.program_spans = list(records)

    def stop(self):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        t_end_host = time.perf_counter()
        probes1 = _probes(self._probe)
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        anchor = [e for e in events if e.name() == ANCHOR]
        dev = [e for e in events if e.device_type() == DeviceType.CUDA]
        self._prof = None
        if not anchor:
            raise RuntimeError("the trace lost its anchor range")
        a_ns = anchor[0].start_ns()
        to_dev = to_cpu = lambda ns: self._t0_host + (ns - a_ns) * 1e-9
        fits = {}
        # The first and the last device records are the probes' kernels
        # (not the traced work); each one's wait is the runtime's first
        # synchronize after its launch.
        after = sorted((e for e in dev if e.start_ns() >= a_ns),
                       key=lambda e: e.start_ns())
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if e.device_type() == DeviceType.CPU
                  and e.correlation_id() and "Launch" in e.name()}
        syncs = sorted((e for e in events if e.name() == SYNC
                        and e.start_ns() >= a_ns), key=lambda e: e.start_ns())
        starts = [e.start_ns() for e in syncs]

        def waited(k):
            i = bisect.bisect_left(starts, launch.get(k.correlation_id(), -1))
            return syncs[i] if i < len(syncs) else None

        if len(after) >= 2 * PROBES:
            kernels = after[:PROBES], after[-PROBES:]
            waits = [[waited(k) for k in part] for part in kernels]
            readings = self._probes0, probes1
            # The device's records and the runtime's are placed apart:
            # each clock drifts against the host's in its own way.
            to_dev, fits["device"] = fit_clock(readings, kernels, a_ns)
            if all(w is not None for part in waits for w in part):
                to_cpu, fits["host"] = fit_clock(readings, waits, a_ns)
            ids = {id(e) for part in kernels for e in part}
            dev = [e for e in dev if id(e) not in ids]
        ops = sorted((to_dev(e.start_ns()), to_dev(e.end_ns()),
                      _op_name(e.name())) for e in dev)
        out = reduce(ops, self.spans, self._t0_host, t_end_host,
                     program=self.program_spans)
        if self.program_spans is not None:
            out["clock"] = fits
            dv = fits.get("device")
            out["clock_skew_us"] = None if dv is None else dv["skew_us"]
            out["causality"] = causality(events, dev, to_cpu, to_dev,
                                         self.program_spans)
            out["torch_ops_in_slices"] = ops_in_slices(
                events, to_cpu, anchor[0].start_thread_id(),
                self.program_spans)
            out["copies_s"] = copies(dev)
        return out


def _probes(z) -> list:
    """``PROBES`` one-kernel additions to ``z`` on an idle card, each
    waited for: the host's readings before each launch and after each
    wait."""
    import torch

    out = []
    for _ in range(PROBES):
        a = time.perf_counter()
        z.add_(1)
        torch.cuda.synchronize()
        out.append((a, time.perf_counter()))
    return out


def fit_clock(readings, records, a_ns):
    """The map of the trace's nanoseconds onto the host's seconds from the
    probes' host readings and the trace's records of them, at the start
    and at the end: the offset at each end (``clock_offset``),
    interpolated between them; and the fit's numbers in microseconds:
    the start's bounds' width and the two ends' disagreement (the drift
    taken out)."""
    rel = lambda e: ((e.start_ns() - a_ns) * 1e-9,
                     (e.end_ns() - a_ns) * 1e-9)
    first, last = ([rel(e) for e in part] for part in records)
    (o0, width), (o1, _) = (clock_offset(r, p) for r, p in
                            zip(readings, (first, last)))
    p0, p1 = first[0][0], last[0][0]
    slope = (o1 - o0) / (p1 - p0)

    def to_host(ns):
        t = (ns - a_ns) * 1e-9
        return t + o0 + slope * (t - p0)

    return to_host, {"bounds_us": 1e6 * width, "skew_us": 1e6 * (o1 - o0)}


def clock_offset(readings, records) -> Tuple[float, float]:
    """The host clock less the trace's, from host readings (a, b) around
    calls and the trace's records (start, end) of them, in order: each
    record lies inside its readings, so the offset lies in every
    [a - start, b - end]: the middle of their intersection (of the two
    bounds where they cross), and its width (negative where they
    cross)."""
    lo = max(a - s for (a, _), (s, _) in zip(readings, records))
    hi = min(b - e for (_, b), (_, e) in zip(readings, records))
    return 0.5 * (lo + hi), hi - lo


def copies(dev) -> dict:
    """The device's copies' summed seconds by direction (``HtoD``,
    ``DtoH``, ``DtoD``, as the profiler names them)."""
    out = defaultdict(float)
    for e in dev:
        if e.name().startswith("Memcpy"):
            kind = e.name().split(" ")[1] if " " in e.name() else "?"
            out[kind] += (e.end_ns() - e.start_ns()) * 1e-9
    return dict(out)


def _main_spans(program, name: str) -> list:
    return sorted((s.t0, s.t1) for s in program
                  if s.thread == "main" and s.name == name)


def causality(events, dev, to_cpu, to_dev, program) -> dict:
    """Of the trips (``drive.launch`` and the ``drive.read`` after it)
    whose B2 kernels the trace holds, matched by the host launch's
    correlation id and its time inside the trip, the share whose last B2
    ended on the host clock before the trip's read returned: the read can
    only return after it, so a share below 1 is a clock that
    disagrees."""
    from torch.autograd import DeviceType

    launched = {e.correlation_id(): to_cpu(e.start_ns()) for e in events
                if e.device_type() == DeviceType.CPU and e.correlation_id()
                and "Launch" in e.name()}
    trips = _main_spans(program, "drive.launch")
    reads = _main_spans(program, "drive.read")
    if len(trips) != len(reads) or not trips:
        return {"trips": 0, "of_trips": len(trips), "share": None}
    starts = [a for a, _ in trips]
    last_b2 = {}
    for e in dev:
        if _op_name(e.name()) != B2 or e.correlation_id() not in launched:
            continue
        h = launched[e.correlation_id()]
        k = bisect.bisect_right(starts, h) - 1
        if k >= 0 and h <= reads[k][1]:
            last_b2[k] = max(last_b2.get(k, h), to_dev(e.end_ns()))
    late = sorted(1e6 * (end - reads[k][1]) for k, end in last_b2.items()
                  if end > reads[k][1])
    ok = len(last_b2) - len(late)
    # By tenths of the traced trips: their share late and median lateness.
    ks = sorted(last_b2)
    tenths = []
    for q in range(10):
        d = sorted(1e6 * (last_b2[k] - reads[k][1])
                   for k in ks[q * len(ks) // 10:(q + 1) * len(ks) // 10])
        if d:
            tenths.append((round(sum(v > 0 for v in d) / len(d), 4),
                           round(d[len(d) // 2], 1)))
    return {"trips": len(last_b2), "of_trips": len(trips),
            "late_us_median": late[len(late) // 2] if late else None,
            "tenths": tenths,
            "b2": sum(_op_name(e.name()) == B2 for e in dev),
            "b2_launched": sum(_op_name(e.name()) == B2
                               and e.correlation_id() in launched
                               for e in dev),
            "share": ok / len(last_b2) if last_b2 else None}


def ops_in_slices(events, to_host, thread, program) -> int:
    """The profiler's top-level host operators (``aten::``, not inside
    another on their thread) of the main thread (``thread``) that started
    inside the program's ``slice`` spans."""
    from torch.autograd import DeviceType

    slices = _main_spans(program, "slice")
    starts = [a for a, _ in slices]
    ops = sorted((e.start_ns(), -e.end_ns()) for e in events
                 if e.device_type() == DeviceType.CPU
                 and e.start_thread_id() == thread
                 and e.name().startswith("aten::"))
    n, outer_end = 0, None
    for s_ns, neg_end in ops:
        if outer_end is not None and s_ns < outer_end:
            continue                     # inside the last top-level one
        outer_end = -neg_end
        h = to_host(s_ns)
        k = bisect.bisect_right(starts, h) - 1
        n += k >= 0 and h <= slices[k][1]
    return n


def innermost(spans, points) -> list:
    """For each of ``points`` (ascending), the innermost of ``spans``
    ((t0, t1, label), nested or disjoint, as one thread's are) that holds
    it, or None: one sweep over both sorted by start."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(order) and order[i][0] <= p:
            while stack and stack[-1][1] < order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def program_labels(gaps, program) -> list:
    """Each gap's label by the program's spans: the innermost main-thread
    span holding its midpoint, and where that span waits on the worker,
    ``" > "`` and the worker's innermost span there; None outside them."""
    mids = [0.5 * (a + b) for a, b in gaps]
    order = sorted(range(len(mids)), key=mids.__getitem__)
    pts = [mids[k] for k in order]
    main = innermost([(s.t0, s.t1, s.name) for s in program
                      if s.thread == "main"], pts)
    worker = innermost([(s.t0, s.t1, s.name) for s in program
                        if s.thread != "main"], pts)
    labels = [None] * len(gaps)
    for k, m, w in zip(order, main, worker):
        labels[k] = f"{m} > {w}" if m in WAITS and w else m
    return labels


def idle_gaps(ops, t0: float, t1: float) -> list:
    """The device's idle gaps (start, end) inside [t0, t1] between
    ``ops`` (start, end, name), sorted by start, as ``tracing.reduce``
    finds them."""
    gaps = []
    cur_e, last_end = None, t0
    for s, e, _ in ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if s > last_end:
                gaps.append((last_end, s))
            cur_e = e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, cur_e)
    if t1 > last_end:
        gaps.append((last_end, t1))
    return gaps


def reduce(ops, spans, t0: float, t1: float, program=None) -> dict:
    """``tracing.reduce``'s reduction; given the ``program``'s spans, a
    gap that one of them holds takes its label from them
    (``program_labels``), any other the harness span's, and the idle
    time by label is added whole (``idle_by_label``)."""
    out = tracing.reduce(ops, spans, t0, t1)
    if not program:
        return out
    gaps = idle_gaps(ops, t0, t1)
    by_program = program_labels(gaps, program)
    pts = sorted(0.5 * (a + b) for a, b in gaps)
    harness = dict(zip(pts, innermost([(a, b, n) for n, a, b in spans],
                                      pts)))
    labelled = [(p or harness[0.5 * (g[0] + g[1])]
                 or "outside the harness spans", g[1] - g[0])
                for g, p in zip(gaps, by_program)]
    idle_by = defaultdict(float)
    for name, d in labelled:
        idle_by[name] += d
    totals = sorted(idle_by.items(), key=lambda kv: -kv[1])[:5]
    longest = sorted(labelled, key=lambda kv: -kv[1])[:10 - len(totals)]
    out["idle_gaps"] = [[f"all idle in {k}", v] for k, v in totals] + \
        [[f"one gap in {k}", v] for k, v in longest]
    out["idle_by_label"] = dict(idle_by)
    return out


def below_calls(idle_by_label: dict) -> float:
    """The idle seconds under a program span below a whole call's
    (``CALLS``): labelled by a span name that is neither a call's nor a
    harness phrase."""
    main = lambda k: k.split(" > ")[0]
    return sum(v for k, v in idle_by_label.items()
               if main(k) not in CALLS and " " not in main(k))


def program_layer(recorder, trace: dict) -> dict:
    """``layer["program"]`` of a traced recording: the recorder's summary
    (spans by name, counters, launches) and the operators inside slices."""
    return dict(recorder.summary(),
                torch_ops_in_slices=trace.get("torch_ops_in_slices"))


def _mean_us(name: str):
    def read(layer):
        s = layer.get("program", {}).get("spans", {}).get(name)
        return 1e6 * s["total_s"] / s["n"] if s and s["n"] else None
    return read


def _slice_host_us(layer):
    s = layer.get("program", {}).get("spans", {}).get("slice")
    return 1e6 * s["self_s"] / s["n"] if s and s["n"] else None


def _cold_stage_wait_share(layer):
    spans = layer.get("program", {}).get("spans", {})
    cold, wait = spans.get("cold"), spans.get("cold.wait_stage")
    if not cold or not wait or not cold["total_s"]:
        return None
    return 100.0 * wait["total_s"] / cold["total_s"]


def _torch_ops_per_slice(layer):
    p = layer.get("program", {})
    s = p.get("spans", {}).get("slice")
    if not s or not s["n"] or p.get("torch_ops_in_slices") is None:
        return None
    return p["torch_ops_in_slices"] / s["n"]


def _launches_per_iter(layer):
    p = layer.get("program", {})
    iters = p.get("counters", {}).get("iters")
    if not iters or not p.get("launches"):
        return None
    return sum(p["launches"].values()) / iters


# The readings of a traced recording's ``layer["program"]``, each None
# where the program has no such span or counter:
# - trip_launch_us: the host's enqueue of an optimizer trip (B1 + B2), the
#   mean ``drive.launch``;
# - trip_read_wait_us: the host blocked on a trip's CONT/ITERS read, the
#   mean ``drive.read``;
# - slice_host_us: per-slice host work outside the trips, the mean self
#   time of ``slice``;
# - cold_stage_wait_share: the main thread waiting on staging, summed
#   ``cold.wait_stage`` over ``cold``, in percent;
# - torch_ops_per_slice: top-level host operators (``aten::``) of the main
#   thread that started inside ``slice`` spans, over those spans;
# - launches_per_iter: hand-kernel launches (``ops.fused_model.LAUNCHES``
#   at the call's boundaries) over the iterations the slices ran.
METRICS = {
    "trip_launch_us.offline": _mean_us("drive.launch"),
    "trip_read_wait_us.offline": _mean_us("drive.read"),
    "slice_host_us.offline": _slice_host_us,
    "cold_stage_wait_share.offline": _cold_stage_wait_share,
    "torch_ops_per_slice.offline": _torch_ops_per_slice,
    "launches_per_iter.offline": _launches_per_iter,
}


def log_idle(idle_by_label: dict) -> None:
    from portbench.harness import log

    total = sum(idle_by_label.values())
    below = below_calls(idle_by_label)
    log(f"idle {total:.6f} s, below the call {below:.6f} s "
        f"({100.0 * below / total if total else 0.0:.3f}%):")
    for k, v in sorted(idle_by_label.items(), key=lambda kv: -kv[1]):
        log(f"  idle {v:.6f} s in {k}")


def traced(call, rec, on: bool) -> Tuple[dict, dict, float]:
    """One recording through ``call`` under a ``ProgramTracer``, with the
    program's spans on or off: the call's output, the trace's reduction
    (with ``program`` added where on) and the call's wall seconds."""
    import contextlib

    from better_flow_tpu_torch import profiling

    tracer = ProgramTracer()
    tracer.start()
    with (profiling.program_spans() if on
          else contextlib.nullcontext()) as recorder:
        a = time.perf_counter()
        out = call(rec)
        b = time.perf_counter()
    if on:
        tracer.program(recorder.records)
    tracer.span("call", a, b)
    trace = tracer.stop()
    if on:
        trace["program"] = program_layer(recorder, trace)
    return out, trace, b - a


def main(argv, t_process: float) -> int:
    import argparse
    import json
    import statistics

    import numpy as np

    from portbench import harness, traffic
    from portbench.harness import log

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="offline-fast-long")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.read_json(harness.ROOT /
                                               "BENCHMARK.json"),
                             args.workload)
    import torch

    from better_flow_tpu_torch import profiling

    if not torch.cuda.is_available():
        log("needs a CUDA card: no result")
        return 3
    if not hasattr(profiling, "program_spans"):
        log("the program records no spans of its own: no result")
        return 3
    if cell.config["entry"] != "offline_recording":
        log(f"{args.workload}: only offline cells are traced here")
        return 2
    from better_flow_tpu_torch.runtime import scan_pipeline

    run = harness.Run(cell=cell, seed=args.seed, seconds=0.0, trace=True,
                      device="cuda", t_process=t_process)
    cfg = run.pipeline_config()
    fn = getattr(scan_pipeline, cell.config["entry_args"]["function"])
    call = lambda r: fn(r["x"], r["y"], r["t_ns"], cfg, device="cuda")
    pool = traffic.recordings(cell.mix, args.seed)
    call(pool[0])                     # every shape the calls use
    torch.cuda.synchronize()
    log(f"set-up {time.perf_counter() - t_process:.3f} s; card: "
        f"{harness.power_limit()}")
    # The readings come from the process's first profiler session: a
    # later one in the same process loses records and places the trace's
    # clocks far off (PERF.md §6).
    out, trace, wall = traced(call, pool[1 % len(pool)], True)
    c = trace["causality"]
    first = {"wall_s": wall,
             "metrics": {n: f({"program": trace["program"]})
                         for n, f in METRICS.items()},
             "clock_skew_us": trace["clock_skew_us"],
             "clock": trace["clock"], "causality": c["share"],
             "causality_trips": c["trips"],
             "causality_tenths": c["tenths"],
             "busy_s": trace["busy_s"], "window_s": trace["window_s"],
             "idle_by_label": trace["idle_by_label"],
             "below_calls_s": below_calls(trace["idle_by_label"]),
             "copies_s": trace["copies_s"],
             "spans": trace["program"]["spans"],
             "counters": trace["program"]["counters"],
             "launches": trace["program"]["launches"]}
    out = trace = None
    log(f"traced: {json.dumps(first['metrics'])}; clock_skew_us "
        f"{first['clock_skew_us']!r}; causality {c['share']!r} of "
        f"{c['trips']} traced trips")
    log_idle(first["idle_by_label"])
    # Then the cost of the spans: recordings under the profiler with the
    # spans on and off in turns, and their outputs against each other.
    walls = {True: [], False: []}
    equal = True
    for k in range(args.pairs):
        rec = pool[k % len(pool)]
        got = {}
        for on in ((True, False) if k % 2 == 0 else (False, True)):
            out, _, wall = traced(call, rec, on)
            walls[on].append(wall)
            got[on] = [np.asarray(out[n]) for n in
                       ("u", "v", "noise", "iters")]
            out = None
        same = all(np.array_equal(a, b) for a, b in zip(got[True],
                                                        got[False]))
        equal = equal and same
        log(f"pair {k}: wall on {walls[True][-1]:.4f} s off "
            f"{walls[False][-1]:.4f} s; outputs bitwise equal: {same}")
    on_cost = [a / b - 1.0 for a, b in zip(walls[True], walls[False])]
    result = {"workload": args.workload, "seed": args.seed,
              "card": harness.power_limit(),
              "bitwise_equal_on_off": equal,
              "wall_on_s": walls[True], "wall_off_s": walls[False],
              "on_cost_median": statistics.median(on_cost)
              if on_cost else None,
              "traced": first}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
