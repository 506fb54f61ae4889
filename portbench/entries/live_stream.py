"""Open-loop live runs: one event stream through ``DVSFlow``, as the live
frontend (``runtime/live.EventVisualizer``) embeds it.

The mix's stream is due on the wall clock at its own sensor times: every
``packet_s`` of sensor time the events of that packet are due, and the
feed hands the program every event that is due and not yet fed, in one
``add_events`` call, whenever the previous call has returned.  The
program's ``on_slice`` callback stamps each slice's result.  A slice's
latency runs from the due time of its triggering event to that stamp, so a
feed that falls behind adds its delay to every later slice.  Set-up warms
a first ``DVSFlow`` on a warm-up stream; the window feeds a fresh one (a
new live session) for ``seconds``; a traced run then feeds on under the
profiler.  Once the window has closed, the plain reference recomputes the
session's first slices from its start, and a sample of the window's slices
drawn from the seed, each from the model the program handed it.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import compare, roofline, traffic
from portbench.harness import log
from portbench.reference import flow as ref
from portbench.tracing import Tracer

N_START = 16        # slices compared from the session's start, as a chain
N_SAMPLED = 48      # further slices of the window, drawn from the seed
WARM_S = 0.5        # sensor seconds of the warm-up stream
TRACE_S = 1.0       # wall seconds fed under the profiler after the window


def expected_slices(mix: dict, config: dict, seconds: float) -> float:
    sl = config["slice"]
    return seconds * max(mix["rate_eps"] / sl["refresh_events"],
                         1e9 / sl["refresh_time_ns"])


class Session:
    """The feed's bookkeeping: each slice's callback stamp, its triggering
    event's sensor time, the start of the feed call that delivered it, its
    wall time and iterations, and the outputs of the slices kept for the
    comparison."""

    def __init__(self, keep):
        self.keep = keep
        self.t0 = 0.0
        self.feed_start = 0.0
        self.rows = []
        self.models = []
        self.outs = {}

    def on_slice(self, rec):
        now = time.perf_counter()
        k = len(self.rows)
        self.rows.append((now, int(rec.timestamp[-1]) if rec.n_events else 0,
                          self.feed_start, rec.wall_s, rec.iters,
                          rec.n_events))
        self.models.append(rec.model)
        if self.keep(k):
            self.outs[k] = (rec.u, rec.v, rec.noise, rec.iters)


def feed(flow, stream, session: Session, t_stop: float, packet_ns: int,
         fed_ns: int, tracer=None) -> int:
    """Feed the due packets of ``stream`` from ``fed_ns`` on, until the host
    clock passes ``t_stop``; sensor time 0 is due at ``session.t0``.
    Returns the sensor time fed up to."""
    while True:
        now = time.perf_counter()
        if now >= t_stop:
            return fed_ns
        due = int((now - session.t0) * 1e9) // packet_ns * packet_ns
        if due <= fed_ns:
            # Spin, not sleep, until the next packet is due: a sleeping
            # feed wakes late by the scheduler's whim and on a slowed core.
            wake = min(session.t0 + (fed_ns + packet_ns) * 1e-9, t_stop)
            while time.perf_counter() < wake:
                pass
            if tracer is not None:
                tracer.span("waiting for the due time", now,
                            time.perf_counter())
            continue
        x, y, t = stream.take(fed_ns, due)
        session.feed_start = time.perf_counter()
        flow.add_events(x, y, t)
        if tracer is not None:
            tracer.span("feed", session.feed_start, time.perf_counter())
        fed_ns = due


def model_numbers(m):
    """(totals (rot, div, dx, dy), compensations, cx, cy) of the program's
    motion model, as host numbers."""
    f = lambda a: float(a)
    return ([f(m.total_rot), f(m.total_div), f(m.total_dx), f(m.total_dy)],
            [f(m.comp_rot), f(m.comp_div), f(m.comp_dx), f(m.comp_dy)],
            f(m.cx), f(m.cy))


def run(run) -> dict:
    import torch

    from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow

    cfg = run.pipeline_config()
    depth = int(run.cell.config["entry_args"].get("pipeline_depth", 0))
    mix, dev = run.cell.mix, run.device
    cuda = torch.device(dev).type == "cuda"
    packet_ns = int(round(mix["packet_s"] * 1e9))
    tail = TRACE_S if run.trace else 0.0
    stream = traffic.stream(mix, run.seed, run.seconds + tail + 1.0)

    # Set-up: a first session on a warm-up stream, fed as fast as it goes.
    warm = traffic.stream(mix, run.seed, WARM_S, salt=100)
    f0 = DVSFlow(cfg, pipeline_depth=depth, device=dev)
    wn = int(WARM_S * 1e9)
    for lo in range(0, wn, packet_ns):
        f0.add_events(*warm.take(lo, lo + packet_ns))
    f0.flush()
    f0 = None
    # A traced run starts the profiler only after the window: a profiler
    # started before it slows every later launch.
    tracer = Tracer() if run.trace else None
    if cuda:
        torch.cuda.synchronize()

    exp = expected_slices(mix, run.cell.config, run.seconds)
    every = max(1, int(exp // N_SAMPLED))
    salt = int(np.random.default_rng([run.seed, 13]).integers(every))
    keep = lambda k: k < N_START or (k % every) == salt
    session = Session(keep)
    flow = DVSFlow(cfg, pipeline_depth=depth, device=dev)
    flow.on_slice = session.on_slice

    session.t0 = t0 = time.perf_counter()
    setup_s = t0 - run.t_process
    fed = feed(flow, stream, session, t0 + run.seconds, packet_ns, 0)
    n_window = len(session.rows)
    syncs_window = flow.host_syncs
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    trace = None
    if tracer is not None:
        k0 = len(session.rows)
        orig = flow.recompute

        def recompute():
            a = time.perf_counter()
            r = orig()
            tracer.span("recompute", a, time.perf_counter())
            return r

        flow.recompute = recompute
        tracer.start()
        # The stream resumes where it stopped, due from now on: the events
        # that came due while the profiler started are not dumped at once.
        now = time.perf_counter()
        session.t0 = now - fed * 1e-9
        fed = feed(flow, stream, session, now + TRACE_S, packet_ns, fed,
                   tracer)
        trace = tracer.stop()
        flow.recompute = orig
    flow.flush()

    rows = session.rows[:n_window]
    lat = np.array([(r[0] - (t0 + r[1] * 1e-9)) * 1e3 for r in rows])
    wait = np.array([(r[2] - (t0 + r[1] * 1e-9)) * 1e3 for r in rows])
    layer = {"live": {
        "slices": n_window, "wall_ms": [r[3] * 1e3 for r in rows],
        "iters": [r[4] for r in rows], "queue_wait_ms": wait.tolist(),
        "host_syncs": syncs_window}}

    # The reference: the plan of everything fed, then the compared slices.
    x, y, t = stream.events(fed)
    st = ref.Settings.from_config(run.cell.config)
    a = time.perf_counter()
    prep = ref.prepare(x, y, t, st, flush=False)
    if trace is not None:
        least = 0.0
        for k in range(k0, min(len(session.rows), prep.n_slices)):
            g = ref.geometry(*prep.bbox[k], st)
            lo, hi = prep.window(k)
            least += roofline.slice_least_s(hi - lo, g.w_dyn * g.h_dyn,
                                            session.rows[k][4], st.scale)
        trace["least_s"] = least
        layer["trace"] = trace
    checks = compare_slices(session, prep, st, dev, n_window, run.limits)
    ref_s = time.perf_counter() - a
    q = lambda a, p: float(np.percentile(a, p)) if len(a) else float("nan")
    wall = layer["live"]["wall_ms"]
    log(f"window {run.seconds:.3f} s, {n_window} slices, fed "
        f"{fed / 1e9:.3f} s of sensor time; reference {ref_s:.3f} s; "
        f"latency p50 {q(lat, 50):.3f} p95 {q(lat, 95):.3f} ms; slice wall "
        f"p50 {q(wall, 50):.3f} p95 {q(wall, 95):.3f} ms; feed lateness "
        f"p95 {q(wait, 95):.3f} ms; iterations a slice "
        f"{np.mean(layer['live']['iters']) if rows else float('nan'):.3f}")
    e2e = {"setup_s": setup_s}
    if len(lat):
        e2e.update(slice_latency_p50_ms=float(np.percentile(lat, 50)),
                   slice_latency_p95_ms=float(np.percentile(lat, 95)))
    return {"attempted": n_window, "failed": 0, "e2e": e2e, "layer": layer,
            "trace": trace, "checks": checks, "memory_peak_bytes": peak}


def compare_slices(session: Session, prep, st, dev, n_window: int,
                   lim: dict):
    """The session's first ``N_START`` slices as a chain from a zero model,
    and the kept slices of the window after them, each from the model that
    the program handed it, against the program's outputs."""
    if len(session.rows) != prep.n_slices:
        return compare.failed("slice_count_mismatch")
    ks = sorted(k for k in session.outs if k < n_window)
    u, v, nz, ur, vr, nzr, it, itr, slices = ([] for _ in range(9))
    model_gap = 0.0
    import torch

    model, seed = ref.Model.zero(dev, torch.float32), None
    pos = 0
    for k in ks:
        if k >= N_START:
            tot, comp, cx, cy = model_numbers(session.models[k - 1])
            model = ref.Model.from_numbers(tot, comp, cx, cy, dev,
                                           torch.float32)
            seed = None
        r = ref.run_one(prep, k, model, seed, st, dev)
        model, seed = r.out.model, r.out.seed
        pu, pv, pn, pit = session.outs[k]
        u.append(pu)
        v.append(pv)
        nz.append(pn)
        ur.append(r.u)
        vr.append(r.v)
        nzr.append(r.noise)
        it.append(pit)
        itr.append(r.out.iters)
        slices.append((pos, pos + len(pu)))
        pos += len(pu)
        tp = np.array(model_numbers(session.models[k])[0][2:])
        tr = r.out.model.tot.double().cpu().numpy()[2:]
        model_gap = max(model_gap, float(np.hypot(*(tp - tr))
                                         / max(np.hypot(*tr), 1e-6)))
    cat = lambda a: np.concatenate(a) if a else np.zeros(0)
    if not ks or any(len(a) != len(b) for a, b in zip(u, ur)):
        return compare.failed("slice_size_mismatch")
    U, V, N = cat(u), cat(v), cat(nz).astype(bool)
    UR, VR, NR = cat(ur), cat(vr), cat(nzr).astype(bool)
    numbers = compare.flow_numbers(U, V, N, UR, VR, NR, slices,
                                   compare.mean_speed(UR, VR), it, itr)
    numbers["model_gap_max"] = model_gap
    return compare.judge(numbers, lim)
