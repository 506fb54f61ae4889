"""Closed-loop offline runs: whole recordings through one call each.

The configuration's ``entry_args.function`` names the call in
``better_flow_tpu_torch.runtime.scan_pipeline`` (``compensate_recording_
scan``): host arrays in, per-event u, v and noise in host arrays out, with
staging, the slice loop, accumulation and the fetch inside it, or the cold
path where the call routes a recording there by itself.  Set-up makes the
pool of recordings and runs one through the call.  The window runs
recordings one after another while ``seconds`` have not passed: from the
first one's start to the end of the last one that began inside it.  A
traced run then runs one more recording under the profiler.  Once the
window has closed and the peak memory is read, the plain reference
recomputes one recording of the window, drawn from the seed, from its
events, every slice of it, and the outputs are compared.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import compare, roofline, traffic
from portbench.harness import log
from portbench.reference import flow as ref
from portbench.tracing import Tracer


def _stats_row(rec, out, wall_s: float) -> dict:
    st = out["stats"]
    iters = np.asarray(out["iters"])
    row = {"n": len(rec["t_ns"]), "wall_s": wall_s,
           "slices": int(st["n_slices"]), "iters": int(iters.sum()),
           "slices_ran": int(np.count_nonzero(iters > 0)),
           "host_syncs": int(st["host_syncs"]),
           "routed_cold": bool(st.get("routed_cold", False))}
    if row["routed_cold"]:
        phases = sum(b["stage_s"] + b["run_s"] + b["fetch_s"]
                     for b in st["batches"])
        row.update(cold_phases_s=phases, cold_total_s=st["total_s"])
    return row


def layer_totals(rows) -> dict:
    """The window's sums that the per-layer readers take."""
    keys = ("n", "wall_s", "slices", "iters", "slices_ran", "host_syncs",
            "cold_phases_s", "cold_total_s")
    out = {k: sum(r.get(k, 0) for r in rows) for k in keys}
    out["routed_cold"] = any(r["routed_cold"] for r in rows)
    return out


def least_time(rec, iters, run) -> float:
    """The least time of the work one recording needed (``roofline``)."""
    st = ref.Settings.from_config(run.cell.config)
    prep = ref.prepare(rec["x"], rec["y"], rec["t_ns"], st, flush=True)
    total = 0.0
    for s in range(prep.n_slices):
        g = ref.geometry(*prep.bbox[s], st)
        a, b = prep.window(s)
        total += roofline.slice_least_s(b - a, g.w_dyn * g.h_dyn,
                                        int(iters[s]), st.scale)
    return total


def run(run) -> dict:
    import torch

    from better_flow_tpu_torch.runtime import scan_pipeline

    cfg = run.pipeline_config()
    fn = getattr(scan_pipeline, run.cell.config["entry_args"]["function"])
    dev = run.device
    call = lambda r: fn(r["x"], r["y"], r["t_ns"], cfg, device=dev)
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    pool = traffic.recordings(run.cell.mix, run.seed)
    call(pool[0])                     # every shape this cell's calls use
    sync()
    pick = int(np.random.default_rng([run.seed, 11]).integers(len(pool)))

    t_start = time.perf_counter()
    setup_s = t_start - run.t_process
    rows, kept, t_end, i = [], {}, t_start, 0
    while time.perf_counter() - t_start < run.seconds:
        rec = pool[i % len(pool)]
        a = time.perf_counter()
        out = call(rec)
        t_end = time.perf_counter()
        rows.append(_stats_row(rec, out, t_end - a))
        if i < len(pool):
            kept[i] = (out["u"], out["v"], out["noise"],
                       np.asarray(out["iters"]))
        out = None
        i += 1
    window_s = t_end - t_start
    events = sum(r["n"] for r in rows)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    layer = {"offline": layer_totals(rows)}
    trace = None
    if run.trace:
        rec = pool[i % len(pool)]
        tracer = Tracer()
        tracer.start()
        a = time.perf_counter()
        out = call(rec)
        b = time.perf_counter()
        st = out["stats"]
        if st.get("routed_cold"):
            tracer.span("cold path (staging, slice loop, fetch overlapped)",
                        a, b)
        else:
            tracer.span("staging", a, a + st["plan_s"])
            tracer.span("slice loop", a + st["plan_s"],
                        a + st["plan_s"] + st["run_s"])
            tracer.span("accumulate and fetch",
                        a + st["plan_s"] + st["run_s"], b)
        trace = tracer.stop()
        trace["least_s"] = least_time(rec, out["iters"], run)
        layer["trace"] = trace
        out = None

    # The reference, once the window has closed and the program's state is
    # freed: one recording of the window, drawn from the seed.
    if cuda:
        torch.cuda.empty_cache()
    j = pick % len(kept)
    rec = pool[j]
    u, v, noise, iters = kept[j]
    st = ref.Settings.from_config(run.cell.config)
    a = time.perf_counter()
    prep = ref.prepare(rec["x"], rec["y"], rec["t_ns"], st, flush=True)
    r = ref.compensate(prep, st, dev)
    ref_s = time.perf_counter() - a
    if len(iters) != prep.n_slices:
        checks = compare.failed("slice_count_mismatch")
    else:
        slices = compare.claimed(prep.plan.starts, prep.plan.ends)
        numbers = compare.flow_numbers(
            u, v, noise, r.u, r.v, r.noise, slices,
            compare.mean_speed(r.u, r.v), iters, r.iters)
        checks = compare.judge(numbers, run.limits)
    walls = [r["wall_s"] for r in rows]
    half = len(walls) // 2
    log(f"window {window_s:.3f} s, {len(rows)} recordings, "
        f"{events} events; a recording's wall s min {min(walls):.4f} "
        f"median {float(np.median(walls)):.4f} max {max(walls):.4f}, "
        f"first half mean {np.mean(walls[:half] or walls):.4f}, second "
        f"{np.mean(walls[half:]):.4f}; reference {ref_s:.3f} s on "
        f"recording {j} ({prep.n_slices} slices)")
    return {"attempted": len(rows), "failed": 0,
            "e2e": {"events_per_s": events / window_s, "setup_s": setup_s},
            "layer": layer, "trace": trace, "checks": checks,
            "memory_peak_bytes": peak}
