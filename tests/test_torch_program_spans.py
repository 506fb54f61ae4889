"""The program's own spans (``profiling.program_spans``) on the CPU: the
cold path, the scan and the XLA branch give bitwise the same outputs with
spans recorded and without; the spans nest, count what the program counts
(slices, the drives' blocking reads and trips) and their self times add
up; off, the drive reads no clock; ``device_trace`` writes them into its
trace.  Imports no JAX."""

import json
import os
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch import profiling  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import small_cfg  # noqa: E402

KEYS = ("u", "v", "noise", "iters")
COLD_MAIN = {"cold", "cold.plan", "stage.plan", "stage.coords",
             "cold.wait_stage", "cold.run", "cold.accumulate",
             "cold.wait_fetch", "loop.rows", "slice", "drive.launch",
             "drive.read"}
COLD_WORKER = {"stage", "stage.sort", "stage.upload", "stage.device_wait",
               "fetch", "fetch.wait", "fetch.decode"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rec_stream():
    return synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32,
                            vx=20.0, vy=-14.0, seed=2)


CALLS = {
    "cold": lambda d, cfg: tscan.compensate_recording_cold(
        d["x"], d["y"], d["t_ns"], cfg, n_batch=2, device="cpu"),
    "scan": lambda d, cfg: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device="cpu"),
    "xla": lambda d, cfg: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device="cpu"),
}
MODES = {"cold": "pallas", "scan": "pallas", "xla": "xla"}


@pytest.fixture(scope="module")
def runs(rec_stream):
    """Each call off, then on (with its recorder), then off again with the
    recorder closed."""
    out = {}
    for name, call in CALLS.items():
        cfg = small_cfg(scatter_mode=MODES[name])
        off = call(rec_stream, cfg)
        with profiling.program_spans() as rec:
            on = call(rec_stream, cfg)
        n_kept = len(rec.records)
        again = call(rec_stream, cfg)
        out[name] = (off, on, rec, n_kept, again)
    return out


@pytest.mark.parametrize("name", list(CALLS))
def test_outputs_are_bitwise_with_and_without_spans(runs, name):
    off, on, _rec, _n, again = runs[name]
    for k in KEYS:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
        np.testing.assert_array_equal(again[k], off[k], err_msg=k)
    assert on["stats"]["host_syncs"] == off["stats"]["host_syncs"]


@pytest.mark.parametrize("name", list(CALLS))
def test_off_records_nothing(runs, name):
    _off, _on, rec, n_kept, _again = runs[name]
    assert profiling.RECORDER is None
    assert n_kept > 0 and len(rec.records) == n_kept


@pytest.mark.parametrize("name", list(CALLS))
def test_reads_slices_and_trips_are_counted(runs, name):
    _off, on, rec, _n, _again = runs[name]
    counts = rec.counts
    assert counts["slice"] == on["stats"]["n_slices"]
    assert counts["drive.read"] == on["stats"]["host_syncs"]
    assert rec.counters["iters"] == int(np.sum(on["iters"]))
    if name != "xla":
        # megastep_unroll 1: a trip is one iteration, and every trip reads.
        assert counts["drive.launch"] == int(np.sum(on["iters"]))


@pytest.mark.parametrize("name", list(CALLS))
def test_children_lie_inside_their_parents(runs, name):
    _off, _on, rec, _n, _again = runs[name]
    by_id = {s.id: s for s in rec.records}
    assert len(by_id) == len(rec.records)
    tops = [s for s in rec.records if s.parent is None]
    assert len(tops) == 1
    for s in rec.records:
        assert s.t0 <= s.t1
        assert s.call == tops[0].id
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread:
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)


@pytest.mark.parametrize("name", list(CALLS))
def test_self_times_add_up(runs, name):
    _off, _on, rec, _n, _again = runs[name]
    own = rec.self_times()
    children = {}
    by_id = {s.id: s for s in rec.records}
    for s in rec.records:
        p = by_id.get(s.parent)
        if p is not None and p.thread == s.thread:
            children[p.id] = children.get(p.id, 0.0) + s.t1 - s.t0
    for s in rec.records:
        assert own[s.id] >= -1e-9
        assert s.t1 - s.t0 == pytest.approx(
            own[s.id] + children.get(s.id, 0.0), abs=1e-9)
    summ = rec.summary()["spans"]
    assert summ["slice"]["self_s"] <= summ["slice"]["total_s"]


def test_the_cold_path_names_its_threads_and_hand_offs(runs):
    _off, on, rec, _n, _again = runs["cold"]
    by_id = {s.id: s for s in rec.records}
    main = {s.name for s in rec.records if s.thread == "main"}
    worker = {s.name for s in rec.records if s.thread == profiling.WORKER}
    assert main == COLD_MAIN
    assert worker == COLD_WORKER
    for s in rec.records:
        if s.name == "stage":
            assert by_id[s.parent].name == "cold"
        if s.name == "fetch":
            assert by_id[s.parent].name == "cold.accumulate"
    counts = rec.counts
    assert counts["cold.run"] == counts["stage"] == counts["fetch"] == 2
    assert counts["cold.wait_stage"] == 2
    # The phases of stats["batches"] are the spans' durations.
    stage = sorted(s.t1 - s.t0 for s in rec.records if s.name == "stage")
    assert stage == pytest.approx(sorted(
        b["stage_s"] for b in on["stats"]["batches"]))
    run = sorted(s.t1 - s.t0 for s in rec.records if s.name == "cold.run")
    assert run == pytest.approx(sorted(
        b["run_s"] for b in on["stats"]["batches"]))
    cold = [s for s in rec.records if s.name == "cold"][0]
    assert cold.t1 - cold.t0 == pytest.approx(on["stats"]["total_s"])
    assert rec.launches == {cold.call: on["stats"]["launches"]}


def test_the_scan_names_its_phases(runs):
    _off, _on, rec, _n, _again = runs["scan"]
    assert {s.name for s in rec.records} >= {
        "scan", "scan.route", "stage", "stage.plan", "stage.sort",
        "stage.upload", "stage.device_wait", "scan.run", "scan.accumulate",
        "scan.fetch", "loop.rows", "slice", "drive.launch", "drive.read"}
    assert {s.thread for s in rec.records} == {"main"}


def test_staging_spans_are_the_plan_breakdown(rec_stream):
    cfg = small_cfg(scatter_mode="pallas")
    with profiling.program_spans() as rec:
        prep = tscan.prepare_recording(rec_stream["x"], rec_stream["y"],
                                       rec_stream["t_ns"], cfg,
                                       device="cpu")
    names = {"plan": "stage.plan", "coords_u16": "stage.coords",
             "native_sort": "stage.sort", "numpy_staging": "stage.sort",
             "device_put": "stage.upload", "device_wait": "stage.device_wait"}
    totals = rec.totals
    for phase, secs in prep["plan_breakdown"].items():
        assert totals[names[phase]] == pytest.approx(secs, abs=6e-4)


def test_the_drive_reads_no_clock_when_off(monkeypatch, rec_stream):
    """Off, a drive's trip costs no clock read: the drives' clock is
    replaced by one that fails."""
    class NoClock:
        @staticmethod
        def perf_counter():
            raise AssertionError("read the clock with the spans off")

    cfg = small_cfg(scatter_mode="pallas")
    d = rec_stream
    want = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                           device="cpu")
    monkeypatch.setattr(tgf, "time", NoClock)
    got = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                          device="cpu")
    np.testing.assert_array_equal(got["iters"], want["iters"])


def test_exit_reads_count_and_span_the_trips(monkeypatch):
    ticks = iter(range(100))
    monkeypatch.setattr(tgf, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    flag = torch.tensor([3.0, 1.0])
    off = tgf.ExitReads()
    assert off(flag) == [3.0, 1.0] and off.n == 1
    with profiling.program_spans() as rec:
        reads = tgf.ExitReads()                 # t = 0
        assert reads(flag) == [3.0, 1.0]        # read 1 to 2
        assert reads(flag[1]) == 1.0            # read 3 to 4
    assert reads.n == 2
    got = [(s.name, s.t0, s.t1) for s in rec.records]
    assert got == [("drive.launch", 0.0, 1.0), ("drive.read", 1.0, 2.0),
                   ("drive.launch", 2.0, 3.0), ("drive.read", 3.0, 4.0)]


def test_spans_nest_hand_off_and_heal():
    rec = profiling.Spans()
    with rec("call"):
        outer = rec.context()
        ctx = []
        t = threading.Thread(target=lambda: ctx.append(
            rec.close(rec.open("work", ctx=outer))), name="bf-stage_0")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        inner = rec.open("inner")
        rec.open("left open")               # abandoned by an exception
        rec.close(inner)
        rec.add("leaf", 1.0, 2.0)
    by_name = {s.name: s for s in rec.records}
    call = by_name["call"]
    assert set(by_name) == {"call", "work", "inner", "leaf"}
    assert by_name["work"].parent == call.id
    assert by_name["work"].thread == profiling.WORKER
    assert by_name["inner"].parent == call.id
    assert by_name["leaf"].parent == call.id
    assert {s.call for s in rec.records} == {call.id}
    assert rec.context() == (None, None)
    with pytest.raises(RuntimeError):
        with profiling.program_spans():
            with profiling.program_spans():
                pass
    assert profiling.RECORDER is None


def test_device_trace_writes_the_program_spans(tmp_path, rec_stream):
    cfg = small_cfg(scatter_mode="pallas")
    d = rec_stream
    with profiling.device_trace(str(tmp_path)):
        out = tscan.compensate_recording_cold(d["x"], d["y"], d["t_ns"], cfg,
                                              n_batch=2, device="cpu")
    assert profiling.RECORDER is None
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program"]
    names = [e["name"] for e in spans]
    assert names.count("slice") == out["stats"]["n_slices"]
    assert names.count("drive.read") == out["stats"]["host_syncs"]
    anchor = [e for e in events if e.get("name") == profiling.ANCHOR][0]
    cold = [e for e in spans if e["name"] == "cold"][0]
    # The call began after the anchor and lasted its own total_s.
    assert cold["ts"] >= anchor["ts"]
    assert cold["dur"] == pytest.approx(out["stats"]["total_s"] * 1e6,
                                        rel=1e-6)
    assert {e["tid"] for e in spans} == {
        e["tid"] for e in events if e.get("ph") == "M"
        and str(e["args"].get("name", "")).startswith("program spans")}
