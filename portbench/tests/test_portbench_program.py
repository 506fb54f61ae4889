"""The program's spans in the traced span's reduction
(``portbench.program_trace``), on made-up timings: idle gaps labelled by
the innermost span of the program's main thread (and the worker's, where
the main thread waits on it), the reduction without them as
``portbench.tracing`` gives it, a sweep that stays fast at the size of a
traced recording, and the readings of ``layer["program"]``; on the card,
the program's spans and the device trace on one clock."""

import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench import tracing
from portbench.program_trace import METRICS, innermost, reduce


def _span(name, t0, t1, thread="main"):
    return SimpleNamespace(name=name, t0=t0, t1=t1, thread=thread)


OPS = [(1.0, 1.5, "k1"), (1.25, 2.0, "k2"), (3.0, 3.5, "k1"),
       (4.5, 6.0, "copy")]
HARNESS = [("cold path", 0.0, 5.0)]
PROGRAM = [
    _span("cold", 0.1, 4.9),
    _span("cold.plan", 0.1, 0.3),
    _span("cold.wait_stage", 0.3, 0.95),
    _span("cold.run", 0.95, 3.9),
    _span("slice", 1.0, 2.5),
    _span("drive.launch", 1.0, 1.2),
    _span("drive.read", 1.2, 2.1),
    _span("slice", 2.5, 3.9),
    _span("drive.launch", 2.5, 2.6),
    _span("drive.read", 2.6, 3.6),
    _span("cold.wait_fetch", 3.9, 4.9),
    _span("stage", 0.2, 1.5, "bf-stage"),
    _span("stage.sort", 0.25, 0.9, "bf-stage"),
    _span("fetch", 3.95, 4.8, "bf-stage"),
    _span("fetch.wait", 3.95, 4.7, "bf-stage"),
]


def _idle(t):
    return {k: v for k, v in t["idle_gaps"] if k.startswith("all idle")}


def test_gaps_take_the_innermost_program_span():
    t = reduce(OPS, HARNESS, 0.0, 5.0, program=PROGRAM)
    idle = _idle(t)
    # gaps: [0, 1] mid 0.5, [2, 3] mid 2.5, [3.5, 4.5] mid 4.0
    assert idle["all idle in cold.wait_stage > stage.sort"] == \
        pytest.approx(1.0)
    assert idle["all idle in drive.launch"] == pytest.approx(1.0)
    assert idle["all idle in cold.wait_fetch > fetch.wait"] == \
        pytest.approx(1.0)
    assert t["busy_s"] == pytest.approx(2.0)


def test_gaps_outside_the_program_keep_the_harness_label():
    t = reduce(OPS, HARNESS, 0.0, 5.0, program=[_span("cold", 2.2, 2.8)])
    idle = _idle(t)
    assert idle["all idle in cold"] == pytest.approx(1.0)
    assert idle["all idle in cold path"] == pytest.approx(2.0)


def test_a_wait_with_an_idle_worker_is_the_wait():
    t = reduce(OPS, HARNESS, 0.0, 5.0,
               program=[_span("cold.wait_fetch", 3.4, 4.6)])
    assert _idle(t)["all idle in cold.wait_fetch"] == pytest.approx(1.0)


@pytest.mark.parametrize("program", [None, []])
def test_without_program_spans_the_reduction_is_unchanged(program):
    spans = [("slice loop", 0.0, 3.2), ("fetch", 3.2, 5.0),
             ("feed", 0.9, 1.1)]
    t = reduce(OPS, spans, 0.0, 5.0, program=program)
    assert t == tracing.reduce(OPS, spans, 0.0, 5.0)
    assert list(t) == ["busy_s", "window_s", "device_s", "n_ops",
                       "device_ops", "idle_gaps"]
    assert dict(t["idle_gaps"][:2]) == {
        "all idle in slice loop": pytest.approx(2.0),
        "all idle in fetch": pytest.approx(1.0)}


def test_innermost_nested_touching_and_outside():
    spans = [(0.0, 10.0, "a"), (1.0, 2.0, "b"), (2.0, 3.0, "c"),
             (2.2, 2.4, "d"), (12.0, 13.0, "e")]
    pts = [0.5, 1.5, 2.3, 2.7, 5.0, 11.0, 12.5, 14.0]
    assert innermost(spans, pts) == ["a", "b", "d", "c", "a", None, "e",
                                     None]


def test_the_sweep_labels_a_traced_recording_in_seconds():
    """50,000 spans (slices holding a launch and a read each) against
    50,000 gaps."""
    program, ops = [], []
    for k in range(50_000 // 3):
        t = 10.0 * k
        program += [_span("slice", t, t + 9.0),
                    _span("drive.launch", t + 1.0, t + 2.0),
                    _span("drive.read", t + 2.0, t + 8.0)]
        ops += [(t + 0.5, t + 1.5, "b1"), (t + 3.0, t + 4.0, "b2"),
                (t + 9.5, t + 9.6, "b4")]
    a = time.perf_counter()
    t = reduce(ops, [("cold path", 0.0, 10.0 * len(ops))], 0.0,
               10.0 * len(ops) / 3, program=program)
    assert time.perf_counter() - a < 5.0
    # a slice's gaps: B1 to B2 (1.5) and B2 to B4 (5.5) inside its read
    assert _idle(t)["all idle in drive.read"] == \
        pytest.approx(len(ops) / 3 * 7.0)


def test_program_readers():
    layer = {"program": {
        "spans": {"drive.launch": {"n": 400, "total_s": 0.004,
                                   "self_s": 0.004},
                  "drive.read": {"n": 400, "total_s": 0.012,
                                 "self_s": 0.012},
                  "slice": {"n": 100, "total_s": 0.03, "self_s": 0.01},
                  "cold": {"n": 1, "total_s": 2.0, "self_s": 0.1},
                  "cold.wait_stage": {"n": 4, "total_s": 0.5,
                                      "self_s": 0.5}},
        "counters": {"iters": 400},
        "launches": {"warp_images_st": 400, "megastep_finish": 400,
                     "warp_uv": 100, "act_rows": 1},
        "torch_ops_in_slices": 2500}}
    read = lambda n: METRICS[n](layer)
    assert read("trip_launch_us.offline") == pytest.approx(10.0)
    assert read("trip_read_wait_us.offline") == pytest.approx(30.0)
    assert read("slice_host_us.offline") == pytest.approx(100.0)
    assert read("cold_stage_wait_share.offline") == pytest.approx(25.0)
    assert read("torch_ops_per_slice.offline") == pytest.approx(25.0)
    assert read("launches_per_iter.offline") == pytest.approx(901 / 400)


@pytest.mark.parametrize("name", [
    "trip_launch_us.offline", "trip_read_wait_us.offline",
    "slice_host_us.offline", "cold_stage_wait_share.offline",
    "torch_ops_per_slice.offline", "launches_per_iter.offline"])
def test_program_readers_without_program_spans(name):
    """A program without spans of its own: the readers give nothing."""
    assert METRICS[name]({"offline": {}, "trace": {}}) is None
    assert METRICS[name]({"program": {"spans": {}, "counters": {},
                                      "launches": {}}}) is None


class _Event:
    """A profiler event as ``Tracer.stop`` reads one."""

    def __init__(self, name, start_ns, end_ns, cuda=False, corr=0,
                 thread=1):
        from torch.autograd import DeviceType

        self._v = (name, start_ns, end_ns, corr, thread,
                   DeviceType.CUDA if cuda else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def device_type(self):
        return self._v[5]


def test_causality_and_operators_in_slices():
    """Two trips: the first's B2 ends before its read returns, the
    second's after (a clock that disagrees); host operators counted at
    the top level of the main thread inside slices only."""
    from portbench.program_trace import causality, ops_in_slices

    us = 1000
    program = [_span("slice", 0.0, 400e-6),
               _span("drive.launch", 0.0, 100e-6),
               _span("drive.read", 100e-6, 150e-6),
               _span("drive.launch", 150e-6, 250e-6),
               _span("drive.read", 250e-6, 300e-6)]
    host = [_Event("cudaLaunchKernel", 90 * us, 95 * us, corr=7),
            _Event("cudaLaunchKernel", 245 * us, 249 * us, corr=8),
            _Event("aten::mul", 10 * us, 20 * us),
            _Event("aten::copy_", 12 * us, 18 * us),     # inside mul
            _Event("aten::cat", 30 * us, 40 * us, thread=2),
            _Event("aten::add", 500 * us, 510 * us)]     # after the slice
    dev = [_Event("iteration_kernel(float*)", 96 * us, 140 * us,
                  cuda=True, corr=7),
           _Event("iteration_kernel(float*)", 250 * us, 320 * us,
                  cuda=True, corr=8)]
    to_host = lambda ns: ns * 1e-9
    c = causality(host + dev, dev, to_host, to_host, program)
    assert c["trips"] == 2 and c["share"] == 0.5
    assert ops_in_slices(host, to_host, 1, program) == 1


def test_clock_offset_is_the_middle_of_the_brackets():
    """Records 5 s behind the host clock, each inside host readings that
    lag or lead it by a varying amount: the bounds close in on 5."""
    from portbench.program_trace import clock_offset

    records = [(1.0, 1.001), (2.0, 2.0005), (3.0, 3.002)]
    readings = [(5.99990, 6.00120), (6.99998, 7.00060), (7.99995, 8.00201)]
    offset, width = clock_offset(readings, records)
    assert offset == pytest.approx(5.0, abs=2e-5)
    # bounds: lo = max(a - s) = 4.99998, hi = min(b - e) = 5.00001
    assert offset == pytest.approx(4.999995)
    assert width == pytest.approx(3e-5)


def test_gaps_as_the_harness_finds_them():
    """The idle gaps the program's labels go to are those of
    ``tracing.reduce``: their sum is its window less its busy time."""
    from portbench.program_trace import idle_gaps

    gaps = idle_gaps(OPS, 0.0, 5.0)
    assert gaps == [(0.0, 1.0), (2.0, 3.0), (3.5, 4.5)]
    t = tracing.reduce(OPS, HARNESS, 0.0, 5.0)
    assert sum(b - a for a, b in gaps) == \
        pytest.approx(t["window_s"] - t["busy_s"])


def test_idle_below_the_calls():
    from portbench.program_trace import below_calls

    assert below_calls({"cold": 1.0, "scan": 2.0, "slice": 0.5,
                        "cold.wait_stage > stage.sort": 0.25,
                        "cold path": 4.0}) == pytest.approx(0.75)


@pytest.mark.cuda
def test_program_spans_share_the_trace_clock(tmp_path):
    """A traced recording of the first offline cell with the program's
    spans on, then a pair with them on and off: the pair's outputs are
    bitwise equal, every reading is a number, and the program's spans and
    the device trace keep one clock (at least 99% of the traced trips' B2
    kernels end before their blocking read returns)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w["name"] for w in bench["workloads"]
                if w["config"].startswith("davis240-offline"))
    out = subprocess.run(
        [sys.executable, "portbench/program_trace.py", "--workload", cell,
         "--seed", "2718281828", "--pairs", "1"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bitwise_equal_on_off"]
    r = res["traced"]
    assert all(v is not None for v in r["metrics"].values()), r["metrics"]
    assert r["causality"] >= 0.99, \
        re.findall(r"clock_skew_us.*", out.stderr)
