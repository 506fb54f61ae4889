"""The window's arithmetic on made-up timings: rates over the whole window,
percentiles over every slice, the traced span's busy time, idle gaps and
their labels, the roofline's least time, and the comparison's numbers."""

import numpy as np
import pytest

from portbench import compare, roofline
from portbench.entries import live_stream, offline_recording
from portbench.tracing import reduce


def _metric(name):
    from conftest import ROOT
    from portbench import harness

    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def test_offline_totals_and_readers():
    rows = [
        {"n": 6_000_000, "wall_s": 1.0, "slices": 300, "iters": 1200,
         "slices_ran": 300, "host_syncs": 1200, "routed_cold": False},
        {"n": 6_000_000, "wall_s": 1.2, "slices": 300, "iters": 1500,
         "slices_ran": 250, "host_syncs": 1500, "routed_cold": False},
    ]
    layer = {"offline": offline_recording.layer_totals(rows)}
    read = lambda n: _metric(n).read(layer)
    assert read("iters_per_slice.offline") == pytest.approx(2700 / 550)
    assert read("host_syncs_per_slice.offline") == pytest.approx(2700 / 600)
    assert read("cold_overlap_share.offline") is None
    assert read("kernels_roofline.offline") is None


def test_cold_overlap_reader():
    rows = [{"n": 64, "wall_s": 7.0, "slices": 3, "iters": 9,
             "slices_ran": 3, "host_syncs": 9, "routed_cold": True,
             "cold_phases_s": 10.0, "cold_total_s": 7.0}]
    layer = {"offline": offline_recording.layer_totals(rows)}
    assert _metric("cold_overlap_share.offline").read(layer) == \
        pytest.approx(30.0)


def test_live_readers():
    layer = {"live": {"slices": 4, "wall_ms": [1.0, 2.0, 3.0, 6.0],
                      "iters": [11, 11, 10, 8], "host_syncs": 48,
                      "queue_wait_ms": list(np.arange(1.0, 101.0))}}
    assert _metric("slice_wall_ms.live").read(layer) == 3.0
    assert _metric("iters_per_slice.live").read(layer) == 10.0
    assert _metric("host_syncs_per_slice.live").read(layer) == 12.0
    assert _metric("queue_wait_ms_p95.live").read(layer) == \
        pytest.approx(95.05)


def test_expected_slices_counts_both_triggers():
    cfg = {"slice": {"refresh_events": 30_000, "refresh_time_ns": 50_000_000}}
    assert live_stream.expected_slices({"rate_eps": 3e6}, cfg, 10) == 1000
    assert live_stream.expected_slices({"rate_eps": 1e5}, cfg, 10) == 200


def test_trace_reduction():
    ops = [(1.0, 1.5, "k1"), (1.25, 2.0, "k2"), (3.0, 3.5, "k1"),
           (4.5, 6.0, "copy")]
    spans = [("slice loop", 0.0, 3.2), ("fetch", 3.2, 5.0),
             ("feed", 0.9, 1.1)]
    t = reduce(ops, spans, 0.0, 5.0)
    assert t["busy_s"] == pytest.approx(1.0 + 0.5 + 0.5)
    assert t["window_s"] == 5.0
    assert t["device_s"] == pytest.approx(0.5 + 0.75 + 0.5 + 0.5)
    assert t["device_ops"][0] == ["k1", pytest.approx(1.0)]
    idle = dict(t["idle_gaps"][:2])
    assert idle["all idle in slice loop"] == pytest.approx(1.0 + 1.0)
    assert idle["all idle in fetch"] == pytest.approx(1.0)
    assert len(t["idle_gaps"]) <= 10
    m = _metric("device_idle_share.offline")
    assert m.read({"trace": t}) == pytest.approx(60.0)


def test_roofline_least_time():
    # bytes bound: 50,000 events, no iterations
    t = roofline.slice_least_s(50_000, 0, 0, 3)
    assert t == pytest.approx((8 + 36) * 50_000 / roofline.HBM_BYTES_PER_S)
    # each iteration adds the larger of its bytes and operations
    t2 = roofline.slice_least_s(50_000, 100_000, 2, 3)
    it = max(32 * 50_000 / roofline.HBM_BYTES_PER_S,
             (50_000 * 56 + 100_000 * 68) / roofline.F32_OPS_PER_S)
    assert t2 - t == pytest.approx(2 * it)
    m = _metric("kernels_roofline.live")
    assert m.read({"trace": {"least_s": 1.0, "device_s": 4.0}}) == 25.0


def test_comparison_numbers():
    n = 1000
    ur = np.full(n, 60.0)
    vr = np.full(n, -40.0)
    u, v = ur.copy(), vr.copy()
    step = 0.1 * np.hypot(60.0, 40.0)   # 10% of the speed
    u[:50] += step                      # on a twentieth of the events
    noise = np.zeros(n, bool)
    nums = compare.flow_numbers(u, v, noise, ur, vr, noise.copy(),
                                [(0, 500), (500, 1000)],
                                compare.mean_speed(ur, vr),
                                [3, 4], [3, 5])
    assert nums["noise_mismatch"] == 0
    assert nums["flow_gap_p50"] == 0
    assert nums["flow_gap_p90"] == pytest.approx(0.0, abs=1e-12)
    assert nums["iters_mismatch"] == 0.5
    u[:300] += step
    nums = compare.flow_numbers(u, v, noise, ur, vr, ~noise,
                                [(0, 500), (500, 1000)],
                                compare.mean_speed(ur, vr))
    assert nums["noise_mismatch"] == n
    assert nums["slice_gap_max"] == pytest.approx(0.1, rel=1e-6)
    rows = compare.judge(nums, {"noise_mismatch": 0, "flow_gap_p90": 0.5})
    ok = {r["name"]: r["ok"] for r in rows}
    assert ok["noise_mismatch"] is False and ok["flow_gap_p90"] is True
    assert ok["slice_gap_max"] is True       # no limit: printed only
