"""The small-sensor and slice-level gates of ``tests/test_fast_schedule.py``
on the port, with the JAX tests' scenes, seeds and bounds (24x32 sensor,
scale 3, ``min_events`` 500, slices of 4,000 events / 0.1 s).

The tests that force ``scatter_mode="pallas"`` in the JAX package (:179,
:219, :275, :332, :361) run on the port's kernel route only, as there: on
the CPU the kernels' plain twins, the flat slice through
``models.global_flow.process_event_slice`` (the JAX package's flat
``process_slice``).  :58 and :395 run on both routes, "auto" (the kernel
route) and "xla".
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
)
from better_flow_tpu_torch.core.events import make_slice  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models.global_flow import (  # noqa: E402
    process_event_slice,
)
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    compensate_recording_scan,
)

SENSOR = SensorConfig(24, 32)
SLICE = SliceConfig(max_events=4000, span_ns=int(0.1e9), refresh_events=1500,
                    refresh_time_ns=int(0.04e9))
# The secant-slope seed of test_fast_schedule.py:201 and :243.
SEEDS = [None, torch.tensor([-2e3, -2e3, -40.0, -40.0, 0, 0, 0, 0])]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(sched, **opt):
    """test_fast_schedule.py's ``_cfg``: the schedule with the reference
    tolerances (not the fast() preset)."""
    return PipelineConfig(sensor=SENSOR, slice=SLICE,
                          optimizer=OptimizerConfig(scale=3, min_events=500,
                                                    schedule=sched, **opt))


def _scan(d, cfg):
    return compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                     device="cpu")


def _aee(out, d):
    ok = ~out["noise"]
    return float(np.median(np.hypot(out["u"][ok] - d["u"][ok],
                                    out["v"][ok] - d["v"][ok])))


def _slice():
    """The 3,000-event slice of test_fast_schedule.py:194-198."""
    d = synthetic_events(3000, duration_s=0.1, res_x=24, res_y=32,
                         n_points=60, seed=3, vx=8.0, vy=-5.0, rot=0.05,
                         div=0.02)
    return make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64),
                      capacity=3072)


def _recording(seed, **kw):
    return synthetic_events(24000, duration_s=0.4, res_x=24, res_y=32,
                            n_points=80, seed=seed, **kw)


def _same_slice_totals(rc, rm):
    assert rm.iters == rc.iters, (rm.iters, rc.iters)
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        a = float(getattr(rc.model, f))
        b = float(getattr(rm.model, f))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (f, a, b)


@pytest.mark.parametrize("route", ["auto", "xla"])
def test_fast_small_sensor_quality_bounded(route):
    """test_fast_schedule.py:58: on tiny windows the fast schedule's AEE
    within 1.2 of the reference schedule's, its iterations within 1.1."""
    d = _recording(5, vx=4.0, vy=-3.0, rot=0.5, div=0.15)
    ref = _scan(d, _cfg("reference", scatter_mode=route))
    fast = _scan(d, _cfg("fast", scatter_mode=route))
    assert _aee(fast, d) <= 1.2 * _aee(ref, d), (_aee(fast, d), _aee(ref, d))
    assert fast["iters"].sum() <= 1.1 * ref["iters"].sum()


def test_megastep_fast_matches_composed_slice():
    """test_fast_schedule.py:179: the secant schedule of the megastep's
    kernels (B1 + B2) against the composed loop's (B6, the scalar update
    between launches) on one slice, unseeded and seeded: equal iterations,
    totals within 1e-4, u within rtol 1e-3, atol 1e-2."""
    ev = _slice()
    mk = lambda mega, **kw: OptimizerConfig.fast(
        scale=3, min_events=500, scatter_mode="pallas",
        splat_time_lo=True, use_megastep=mega, **kw)
    for seed in SEEDS:
        rc = process_event_slice(ev, MotionModel.zero(), mk(False), SENSOR,
                                 seed=seed)
        rm = process_event_slice(ev, MotionModel.zero(), mk(True), SENSOR,
                                 seed=seed)
        _same_slice_totals(rc, rm)
        np.testing.assert_allclose(rm.u.numpy(), rc.u.numpy(), rtol=1e-3,
                                   atol=1e-2)


def test_predicted_exit_parity_and_effect():
    """test_fast_schedule.py:219: with ``exit_predict_cap`` 4 (a) the two
    schedule copies take equal iterations on one slice, totals within
    1e-4, and (b) over a recording the predicted exit never adds
    iterations to the plain fast exit."""
    ev = _slice()
    mk = lambda mega, **kw: OptimizerConfig.fast(
        scale=3, min_events=500, scatter_mode="pallas",
        splat_time_lo=True, use_megastep=mega, exit_predict_cap=4.0, **kw)
    for seed in SEEDS:
        rc = process_event_slice(ev, MotionModel.zero(), mk(False), SENSOR,
                                 seed=seed)
        rm = process_event_slice(ev, MotionModel.zero(), mk(True), SENSOR,
                                 seed=seed)
        _same_slice_totals(rc, rm)
    d2 = _recording(7, vx=6.0, vy=-4.0, rot=0.1, div=0.04)
    plain = _scan(d2, _cfg("fast"))
    pred = _scan(d2, _cfg("fast", exit_predict_cap=4.0))
    assert int(pred["iters"].sum()) <= int(plain["iters"].sum()), (
        int(pred["iters"].sum()), int(plain["iters"].sum()))


@pytest.mark.parametrize("sched", ["fast", "reference"])
def test_megastep_split_matches_monolithic_slice(sched):
    """test_fast_schedule.py:275: the split drive (B1 + B2), unrolled by 2
    or not, bitwise the monolithic megastep (B5), iterations included; the
    merged megastep (B12) with equal iterations, u and v within rtol 1e-5,
    atol 1e-4."""
    ev = _slice()
    mk = lambda **kw: (
        OptimizerConfig.fast(scale=3, min_events=500, scatter_mode="pallas",
                             **kw)
        if sched == "fast" else
        OptimizerConfig(scale=3, min_events=500, scatter_mode="pallas", **kw))
    run = lambda **kw: process_event_slice(ev, MotionModel.zero(), mk(**kw),
                                           SENSOR)
    mono = run(megastep_split=False)
    split = run(megastep_split=True)
    merged = run(megastep_merged=True)
    unrolled = run(megastep_split=True, megastep_unroll=2)
    assert unrolled.iters == mono.iters
    np.testing.assert_array_equal(unrolled.u.numpy(), split.u.numpy())
    assert split.iters == mono.iters
    np.testing.assert_array_equal(split.u.numpy(), mono.u.numpy())
    np.testing.assert_array_equal(split.v.numpy(), mono.v.numpy())
    assert merged.iters == mono.iters
    np.testing.assert_allclose(merged.u.numpy(), mono.u.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(merged.v.numpy(), mono.v.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_megastep_fast_matches_composed_recording():
    """test_fast_schedule.py:332: over a recording the megastep's and the
    composed loop's schedule copies flag the same noise, their iteration
    totals within 0.75-1.33 of each other and the megastep's AEE within
    1.05 of the composed loop's."""
    d = _recording(7, vx=6.0, vy=-4.0, rot=0.1, div=0.04)
    mk = lambda mega: _cfg("fast", scatter_mode="pallas", splat_time_lo=True,
                           use_megastep=mega, dx_tol=1e-4, dy_tol=1e-4,
                           rot_tol=1e-3, div_tol=1.0, exit_grad_factor=1.0)
    comp = _scan(d, mk(False))
    mega = _scan(d, mk(True))
    np.testing.assert_array_equal(mega["noise"], comp["noise"])
    it_m, it_c = int(mega["iters"].sum()), int(comp["iters"].sum())
    assert 0.75 * it_c <= it_m <= 1.33 * it_c, (it_m, it_c)
    assert _aee(mega, d) <= 1.05 * _aee(comp, d), (_aee(mega, d),
                                                   _aee(comp, d))


def test_fast_2row_splat_quality_pallas():
    """test_fast_schedule.py:361: the bf16 time weight
    (``splat_time_lo=False``) against the hi + lo pair: median |du|, |dv|
    below 5% of the speed, AEE within 1.05, iterations within 1.2."""
    d = _recording(9, vx=20.0, vy=-15.0, rot=0.1, div=0.04)
    mk = lambda lo: _cfg("fast", scatter_mode="pallas", splat_time_lo=lo)
    hi_lo = _scan(d, mk(True))
    two = _scan(d, mk(False))
    ok = ~(hi_lo["noise"] | two["noise"])
    speed = float(np.hypot(hi_lo["u"][ok], hi_lo["v"][ok]).mean())
    assert np.median(np.abs(two["u"][ok] - hi_lo["u"][ok])) < 0.05 * speed
    assert np.median(np.abs(two["v"][ok] - hi_lo["v"][ok])) < 0.05 * speed
    assert _aee(two, d) <= 1.05 * _aee(hi_lo, d), (_aee(two, d),
                                                   _aee(hi_lo, d))
    assert two["iters"].sum() <= 1.2 * hi_lo["iters"].sum()


@pytest.mark.parametrize("route", ["auto", "xla"])
def test_fast_degenerate_and_gates_identical(route):
    """test_fast_schedule.py:395: one pixel's events flag the same noise,
    all of it, under both schedules."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.integers(0, int(3e8), 5000)).astype(np.int64)
    x = np.full(5000, 3.0)
    y = np.full(5000, 4.0)
    cfg = lambda sched: _cfg(sched, scatter_mode=route)
    ref = compensate_recording_scan(x, y, t, cfg("reference"), device="cpu")
    fast = compensate_recording_scan(x, y, t, cfg("fast"), device="cpu")
    np.testing.assert_array_equal(ref["noise"], fast["noise"])
    assert fast["noise"].all()
