"""The streaming path of the PyTorch port (``DVSFlow``, ``offline``, the
ring buffer, the merge, the checkpoint and the live frontend) against the
JAX package's, with ``scatter_mode="pallas"`` so that the JAX side runs its
kernels (the megastep under the reference schedule, the split pair under
``fast()``) in interpret mode.

Per-event outputs are compared in the original event order: the merged
stream (first-slice-wins, emitted slice by slice, each slice oldest to
newest) and each slice's record in the ring's order.  The tolerances are
those of the scan's tests (``torch_inputs.flow_gates``): on 24x32 windows
the two warm-start chains may drift apart mid-stream through ~1e-7
differences in the finish sums, while on the production geometry they agree
slice for slice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
)
from better_flow_tpu.core import events as jevents  # noqa: E402
from better_flow_tpu.io.event_file import write_events  # noqa: E402
from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu.runtime import accumulate as jacc  # noqa: E402
from better_flow_tpu.runtime import checkpoint as jckpt  # noqa: E402
from better_flow_tpu.runtime import dvs_flow as jdvs  # noqa: E402
from better_flow_tpu.runtime import live as jlive  # noqa: E402
from better_flow_tpu.runtime import offline as joff  # noqa: E402
from better_flow_tpu.runtime import slice_buffer as jbuf  # noqa: E402
from better_flow_tpu_torch.core import events as tevents  # noqa: E402
from better_flow_tpu_torch.core.model import FIELDS  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.runtime import accumulate as tacc  # noqa: E402
from better_flow_tpu_torch.runtime import checkpoint as tckpt  # noqa: E402
from better_flow_tpu_torch.runtime import dvs_flow as tdvs  # noqa: E402
from better_flow_tpu_torch.runtime import live as tlive  # noqa: E402
from better_flow_tpu_torch.runtime import offline as toff  # noqa: E402
from better_flow_tpu_torch.runtime import slice_buffer as tbuf  # noqa: E402
from torch_inputs import SENSOR, bench_stream, flow_gates  # noqa: E402
from torch_inputs import gate_stream  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL_SLICES = SliceConfig(max_events=4000, span_ns=int(0.1e9),
                           refresh_events=1500, refresh_time_ns=int(0.04e9))
OPTS = {
    "reference": OptimizerConfig(scale=3, min_events=500,
                                 scatter_mode="pallas"),
    "fast": OptimizerConfig.fast(scale=3, min_events=500,
                                 scatter_mode="pallas"),
}


def _small_cfg(schedule):
    return PipelineConfig(sensor=SENSOR, slice=SMALL_SLICES,
                          optimizer=OPTS[schedule])


def _prod_cfg():
    return PipelineConfig(optimizer=OptimizerConfig(scatter_mode="pallas"))


def _small_stream():
    """A 24x32 stream whose two chains do not drift apart: under the
    reference schedule 2 of 6 such streams tried drift beyond the 10%
    iteration-sum gate (seeds 2 and 3 of this scene), see PERF.md §7."""
    return synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32,
                            vx=20.0, vy=-14.0, seed=4)


def _both(d, cfg):
    rj = joff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg)
    rt = toff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu")
    return rt, rj


def _flat(r):
    """The gate view of a compensate_recording result: the merged
    per-event outputs and the per-slice iterations."""
    acc, sl = r["accumulated"], r["engine"].slices
    iters = np.array([s.iters for s in sl])
    return dict(noise=acc["noise"], u=acc["u"], v=acc["v"], iters=iters,
                ran=iters > 0)


def _same_events(rt, rj):
    """Both runs cut the same slices and merge the same events, in the
    original order."""
    at, aj = rt["accumulated"], rj["accumulated"]
    for k in ("x", "y", "timestamp"):
        np.testing.assert_array_equal(at[k], aj[k])
    assert np.all(np.diff(at["timestamp"]) >= 0)
    st, sj = rt["engine"].slices, rj["engine"].slices
    assert len(st) == len(sj)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        np.testing.assert_array_equal(a.x, b.x)


# ------------------------------------------------- whole streams vs JAX


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_small_stream_matches_jax(schedule):
    rt, rj = _both(_small_stream(), _small_cfg(schedule))
    _same_events(rt, rj)
    t, j = _flat(rt), _flat(rj)
    assert len(t["iters"]) > 10 and t["ran"].all()
    flow_gates(t, j)
    for a, b in zip(rt["engine"].slices, rj["engine"].slices):
        np.testing.assert_array_equal(a.noise, b.noise)
    st = rt["stats"]
    assert set(st) == set(rj["stats"])
    assert st["n_slices"] == len(t["iters"])
    assert st["mean_iters"] == pytest.approx(t["iters"].mean())


def test_production_stream_matches_jax():
    """The reference schedule on the production geometry (180x240, scale
    3, 50k/0.2 s slices, a retrigger every 20k events or 33 ms): every
    slice's iteration count equal."""
    rt, rj = _both(bench_stream(60_000), _prod_cfg())
    _same_events(rt, rj)
    t, j = _flat(rt), _flat(rj)
    assert len(t["iters"]) >= 3 and t["ran"].all()
    np.testing.assert_array_equal(t["iters"], j["iters"])
    flow_gates(t, j)


def test_gate_firing_stream_matches_jax():
    """The window gate fires on the one-pixel phase: the ring's noise flags
    are set at dispatch, the same events are noise in both packages, and
    they stay noise in the later slices that hold them."""
    rt, rj = _both(gate_stream(), _small_cfg("fast"))
    _same_events(rt, rj)
    t, j = _flat(rt), _flat(rj)
    assert t["noise"].any() and not t["noise"].all()
    assert t["ran"].any() and not t["ran"].all()
    flow_gates(t, j)
    for a, b in zip(rt["engine"].slices, rj["engine"].slices):
        np.testing.assert_array_equal(a.noise, b.noise)


@pytest.mark.parametrize("depth,compact", [(2, False), (0, True), (2, True)])
def test_pipelined_and_compact_fetch_bit_identical(depth, compact):
    """Depth 2 gives depth 0's outputs bit for bit; the compact fetch gives
    them rounded to f16 (u, v, pr) bit for bit, with the same noise and
    iterations."""
    cfg = _small_cfg("fast").replace(accumulate=True)
    d = synthetic_events(12000, duration_s=0.3, res_x=24, res_y=32,
                         n_points=80, seed=5, vx=4.0, vy=-3.0, rot=0.5,
                         div=0.15)

    def run(depth, compact):
        flow = tdvs.DVSFlow(cfg, pipeline_depth=depth, compact_fetch=compact,
                            device="cpu")
        fired = flow.add_events(d["x"], d["y"], d["t_ns"])
        assert len(flow._pending) == min(depth, fired)
        flow.recompute()
        flow.flush()
        return flow.slices

    sync, other = run(0, False), run(depth, compact)
    assert len(sync) == len(other) > 5
    q = (lambda a: a.astype(np.float16).astype(np.float32)) if compact \
        else (lambda a: a)
    for a, b in zip(sync, other):
        for k in ("u", "v", "pr_x", "pr_y"):
            np.testing.assert_array_equal(q(getattr(a, k)), getattr(b, k))
        np.testing.assert_array_equal(a.noise, b.noise)
        assert a.iters == b.iters


# ------------------------------------------------------ numpy parts


def test_ring_buffer_matches_jax():
    rng = np.random.default_rng(4)
    a, b = jbuf.EventRingBuffer(500, 10**6), tbuf.EventRingBuffer(500, 10**6)
    t = 0
    for step in range(40):
        n = int(rng.integers(1, 300))
        ts = t + np.sort(rng.integers(0, 60_000, n))
        t = int(ts[-1])
        x = rng.integers(0, 24, n).astype(np.float32)
        y = rng.integers(0, 32, n).astype(np.float32)
        for buf in (a, b):
            if step % 3 == 0:
                for i in range(n):
                    buf.push(x[i], y[i], ts[i])
            else:
                buf.push_batch(x, y, ts)
        sa, sb = a.snapshot(), b.snapshot()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        mark = sa["index"][rng.uniform(size=len(sa["index"])) < 0.2]
        a.writeback(mark, noise=True)
        b.writeback(mark, noise=True)
        assert len(a) == len(b) and a.oldest_timestamp() == \
            b.oldest_timestamp() and a.newest_timestamp() == \
            b.newest_timestamp()
    np.testing.assert_array_equal(a.noise, b.noise)


def test_merge_slices_matches_jax():
    rng = np.random.default_rng(6)

    class S:
        pass

    slices, t0 = [], 0
    for s in range(8):
        n = int(rng.integers(50, 400))
        sl = S()
        sl.x = rng.integers(0, 6, n).astype(np.float32)
        sl.y = rng.integers(0, 6, n).astype(np.float32)
        sl.timestamp = t0 + np.sort(rng.integers(0, 300_000, n))
        if s:   # overlap: repeat part of the previous slice
            k = int(rng.integers(0, len(slices[-1].x)))
            for f in ("x", "y", "timestamp"):
                setattr(sl, f, np.concatenate([getattr(slices[-1], f)[k:],
                                               getattr(sl, f)]))
        n = len(sl.x)
        sl.u = rng.normal(size=n).astype(np.float32)
        sl.v = rng.normal(size=n).astype(np.float32)
        sl.noise = rng.uniform(size=n) < 0.1
        t0 = int(sl.timestamp[-1]) - 50_000
        slices.append(sl)
    want, got = jacc.merge_slices(slices), tacc.merge_slices(slices)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["x"]) < sum(len(s.x) for s in slices)
    assert tacc.merge_slices([])["x"].shape == (0,)


def test_event_slice_and_chunk_layouts_match_jax():
    rng = np.random.default_rng(7)
    n, cap = 3000, 5000
    x, y = rng.integers(0, 24, (2, n)).astype(np.float32)
    t = rng.uniform(0, 1e8, n).astype(np.float32)
    noise = rng.uniform(size=n) < 0.2
    ej = jevents.make_slice(x, y, t, capacity=cap, noise=noise)
    et = tevents.make_slice(x, y, t, capacity=cap, noise=noise)
    for f in ej._fields:
        np.testing.assert_array_equal(getattr(et, f).numpy(),
                                      np.asarray(getattr(ej, f)))
    np.testing.assert_array_equal(et.active.numpy(), np.asarray(ej.active))
    assert et.capacity == ej.capacity == cap
    np.testing.assert_array_equal(
        layout.prepare_chunk_layouts(et.x, et.y, et.t).numpy(),
        np.asarray(jfm.prepare_chunk_layouts(ej.x, ej.y, ej.t)))
    np.testing.assert_array_equal(layout.pack_act(et.active).numpy(),
                                  np.asarray(jfm.pack_act(ej.active)))
    with pytest.raises(ValueError, match="exceed"):
        tevents.make_slice(x, y, t, capacity=10)


def test_f64_totals_raises():
    """f64 totals with the ``fast`` schedule raise at construction, naming
    the JAX package's defect; under the reference schedule the engine
    builds with an f64 carry (test_torch_composed.py runs it)."""
    cfg = _small_cfg("fast").replace(f64_totals=True)
    for make in (lambda: tdvs.DVSFlow(cfg, device="cpu"),
                 lambda: toff.compensate_recording(
                     np.zeros(10), np.zeros(10), np.arange(10), cfg,
                     device="cpu")):
        with pytest.raises(NotImplementedError, match="fast.*TypeError"):
            make()
    flow = tdvs.DVSFlow(_small_cfg("reference").replace(f64_totals=True),
                        device="cpu")
    assert flow.last_model.total_rot.dtype == torch.float64


# --------------------------------------------------------- checkpoint


def _feed(engine, d, a, b):
    engine.add_events(d["x"][a:b], d["y"][a:b], d["t_ns"][a:b])


def _finish(engine):
    if len(engine.buffer):
        engine.recompute()
    engine.flush()
    return engine


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A stream checkpointed by the JAX package (version 2, no seed)
    resumes in the port and continues as the JAX package continues it."""
    cfg = _prod_cfg().replace(accumulate=True)
    d, cut = bench_stream(60_000), 41_000
    ej = jdvs.DVSFlow(cfg)
    _feed(ej, d, 0, cut)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, ej)
    assert "last_seed" not in np.load(path).files

    rj = jckpt.load_checkpoint(path, jdvs.DVSFlow(cfg))
    rt = tckpt.load_checkpoint(path, tdvs.DVSFlow(cfg, device="cpu"))
    for f in FIELDS:
        assert float(getattr(rt.last_model, f)) == \
            float(getattr(ej.last_model, f)), f
    assert not rt.last_seed.any()
    assert len(rt.slices) == len(ej.slices) >= 1
    for e in (rj, rt):
        _feed(e, d, cut, len(d["x"]))
        _finish(e)
    t, j = (_flat(dict(accumulated=e.get_accumulated(), engine=e))
            for e in (rt, rj))
    np.testing.assert_array_equal(t["iters"], j["iters"])
    flow_gates(t, j)


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = _prod_cfg().replace(accumulate=True)
    d, cut = bench_stream(60_000), 41_000
    et = tdvs.DVSFlow(cfg, device="cpu")
    _feed(et, d, 0, cut)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, et)
    ej = jckpt.load_checkpoint(path, jdvs.DVSFlow(cfg))
    for f in FIELDS:
        assert float(getattr(ej.last_model, f)) == \
            float(getattr(et.last_model, f)), f
    for k in ("event_diff", "time_diff", "last_slice_time",
              "current_slice_time"):
        assert getattr(ej, k) == getattr(et, k)
    st, sj = et.buffer.snapshot(), ej.buffer.snapshot()
    for k in ("x", "y", "timestamp", "noise"):
        np.testing.assert_array_equal(st[k], sj[k])
    assert [r.iters for r in ej.slices] == [r.iters for r in et.slices]
    _feed(ej, d, cut, len(d["x"]))
    assert len(_finish(ej).slices) > len(et.slices)


def test_resumed_fast_stream_is_bitwise_uninterrupted(tmp_path):
    """Under fast() the secant seed crosses the checkpoint: a stream saved
    and resumed mid-way equals the uninterrupted one bit for bit.  Without
    the seed (the JAX package's format) it does not."""
    cfg = _small_cfg("fast").replace(accumulate=True)
    d = synthetic_events(14000, duration_s=0.35, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=8)
    cut, n = 7000, 14000
    whole = tdvs.DVSFlow(cfg, device="cpu")
    _feed(whole, d, 0, n)
    _finish(whole)

    first = tdvs.DVSFlow(cfg, device="cpu")
    _feed(first, d, 0, cut)
    assert first.last_seed[:4].any()
    path = str(tmp_path / "mid.npz")
    tckpt.save_checkpoint(path, first)
    resumed = tckpt.load_checkpoint(path, tdvs.DVSFlow(cfg, device="cpu"))
    _feed(resumed, d, cut, n)
    _finish(resumed)
    want, got = whole.get_accumulated(), resumed.get_accumulated()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert [r.iters for r in resumed.slices] == \
        [r.iters for r in whole.slices]

    seedless = tckpt.load_checkpoint(path, tdvs.DVSFlow(cfg, device="cpu"))
    seedless.last_seed = torch.zeros(8)
    _feed(seedless, d, cut, n)
    _finish(seedless)
    assert not np.array_equal(seedless.get_accumulated()["u"], want["u"])


def test_checkpoint_version_is_checked(tmp_path):
    path = str(tmp_path / "v1.npz")
    np.savez(path, version=1)
    with pytest.raises(ValueError, match="version 1"):
        tckpt.load_checkpoint(path, tdvs.DVSFlow(_small_cfg("fast"),
                                                 device="cpu"))


# ------------------------------------------------------------- live


def _live_cfg():
    """low_latency_config()'s optimizer (scale 1, at most 10 iterations)
    on the 24x32 sensor."""
    return PipelineConfig(
        sensor=SENSOR,
        slice=SliceConfig(max_events=4000, span_ns=int(0.07e9),
                          refresh_events=3000, refresh_time_ns=int(0.05e9)),
        optimizer=OptimizerConfig(scale=1, max_iter=10, min_events=500,
                                  scatter_mode="pallas"))


def _visualizer(mod, **kw):
    out = dict(clouds=[], images=[], lags=[])
    vis = mod.EventVisualizer(
        process_data=True, refresh_ns=int(0.066e9), cfg=_live_cfg(),
        on_cloud=out["clouds"].append, on_images=out["images"].append,
        on_lag=out["lags"].append, **kw)
    return vis, out


def _assert_same_refreshes(ot, oj):
    assert len(ot["clouds"]) == len(oj["clouds"]) >= 3
    assert len(ot["lags"]) == len(oj["lags"]) == len(oj["clouds"])
    for a, b in zip(ot["clouds"], oj["clouds"]):
        np.testing.assert_array_equal(a, b)
    assert len(ot["images"]) == len(oj["images"]) >= 2
    for a, b in zip(ot["images"], oj["images"]):
        assert set(a) == set(b) == {"projection", "color_flow",
                                    "unoptimized"}
        np.testing.assert_array_equal(a["unoptimized"], b["unoptimized"])
        for k in ("projection", "color_flow"):
            assert a[k].shape == b[k].shape
            differ = np.any(a[k] != b[k], axis=-1) if a[k].ndim == 3 \
                else a[k] != b[k]
            assert differ.mean() <= 0.01, (k, differ.mean())


def test_visualizer_matches_jax():
    d = synthetic_events(12000, duration_s=0.3, res_x=24, res_y=32,
                         vx=20.0, vy=-10.0, seed=1)
    runs = {}
    for mod, kw in ((jlive, {}), (tlive, {"device": "cpu"})):
        vis, out = _visualizer(mod, **kw)
        for start in range(0, len(d["x"]), 2048):
            end = start + 2048
            out.setdefault("fired", 0)
            out["fired"] += vis.add_events(d["x"][start:end],
                                           d["y"][start:end],
                                           d["t_ns"][start:end])
        runs[mod] = out
    ot, oj = runs[tlive], runs[jlive]
    assert ot["fired"] == oj["fired"]
    _assert_same_refreshes(ot, oj)
    assert ot["images"][-1]["projection"].shape == (24, 32)


def test_replay_file_matches_jax(tmp_path):
    d = synthetic_events(9000, duration_s=0.25, res_x=24, res_y=32,
                         vx=-15.0, vy=12.0, seed=11)
    path = str(tmp_path / "rec.txt")
    write_events(path, d["x"], d["y"], d["t_ns"], d["polarity"])
    runs = {}
    for mod, kw in ((jlive, {}), (tlive, {"device": "cpu"})):
        vis, out = _visualizer(mod, **kw)
        assert mod.replay_file(path, vis, chunk=1500) == len(d["x"])
        runs[mod] = out
    _assert_same_refreshes(runs[tlive], runs[jlive])


def test_lag_monitor_and_point_cloud_match_jax():
    mt, mj = tlive.LagMonitor(), jlive.LagMonitor()
    for t in (int(1e9), int(2e9), int(0.5e9)):
        mt.update(t)
        mj.update(t)
        assert mt._event0 == mj._event0
    for lag in (0.0, 0.1, 0.5):
        assert mt.format(lag) == mj.format(lag)
    n = 450_001
    x, y = np.arange(n) % 24, np.arange(n) % 32
    t = np.arange(n, dtype=np.int64) * 1000
    np.testing.assert_array_equal(tlive.point_cloud(x, y, t),
                                  jlive.point_cloud(x, y, t))
