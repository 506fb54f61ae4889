"""The port's own copies of the JAX package's numpy-only modules
(``io/dvs_sim``, ``eval/metrics``, ``core/pixel_map``, ``profiling``)
against the originals, and the first of the fast schedule's quality gates
on the port's own pipeline: ``tests/test_dvs_sim.py``'s noisy, bursty
stream through ``compensate_recording_scan(..., device="cpu")``."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import better_flow_tpu.eval as jeval  # noqa: E402
import better_flow_tpu.profiling as jprof  # noqa: E402
import better_flow_tpu_torch.eval as teval  # noqa: E402
import better_flow_tpu_torch.profiling as tprof  # noqa: E402
from better_flow_tpu.core.pixel_map import PixelEventMap as JMap  # noqa: E402
from better_flow_tpu.eval.metrics import aee as jaee  # noqa: E402
from better_flow_tpu.io.dvs_sim import dvs_events as jdvs  # noqa: E402
from better_flow_tpu_torch.config import PipelineConfig  # noqa: E402
from better_flow_tpu_torch.core.pixel_map import PixelEventMap  # noqa: E402
from better_flow_tpu_torch.eval.metrics import aee  # noqa: E402
from better_flow_tpu_torch.io.dvs_sim import dvs_events  # noqa: E402
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    compensate_recording_scan,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dvs_events_are_the_jax_packages(seed):
    kw = dict(duration_s=0.2, vx=60, vy=-40, rot=0.1, div=0.03, seed=seed)
    want, got = jdvs(40_000, **kw), dvs_events(40_000, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_metrics_are_the_jax_packages(tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    prx, pry = rng.uniform(-2, 182, n), rng.uniform(-2, 242, n)
    u, v = rng.normal(60, 20, n), rng.normal(-40, 20, n)
    u[:50] = v[:50] = 0.0
    noise = rng.uniform(size=n) < 0.1
    gt = rng.normal(0, 50, (181, 240, 2))
    gt[rng.uniform(size=(181, 240)) < 0.2] = np.nan
    for nz in (None, noise):
        got = teval.evaluate_flow(prx, pry, u, v, gt, noise=nz)
        want = jeval.evaluate_flow(prx, pry, u, v, gt, noise=nz)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n > 1000
    gu, gv = rng.normal(60, 1, n), rng.normal(-40, 1, n)
    for m in (None, ~noise):
        assert aee(u, v, gu, gv, mask=m) == jaee(u, v, gu, gv, mask=m)
    a, b = rng.uniform(0, 255, (2, 40, 50))
    assert teval.psnr(a, b) == jeval.psnr(a, b)
    assert teval.psnr(a, a) == jeval.psnr(a, a) == float("inf")
    assert teval.psnr(a, b, peak=255.0) == jeval.psnr(a, b, peak=255.0)
    a[a < 100] = 0
    assert teval.sharpness(a) == jeval.sharpness(a) > 0
    assert teval.sharpness(np.zeros(4)) == jeval.sharpness(np.zeros(4)) == 0
    path = tmp_path / "gt.txt"
    rows = np.c_[rng.integers(1, 241, 300), rng.integers(1, 181, 300),
                 rng.normal(size=(300, 2))]
    np.savetxt(path, rows)
    np.testing.assert_array_equal(teval.read_dense_gt(path),
                                  jeval.read_dense_gt(path))


def _maps(**kw):
    return JMap(**kw), PixelEventMap(**kw)


def _same_maps(a, b):
    np.testing.assert_array_equal(a.counts(), b.counts())
    np.testing.assert_array_equal(a.time_surface(), b.time_surface())
    np.testing.assert_array_equal(a.nonempty_pixels(), b.nonempty_pixels())


def test_pixel_map_cases():
    """test_pixel_map's four cases on both maps, and a seeded stream."""
    j, m = _maps(res_x=8, res_y=8, per_px=4, span_ns=1000)
    for p in (j, m):
        p.push_batch([1, 1, 2], [1, 1, 3], [100, 200, 300])
    c = m.counts()
    assert c[1, 1] == 2 and c[2, 3] == 1 and c.sum() == 3
    _same_maps(j, m)
    j, m = _maps(res_x=4, res_y=4, per_px=3, span_ns=10 ** 9)
    for p in (j, m):
        p.push_batch([0] * 10, [0] * 10, np.arange(10))
    assert m.counts()[0, 0] == 3
    _same_maps(j, m)
    j, m = _maps(res_x=4, res_y=4, per_px=8, span_ns=100)
    for p in (j, m):
        p.push_batch([0, 0, 0], [0, 0, 0], [0, 50, 500])
    assert m.counts()[0, 0] == 1 and m.time_surface()[0, 0] == 500
    _same_maps(j, m)
    j, m = _maps(res_x=6, res_y=6, per_px=4, span_ns=10 ** 9)
    for p in (j, m):
        p.push_batch([1, 4], [2, 5], [10, 20])
    assert sorted(map(tuple, m.nonempty_pixels())) == [(1, 2), (4, 5)]
    _same_maps(j, m)
    rng = np.random.default_rng(5)
    j, m = _maps(res_x=12, res_y=16, per_px=5, span_ns=30_000)
    t = 0
    for _ in range(4):
        n = int(rng.integers(50, 400))
        t_ns = t + np.sort(rng.integers(0, 20_000, n))
        t = int(t_ns[-1])
        xs, ys = rng.integers(0, 12, n), rng.integers(0, 16, n)
        for p in (j, m):
            p.push_batch(xs, ys, t_ns)
        _same_maps(j, m)


def test_profiling_cases(tmp_path):
    """test_aux's Spans and realtime_factor cases on both modules,
    ``SliceStats`` alike, and ``device_trace`` writing a trace."""
    for mod in (jprof, tprof):
        s = mod.Spans()
        with s("projection"):
            pass
        with s("image"):
            pass
        line = s.report()
        assert "projection" in line and "image" in line
        assert s.counts == {"image": 1, "projection": 1}
        s.reset()
        assert not s.totals
        assert mod.realtime_factor(int(0.5e9), 0.25) == 2.0
        assert mod.realtime_factor(10, 0.0) == 0.0
    rows = [(1, 4, 0.01, 5000, int(0.2e9), int(0.3e9)),
            (3, 4, 0.02, 6000, int(0.1e9), int(0.3e9))]
    j, t = jprof.SliceStats(), tprof.SliceStats()
    assert t.summary() == j.summary() == {}
    for r in rows:
        j.add(*r)
        t.add(*r)
        assert t.format_last() == j.format_last()
    assert t.summary() == j.summary()
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(8).add_(1)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_pipeline_recovers_flow_through_noise():
    """``tests/test_dvs_sim.py``'s gate on the port's scan, on the CPU: the
    same noisy, bursty 120,000-event stream and the same gates."""
    d = dvs_events(120_000, duration_s=0.4, vx=60, vy=-40, rot=0.0,
                   div=0.0, seed=3)
    out = compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                    PipelineConfig(), device="cpu")
    ok = (~out["noise"]) & (~d["is_noise"])
    assert ok.sum() > 10_000
    assert abs(np.median(out["u"][ok]) - 60.0) < 9.0
    assert abs(np.median(out["v"][ok]) - (-40.0)) < 6.0
