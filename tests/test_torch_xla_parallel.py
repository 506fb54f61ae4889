"""The XLA-composed branch (``scatter_mode`` "xla", "rep", "mxu") of the
PyTorch port under an event group and on the tiled path, against the port's
single-device XLA branch and against the JAX package.

Under a group each iteration's exact integer pre-filter pair is summed over
the shards before the image chain (``ops.time_image``'s ``comm``), so the
branch with 2 and 4 shards is BITWISE the single-device branch, on the flat
slice (``process_slice_event_parallel``), the sharded scan and the range
pipeline.  Against the JAX package, whose default program off the TPU this
branch is (one ``psum`` of f32 images under ``shard_map`` on the 8 virtual
CPU devices of ``tests/conftest.py``): iterations and noise equal, u/v
within rtol 1e-3 atol 1e-2 (the tolerance of ``test_torch_xla_branch.py``).

The tiled XLA branch (an exact integer scatter and the JAX package's
box / normalise / masked-Scharr / owned-window chain in place of B8/B9)
against the JAX package's tiled "xla" run on a 2x2 mesh: iterations and
noise equal, no event dropped, and the gate of ``tests/test_spatial.py:
350-354`` on u/v (median <= 0.001 speed, max <= 0.05 speed, speed > 20).
The branch leaves the run's image pair zero after every iteration.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from better_flow_tpu.core import events as jev  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.parallel import event_parallel as jep  # noqa: E402
from better_flow_tpu.parallel import spatial as jsp  # noqa: E402
from better_flow_tpu.parallel.mesh import (  # noqa: E402
    make_event_mesh as jax_event_mesh,
)
from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig, SensorConfig,
)
from better_flow_tpu_torch.core import events as tev  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.parallel import event_parallel as tep  # noqa: E402
from better_flow_tpu_torch.parallel import spatial as tsp  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import (  # noqa: E402
    make_event_mesh, make_tiled_mesh,
)
from better_flow_tpu_torch.parallel.multihost import (  # noqa: E402
    compensate_recording_multihost,
)
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    SENSOR, bench_stream, small_cfg, tiled_cfg, tiled_stream,
)

MODES = ("xla", "rep", "mxu")
SCHEDULES = ("reference", "fast")
HALO, ESC_CAP = 8, 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def eight():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return 8


def _opt(mode, schedule, **kw):
    if schedule == "fast":
        return OptimizerConfig.fast(scale=3, max_iter=6, min_events=100,
                                    scatter_mode=mode, **kw)
    return OptimizerConfig(scale=3, max_iter=6, min_events=100,
                           scatter_mode=mode, exit_grad_factor=0.0, **kw)


def _slices(cap=2048, seed=3, fill=0.9):
    d = synthetic_events(int(cap * fill), duration_s=0.1, res_x=24, res_y=32,
                         vx=18.0, vy=-12.0, n_points=60, seed=seed)
    x, y, t = d["x"], d["y"], d["t_ns"].astype(np.float64)
    return (jev.make_slice(x, y, t, capacity=cap),
            tev.make_slice(x, y, t, capacity=cap))


def _warm_models():
    vals = dict(total_dx=0.008, total_dy=-0.005, total_rot=4e-4,
                total_div=2e-4, cx=11.5, cy=16.0)
    mj = JaxModel.zero()._replace(**{k: np.float32(v)
                                     for k, v in vals.items()})
    mt = MotionModel.zero().replace(**{k: torch.tensor(np.float32(v))
                                       for k, v in vals.items()})
    return mj, mt


def _same_slice(r, want):
    assert (r.iters, r.ran, r.window_small) == (want.iters, want.ran,
                                                want.window_small)
    for f in ("pr_x", "pr_y", "nx", "ny", "u", "v", "noise", "seed"):
        assert torch.equal(getattr(r, f), getattr(want, f)), f
    for f in ("total_dx", "total_dy", "total_rot", "total_div", "cx", "cy"):
        assert torch.equal(getattr(r.model, f), getattr(want.model, f)), f


def _same_run(r, want):
    for k in ("u", "v", "noise", "iters", "ran"):
        np.testing.assert_array_equal(r[k], want[k], err_msg=k)
    for f in ("total_dx", "total_rot", "comp_dx", "cx"):
        assert torch.equal(getattr(r["model"], f), getattr(want["model"], f))


# ----------------------------------- bitwise the single-device XLA branch


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode", MODES)
def test_flat_slice_under_a_group_is_bitwise_one_device(mode, schedule):
    """``process_slice_event_parallel`` with 1, 2 and 4 shards against the
    single-device flat slice (``process_event_slice``), from a warm model:
    every per-event output and the model bitwise, no kernel launched."""
    _, ev = _slices()
    _, mt = _warm_models()
    opt = _opt(mode, schedule)
    tfm.reset_launches()
    want = tgf.process_event_slice(ev, mt, opt, SENSOR)
    assert want.ran and want.iters >= 2
    for n in (1, 2, 4):
        r = tep.process_slice_event_parallel(
            ev, mt, opt, SENSOR, make_event_mesh(n, device="cpu"))
        _same_slice(r, want)
    assert not any(tfm.LAUNCHES.values())
    # jit_event_parallel binds the same call.
    fn = tep.jit_event_parallel(opt, SENSOR, make_event_mesh(4, device="cpu"))
    _same_slice(fn(ev, mt), want)


def _scan_cfg(mode, schedule):
    if schedule == "fast":
        return small_cfg(scatter_mode=mode)
    return small_cfg(scatter_mode=mode, schedule="reference",
                     exit_grad_factor=0.0)


@pytest.fixture(scope="module")
def stream():
    return synthetic_events(8000, duration_s=0.2, res_x=24, res_y=32,
                            vx=20.0, vy=-14.0, seed=2)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_scan_under_a_group_is_bitwise_one_device(stream, mode,
                                                          schedule):
    """``compensate_recording_scan_sharded`` with 2 and 4 shards, staged
    for each, against the single-device XLA scan: u, v, noise, iterations,
    the gates and the model bitwise, no kernel launched."""
    d, cfg = stream, _scan_cfg(mode, schedule)
    want = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                           device="cpu")
    assert want["ran"].any() and int(want["iters"].sum()) > len(
        want["iters"])
    for n in (2, 4):
        rs = tep.compensate_recording_scan_sharded(
            d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(n, device="cpu"))
        _same_run(rs, want)
        assert rs["stats"]["n_devices"] == n
        assert rs["stats"]["launches"] == dict.fromkeys(
            rs["stats"]["launches"], 0)


@pytest.mark.parametrize("mode", MODES)
def test_multihost_ranges_run_the_xla_modes(stream, mode):
    """``compensate_recording_multihost`` in one process over two chained
    ranges of two shards: bitwise the single-device XLA scan."""
    d, cfg = stream, _scan_cfg(mode, "fast")
    want = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                           device="cpu")
    r = compensate_recording_multihost(d["x"], d["y"], d["t_ns"], cfg,
                                       ev_per_host=2, n_ranges=2,
                                       device="cpu")
    for k in ("u", "v", "noise", "iters", "ran"):
        np.testing.assert_array_equal(r[k], want[k], err_msg=k)
    assert r["stats"]["n_ranges"] == 2


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_flat_slice_under_a_group_matches_jax(eight, schedule):
    """Both packages' event-parallel slice on the XLA branch with 2 and 4
    shards, from a warm model: the gates, iterations and noise equal, the
    totals within 1e-4 relative, u/v within rtol 1e-3 atol 1e-2."""
    ev_j, ev_t = _slices(seed=5)
    mj, mt = _warm_models()
    opt = _opt("xla", schedule)
    for n in (2, 4):
        rj = jep.process_slice_event_parallel(ev_j, mj, opt, SENSOR,
                                              jax_event_mesh(n))
        rt = tep.process_slice_event_parallel(
            ev_t, mt, opt, SENSOR, make_event_mesh(n, device="cpu"))
        assert rt.ran and rt.iters >= 2
        assert rt.iters == int(rj.iters)
        assert (rt.ran, rt.window_small) == (bool(rj.ran),
                                             bool(rj.window_small))
        np.testing.assert_array_equal(rt.noise.numpy(), np.asarray(rj.noise))
        for f in ("total_dx", "total_dy", "total_rot", "total_div"):
            a, b = float(getattr(rj.model, f)), float(getattr(rt.model, f))
            assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (f, a, b)
        for f in ("u", "v"):
            np.testing.assert_allclose(getattr(rt, f).numpy(),
                                       np.asarray(getattr(rj, f)),
                                       rtol=1e-3, atol=1e-2)


def _scan_close(rt, rj):
    np.testing.assert_array_equal(rt["noise"], np.asarray(rj["noise"]))
    np.testing.assert_array_equal(rt["ran"], np.asarray(rj["ran"]))
    np.testing.assert_array_equal(rt["iters"], np.asarray(rj["iters"]))
    np.testing.assert_allclose(rt["u"], rj["u"], rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(rt["v"], rj["v"], rtol=1e-3, atol=1e-2)


def test_sharded_scan_reference_matches_jax(eight):
    """Both packages' sharded XLA scan on 4 shards of a 24x32 recording
    under the reference schedule (whose chains agree slice for slice on
    this sensor, ``test_torch_xla_branch.py``)."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = _scan_cfg("xla", "reference")
    rj = jep.compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"],
                                               cfg, jax_event_mesh(4))
    rt = tep.compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(4, device="cpu"))
    assert len(rt["iters"]) > 10 and rt["ran"].all()
    _scan_close(rt, rj)


def test_sharded_scan_fast_production_geometry_matches_jax(eight):
    """``fast(scatter_mode="xla")`` at bench.py's geometry (180x240, scale
    3, 50k/20k slices) on 2 shards in both packages (under ``fast()`` the
    24x32 chains drift apart, ROADMAP C, so the schedule is held here)."""
    d = bench_stream(60_000)
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast(scatter_mode="xla"))
    rj = jep.compensate_recording_scan_sharded(d["x"], d["y"], d["t_ns"],
                                               cfg, jax_event_mesh(2))
    rt = tep.compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(2, device="cpu"))
    assert len(rt["iters"]) == 3 and rt["ran"].all()
    _scan_close(rt, rj)


# ------------------------------------------------------- the tiled branch


def _tiled_opt(schedule, mode="xla"):
    if schedule == "fast":
        return OptimizerConfig.fast(scale=1, min_events=300,
                                    scatter_mode=mode)
    return OptimizerConfig(scale=1, max_iter=10, min_events=300,
                           scatter_mode=mode)


@pytest.fixture(scope="module")
def tiled_rec():
    return tiled_stream(jitter_px=2.5, n_points=30)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_tiled_xla_matches_jax(tiled_rec, schedule):
    """The port's tiled XLA branch on 2x2 tiles of a 96x128 recording
    against the JAX package's tiled "xla" run on a 2x2 mesh."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    d = tiled_rec
    cfg = tiled_cfg(optimizer=_tiled_opt(schedule))
    rt = tsp.compensate_recording_tiled(
        d["x"], d["y"], d["t_ns"], cfg, make_tiled_mesh((2, 2), device="cpu"),
        halo=HALO, esc_cap=ESC_CAP)
    jm = jax.make_mesh((2, 2), ("tile_x", "tile_y"),
                       devices=jax.devices()[:4])
    rj = jsp.compensate_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, jm,
                                        halo=HALO, esc_cap=ESC_CAP)
    assert rt["stats"]["escaped_dropped"] == \
        int(rj["stats"]["escaped_dropped"]) == 0
    ij = np.asarray(rj["iters"])
    assert len(ij) >= 10
    np.testing.assert_array_equal(rt["iters"], ij)
    np.testing.assert_array_equal(rt["noise"], np.asarray(rj["noise"]))
    ok = ~np.asarray(rj["noise"])
    speed = float(np.hypot(rj["u"][ok], rj["v"][ok]).mean())
    assert speed > 20.0, speed
    for k in ("u", "v"):
        dk = np.abs(rt[k][ok] - rj[k][ok])
        assert np.median(dk) <= 0.001 * speed, (k, np.median(dk), speed)
        assert dk.max() <= 0.05 * speed, (k, dk.max(), speed)
    launches = rt["stats"]["launches"]
    assert launches == dict.fromkeys(launches, 0)


@pytest.mark.parametrize("mode", MODES)
def test_tiled_xla_iterations_leave_the_pair_zero(tiled_rec, monkeypatch,
                                                  mode):
    """Every tiled XLA iteration reads the run's pair and leaves it zero,
    calls neither B8 nor B9, and the three modes give the same bits."""
    calls = []
    finish = tsp._finish_exact

    def checked(acc_t, acc_c, tl):
        assert int(acc_c.sum()) > 0
        p = finish(acc_t, acc_c, tl)
        assert not acc_t.any() and not acc_c.any()
        assert acc_t is tl.acc_t and acc_c is tl.acc_c
        calls.append(p.shape)
        return p

    def refused(*a, **k):
        raise AssertionError("the XLA branch called a kernel wrapper")

    monkeypatch.setattr(tsp, "_finish_exact", checked)
    monkeypatch.setattr(tsp, "splat_local_call", refused)
    monkeypatch.setattr(tsp, "finish_local_call", refused)
    d = tiled_rec
    cfg = tiled_cfg(optimizer=_tiled_opt("reference", mode))
    r = tsp.compensate_recording_tiled(
        d["x"], d["y"], d["t_ns"], cfg, make_tiled_mesh((2, 2), device="cpu"),
        halo=HALO, esc_cap=ESC_CAP)
    assert len(calls) == int(r["iters"].sum()) > 0
    assert all(s == (4, 7) for s in calls)
    if mode != "xla":
        want = tsp.compensate_recording_tiled(
            d["x"], d["y"], d["t_ns"],
            tiled_cfg(optimizer=_tiled_opt("reference")),
            make_tiled_mesh((2, 2), device="cpu"), halo=HALO,
            esc_cap=ESC_CAP)
        for k in ("u", "v", "noise", "iters"):
            np.testing.assert_array_equal(r[k], want[k], err_msg=k)


def test_tiled_xla_single_slice_is_tile_independent():
    """``process_slice_tiled`` on the XLA branch: 1x1, 2x2 and 4x2 tiles
    give the same iterations and agree per event within the tiled gate
    (the tile sum adds the tiles' f32 sums in another grouping)."""
    d = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=64, vx=40.0,
                         vy=-25.0, n_points=100, seed=0)
    n = len(d["x"])
    t = d["t_ns"].astype(np.float32)
    opt = OptimizerConfig(scale=3, max_iter=12, min_events=100,
                          scatter_mode="xla")
    runs = {}
    for mesh in ((1, 1), (2, 2), (4, 2)):
        x, y, tb, ok, idx = tsp.bucket_events_2d(
            d["x"], d["y"], t, 48, 64, 3, *mesh, None, idx=np.arange(n))
        r = tsp.process_slice_tiled(x, y, tb, ok, MotionModel.zero(), opt,
                                    SensorConfig(48, 64),
                                    make_tiled_mesh(mesh, device="cpu"),
                                    halo=8)
        assert r.escaped_dropped == 0
        u, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
        u[idx[ok]], v[idx[ok]] = r.u.numpy()[ok], r.v.numpy()[ok]
        runs[mesh] = (r, u, v)
    r1, u1, v1 = runs[(1, 1)]
    assert r1.iters >= 2
    speed = float(np.hypot(u1, v1).mean())
    assert speed > 20.0, speed
    for mesh in ((2, 2), (4, 2)):
        r, u, v = runs[mesh]
        assert r.iters == r1.iters
        for a, b in ((u, u1), (v, v1)):
            assert np.median(np.abs(a - b)) <= 0.001 * speed
            assert np.abs(a - b).max() <= 0.05 * speed
