"""The XLA-composed branch of the PyTorch port (``scatter_mode="xla"``)
against the JAX package's, which is the program the JAX package runs off
the TPU.

The port's images are exact integer sums (``ops.time_image``) where the
JAX package adds f32 times in event order, and its whole-image reductions
are f64 rounded to f32 once where XLA sums in f32; every other operation
repeats XLA's compiled arithmetic (measured bit for bit: the fused
multiply-adds of the warp, the scaled truncation, Scharr and the model
integrands, reciprocal multiplications for constant divisions).  So one
iteration agrees to ~1e-6 relative, and a slice or a chain agrees where
its exits are not within that of a tolerance.

Tolerances are the JAX package's own for its scatter modes
(``tests/test_pallas.py:84-89``): iterations equal, ``total_dx`` rtol 1e-4
atol 1e-6, per-event u rtol 1e-3 atol 1e-2; noise flags identical
(``tests/test_scan_pipeline.py:232-239``).  Whole recordings are compared
per event in the original event order.  Under the reference schedule the
24x32 chains agree slice for slice; under ``fast()`` they do on the
production geometry, while on 24x32 windows the secant's chains drift
apart within a few slices, as the JAX package's own "xla" and "pallas"
chains do (ROADMAP C, small-sensor drift).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import (  # noqa: E402
    OptimizerConfig as JaxOpt, SensorConfig as JaxSensor,
)
from better_flow_tpu.core.events import make_slice as jax_slice  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.models import global_flow as jgf  # noqa: E402
from better_flow_tpu.runtime import offline as joff  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig,
)
from better_flow_tpu_torch.core.events import make_slice  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops.layout import sort_key_blocks  # noqa: E402
from better_flow_tpu_torch.parallel.event_parallel import (  # noqa: E402
    compensate_recording_scan_sharded,
)
from better_flow_tpu_torch.parallel.mesh import (  # noqa: E402
    make_event_mesh, make_tiled_mesh,
)
from better_flow_tpu_torch.parallel.spatial import (  # noqa: E402
    compensate_recording_tiled,
)
from better_flow_tpu_torch.runtime import offline as toff  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    SENSOR, bench_stream, flow_gates, gate_stream, small_cfg,
)

JSENSOR = JaxSensor(SENSOR.res_x, SENSOR.res_y)
H, W = tgf.static_image_shape(3, SENSOR)
# The JAX slice compiled whole, with the events traced as the JAX scan and
# stream have them (called eagerly, its warm-start warp would run op by op,
# unfused).
jax_process_slice = jax.jit(jgf.process_slice, static_argnums=(2, 3))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(schedule="reference", **kw):
    return OptimizerConfig(scale=3, scatter_mode="xla", schedule=schedule,
                           **kw)


def _slice(seed, n=3000, cap=4096):
    """One 24x32 slice in both packages' flat layout (slice-local times),
    its bbox and its event count."""
    d = synthetic_events(n, duration_s=0.1, res_x=SENSOR.res_x,
                         res_y=SENSOR.res_y, vx=18.0, vy=-12.0, n_points=60,
                         seed=seed)
    t = (d["t_ns"] - d["t_ns"][0]).astype(np.float32)
    evj = jax_slice(d["x"], d["y"], t.astype(np.float64), capacity=cap)
    evt = make_slice(d["x"], d["y"], t, capacity=cap)
    bbox = (int(d["x"].min()), int(d["x"].max()), int(d["y"].min()),
            int(d["y"].max()))
    return evj, evt, bbox, n


def _warm_models():
    """A mid-chain model in both packages: non-zero totals and centroid."""
    vals = dict(cx=11.5, cy=15.25, total_dx=0.021, total_dy=-0.014,
                total_rot=0.004, total_div=0.002)
    mj = JaxModel.zero()._replace(**{k: jnp.float32(v)
                                     for k, v in vals.items()})
    mt = MotionModel.zero().replace(**{k: torch.tensor(np.float32(v))
                                       for k, v in vals.items()})
    return mj, mt


def _assert_slice_close(rt, rj, iters=True):
    if iters:
        assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(float(rt.model.total_dx),
                               float(rj.model.total_dx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(rt.pr_x.numpy(), np.asarray(rj.pr_x),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_array_equal(rt.noise.numpy(), np.asarray(rj.noise))


# ----------------------------------------------------- one step, one slice


def test_iteration_step_matches_jax():
    """Three XLA iterations from a warm-start warp: the warp bitwise the
    JAX package's compiled one, then warp, direction vectors and model
    within the tolerances above, the count exact."""
    evj, evt, bbox, _ = _slice(3)
    mj, mt = _warm_models()
    geomj = jgf.slice_geometry(evj, 3, JSENSOR)
    geomt = tgf.geometry_from_bbox(*bbox, 3, SENSOR)
    sj = jgf.GlobalFlowState(
        pr_x=evj.x, pr_y=evj.y, nx=jnp.zeros_like(evj.x),
        ny=jnp.zeros_like(evj.x), model=mj, x_div=jnp.float32(1),
        y_div=jnp.float32(1), rot_div=jnp.float32(1),
        div_div=jnp.float32(1), iters=jnp.int32(0))
    st = tgf.warp_init(evt, mt)
    warp = jax.jit(lambda e, m: jgf.project_4param_reinit(
        e.x, e.y, e.t, e.x, e.y, -m.total_dx, -m.total_dy, m.cx, m.cy,
        m.total_div, -m.total_rot))
    pj, _, nj, _ = warp(evj, mj)
    np.testing.assert_array_equal(st.pr_x.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.nx.numpy(), np.asarray(nj))
    sj = sj._replace(pr_x=st.pr_x.numpy(), pr_y=st.pr_y.numpy())
    step = jax.jit(lambda s, e, g: jgf._iteration_step(s, e, g, 3, H, W))
    for _ in range(3):
        sj = step(sj, evj, geomj)
        st = tgf.iteration_step(st, evt, geomt, 3, H, W)
        assert float(st.model.cnt) == float(sj.model.cnt) > 500
        # A direction vector moves its event by up to 79x as much (t / (NZ
        # * 1e4) at 0.1 s), so its bound is the positions' / 79.
        for f, atol in (("pr_x", 1e-2), ("pr_y", 1e-2), ("nx", 1.3e-4),
                        ("ny", 1.3e-4)):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(sj, f)),
                                       rtol=1e-4, atol=atol)
        for f in ("dx", "dy", "rot", "div", "total_dx", "total_dy",
                  "total_rot", "total_div"):
            np.testing.assert_allclose(float(getattr(st.model, f)),
                                       float(getattr(sj.model, f)),
                                       rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(st.model.cx), float(sj.model.cx),
                                   rtol=1e-6)
    assert st.iters == int(sj.iters) == 3


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_process_slice_matches_jax(schedule, warm):
    """``process_slice`` on the XLA branch against the JAX package's, cold
    and from a warm-start model, both schedules."""
    evj, evt, bbox, n = _slice(4)
    mj, mt = _warm_models() if warm else (JaxModel.zero(),
                                          MotionModel.zero())
    rj = jax_process_slice(evj, mj, JaxOpt(scale=3, scatter_mode="xla",
                                           schedule=schedule), JSENSOR)
    rt, uvn = tgf.process_slice(None, None, mt, _opt(schedule), SENSOR, bbox,
                                n, ev=evt)
    assert rt.ran and rt.iters > 3
    _assert_slice_close(rt, rj)
    if schedule == "fast":
        np.testing.assert_allclose(rt.seed.numpy(), np.asarray(rj.seed),
                                   rtol=1e-3, atol=1e-6)
    # The scan's pack: [u, v, noise | padding] in the slice's slot order.
    assert uvn.shape == (2, 3, 2048)
    flat = uvn.transpose(0, 1).reshape(3, -1)
    assert torch.equal(flat[0], rt.u) and torch.equal(flat[1], rt.v)
    np.testing.assert_array_equal(flat[2].numpy() > 0,
                                  ~evt.valid.numpy() | rt.noise.numpy())


def test_gated_slice_keeps_the_warm_start_warp():
    """Too few events: no iteration, the warm-start warp of the incoming
    model and that model itself, as in the JAX package."""
    evj, evt, bbox, n = _slice(5)
    mj, mt = _warm_models()
    opt = _opt(min_events=10 ** 6)
    rj = jax_process_slice(evj, mj, JaxOpt(scale=3, scatter_mode="xla",
                                           min_events=10 ** 6), JSENSOR)
    rt, _ = tgf.process_slice(None, None, mt, opt, SENSOR, bbox, n, ev=evt)
    assert not rt.ran and rt.iters == 0 == int(rj.iters)
    np.testing.assert_array_equal(rt.pr_x.numpy(), np.asarray(rj.pr_x))
    np.testing.assert_array_equal(rt.u.numpy(), np.asarray(rj.u))
    assert rt.model is mt


def test_pallas_branch_of_run_optimizer_matches_xla_branch():
    """``run_optimizer`` with "pallas" (B11's twin on events sorted by
    ``sort_key_blocks``) against the port's own XLA branch and against the
    JAX package's pallas branch (B11 in interpret mode), cold start,
    reference schedule."""
    evj, evt, bbox, n = _slice(6)
    order = torch.argsort(sort_key_blocks(evt.x, evt.y, evt.valid),
                          stable=True)
    evs = type(evt)(*(f[order] for f in evt))
    geom = tgf.geometry_from_bbox(*bbox, 3, SENSOR)
    runs = {}
    for mode in ("xla", "pallas"):
        init = tgf.warp_init(evs, MotionModel.zero())
        runs[mode], _ = tgf.run_optimizer(
            init, evs, geom, 3, H, W,
            OptimizerConfig(scale=3, scatter_mode=mode))
    evjs = type(evj)(*(jnp.asarray(np.asarray(f)[order.numpy()])
                       for f in evj))
    geomj = jgf.slice_geometry(evjs, 3, JSENSOR)
    init = jgf.GlobalFlowState(
        pr_x=evjs.x, pr_y=evjs.y, nx=jnp.zeros_like(evjs.x),
        ny=jnp.zeros_like(evjs.x), model=JaxModel.zero(),
        x_div=jnp.float32(1), y_div=jnp.float32(1), rot_div=jnp.float32(1),
        div_div=jnp.float32(1), iters=jnp.int32(0))
    fj, _ = jgf._run_optimizer(init, evjs, geomj, 3, H, W,
                               JaxOpt(scale=3, scatter_mode="pallas"))
    x, p = runs["xla"], runs["pallas"]
    for other in (p, fj):
        assert x.iters == int(other.iters) > 3
        np.testing.assert_allclose(float(x.model.total_dx),
                                   float(other.model.total_dx), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(x.nx.numpy(), np.asarray(other.nx),
                                   rtol=1e-3, atol=1e-2 * 127 / 1e5)


def test_final_time_image_matches_jax():
    evj, evt, bbox, n = _slice(7)
    rj = jax_process_slice(evj, JaxModel.zero(),
                           JaxOpt(scale=3, scatter_mode="xla"), JSENSOR)
    rt, _ = tgf.process_slice(None, None, MotionModel.zero(), _opt(), SENSOR,
                              bbox, n, ev=evt)
    ij = np.asarray(jgf.final_time_image(evj, rj, 3, JSENSOR))
    it = tgf.final_time_image(evt, rt, 3, SENSOR).numpy()
    assert (it > 0).sum() > 500
    np.testing.assert_array_equal(it > 0, ij > 0)
    np.testing.assert_allclose(it, ij, rtol=1e-5, atol=1e-7)


# --------------------------------------------------- recordings, streams


def _scans(d, cfg):
    rj = jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    rt = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    return rt, rj


def _per_event_close(rt, rj):
    np.testing.assert_array_equal(rt["noise"], rj["noise"])
    np.testing.assert_allclose(rt["u"], rj["u"], rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(rt["v"], rj["v"], rtol=1e-3, atol=1e-2)


def test_small_scan_matches_jax_slice_for_slice():
    """The scan on a 24x32 recording under the reference schedule:
    iterations equal slice for slice, per-event flow and noise in the
    original event order."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = small_cfg(scatter_mode="xla", schedule="reference",
                    exit_grad_factor=0.0)
    rt, rj = _scans(d, cfg)
    assert len(rt["iters"]) > 10 and rt["ran"].all()
    np.testing.assert_array_equal(rt["iters"], rj["iters"])
    _per_event_close(rt, rj)
    launches = rt["stats"]["launches"]
    assert launches == dict.fromkeys(launches, 0)      # CPU: plain code


def test_production_scan_fast_matches_jax():
    """bench.py's configuration, ``fast()`` on the XLA branch: 180x240,
    scale 3, 50k/20k slices; iterations equal slice for slice."""
    d = bench_stream(60_000)
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast(scatter_mode="xla"))
    rt, rj = _scans(d, cfg)
    assert len(rt["iters"]) == 3 and rt["ran"].all()
    np.testing.assert_array_equal(rt["iters"], rj["iters"])
    _per_event_close(rt, rj)


def test_gate_firing_scan_matches_jax():
    """The window gate fires mid-recording: the same events are noise, the
    same slices run."""
    d = gate_stream()
    rt, rj = _scans(d, small_cfg(scatter_mode="xla", schedule="reference",
                                 exit_grad_factor=0.0))
    assert rt["noise"].any() and not rt["noise"].all()
    assert rt["ran"].any() and not rt["ran"].all()
    np.testing.assert_array_equal(rt["ran"], rj["ran"])
    flow_gates(rt, rj)


def test_fast_small_scan_agrees_before_the_chain_drifts():
    """``fast()`` on 24x32: the first slices equal; later the secant's
    chain is free to drift (the module docstring)."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    rt, rj = _scans(d, small_cfg(scatter_mode="xla"))
    np.testing.assert_array_equal(rt["iters"][:3], rj["iters"][:3])
    np.testing.assert_array_equal(rt["noise"], rj["noise"])


def test_stream_matches_jax_per_event():
    """``DVSFlow`` on the XLA branch (through ``offline``) against the JAX
    package's stream, whose default off the TPU is this branch: the same
    slices, iterations equal, each slice's per-event outputs equal within
    the tolerances in the ring's order and the merged outputs in the
    original event order."""
    d = synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=4)
    cfg = small_cfg(scatter_mode="xla", schedule="reference",
                    exit_grad_factor=0.0)
    rj = joff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg)
    rt = toff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu")
    st, sj = rt["engine"].slices, rj["engine"].slices
    assert len(st) == len(sj) > 10
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.timestamp, b.timestamp)
        assert a.iters == int(b.iters)
        np.testing.assert_array_equal(a.noise, b.noise)
        np.testing.assert_allclose(a.u, b.u, rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(a.pr_x, b.pr_x, rtol=1e-4, atol=1e-2)
    at, aj = rt["accumulated"], rj["accumulated"]
    np.testing.assert_array_equal(at["timestamp"], aj["timestamp"])
    np.testing.assert_array_equal(at["noise"], aj["noise"])
    np.testing.assert_allclose(at["u"], aj["u"], rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(at["v"], aj["v"], rtol=1e-3, atol=1e-2)


# ------------------------------------ groups, tiles, and what stays raising


def test_xla_runs_under_a_group_and_tiled_and_unknown_modes_raise():
    """The XLA branch runs under an event group and on the tiled path (the
    sharded scan bitwise the scan, ``tests/test_torch_xla_parallel.py``
    holds both against the JAX package); what still raises does so by
    name: an unknown scatter mode, and the XLA branch without the flat
    slice."""
    d = synthetic_events(6000, duration_s=0.2, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = small_cfg(scatter_mode="xla")
    rs = compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(2, device="cpu"))
    ru = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rs[k], ru[k], err_msg=k)
    rt = compensate_recording_tiled(d["x"], d["y"], d["t_ns"], cfg,
                                    make_tiled_mesh((1, 1), device="cpu"))
    assert rt["stats"]["escaped_dropped"] == 0
    assert np.isfinite(rt["u"]).all() and (rt["iters"] > 0).any()
    evj, evt, bbox, n = _slice(3)
    geom = tgf.geometry_from_bbox(*bbox, 3, SENSOR)
    group = make_event_mesh(1, device="cpu")
    s0 = tgf.warp_init(evt, MotionModel.zero())
    one = tgf.iteration_step(s0, evt, geom, 3, H, W)
    for mode in ("xla", "pallas"):
        # Under a group "pallas" takes the XLA chain, as in the JAX package.
        got = tgf.iteration_step(s0, evt, geom, 3, H, W, scatter_mode=mode,
                                 group=group)
        assert torch.equal(got.pr_x, one.pr_x)
        assert torch.equal(got.model.total_dx, one.model.total_dx)
    # "rep" and "mxu" run the XLA branch, under a group and tiled too.
    for mode in ("rep", "mxu"):
        tgf.check_supported(OptimizerConfig(scatter_mode=mode))
    with pytest.raises(NotImplementedError, match="scatter_mode"):
        tgf.check_supported(OptimizerConfig(scatter_mode="segment"))
    with pytest.raises(ValueError, match="pass ev"):
        tgf.process_slice(None, None, MotionModel.zero(), _opt(), SENSOR,
                          bbox, n)


@pytest.mark.parametrize("order", ["sorted", "staged"])
def test_pallas_branch_calls_b11_in_any_event_order(monkeypatch, order):
    """The step's pallas branch calls B11 once an iteration, on events
    sorted by ``sort_key_blocks`` (as the JAX package's ``process_slice``
    sorts them) or in their staged order; its sums are B10's on the same
    positions either way."""
    from better_flow_tpu_torch.core.events import EventSlice
    from better_flow_tpu_torch.ops import fused_model as tfm

    calls = []

    def counted(*a, **k):
        calls.append(a)
        return tfm.fused_model_partials_windowed_call(*a, **k)

    monkeypatch.setattr(tgf, "fused_model_partials_windowed_call", counted)
    _, evt, bbox, _ = _slice(4)
    if order == "sorted":
        o = torch.argsort(sort_key_blocks(evt.x, evt.y, evt.valid),
                          stable=True)
        evt = EventSlice(*(f[o] for f in evt))
    geom = tgf.geometry_from_bbox(*bbox, 3, SENSOR)
    final, _ = tgf.run_optimizer(
        tgf.warp_init(evt, MotionModel.zero()), evt, geom, 3, H, W,
        OptimizerConfig(scale=3, scatter_mode="pallas"))
    assert len(calls) == final.iters > 2
    kw = dict(scale=3, H=H, W=W)
    p11 = tfm.fused_model_partials_windowed_call(*calls[-1], **kw)
    assert torch.equal(p11, tfm.fused_model_partials_call(*calls[-1], **kw))
    assert float(p11[0]) > 100
