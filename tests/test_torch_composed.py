"""The composed kernel path of the PyTorch port against the JAX package's.

The composed path is ``_run_fused``'s loop without the megastep: one B6
launch (``fused_warp_splat``: warp + splat + finish to seven sums) per
iteration, then the scalar model update between launches.  The JAX package
takes it for f64 totals (``PipelineConfig.f64_totals``, run here under
``jax.enable_x64()``) and for ``OptimizerConfig(use_megastep=False)``; with
``scatter_mode="pallas"`` its B6 runs in interpret mode.

Tolerances: the kernel twin's new positions are bitwise JAX's and its seven
sums within 1e-6 relative to the sum of their terms' magnitudes (JAX sums
in f32 in XLA's order, the port in f64; the gradient sums cancel, so their
own values can be ~1e-5 apart relatively).
The warm-start chains are held to the gates of the scan's tests
(``torch_inputs.flow_gates``); on the production geometry the iterations
agree slice for slice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
)
from better_flow_tpu.core.events import EventSlice  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu.models.global_flow import (  # noqa: E402
    process_slice as jax_process_slice,
)
from better_flow_tpu.ops import reductions as jred  # noqa: E402
from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu.runtime import checkpoint as jckpt  # noqa: E402
from better_flow_tpu.runtime import dvs_flow as jdvs  # noqa: E402
from better_flow_tpu.runtime import live as jlive  # noqa: E402
from better_flow_tpu.runtime import offline as joff  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.convert import (  # noqa: E402
    carry_from_numpy, carry_to_numpy,
)
from better_flow_tpu_torch.core.model import (  # noqa: E402
    FIELDS, TOTAL_FIELDS, MotionModel,
)
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import reductions as tred  # noqa: E402
from better_flow_tpu_torch.ops.warp import cos_sin_f32  # noqa: E402
from better_flow_tpu_torch.runtime import checkpoint as tckpt  # noqa: E402
from better_flow_tpu_torch.runtime import dvs_flow as tdvs  # noqa: E402
from better_flow_tpu_torch.runtime import live as tlive  # noqa: E402
from better_flow_tpu_torch.runtime import offline as toff  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    SENSOR, bench_stream, flow_gates, image_shape, slice_inputs,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

PARTS = ("cnt", "s_row", "s_col", "s_gx", "s_gy", "s_rg", "s_dg")
SMALL_SLICES = SliceConfig(max_events=4000, span_ns=int(0.1e9),
                           refresh_events=1500, refresh_time_ns=int(0.04e9))
# An f64 angle whose f32 rounding changes its f32 sine.
ANGLE64 = 0.02603218874814671


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref(**kw):
    return OptimizerConfig(scale=3, min_events=500, scatter_mode="pallas",
                           **kw)


def _small(opt, f64=False):
    return PipelineConfig(sensor=SENSOR, slice=SMALL_SLICES, optimizer=opt,
                          f64_totals=f64)


def _prod(f64=True, **opt):
    return PipelineConfig(optimizer=OptimizerConfig(scatter_mode="pallas",
                                                    **opt), f64_totals=f64)


def _small_stream(seed=4):
    return synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32,
                            vx=20.0, vy=-14.0, seed=seed)


# ------------------------------------------------------------- B6 twin


def _b6_inputs(res, scale, nch, seed):
    d = slice_inputs(seed, res=res, scale=scale, nch=nch)
    st = d["st"][0]
    # (dnx_, dny_, cx, cy, divp) in the carry's sign pattern.
    warp = [np.float32(v) for v in (-st[0], -st[1], st[8], st[9], st[3])]
    return d, warp


def _jax_row(geo, warp, crl):
    """The JAX wrapper's (1, 16) row (fused_model.py:654-659): every value
    rounded to f32 once, cos and sin taken on ``crl`` in its own dtype."""
    vals = [geo[0, 0], geo[0, 1], geo[0, 2], geo[0, 3], *warp,
            jnp.cos(crl), jnp.sin(crl)]
    return np.concatenate([np.array([np.float32(v) for v in vals]),
                           np.zeros(5, np.float32)]).reshape(1, 16)


def _jax_b6(d, warp, crl, scale, H, W):
    geo = d["geo"]
    npr, p = jfm.fused_warp_splat(
        jnp.asarray(d["stat"]), jnp.asarray(d["act"]), jnp.asarray(d["pr"]),
        scale, geo[0, 0], geo[0, 1], geo[0, 2], geo[0, 3], *warp, crl, H, W)
    return np.asarray(npr), np.array([float(p[k]) for k in PARTS], np.float32)


def _term_scale(inputs, scale, H, W):
    """Each of the seven sums taken over its terms' magnitudes (f64): an
    f32 sum's rounding error grows with it, and the gradient sums cancel
    to far less."""
    def abs_partial(img, gx, gy):
        f64 = torch.float64
        m = (img > 1e-6).to(f64)
        ax, ay = gx.abs().to(f64) * m, gy.abs().to(f64) * m
        ri = torch.arange(img.shape[0])[:, None].to(f64)
        ci = torch.arange(img.shape[1])[None, :].to(f64)
        return torch.stack([m.sum(), (m * ri).sum(), (m * ci).sum(),
                            ax.sum(), ay.sum(), (ay * ri + ax * ci).sum(),
                            (ax * ri + ay * ci).sum()])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfm, "model_compute_partial", abs_partial)
        _, mag = tfm.fused_warp_splat_plain(*inputs, scale=scale, H=H, W=W)
    return mag[:7].numpy()


def _assert_b6_close(npr, vals, npr_j, vals_j, mag):
    """New positions bitwise; each sum within 1e-6 relative to its terms'
    magnitudes (rtol 1e-6 where no terms cancel: cnt, s_row, s_col)."""
    np.testing.assert_array_equal(npr.numpy(), npr_j)
    err = np.abs(vals.numpy()[:7].astype(np.float64) - vals_j)
    assert np.all(err <= 1e-6 * mag), (vals.numpy()[:7], vals_j, mag)
    assert float(vals[7]) == 0.0        # no splat window, no fallback
    assert vals_j[0] > 1000


@pytest.mark.parametrize("res,scale,nch", [((24, 32), 3, 3),
                                           ((180, 240), 3, 4)])
def test_fused_warp_splat_twin_matches_pallas(res, scale, nch):
    """B6's twin against the Pallas kernel at 24x32 (images 75x99) and at
    the production 180x240, scale 3 (padded images 576x768), on the row
    the JAX wrapper builds from an f32 carry."""
    H, W = image_shape(res, scale)
    d, warp = _b6_inputs(res, scale, nch, seed=6)
    crl = jnp.float32(-d["st"][0, 2])
    npr_j, vals_j = _jax_b6(d, warp, crl, scale, H, W)
    scal = _t(_jax_row(d["geo"], warp, crl))
    inputs = [_t(d[k]) for k in ("stat", "act", "pr")] + [scal]
    npr, vals = tfm.fused_warp_splat_call(*inputs, scale=scale, H=H, W=W)
    _assert_b6_close(npr, vals, npr_j, vals_j,
                     _term_scale(inputs, scale, H, W))
    assert tfm.LAUNCHES["fused_warp_splat"] == 0      # CPU: the twin


def test_fused_warp_splat_f64_angle_matches_pallas(monkeypatch):
    """Under f64 totals the JAX wrapper takes cos and sin of the f64 angle
    (then rounds each to f32), where the final warp casts the angle to f32
    first.  ``warp_scal_row`` builds the f64 way: on an angle whose f32
    rounding changes the sine, its row is JAX's (x64 on) bit for bit, and
    B6's twin on that row matches the Pallas kernel fed the same cos and
    sin."""
    res, scale, nch = (24, 32), 3, 3
    H, W = image_shape(res, scale)
    d, warp = _b6_inputs(res, scale, nch, seed=7)
    with jax.enable_x64():
        row_j = _jax_row(d["geo"], warp, jnp.float64(-ANGLE64))
    model = MotionModel.zero(f64_totals=True).replace(
        total_dx=torch.tensor(-float(warp[0]), dtype=torch.float64),
        total_dy=torch.tensor(-float(warp[1]), dtype=torch.float64),
        cx=torch.tensor(warp[2]), cy=torch.tensor(warp[3]),
        total_div=torch.tensor(float(warp[4]), dtype=torch.float64),
        total_rot=torch.tensor(ANGLE64, dtype=torch.float64))
    row = tfm.warp_scal_row(_t(d["geo"]), model)
    np.testing.assert_array_equal(row.numpy(), row_j)
    _, s32 = cos_sin_f32(torch.tensor(-ANGLE64, dtype=torch.float32))
    assert float(s32) != float(row[0, 10])      # the f32-cast angle differs
    monkeypatch.setattr(jnp, "cos", lambda a: jnp.float32(row_j[0, 9]))
    monkeypatch.setattr(jnp, "sin", lambda a: jnp.float32(row_j[0, 10]))
    npr_j, vals_j = _jax_b6(d, warp, jnp.float32(0), scale, H, W)
    monkeypatch.undo()
    inputs = [_t(d[k]) for k in ("stat", "act", "pr")] + [row]
    npr, vals = tfm.fused_warp_splat_call(*inputs, scale=scale, H=H, W=W)
    _assert_b6_close(npr, vals, npr_j, vals_j,
                     _term_scale(inputs, scale, H, W))


def test_warp_scal_row_of_f32_carry_matches_jax_row():
    """From an f32 carry the row's cos and sin are rounded once from f64
    (the port's rule, ops/warp.py); XLA's f32 cos and sin are within one
    ulp of them.  Every other slot is bitwise."""
    d, warp = _b6_inputs((24, 32), 3, 1, seed=8)
    for angle in (3e-3, -0.0213, 0.3):
        model = MotionModel.zero().replace(
            total_dx=torch.tensor(-warp[0]), total_dy=torch.tensor(-warp[1]),
            cx=torch.tensor(warp[2]), cy=torch.tensor(warp[3]),
            total_div=torch.tensor(warp[4]),
            total_rot=torch.tensor(angle, dtype=torch.float32))
        row = tfm.warp_scal_row(_t(d["geo"]), model).numpy()
        want = _jax_row(d["geo"], warp, jnp.float32(-np.float32(angle)))
        keep = [k for k in range(16) if k not in (9, 10)]
        np.testing.assert_array_equal(row[0, keep], want[0, keep])
        np.testing.assert_allclose(row[0, 9:11], want[0, 9:11], rtol=2e-7)


def test_b6_splats_the_time_pair_under_fast():
    """B6 always splats the hi+lo time pair, as the TPU kernel does
    whatever ``splat_time_lo`` says: its sums are those of B1's splat with
    the pair, not of the high row alone that the megastep splats under
    ``fast()``; and ``fast(use_megastep=False)`` takes B6."""
    res, scale, nch = (24, 32), 3, 3
    H, W = image_shape(res, scale)
    d = slice_inputs(9, res=res, scale=scale, nch=nch)
    t = {k: _t(d[k]) for k in ("stat", "act", "pr", "st", "geo")}
    model = tgf.model_from_state(t["st"])
    _, vals = tfm.fused_warp_splat_call(
        t["stat"], t["act"], t["pr"], tfm.warp_scal_row(t["geo"], model),
        scale=scale, H=H, W=W)

    def sums(time_lo):
        _, at, ac = tfm.warp_images_st_call(
            t["stat"], t["act"], t["pr"], t["st"], t["geo"],
            *tfm.image_pair("cpu", H, W), scale=scale, H=H, W=W,
            time_lo=time_lo)
        return tfm.finish_values_plain(at, ac, scale=scale, H=H, W=W)

    assert torch.equal(vals[:7], sums(True))
    assert not torch.equal(vals[:7], sums(False))
    cfg = OptimizerConfig.fast(use_megastep=False)
    assert not cfg.splat_time_lo and not tgf.uses_megastep(cfg, torch.float32)


# -------------------------------------------------- the scalar update


def test_model_from_partials_matches_jax():
    """The port's ``model_from_partials`` against the JAX function as XLA
    compiles it (jitted): the centroid, dx, dy and count bitwise; rot and
    div, whose centroid corrections the port takes as fused multiply-adds,
    to rtol 1e-6."""
    rng = np.random.default_rng(3)
    jit = jax.jit(jred.model_from_partials)
    for _ in range(20):
        cnt = np.float32(rng.integers(0, 20000))
        p = np.array([cnt, cnt * rng.uniform(10, 500),
                      cnt * rng.uniform(10, 700),
                      *rng.normal(0, 50, 2), *rng.normal(0, 5e4, 2)],
                     np.float32)
        cx, cy, terms = tred.model_from_partials(
            _t(np.concatenate([p, [0.0]]).astype(np.float32)))
        jcx, jcy, jterms = jit(dict(zip(PARTS, (jnp.float32(v) for v in p))))
        for a, b in ((cx, jcx), (cy, jcy), (terms.dx, jterms.dx),
                     (terms.dy, jterms.dy), (terms.cnt, jterms.cnt)):
            assert float(a) == float(b)
        for a, b in ((terms.rot, jterms.rot), (terms.div, jterms.div)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                       atol=1e-12)


def test_f64_add_totals_and_update_accumulators_match_jax():
    """With x64 on, JAX promotes an f32 step added to an f64 total to f64;
    the port does the same.  Every field bitwise, the totals and
    compensations f64 and the rest f32."""
    rng = np.random.default_rng(4)
    tm = MotionModel.zero(f64_totals=True)
    with jax.enable_x64():
        jm = JaxModel.zero(jnp.float64)
        for k, d in enumerate(rng.normal(0, 1e-3, (120, 4))
                              .astype(np.float32)):
            if k % 2:
                jm = jm.add_totals(*(jnp.float32(v) for v in d))
                tm = tm.add_totals(*(torch.tensor(v) for v in d))
            else:       # the reference step: f32 gradient / f32 divider
                g = dict(rot=d[0], div=d[1], dx=d[2], dy=d[3])
                jm = jm._replace(**{f: jnp.float32(v) for f, v in g.items()})
                tm = tm.replace(**{f: torch.tensor(v) for f, v in g.items()})
                dv = [np.float32(v) for v in (3.0, 5.0, 2.0, 7.0)]
                jm = jm.update_accumulators(*(jnp.float32(v) for v in dv))
                tm = tm.update_accumulators(*(torch.tensor(v) for v in dv))
        for f in FIELDS:
            a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
            assert a.dtype == b.dtype, f
            assert a == b, f
    assert {f for f in FIELDS if getattr(tm, f).dtype == torch.float64} \
        == set(TOTAL_FIELDS)


# -------------------------------------------------------- one slice


def _slice_both(prep, s, cfg, sensor, f64):
    """Slice ``s`` of a staged recording through both packages' kernel
    branch from a zero model (f64 totals when ``f64``)."""
    stat, sidx = prep["stat"][s], prep["sidx"][s]
    bbox, nv = prep["bbox"][s], int(prep["nval"][s])
    st_np, sidx_np = stat.numpy(), sidx.numpy()
    K = 1
    hist = np.stack([np.zeros(K, np.int32), np.zeros(K, np.int32),
                     np.full(K, -1, np.int32)])
    with jax.enable_x64(f64):
        ev = EventSlice(x=jnp.asarray(st_np[:, 0].reshape(-1)),
                        y=jnp.asarray(st_np[:, 1].reshape(-1)),
                        t=jnp.asarray(st_np[:, 2].reshape(-1)),
                        valid=jnp.asarray(sidx_np >= 0),
                        noise=jnp.zeros(sidx_np.shape, bool))
        act_j = jfm.act_rows_call(jnp.asarray(sidx_np),
                                  jnp.asarray(hist[0] > 0),
                                  jnp.asarray(hist[1]), jnp.asarray(hist[2]))
        model_j = JaxModel.zero(jnp.float64 if f64 else jnp.float32)
        rj, uvn_j = jax_process_slice(
            ev, model_j, cfg.optimizer, sensor, presorted=True,
            stat3=jnp.asarray(st_np), seed=jnp.zeros(8, jnp.float32),
            bbox=jnp.asarray(bbox), n_valid=nv, want_uvn=True, act3=act_j)
        rj_model = {f: np.asarray(getattr(rj.model, f)) for f in FIELDS}
        rj_iters, uvn_j = int(rj.iters), np.asarray(uvn_j)
    act = tfm.act_rows_call(sidx, _t(hist))
    rt, uvn_t = tgf.process_slice(
        stat, act, MotionModel.zero(f64_totals=f64), cfg.optimizer, sensor,
        bbox, nv, seed=torch.zeros(8))
    return rj_model, rj_iters, uvn_j, rt, uvn_t.numpy()


@pytest.fixture(scope="module")
def prod_prep():
    cfg = _prod()
    return tscan.prepare_recording(*(bench_stream(20_000)[k] for k in
                                     ("x", "y", "t_ns")), cfg, device="cpu")


@pytest.mark.parametrize("f64,opt", [
    (True, {}), (False, {"use_megastep": False, "schedule": "fast"})])
def test_production_slice_composed_matches_jax(prod_prep, f64, opt):
    """The first slice of bench.py's stream (180x240, scale 3: 576x768
    padded images; the 20k events of its first trigger) through the
    composed loop, from a zero model: iterations equal, totals
    within 1e-6, the carry's dtype kept, u and v close and the noise row
    equal."""
    cfg = _prod(f64=f64, **opt)
    before = dict(tfm.LAUNCHES)
    rj_model, rj_iters, uvn_j, rt, uvn_t = _slice_both(
        prod_prep, 0, cfg, SensorConfig(), f64)
    assert tfm.LAUNCHES == before            # CPU tensors: the twins
    assert rt.ran and rt.iters == rj_iters >= 3
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        got = getattr(rt.model, f)
        assert got.dtype == (torch.float64 if f64 else torch.float32)
        assert rj_model[f].dtype == (np.float64 if f64 else np.float32)
        assert abs(float(got) - float(rj_model[f])) <= 1e-6, f
    np.testing.assert_allclose(uvn_t[:, 0:2], uvn_j[:, 0:2], rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_array_equal(uvn_t[:, 2], uvn_j[:, 2])


@pytest.fixture(scope="module")
def small_prep():
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    return tscan.prepare_recording(d["x"], d["y"], d["t_ns"],
                                   _small(_ref()), device="cpu")


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_composed_loop_reads_once_per_iteration(small_prep, monkeypatch,
                                                schedule):
    """The composed loop reads the device only for its continue flag: one
    read per iteration but the last (stopped by the iteration cap, a host
    value), one B6 call per iteration, and no other tensor-to-host read."""
    calls, reads = [], []
    real_b6 = tgf.fused_warp_splat_call
    monkeypatch.setattr(tgf, "fused_warp_splat_call",
                        lambda *a, **k: calls.append(1) or real_b6(*a, **k))
    for name in ("item", "__bool__", "__float__", "__int__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, _real=real, _n=name: reads.append(_n)
            or _real(self))
    f64 = schedule == "reference"
    opt = _ref(max_iter=3, use_megastep=False, schedule=schedule)
    p, s = small_prep, 2
    rt, _ = tgf.process_slice(
        p["stat"][s], tfm.act_rows_call(
            p["sidx"][s], _t(np.array([[0], [0], [-1]], np.int32))),
        MotionModel.zero(f64_totals=f64), opt, SENSOR, p["bbox"][s],
        int(p["nval"][s]), seed=torch.zeros(8))
    monkeypatch.undo()
    assert 2 <= rt.iters == len(calls) <= 4    # max_iter 3 allows a 4th
    # One read per iteration; none after the 4th (the cap is a host value).
    want = rt.iters - 1 if rt.iters == 4 else rt.iters
    assert reads == ["item"] * want


# --------------------------------------------- whole scans and streams


def _scan_both(d, cfg, f64):
    with jax.enable_x64(f64):
        rj = jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
        rj = dict(rj, model={f: np.asarray(getattr(rj["model"], f))
                             for f in FIELDS})
    rt = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    return rt, rj


@pytest.mark.parametrize("f64,opt", [
    (True, _ref()), (False, _ref(use_megastep=False)),
    (False, OptimizerConfig.fast(scale=3, min_events=500,
                                 scatter_mode="pallas", use_megastep=False))])
def test_small_scan_composed_matches_jax(f64, opt):
    """A 24x32 scan through the composed loop: the scan's gates, the carry
    f64 end to end under f64 totals, one device read per iteration."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    rt, rj = _scan_both(d, _small(opt, f64), f64)
    assert len(rt["iters"]) > 10 and rt["ran"].all()
    flow_gates(rt, rj)
    dt = torch.float64 if f64 else torch.float32
    for f in FIELDS:
        want = dt if f in TOTAL_FIELDS else torch.float32
        assert getattr(rt["model"], f).dtype == want, f
        assert rj["model"][f].dtype == np.dtype(str(want).split(".")[1])
    vals = carry_to_numpy(rt["carry"])[0]
    assert vals.dtype == (np.float64 if f64 else np.float32)
    assert rt["stats"]["host_syncs"] == int(rt["iters"].sum())


def test_production_scan_f64_matches_jax_slice_for_slice():
    """bench.py's geometry (180x240, scale 3, 50k/20k slices) with f64
    totals under the reference schedule: every slice's iterations equal,
    the final f64 totals within 1e-6."""
    rt, rj = _scan_both(bench_stream(40_000), _prod(), True)
    assert len(rt["iters"]) == 2 and rt["ran"].all()
    np.testing.assert_array_equal(rt["iters"], rj["iters"])
    flow_gates(rt, rj)
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        got = getattr(rt["model"], f)
        assert got.dtype == torch.float64
        assert abs(float(got) - float(rj["model"][f])) <= 1e-6


def _stream_both(d, cfg, f64):
    with jax.enable_x64(f64):
        rj = joff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg)
        jm = rj["engine"].last_model
        jdt = np.asarray(jm.total_dx).dtype
    rt = toff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device="cpu")

    def flat(r):
        acc, sl = r["accumulated"], r["engine"].slices
        iters = np.array([s.iters for s in sl])
        return dict(noise=acc["noise"], u=acc["u"], v=acc["v"], iters=iters,
                    ran=iters > 0)

    return flat(rt), flat(rj), rt["engine"], jdt


@pytest.mark.parametrize("case", ["small_f64", "prod_f64",
                                  "prod_fast_nomega"])
def test_stream_composed_matches_jax(case):
    """``offline.compensate_recording`` through the composed loop: f64
    totals under the reference schedule on a 24x32 stream and on the
    production geometry (iterations slice for slice on its first two
    slices), and ``fast(use_megastep=False)`` on the production geometry.  (On 24x32
    streams the fast secant chains of the two packages drift apart through
    the ~1e-7 differences of the sums: 4 of 6 seeds tried leave the 10%
    iteration gate; on the production geometry a near-tolerance exit may
    still differ by one iteration: the third slice of both production
    streams here does.)  The engine's model keeps the carry's
    dtype."""
    if case == "small_f64":
        d, cfg, f64 = _small_stream(), _small(_ref(), True), True
    elif case == "prod_f64":
        d, cfg, f64 = bench_stream(30_000), _prod(), True
    else:
        d, f64 = bench_stream(40_000), False
        cfg = _prod(f64=False, use_megastep=False, schedule="fast")
    t, j, engine, jdt = _stream_both(d, cfg, f64)
    assert len(t["iters"]) >= 2 and t["ran"].all()
    flow_gates(t, j)
    if case == "prod_f64":
        np.testing.assert_array_equal(t["iters"][:2], j["iters"][:2])
    want = torch.float64 if f64 else torch.float32
    assert engine.last_model.total_rot.dtype == want
    assert jdt == np.dtype(str(want).split(".")[1])


def test_live_f64_matches_jax():
    """The live frontend's embedded low-latency engine (scale 1, at most 10
    iterations) with f64 totals, on a 24x32 stream: the same refreshes, the
    same point clouds, images within 1% of pixels."""
    cfg = PipelineConfig(
        sensor=SENSOR,
        slice=SliceConfig(max_events=4000, span_ns=int(0.07e9),
                          refresh_events=3000, refresh_time_ns=int(0.05e9)),
        optimizer=OptimizerConfig(scale=1, max_iter=10, min_events=500,
                                  scatter_mode="pallas"), f64_totals=True)
    d = synthetic_events(12000, duration_s=0.3, res_x=24, res_y=32, vx=20.0,
                         vy=-10.0, seed=1)
    runs = {}
    for mod, kw in ((jlive, {}), (tlive, {"device": "cpu"})):
        out = dict(clouds=[], images=[], lags=[])
        with jax.enable_x64(mod is jlive):
            vis = mod.EventVisualizer(
                process_data=True, refresh_ns=int(0.066e9), cfg=cfg,
                on_cloud=out["clouds"].append,
                on_images=out["images"].append, on_lag=out["lags"].append,
                **kw)
            for start in range(0, len(d["x"]), 2048):
                sl = slice(start, start + 2048)
                vis.add_events(d["x"][sl], d["y"][sl], d["t_ns"][sl])
        out["iters"] = [s.iters for s in vis.estimator.slices]
        out["model"] = vis.estimator.last_model
        runs[mod] = out
    ot, oj = runs[tlive], runs[jlive]
    assert ot["model"].total_rot.dtype == torch.float64
    assert np.asarray(oj["model"].total_rot).dtype == np.float64
    assert len(ot["clouds"]) == len(oj["clouds"]) >= 3
    for a, b in zip(ot["clouds"], oj["clouds"]):
        np.testing.assert_array_equal(a, b)
    assert len(ot["images"]) == len(oj["images"]) >= 2
    for a, b in zip(ot["images"], oj["images"]):
        for k in ("projection", "color_flow"):
            differ = np.any(a[k] != b[k], axis=-1) if a[k].ndim == 3 \
                else a[k] != b[k]
            assert differ.mean() <= 0.01, (k, differ.mean())
    st, sj = sum(ot["iters"]), sum(oj["iters"])
    assert abs(st - sj) <= 0.1 * sj


# ------------------------------------------------ carry and checkpoint


def test_f64_carry_round_trip_and_jax_hand_off():
    """An f64 carry survives ``carry_to_numpy``/``carry_from_numpy`` bit
    for bit, and the JAX package's f64 carry starts the port's scan with
    f64 totals."""
    d = synthetic_events(8000, duration_s=0.2, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = _small(_ref(), True)
    r = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                        device="cpu")
    vals, seed12, ws, st_h, en_h = carry_to_numpy(r["carry"])
    assert vals.dtype == np.float64 and np.any(vals[7:11] != 0)
    back = carry_from_numpy(vals, seed12, ws, st_h, en_h)
    for f in FIELDS:
        a, b = getattr(back[0], f), getattr(r["carry"][0], f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    with jax.enable_x64():
        ra = jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
        jvals = [np.asarray(v) for v in ra["carry"][0]]
    carry = carry_from_numpy(jvals, np.asarray(ra["carry"][1]), ws, st_h,
                             en_h)
    assert carry[0].total_div.dtype == torch.float64
    assert carry[0].cx.dtype == torch.float32
    assert float(carry[0].total_div) == float(jvals[FIELDS.index(
        "total_div")])


def _feed(engine, d, a, b):
    engine.add_events(d["x"][a:b], d["y"][a:b], d["t_ns"][a:b])


def _finish(engine):
    if len(engine.buffer):
        engine.recompute()
    engine.flush()
    return engine


def test_f64_checkpoint_round_trip_and_across_packages(tmp_path):
    """An f64 stream saved mid-way resumes in the port bit for bit as the
    uninterrupted stream; the file loads in the JAX package (x64 on) with
    f64 totals, and the JAX package's f64 checkpoint loads in the port
    with f64 totals."""
    cfg = _small(_ref(), True).replace(accumulate=True)
    d, cut, n = _small_stream(seed=8), 7000, 14000
    whole = tdvs.DVSFlow(cfg, device="cpu")
    _feed(whole, d, 0, n)
    _finish(whole)
    first = tdvs.DVSFlow(cfg, device="cpu")
    _feed(first, d, 0, cut)
    path = str(tmp_path / "port64.npz")
    tckpt.save_checkpoint(path, first)
    z = np.load(path)
    assert z["model_total_rot"].dtype == np.float64
    assert z["model_rot"].dtype == np.float32
    resumed = tckpt.load_checkpoint(path, tdvs.DVSFlow(cfg, device="cpu"))
    for f in FIELDS:
        a, b = getattr(resumed.last_model, f), getattr(first.last_model, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    _feed(resumed, d, cut, n)
    _finish(resumed)
    want, got = whole.get_accumulated(), resumed.get_accumulated()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    with jax.enable_x64():
        ej = jckpt.load_checkpoint(path, jdvs.DVSFlow(cfg))
        for f in FIELDS:
            a = np.asarray(getattr(ej.last_model, f))
            assert a.dtype == z[f"model_{f}"].dtype, f
            assert a == z[f"model_{f}"], f
        _feed(ej, d, cut, cut + 2000)
        jpath = str(tmp_path / "jax64.npz")
        jckpt.save_checkpoint(jpath, ej)
    back = tckpt.load_checkpoint(jpath, tdvs.DVSFlow(cfg, device="cpu"))
    zj = np.load(jpath)
    for f in FIELDS:
        a = getattr(back.last_model, f)
        assert a.dtype == (torch.float64 if f in TOTAL_FIELDS
                           else torch.float32), f
        assert a.numpy() == zj[f"model_{f}"], f


# -------------------------------------------- f64 + fast: no reference


def test_jax_f64_fast_schedule_raises_type_error():
    """The JAX package's defect, pinned as it is: ``_fast_loop`` starts its
    while-loop carry as f32 and its body returns f64 slope memory and
    deltas once the totals are f64."""
    d = synthetic_events(20000, duration_s=0.3, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    cfg = _small(OptimizerConfig.fast(scale=3, min_events=500,
                                      scatter_mode="pallas"), True)
    with jax.enable_x64():
        with pytest.raises(TypeError, match="carry input and carry output"):
            jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)


def test_port_f64_fast_schedule_raises_not_implemented():
    """The port refuses the combination instead of inventing a result, at
    every entry point and at ``process_slice``."""
    opt = OptimizerConfig.fast(scale=3, min_events=500)
    with pytest.raises(NotImplementedError, match="fast.*TypeError"):
        tgf.check_supported(opt, f64_totals=True)
    tgf.check_supported(opt)
    tgf.check_supported(OptimizerConfig(), f64_totals=True)
    d = slice_inputs(0)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        tgf.process_slice(_t(d["stat"]), _t(d["act"]),
                          MotionModel.zero(f64_totals=True), opt, SENSOR,
                          (0, 23, 0, 31), 5000, seed=torch.zeros(8))
