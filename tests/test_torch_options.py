"""The JAX package's optimizer options on the PyTorch port, against the JAX
package on the same numpy-seeded inputs (its Pallas kernels in interpret
mode, ``scatter_mode="pallas"``), at the sizes of
``tests/test_fast_schedule.py:275-330`` (a 24x32 sensor, capacity 3072):

- B1's and B2's predicated mode (``megastep_unroll``'s converged
  pass-through): the twins against the JAX kernels;
- ``megastep_unroll``: the flat-slice ``process_event_slice`` with 2 and 3
  predicated pairs a loop trip bitwise one, and against the JAX slice;
- ``warm_extrapolate``: the scan against the JAX scan, and ignored by the
  stream and the tiled path;
- ``make_carry``: the JAX signature, the seed's padding, and two ranges
  stitched through ``seed=`` bitwise the full scan;
- ``splat_pair`` and the "rep" / "mxu" scatter modes;
- ``process_event_slice`` on unsorted slices against the JAX package's
  flat ``process_slice``, per-event outputs in the slice's order.

The slice gates are ``tests/test_torch_slice.py``'s (iterations and noise
exact, totals within 1e-4, u and v within rtol 1e-3, atol 1e-2); the scan's
are ``tests/test_torch_scan.py``'s.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import (  # noqa: E402
    OptimizerConfig as JaxOpt, PipelineConfig as JaxPipeline,
    SensorConfig as JaxSensor,
)
from better_flow_tpu.core.events import make_slice as jax_slice  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.models import global_flow as jgf  # noqa: E402
from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, PipelineConfig,
)
from better_flow_tpu_torch.core.events import make_slice  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import make_tiled_mesh  # noqa: E402
from better_flow_tpu_torch.parallel.spatial import (  # noqa: E402
    compensate_recording_tiled,
)
from better_flow_tpu_torch.runtime import offline as toff  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    H, SCALE, SENSOR, W, assert_state_close, bench_stream, flow_gates,
    slice_inputs, small_cfg, statics, tiled_cfg, tiled_stream,
)

ROOT = Path(__file__).resolve().parents[1]
JSENSOR = JaxSensor(SENSOR.res_x, SENSOR.res_y)
CAP = 3072
# The JAX slice compiled whole (one compilation per configuration and
# capacity, shared by the tests of this file).
jax_process_slice = jax.jit(jgf.process_slice, static_argnums=(2, 3))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _opt(cls, schedule, **kw):
    """``test_megastep_split_matches_monolithic_slice``'s configurations,
    in either package: the split drive under both schedules."""
    kw = dict(scale=3, min_events=500, scatter_mode="pallas",
              megastep_split=True, **kw)
    return cls.fast(**kw) if schedule == "fast" else cls(**kw)


def _events(seed=3, n=3000, noise_every=0, pixel=None):
    """test_fast_schedule.py's slice: ``n`` events of a moving scene in
    time order (unsorted in space) on the 24x32 sensor, padded to CAP,
    every ``noise_every``-th flagged noise, all moved to one ``pixel``
    when given; in both packages' layout."""
    d = synthetic_events(n, duration_s=0.1, res_x=24, res_y=32,
                         n_points=60, seed=seed, vx=8.0, vy=-5.0, rot=0.05,
                         div=0.02)
    if pixel is not None:
        d["x"] = np.full(n, pixel[0], d["x"].dtype)
        d["y"] = np.full(n, pixel[1], d["y"].dtype)
    t = d["t_ns"].astype(np.float64)
    noise = np.zeros(n, bool)
    if noise_every:
        noise[::noise_every] = True
    return (jax_slice(d["x"], d["y"], t, capacity=CAP, noise=noise),
            make_slice(d["x"], d["y"], t, capacity=CAP, noise=noise))


def _assert_slice_close(rt, rj):
    """The slice gates, every per-event output in the slice's order."""
    assert rt.iters == int(rj.iters)
    assert rt.ran == bool(rj.ran)
    assert rt.window_small == bool(rj.window_small)
    for f in ("total_dx", "total_dy", "total_rot", "total_div"):
        a, b = float(getattr(rj.model, f)), float(getattr(rt.model, f))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a)), (f, a, b)
    for f in ("u", "v", "pr_x", "pr_y"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-3,
                                   atol=1e-2, err_msg=f)
    np.testing.assert_array_equal(rt.noise.numpy(), np.asarray(rj.noise))


# ------------------------------------------ (a) B1 and B2, predicated


@pytest.mark.parametrize("cont", [0.0, 1.0])
def test_predicated_b1_b2_twins_match_pallas(cont):
    """B1 and B2 with ``predicated=1``: a state whose CONT is 0 passes
    through (the positions into ``new_pr``, the state into the next
    state, the pair untouched), bitwise, as the JAX kernels do; a live
    state gives bitwise the unpredicated twins, and the JAX kernels'
    results within the tolerances of tests/test_torch_kernels.py: the
    images and the next state against the predicated JAX kernels, the
    positions against the unpredicated B1.  (In interpret mode the JAX
    package's predicated B1 computes its positions up to 1.2e-4 away from
    its own unpredicated B1, its images bitwise: XLA compiles the body
    under ``pl.when`` without the fused multiply-adds that the
    unpredicated body gets and that the port reproduces.)"""
    d = slice_inputs(0)
    d["st"][0, layout.ST_CONT] = cont
    args = [d[k] for k in ("stat", "act", "pr", "st", "geo")]
    kw = dict(scale=SCALE, H=H, W=W, time_lo=True)
    npr_j, at_j, ac_j = jfm.warp_images_st_call(
        *(jnp.asarray(a) for a in args), predicated=1, **kw)
    npr, at, ac = tfm.warp_images_st_call(
        *(_t(a) for a in args), *tfm.image_pair("cpu", H, W), predicated=1,
        **kw)
    fin = dict(scale=SCALE, H=H, W=W, **statics())
    st_j = jfm.megastep_finish_call(
        jnp.asarray(tfm.time_image_f32(at).numpy()),
        jnp.asarray(ac.numpy().astype(np.float32)), jnp.asarray(d["st"]),
        jnp.asarray(d["geo"]), predicated=1, **fin)
    pair = (at.clone(), ac.clone())
    st = tfm.megastep_finish_call(*pair, _t(d["st"]), _t(d["geo"]),
                                  predicated=1, **fin)
    if cont == 0.0:
        np.testing.assert_array_equal(np.asarray(npr_j), d["pr"])
        assert not np.asarray(ac_j).any() and not np.asarray(at_j).any()
        assert torch.equal(npr, _t(d["pr"]))
        assert not at.any() and not ac.any()
        np.testing.assert_array_equal(np.asarray(st_j), d["st"])
        assert torch.equal(st, _t(d["st"]))
        # B2 leaves the pair as it is, whatever it holds.
        full = (torch.ones_like(at), torch.ones_like(ac))
        tfm.megastep_finish_call(*full, _t(d["st"]), _t(d["geo"]),
                                 predicated=1, **fin)
        assert bool((full[0] == 1).all() and (full[1] == 1).all())
        return
    plain = tfm.warp_images_st_call(*(_t(a) for a in args),
                                    *tfm.image_pair("cpu", H, W), **kw)
    assert all(torch.equal(a, b) for a, b in zip((npr, at, ac), plain))
    assert int(ac.sum()) > 3000
    npr_j0 = jfm.warp_images_st_call(*(jnp.asarray(a) for a in args),
                                     **kw)[0]
    np.testing.assert_allclose(npr.numpy(), np.asarray(npr_j0), rtol=1e-6)
    np.testing.assert_array_equal(ac.numpy().astype(np.float32),
                                  np.asarray(ac_j))
    np.testing.assert_allclose(tfm.time_image_f32(at).numpy(),
                               np.asarray(at_j), rtol=1e-5, atol=1e-6)
    assert not pair[0].any() and not pair[1].any()    # left zero
    assert torch.equal(st, tfm.megastep_finish_call(
        at.clone(), ac.clone(), _t(d["st"]), _t(d["geo"]), **fin))
    assert_state_close(st.numpy()[0], np.asarray(st_j)[0])


# ----------------------------------------------- (b) megastep_unroll


@pytest.mark.parametrize("schedule", ["fast", "reference"])
def test_megastep_unroll_is_bitwise_one_iteration_a_trip(schedule):
    """The port of ``test_megastep_split_matches_monolithic_slice``:
    ``megastep_unroll`` 2 and 3 give bitwise the slice of 1, iterations
    included, with one blocking read a trip (ceil(iters / unroll)), and
    the JAX slice under ``megastep_unroll=2`` within the slice gates."""
    evj, evt = _events()
    runs = {u: tgf.process_event_slice(
        evt, MotionModel.zero(), _opt(OptimizerConfig, schedule,
                                      megastep_unroll=u), SENSOR)
            for u in (1, 2, 3)}
    one = runs[1]
    assert one.ran and one.iters >= 4 and one.reads == one.iters
    for u in (2, 3):
        r = runs[u]
        assert r.iters == one.iters and r.reads == -(-one.iters // u)
        for f in ("u", "v", "noise", "pr_x", "pr_y", "nx", "ny", "seed"):
            assert torch.equal(getattr(r, f), getattr(one, f)), (u, f)
        assert torch.equal(r.model.totals4(), one.model.totals4())
    rj = jax_process_slice(evj, JaxModel.zero(),
                           _opt(JaxOpt, schedule, megastep_unroll=2),
                           JSENSOR)
    _assert_slice_close(runs[2], rj)


def test_unroll_is_ignored_off_the_split_drive(monkeypatch):
    """As in the JAX package, only the single-device split drive unrolls:
    the monolithic megastep (B5) runs one iteration a trip whatever
    ``megastep_unroll`` says, and no launch is predicated."""
    evj, evt = _events(seed=4)
    seen = []
    real = tgf.warp_images_st_call

    def spy(*a, **k):
        seen.append(k.get("predicated", 0))
        return real(*a, **k)

    monkeypatch.setattr(tgf, "warp_images_st_call", spy)
    mono = tgf.process_event_slice(
        evt, MotionModel.zero(),
        OptimizerConfig(scale=3, min_events=500, megastep_unroll=4), SENSOR)
    assert not seen and mono.reads == mono.iters >= 2
    split = tgf.process_event_slice(
        evt, MotionModel.zero(),
        OptimizerConfig(scale=3, min_events=500, megastep_split=True,
                        megastep_unroll=4), SENSOR)
    assert set(seen) == {1} and len(seen) == 4 * split.reads
    assert split.iters == mono.iters
    assert torch.equal(split.u, mono.u)


# ---------------------------------------------- (c) warm_extrapolate


def test_warm_extrapolate_scan_matches_jax():
    """``fast(warm_extrapolate=1.0)`` on the production geometry (bench.py's
    stream, 100,000 events, five slices) against the JAX scan under the
    gates of tests/test_torch_scan.py; the slices' iterations are equal
    one for one, and the extrapolation moved the result (it is not the
    plain warm start's).  On 24x32 the extrapolated chain magnifies the
    small-sensor drift (ROADMAP C) within a few slices."""
    d = bench_stream(100_000)
    opt = dict(scatter_mode="pallas", warm_extrapolate=1.0)
    rj = jscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"],
        JaxPipeline(optimizer=JaxOpt.fast(**opt)))
    cfg = PipelineConfig(optimizer=OptimizerConfig.fast(**opt))
    rt = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    assert len(rt["iters"]) == 5 and rt["ran"].all()
    ok = flow_gates(rt, rj)
    np.testing.assert_array_equal(rt["iters"], np.asarray(rj["iters"]))
    aee = lambda r: float(np.median(np.hypot(r["u"][ok] - d["u"][ok],
                                             r["v"][ok] - d["v"][ok])))
    assert aee(rt) <= 1.05 * aee(rj)
    plain = tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg.replace(
            optimizer=OptimizerConfig.fast(scatter_mode="pallas")),
        device="cpu")
    assert not np.array_equal(plain["iters"], rt["iters"])
    assert rt["stats"]["host_syncs"] == int(rt["iters"].sum())


def test_warm_extrapolate_off_and_ignored_paths_are_bitwise(monkeypatch):
    """Alpha 0 passes no start model (today's scan, bitwise); the stream
    (``DVSFlow``) and the tiled path ignore a non-zero alpha, bitwise,
    as the JAX package's do.  At alpha 0 the scan's loop carries the
    state on the device: a slice that runs starts from the state the
    previous slice's B4 handed on (``handoff``, no model), a skipped one
    takes ``process_slice`` without a start model."""
    d = synthetic_events(12000, duration_s=0.3, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    starts, handed = [], []
    real = tscan.process_slice
    real_drive = tgf.run_fused_mega

    def spy(*a, **k):
        starts.append(k.get("start_model"))
        return real(*a, **k)

    def drive(*a, **k):
        handed.append(k.get("handoff") is not None)
        return real_drive(*a, **k)

    monkeypatch.setattr(tscan, "process_slice", spy)
    monkeypatch.setattr(tgf, "run_fused_mega", drive)
    base = small_cfg(scatter_mode="pallas")
    off = tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], small_cfg(scatter_mode="pallas",
                                             warm_extrapolate=0.0),
        device="cpu")
    assert all(handed) and len(starts) + len(handed) == len(off["iters"])
    assert set(starts) <= {None}
    on = tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], small_cfg(scatter_mode="pallas",
                                             warm_extrapolate=1.0),
        device="cpu")
    assert sum(s is not None for s in starts) == len(on["iters"])
    ref = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], base,
                                          device="cpu")
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(off[k], ref[k])
    stream = lambda c: toff.compensate_recording(
        d["x"], d["y"], d["t_ns"], c, device="cpu")["accumulated"]
    sa, sb = stream(base), stream(small_cfg(scatter_mode="pallas",
                                            warm_extrapolate=1.0))
    for k in ("u", "v", "noise"):
        np.testing.assert_array_equal(sa[k], sb[k])
    dt = tiled_stream(n=8000)
    tiled = lambda a: compensate_recording_tiled(
        dt["x"], dt["y"], dt["t_ns"], tiled_cfg(optimizer=OptimizerConfig(
            scale=1, max_iter=10, min_events=300, warm_extrapolate=a)),
        make_tiled_mesh((1, 1), device="cpu"), halo=8)
    ta, tb = tiled(0.0), tiled(1.0)
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(ta[k], tb[k])


# --------------------------------------------------- (d) make_carry


def test_make_carry_has_the_jax_signature_and_seed_rule():
    """Parameter names and order of the JAX package's ``make_carry`` (read
    from its source), and its seed rule: (12,) as given, (8,) padded with
    the model's f32 totals, None zeros and those totals."""
    src = (ROOT / "better_flow_tpu" / "runtime" /
           "scan_pipeline.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "make_carry")
    jax_params = [a.arg for a in fn.args.args]
    assert list(inspect.signature(tscan.make_carry).parameters) == \
        jax_params == ["init_model", "hist_k", "seed", "ws_h", "st_h",
                       "en_h"]
    vals = np.random.default_rng(1).normal(0, 1e-2, 15).astype(np.float32)
    mj = JaxModel(*(jnp.float32(v) for v in vals))
    mt = MotionModel(*(torch.tensor(v) for v in vals))
    seed8 = np.arange(1, 9, dtype=np.float32) * 1e-3
    seed12 = np.arange(1, 13, dtype=np.float32) * 1e-3
    for seed in (None, seed8, seed12):
        cj = jscan.make_carry(mj, 3, seed=None if seed is None
                              else jnp.asarray(seed))
        ct = tscan.make_carry(mt, 3, seed=None if seed is None
                              else torch.from_numpy(seed))
        np.testing.assert_array_equal(ct[1].numpy(), np.asarray(cj[1]))
        for a, b in zip(ct[2:], cj[2:]):
            np.testing.assert_array_equal(a, np.asarray(b))
    # The third positional argument is the seed, as in the JAX package.
    assert torch.equal(tscan.make_carry(mt, 3, torch.from_numpy(seed12))[1],
                       torch.from_numpy(seed12))
    with pytest.raises(ValueError, match="seed"):
        tscan.make_carry(mt, 3, seed=torch.zeros(5))


@pytest.mark.parametrize("schedule", ["fast_extrapolated", "reference"])
def test_ranges_stitched_through_the_seed_are_the_full_scan(schedule):
    """tests/test_scan_pipeline.py's range protocol: the first range's
    carry hands its model and seed to the second through
    ``make_carry(..., seed=carry[1], ws_h=...)``; the two ranges' claims put
    end to end are bitwise the full scan (under ``fast(warm_extrapolate=
    1.0)`` the seed's trailing totals carry the extrapolation across the
    boundary)."""
    d = synthetic_events(20000, duration_s=0.35, res_x=24, res_y=32,
                         vx=20.0, vy=-14.0, seed=2)
    cfg = small_cfg(scatter_mode="pallas", warm_extrapolate=1.0) \
        if schedule == "fast_extrapolated" else small_cfg(
            scatter_mode="pallas").replace(optimizer=OptimizerConfig(
                scale=3, min_events=500, scatter_mode="pallas"))
    args = (d["x"], d["y"], d["t_ns"], cfg)
    full = tscan.compensate_recording_scan(*args, device="cpu")
    S = len(full["iters"])
    mid = S // 2
    p0 = tscan.prepare_recording(*args, slice_range=(0, mid), device="cpu")
    r0 = tscan.compensate_recording_scan(None, None, None, cfg, prepared=p0)
    p1 = tscan.prepare_recording(*args, slice_range=(mid, S), device="cpu")
    ws_h, st_h, en_h = p1["hist0"]
    carry = tscan.make_carry(r0["carry"][0], p1["hist_k"],
                             seed=r0["carry"][1], ws_h=ws_h, st_h=st_h,
                             en_h=en_h)
    r1 = tscan.compensate_recording_scan(None, None, None, cfg, prepared=p1,
                                         carry_in=carry)
    cut = p1["prev_end"] + 1
    for k in ("u", "v", "noise"):
        np.testing.assert_array_equal(
            np.concatenate([r0[k][:cut], r1[k][cut:]]), full[k])
    np.testing.assert_array_equal(
        np.concatenate([r0["iters"], r1["iters"]]), full["iters"])
    assert torch.equal(r1["carry"][1], full["carry"][1])


# ------------------------------------- (e) splat_pair, "rep" and "mxu"


def test_splat_pair_selects_nothing_and_matches_jax():
    """``splat_pair=2`` is bitwise ``splat_pair=1`` in the port (B1 runs
    one slot a thread) and holds the slice gates against the JAX slice
    under ``splat_pair=2`` (two chunks a grid step there)."""
    evj, evt = _events()
    runs = [tgf.process_event_slice(
        evt, MotionModel.zero(), _opt(OptimizerConfig, "fast",
                                      splat_pair=p), SENSOR) for p in (1, 2)]
    for f in ("u", "v", "noise", "pr_x", "pr_y"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    assert runs[1].iters == runs[0].iters >= 4
    rj = jax_process_slice(evj, JaxModel.zero(),
                           _opt(JaxOpt, "fast", splat_pair=2), JSENSOR)
    _assert_slice_close(runs[1], rj)


@pytest.mark.parametrize("mode", ["rep", "mxu"])
def test_rep_and_mxu_slices_match_jax(mode):
    """An XLA-branch slice under "rep" and "mxu": the JAX package's slice
    in that mode within the slice gates (the time sums there carry the
    mode's rounding, the port's are exact), and bitwise the port's "xla"
    slice."""
    evj, evt = _events(seed=4)
    kw = dict(scale=3, min_events=500)
    rj = jax_process_slice(evj, JaxModel.zero(),
                           JaxOpt(scatter_mode=mode, **kw), JSENSOR)
    rt = tgf.process_event_slice(
        evt, MotionModel.zero(), OptimizerConfig(scatter_mode=mode, **kw),
        SENSOR)
    assert rt.ran and rt.iters >= 3
    _assert_slice_close(rt, rj)
    rx = tgf.process_event_slice(
        evt, MotionModel.zero(), OptimizerConfig(scatter_mode="xla", **kw),
        SENSOR)
    for f in ("u", "v", "noise", "pr_x"):
        assert torch.equal(getattr(rt, f), getattr(rx, f)), f


# ----------------------------------------- (f) the flat-slice form


@pytest.mark.parametrize("case", ["noise_flags", "window_gate", "too_few"])
def test_process_event_slice_matches_jax_flat_slice(case):
    """``process_event_slice`` on an unsorted slice padded to capacity:
    with noise flags on every 7th event, a slice whose window gate fires
    (events on a few pixels: every valid event noise, no iteration) and a
    slice below ``min_events`` (no iteration, no noise); every per-event
    output in the slice's order against the JAX package's flat
    ``process_slice`` (which sorts by ``sort_key_blocks`` itself), under
    the fast split drive unrolled by 2."""
    if case == "noise_flags":
        evj, evt = _events(seed=5, noise_every=7)
    elif case == "window_gate":          # every event on one pixel
        evj, evt = _events(seed=6, n=2000, pixel=(7, 9))
    else:
        evj, evt = _events(seed=7, n=450)
    rng = np.random.default_rng(0)
    perm = rng.permutation(CAP)          # padding slots among the events
    evj = evj._replace(**{f: jnp.asarray(np.asarray(getattr(evj, f))[perm])
                          for f in evj._fields})
    evt = evt._replace(**{f: getattr(evt, f)[torch.from_numpy(perm)]
                          for f in evt._fields})
    opt = dict(megastep_unroll=2)
    rj = jax_process_slice(evj, JaxModel.zero(), _opt(JaxOpt, "fast", **opt),
                           JSENSOR)
    rt = tgf.process_event_slice(evt, MotionModel.zero(),
                                 _opt(OptimizerConfig, "fast", **opt),
                                 SENSOR)
    _assert_slice_close(rt, rj)
    assert rt.u.shape == (CAP,)
    if case == "window_gate":
        assert rt.window_small and not rt.ran and rt.iters == 0
        assert torch.equal(rt.noise, evt.valid)
    elif case == "too_few":
        assert not rt.ran and not rt.window_small and not rt.noise.any()
    else:
        assert rt.ran and torch.equal(rt.noise, evt.noise)
    # The staged call on the sorted slice, un-permuted, bitwise.
    order = torch.argsort(layout.sort_key_blocks(evt.x, evt.y, evt.valid),
                          stable=True)
    sev = type(evt)(*(f[order] for f in evt))
    presorted = tgf.process_event_slice(sev, MotionModel.zero(),
                                        _opt(OptimizerConfig, "fast", **opt),
                                        SENSOR, presorted=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(CAP)
    for f in ("u", "v", "noise", "pr_x", "ny"):
        assert torch.equal(getattr(presorted, f)[inv], getattr(rt, f)), f
