"""The tiled pipeline of the PyTorch port against the JAX package, one
slice at a time: ``better_flow_tpu_torch/parallel/spatial.py`` against
``better_flow_tpu/parallel/spatial.py``.

The same numpy-seeded inputs go through both.  The JAX side runs under
``shard_map`` on the virtual CPU devices of ``tests/conftest.py`` (its XLA
scatter branch, what ``scatter_mode="auto"`` takes off the TPU); the port
holds all tiles in one process and runs the twins of B8 and B9.

Tolerances.  The strip exchanges move integer-valued images: exact.  The
staging is numpy on both sides: array for array.  A slice's optimizer: the
JAX package sums the time image in f32 in scatter order and the seven sums
in f32, the port in fixed point and f64, so each iteration agrees to ~1e-6
and the chain amplifies it: the totals to rtol 2e-3 (atol 1e-6; the JAX
package's own tiled-against-untiled tests use 1e-3 to 5e-3), equal
iteration counts under the adaptive schedule, and per-event flow with
median |du|, |dv| <= 0.5% of the mean speed.  The port's own meshes against
its 1x1 run are held tighter (rtol 2e-4): their images are the same
integers, only the per-tile f32 sums differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from better_flow_tpu.config import (  # noqa: E402
    OptimizerConfig as JaxOptimizerConfig,
    SensorConfig as JaxSensorConfig,
)
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.parallel import spatial as jsp  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, SensorConfig,
)
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.parallel import spatial as tsp  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import make_tiled_mesh  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import tiled_cfg, tiled_stream  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins work on small tensors; one intra-op thread keeps parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(nx, ny):
    if len(jax.devices()) < nx * ny:
        pytest.skip(f"needs {nx * ny} virtual devices")
    return jax.make_mesh((nx, ny), ("tile_x", "tile_y"),
                         devices=jax.devices()[:nx * ny])


def _cpu_mesh(nx, ny):
    return make_tiled_mesh((nx, ny), device="cpu")


@pytest.mark.parametrize("scale,res", [(1, (95, 127)), (3, (31, 41))])
def test_strip_exchanges_match_jax(scale, res):
    """Fold-in (x then y) and broadcast-back of a 4x2 mesh's local images
    against ``_halo_exchange_add`` / ``_halo_broadcast`` under shard_map:
    integer-valued images, so both are exact."""
    nx, ny, halo = 4, 2, 8
    tl = tsp._Tiling(SensorConfig(*res), scale, _cpu_mesh(nx, ny), halo)
    Hl, Wl, g = tl.H, tl.W, 1 + scale // 2
    rng = np.random.default_rng(scale)
    imgs = rng.integers(0, 50, (nx * ny, Hl, Wl))
    glob = imgs.reshape(nx, ny, Hl, Wl).transpose(0, 2, 1, 3).reshape(
        nx * Hl, ny * Wl).astype(np.float32)

    def fold(img):
        img = jsp._halo_exchange_add(img, halo, 0, jsp.AX_X)
        return jsp._halo_exchange_add(img, halo, 1, jsp.AX_Y)

    def both(img):
        img = jsp._halo_broadcast(fold(img), halo, g, 0, jsp.AX_X)
        return jsp._halo_broadcast(img, halo, g, 1, jsp.AX_Y)

    spec = P(jsp.AX_X, jsp.AX_Y)
    run = lambda fn: np.asarray(jax.shard_map(
        fn, mesh=_jax_mesh(nx, ny), in_specs=spec, out_specs=spec,
        check_vma=False)(jnp.asarray(glob)))
    local = lambda a: a.reshape(nx, Hl, ny, Wl).transpose(0, 2, 1, 3).reshape(
        nx * ny, Hl, Wl)
    for dtype in (torch.int64, torch.int32):
        img = torch.from_numpy(imgs.copy()).to(dtype)
        for axis in (0, 1):
            tl.fold_in(img, axis)
        np.testing.assert_array_equal(img.numpy(), local(run(fold)))
        for axis in (0, 1):
            tl.broadcast_back(img, axis)
        np.testing.assert_array_equal(img.numpy(), local(run(both)))
    assert not np.array_equal(run(fold), glob)
    # A corner pixel rides through both phases: tile (0, 0)'s far corner of
    # the halo lands in tile (1, 1)'s interior.
    one = torch.zeros((nx * ny, Hl, Wl), dtype=torch.int64)
    one[0, Hl - 1, Wl - 1] = 7
    for axis in (0, 1):
        tl.fold_in(one, axis)
    assert int(one[ny + 1, 2 * halo - 1, 2 * halo - 1]) == 7


@pytest.mark.parametrize("mesh", [(1, 1), (4, 1), (2, 2), (4, 2)])
def test_bucketing_matches_jax(mesh):
    nx, ny = mesh
    d = tiled_stream(4000, seed=11)
    t = (d["t_ns"] - d["t_ns"][0]).astype(np.float32)
    idx = np.arange(len(t), dtype=np.int32)[::-1].copy()
    for cap in (None, 4096):
        a = jsp.bucket_events_2d(d["x"], d["y"], t, 96, 128, 1, nx, ny, cap,
                                 idx=idx)
        b = tsp.bucket_events_2d(d["x"], d["y"], t, 96, 128, 1, nx, ny, cap,
                                 idx=idx)
        assert len(a) == len(b) == 5
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    # Inside a bucket the events are in (x, y) order.
    xs, ys, _ts, ok = b[:4]
    per = len(xs) // (nx * ny)
    for k in range(nx * ny):
        m = ok[k * per:(k + 1) * per]
        key = xs[k * per:(k + 1) * per][m] * 4096 + ys[k * per:(k + 1) * per][m]
        assert (np.diff(key) >= 0).all() and not m[int(m.sum()):].any()
    if ny == 1:
        for u, v in zip(jsp.bucket_events(d["x"], d["y"], t, 96, 1, nx, 4096),
                        tsp.bucket_events(d["x"], d["y"], t, 96, 1, nx, 4096)):
            np.testing.assert_array_equal(u, v)
    if nx * ny > 1:
        with pytest.raises(ValueError, match="tile overflow"):
            tsp.bucket_events_2d(d["x"], d["y"], t, 96, 128, 1, nx, ny, 16)
        # Not raising keeps the first events of a too-full tile, as JAX.
        for u, v in zip(
                jsp.bucket_events_2d(d["x"], d["y"], t, 96, 128, 1, nx, ny,
                                     16, on_overflow="keep"),
                tsp.bucket_events_2d(d["x"], d["y"], t, 96, 128, 1, nx, ny,
                                     16, on_overflow="keep")):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 2)])
def test_recording_staging_matches_jax(mesh):
    nx, ny = mesh
    d = tiled_stream(20_000, seed=12)
    cfg = tiled_cfg()
    a = jsp.prepare_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, nx, ny)
    b = tsp.prepare_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, nx, ny)
    assert b["cap_per_tile"] == a["cap_per_tile"] and b["n"] == a["n"]
    assert b["hist_k"] == a["hist_k"] and b["cap_per_tile"] % 8 == 0
    for k in ("xb", "yb", "tb", "idx", "bbox", "nval"):
        assert b[k].dtype == np.asarray(a[k]).dtype, k
        np.testing.assert_array_equal(b[k], np.asarray(a[k]))
    for u, v in zip(a["plan"], b["plan"]):
        np.testing.assert_array_equal(u, v)
    assert len(b["plan"].ends) >= 6
    # host_bbox alone, and a fixed capacity.
    for u, v in zip(jscan.host_bbox(d["x"], d["y"], a["plan"]),
                    tscan.host_bbox(d["x"], d["y"], b["plan"])):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    b2 = tsp.prepare_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, nx, ny,
                                     cap_per_tile=b["cap_per_tile"] + 8)
    assert b2["xb"].shape[1] == nx * ny * (b["cap_per_tile"] + 8)
    with pytest.raises(ValueError, match="tile overflow"):
        tsp.prepare_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, nx, ny,
                                    cap_per_tile=8)


SENSOR = (48, 64)


def _slice_stream(vx=40.0, vy=-25.0, seed=0):
    d = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=64, vx=vx,
                         vy=vy, n_points=100, seed=seed)
    return d, d["t_ns"].astype(np.float32)


def _run_both(mesh, d, t, scale, halo, n_iters, esc_cap=4096, max_iter=12):
    nx, ny = mesh
    args = tsp.bucket_events_2d(d["x"], d["y"], t, *SENSOR, scale, nx, ny,
                                None)
    kw = dict(scale=scale, max_iter=max_iter, min_events=100)
    rj = jsp.process_slice_tiled(
        *args, JaxModel.zero(), JaxOptimizerConfig(**kw),
        JaxSensorConfig(*SENSOR), _jax_mesh(nx, ny), halo=halo,
        n_iters=n_iters, esc_cap=esc_cap)
    rt = tsp.process_slice_tiled(
        *args, MotionModel.zero(), OptimizerConfig(**kw),
        SensorConfig(*SENSOR), _cpu_mesh(nx, ny), halo=halo, n_iters=n_iters,
        esc_cap=esc_cap)
    return rj, rt, args[3]


def _assert_slices_agree(rj, rt, ok, rtol=2e-3):
    for f in ("total_dx", "total_dy", "total_rot", "total_div", "cx", "cy"):
        np.testing.assert_allclose(float(getattr(rt.model, f)),
                                   float(getattr(rj.model, f)), rtol=rtol,
                                   atol=1e-6, err_msg=f)
    # An ulp in a warped position moves an event across a pixel edge.
    assert abs(float(rt.model.cnt) - float(rj.model.cnt)) <= 2 \
        and float(rj.model.cnt) > 300
    uj, vj = np.asarray(rj.u)[ok], np.asarray(rj.v)[ok]
    speed = float(np.hypot(uj, vj).mean())
    assert speed > 20.0
    assert np.median(np.abs(rt.u.numpy()[ok] - uj)) <= 0.005 * speed
    assert np.median(np.abs(rt.v.numpy()[ok] - vj)) <= 0.005 * speed
    np.testing.assert_allclose(rt.pr_x.numpy()[ok], np.asarray(rj.pr_x)[ok],
                               atol=0.02)


@pytest.mark.parametrize("mesh,scale,n_iters", [
    ((1, 1), 3, 6), ((4, 1), 3, 6), ((2, 2), 3, 6), ((2, 2), 1, 6),
    ((1, 1), 3, None), ((4, 1), 3, None), ((2, 2), 1, None)])
def test_process_slice_tiled_matches_jax(mesh, scale, n_iters):
    """One slice on 1x1, 4x1 and 2x2 tiles, a fixed count and the adaptive
    schedule (None), against the JAX package on the same buckets."""
    d, t = _slice_stream()
    rj, rt, ok = _run_both(mesh, d, t, scale, halo=16, n_iters=n_iters)
    assert rt.iters == int(rj.iters) and rt.iters > 1
    assert rt.escaped_dropped == int(rj.escaped_dropped) == 0
    _assert_slices_agree(rj, rt, ok)
    assert rt.u.shape == rt.pr_x.shape == (len(ok),)


@pytest.mark.parametrize("scale", [1, 3])
def test_jax_loop_fed_the_twins_is_bitwise(monkeypatch, scale):
    """Which arithmetic XLA compiles for the tiled iteration: the JAX loop
    (``scatter_mode="pallas"``, a 1x1 mesh, so no f32 strip sums) is fed the
    port's twins of B8 and B9 through ``jax.pure_callback``, so that both
    chains see the same images and sums.  After two iterations the warped
    positions are then bitwise the port's (the scaled truncation, ``t / 1e9``
    and ``/ scale`` as reciprocal multiplications, the warp's and the
    shift's multiply-adds fused), the model's fields too but for the Kahan
    residue of the rot/div chain (an ulp in ``total_div``, ROADMAP C) and
    the flow of the few events it moves."""
    from better_flow_tpu.ops.pallas import fused_model as jfm
    from better_flow_tpu_torch.ops import fused_model as tfm

    t_ = lambda a: torch.from_numpy(np.array(a))

    def splat(lx, ly, t_sec, Hl, Wl, time_lo=True):
        def host(lx, ly, t):
            at, ac = tfm.splat_local_call(
                t_(lx)[None], t_(ly)[None], t_(t)[None],
                *tfm.image_pair("cpu", Hl, Wl, n_tiles=1), H=Hl, W=Wl,
                time_lo=time_lo)
            at, ac = at[0, :Hl, :Wl].contiguous(), ac[0, :Hl, :Wl]
            return (tfm.time_image_f32(at).numpy(),
                    ac.to(torch.float32).numpy())
        shape = jax.ShapeDtypeStruct((Hl, Wl), jnp.float32)
        return jax.pure_callback(host, (shape, shape), lx, ly, t_sec)

    def finish(tsum, cnt, sc, Hl, Wl, r0, r1, c0, c1):
        def host(tsum, cnt):
            # The f32 image's fixed-point value converts back to itself.
            at, ac = tfm.image_pair("cpu", Hl, Wl, n_tiles=1)
            at[0, :Hl, :Wl] = tfm.to_fixed(t_(tsum))
            ac[0, :Hl, :Wl] = t_(cnt).to(torch.int32)
            return tfm.finish_local_call(at, ac, scale=sc, H=Hl, W=Wl,
                                         own=(r0, r1, c0, c1))[0].numpy()
        out = jax.pure_callback(host, jax.ShapeDtypeStruct((8,), jnp.float32),
                                tsum, cnt)
        return dict(zip(("cnt", "s_row", "s_col", "s_gx", "s_gy", "s_rg",
                         "s_dg"), out))

    monkeypatch.setattr(jfm, "splat_local_call", splat)
    monkeypatch.setattr(jfm, "finish_local_call", finish)
    d, t = _slice_stream()
    x, y = (np.asarray(d[k], np.float32) for k in ("x", "y"))
    ok = np.ones(len(t), bool)
    kw = dict(scale=scale, max_iter=6, min_events=100)
    rj = jsp.process_slice_tiled(
        x, y, t, ok, JaxModel.zero(),
        JaxOptimizerConfig(scatter_mode="pallas", **kw),
        JaxSensorConfig(*SENSOR), _jax_mesh(1, 1), halo=24, n_iters=2)
    rt = tsp.process_slice_tiled(
        x, y, t, ok, MotionModel.zero(), OptimizerConfig(**kw),
        SensorConfig(*SENSOR), _cpu_mesh(1, 1), halo=24, n_iters=2)
    bits = lambda a: np.asarray(a, np.float32).view(np.int32)
    np.testing.assert_array_equal(bits(rt.pr_x.numpy()), bits(rj.pr_x))
    np.testing.assert_array_equal(bits(rt.pr_y.numpy()), bits(rj.pr_y))
    for f in ("cx", "cy", "dx", "dy", "rot", "div", "cnt", "total_dx",
              "total_dy", "total_rot"):
        assert bits(getattr(rt.model, f).numpy()) == \
            bits(getattr(rj.model, f)), f
    np.testing.assert_allclose(float(rt.model.total_div),
                               float(rj.model.total_div), rtol=3e-7)
    assert int((bits(rt.u.numpy()) != bits(rj.u)).sum()) <= 5
    assert float(rt.model.cnt) > 300 and abs(float(rt.model.total_dx)) > 1e-3


def test_tiles_match_the_ports_own_untiled_run():
    """4x1, 2x2 and 4x2 tiles against the port's 1x1 run of the same slice:
    equal iteration counts, the totals to rtol 2e-4."""
    d, t = _slice_stream()
    cfg = OptimizerConfig(scale=3, max_iter=12, min_events=100)
    runs = {}
    for mesh in ((1, 1), (4, 1), (2, 2), (4, 2)):
        args = tsp.bucket_events_2d(d["x"], d["y"], t, *SENSOR, 3, *mesh,
                                    None, idx=np.arange(len(t)))
        r = tsp.process_slice_tiled(*args[:4], MotionModel.zero(), cfg,
                                    SensorConfig(*SENSOR), _cpu_mesh(*mesh),
                                    halo=16)
        u = np.zeros(len(t), np.float32)
        u[args[4][args[3]]] = r.u.numpy()[args[3]]    # original event order
        runs[mesh] = (r, u)
    r1, u1 = runs[1, 1]
    for mesh in ((4, 1), (2, 2), (4, 2)):
        r, u = runs[mesh]
        assert r.iters == r1.iters > 2 and r.escaped_dropped == 0
        for f in ("total_dx", "total_dy", "total_rot", "total_div"):
            np.testing.assert_allclose(float(getattr(r.model, f)),
                                       float(getattr(r1.model, f)),
                                       rtol=2e-4, atol=1e-7, err_msg=f)
        np.testing.assert_allclose(u, u1, atol=0.05)


def test_beyond_halo_escape_lane_matches_jax():
    """A fast scene whose converged warp far exceeds an 8-pixel halo, 4x1
    tiles: the sized lane drops nothing and reproduces the 1x1 run (the lane
    carried the events); a starved lane (``esc_cap=1``) reports the JAX
    package's dropped count."""
    d, t = _slice_stream(vx=80.0, vy=-50.0, seed=3)
    rj, rt, ok = _run_both((4, 1), d, t, 3, halo=8, n_iters=16, max_iter=16)
    assert rt.escaped_dropped == int(rj.escaped_dropped) == 0
    _assert_slices_agree(rj, rt, ok)
    _, r1, ok1 = _run_both((1, 1), d, t, 3, halo=8, n_iters=16, max_iter=16)
    np.testing.assert_allclose(float(rt.model.total_dx),
                               float(r1.model.total_dx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(rt.model.total_dy),
                               float(r1.model.total_dy), rtol=1e-4, atol=1e-6)
    assert abs(np.median(r1.u.numpy()[ok1]) - 80.0) < 8.0
    sj, st_, _ = _run_both((4, 1), d, t, 3, halo=8, n_iters=16, esc_cap=1,
                           max_iter=16)
    assert st_.escaped_dropped == int(sj.escaped_dropped) > 0
    # Without the lane's events the starved run is a different result.
    assert float(st_.model.total_dx) != float(rt.model.total_dx)


def test_2x2_pair_and_escape_lane_match_jax(monkeypatch):
    """2x2 tiles, an 8-pixel halo and a fast scene, so that the escape lane
    adds events into the run's padded pair, against the JAX package: every
    iteration's B9 gets the run's one pair, whose padding B8, the seams and
    the lane left zero, and leaves all of it zero."""
    from better_flow_tpu_torch.ops.layout import padded_image_shape

    pairs, lanes = [], []
    finish, lane = tsp.finish_local_call, tsp._escape_lane

    def checked_finish(acc_t, acc_c, *, H, W, **kw):
        pairs.append((acc_t.data_ptr(), acc_c.data_ptr()))
        for a in (acc_t, acc_c):
            assert tuple(a.shape[1:]) == padded_image_shape(H, W)
            assert not a[:, H:].any() and not a[:, :, W:].any()
        out = finish(acc_t, acc_c, H=H, W=W, **kw)
        assert not acc_t.any() and not acc_c.any()
        return out

    def counted_lane(*a, **k):
        lanes.append(1)
        return lane(*a, **k)

    monkeypatch.setattr(tsp, "finish_local_call", checked_finish)
    monkeypatch.setattr(tsp, "_escape_lane", counted_lane)
    d, t = _slice_stream(vx=80.0, vy=-50.0, seed=3)
    rj, rt, ok = _run_both((2, 2), d, t, 3, halo=8, n_iters=16, max_iter=16)
    assert rt.escaped_dropped == int(rj.escaped_dropped) == 0
    _assert_slices_agree(rj, rt, ok)
    assert len(pairs) == rt.iters == 16 and len(set(pairs)) == 1
    assert len(lanes) > 0


def test_a_tiled_iteration_on_a_dirty_pair_is_caught(monkeypatch):
    """A finish that reads a copy of the run's pair clears the copy; the
    run's pair keeps one iteration's images into the next, B8 adds to them,
    and the slice leaves the clean run's result."""
    d, t = _slice_stream()
    args = tsp.bucket_events_2d(d["x"], d["y"], t, *SENSOR, 3, 2, 2, None)
    run = lambda: tsp.process_slice_tiled(
        *args, MotionModel.zero(), OptimizerConfig(scale=3, min_events=100),
        SensorConfig(*SENSOR), _cpu_mesh(2, 2), halo=16, n_iters=4)
    want = run()
    finish = tsp.finish_local_call
    monkeypatch.setattr(tsp, "finish_local_call",
                        lambda at, ac, **kw: finish(at.clone(), ac.clone(),
                                                    **kw))
    got = run()
    assert got.iters == want.iters == 4
    assert float(got.model.cnt) > float(want.model.cnt) > 300
    assert not torch.equal(got.pr_x, want.pr_x)


def test_tiled_entry_points_raise(monkeypatch):
    d, t = _slice_stream()
    x, y, ok = (np.asarray(d["x"], np.float32), np.asarray(d["y"], np.float32),
                np.ones(len(t), bool))
    sensor, cfg = SensorConfig(*SENSOR), OptimizerConfig(scale=3)
    run = lambda mesh, cfg=cfg, model=None, halo=32: tsp.process_slice_tiled(
        x, y, t, ok, model or MotionModel.zero(), cfg, sensor, mesh,
        halo=halo)
    with pytest.raises(ValueError, match="halo 64 exceeds the natural tile"):
        run(_cpu_mesh(4, 1), halo=64)
    # The XLA branch runs on the tiled path (an unknown mode still raises).
    rx = run(_cpu_mesh(1, 1), cfg=OptimizerConfig(scale=3, scatter_mode="xla"))
    assert rx.iters > 0 and rx.escaped_dropped == 0
    assert np.isfinite(rx.u.numpy()).all()
    with pytest.raises(NotImplementedError, match="scatter_mode"):
        run(_cpu_mesh(1, 1), cfg=OptimizerConfig(scale=3,
                                                 scatter_mode="segment"))
    with pytest.raises(NotImplementedError, match="f64 totals"):
        run(_cpu_mesh(1, 1), model=MotionModel.zero(f64_totals=True))
    with pytest.raises(ValueError, match="do not divide over 4 tiles"):
        tsp.process_slice_tiled(x[:-1], y[:-1], t[:-1], ok[:-1],
                                MotionModel.zero(), cfg, sensor,
                                _cpu_mesh(4, 1))
    # With no card the tile group is on the CPU only when asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_tiled_mesh((2, 2))
    with pytest.raises(ValueError, match="do not divide"):
        make_tiled_mesh((0, 2), device="cpu")
    mesh = _cpu_mesh(4, 2)
    assert (mesh.n_tiles, mesh.n_local, mesh.first_tile) == (8, 8, 0)
    rec = tiled_stream(8000)
    pcfg = tiled_cfg()
    with pytest.raises(NotImplementedError, match="f64 totals"):
        tsp.compensate_recording_tiled(rec["x"], rec["y"], rec["t_ns"],
                                       pcfg.replace(f64_totals=True), mesh,
                                       halo=8)
    with pytest.raises(ValueError, match="halo 40 exceeds"):
        tsp.compensate_recording_tiled(rec["x"], rec["y"], rec["t_ns"], pcfg,
                                       mesh, halo=40)
    prep = tsp.prepare_recording_tiled(rec["x"], rec["y"], rec["t_ns"], pcfg,
                                       2, 2)
    with pytest.raises(ValueError, match="staged for"):
        tsp.compensate_recording_tiled(None, None, None, pcfg, mesh, halo=8,
                                       prepared=prep)
