"""The port's CUDA kernels against their plain twins, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports no JAX and nothing of the JAX package, so it
also runs where JAX is not installed, from the root of a checkout on a
machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)  Each kernel
gets the numpy-seeded inputs of ``torch_inputs.py`` on the card, and its
twin the same inputs on the CPU.  ``chip_smoke.py`` repeats the kernel
checks at the main path's shapes and drives the main path.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch.config import OptimizerConfig  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models.global_flow import (  # noqa: E402
    finish_statics,
)
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
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
    CH, H, NCH, SCALE, W, carry_bits, flow_gates, gate_stream, gen4_cfg,
    gen4_model, gen4_start, gen4_stream, image_shape, local_splat_inputs,
    partials_inputs, per_slice_run_slices, slice_inputs, small_cfg, statics,
    tiled_cfg, tiled_stream,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _both(d, keys, dev):
    """The inputs ``keys`` of ``d`` as CPU tensors and as card tensors."""
    cpu = [torch.from_numpy(np.ascontiguousarray(d[k])) for k in keys]
    return cpu, [t.to(dev) for t in cpu]


def _launched(name, fn):
    """``fn()`` and a check that it launched kernel ``name`` once."""
    before = tfm.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert tfm.LAUNCHES[name] == before + 1
    return out


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


def _device_ops(fn, calls=10, traces=3):
    """The names of the device operations of ``calls`` calls of ``fn``
    (torch.profiler's device trace), traced again, up to ``traces`` times,
    while the count does not divide into the calls (the profiler can drop
    a record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        if ops and len(ops) % calls == 0:
            return ops
    raise AssertionError(f"{len(ops)} device operations in {calls} calls")


def test_act_rows_kernel_matches_twin(cuda):
    rng = np.random.default_rng(1)
    n = NCH * CH
    sidx = np.where(rng.uniform(size=n) < 0.9, np.arange(n) + 1000, -1)
    st_h = (1100 + 1500 * np.arange(3)).astype(np.int32)
    hist = np.stack([np.array([1, 0, 1], np.int32), st_h, st_h + 400])
    (s_c, h_c), (s_g, h_g) = _both(dict(sidx=sidx.astype(np.int32),
                                        hist=hist), ("sidx", "hist"), cuda)
    got = _launched("act_rows", lambda: tfm.act_rows_call(s_g, h_g))
    want = tfm.act_rows_call(s_c, h_c)
    assert torch.equal(got.cpu(), want)
    assert 0 < float(want.sum()) < float((s_c >= 0).sum())


@pytest.mark.parametrize("K", [1, 3])
def test_batched_act_rows_kernel_is_twin_and_one_slice_calls(cuda, K):
    """B3 over five slices of their own histories (one never fired) in one
    launch: bitwise its twin and the one-slice launches; a slab that is not
    16-byte aligned is refused."""
    rng = np.random.default_rng(K)
    S, n = 5, NCH * CH
    sidx = np.stack([np.where(rng.uniform(size=n) < 0.9,
                              rng.permutation(n) + 1000 * s, -1)
                     for s in range(S)]).astype(np.int32)
    st_h = rng.integers(0, n, (S, K)) + 1000 * np.arange(S)[:, None]
    hist = np.stack([rng.uniform(size=(S, K)) < 0.7, st_h,
                     st_h + rng.integers(100, 2000, (S, K))], axis=1)
    hist[:, 0, 0] = 1
    hist[1, 0] = 0
    (s_c, h_c), (s_g, h_g) = _both(dict(sidx=sidx, hist=hist.astype(
        np.int32)), ("sidx", "hist"), cuda)
    got = _launched("act_rows", lambda: tfm.act_rows_call(s_g, h_g))
    assert got.shape == (S, NCH, 1, CH)
    assert torch.equal(got, tfm.act_rows_plain(s_g, h_g))
    assert torch.equal(got.cpu(), tfm.act_rows_call(s_c, h_c))
    for k in range(S):
        assert torch.equal(got[k], tfm.act_rows_call(s_g[k], h_g[k]))
    before = dict(tfm.LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        tfm.act_rows_call(s_g.reshape(-1)[1:1 + n], h_g[0])
    assert tfm.LAUNCHES == before


@pytest.mark.parametrize("time_lo", [False, True])
def test_warp_images_st_kernel_matches_twin(cuda, time_lo):
    keys = ("stat", "act", "pr", "st", "geo")
    cpu, gpu = _both(slice_inputs(0), keys, cuda)
    kw = dict(scale=SCALE, H=H, W=W, time_lo=time_lo)
    pair = tfm.image_pair(cuda, H, W)
    npr, at, ac = _launched("warp_images_st",
                            lambda: tfm.warp_images_st_call(*gpu, *pair,
                                                            **kw))
    assert at is pair[0] and ac is pair[1]
    npr_p, at_p, ac_p = tfm.warp_images_st_call(
        *cpu, *tfm.image_pair("cpu", H, W), **kw)
    _close(npr, npr_p, rtol=1e-6)
    assert torch.equal(ac.cpu(), ac_p) and int(ac_p.sum()) > 3000
    _close(tfm.time_image_f32(at), tfm.time_image_f32(at_p), rtol=1e-5,
           atol=1e-6)
    # The twin on the card's tensors (the function of one slot a thread with
    # the warp in every thread): bitwise.
    twin = tfm.warp_images_st_plain(*gpu, *tfm.image_pair(cuda, H, W), **kw)
    assert all(torch.equal(a, b) for a, b in zip((npr, at, ac), twin))
    # A second launch adds into the pair: no memset clears it.
    _launched("warp_images_st",
              lambda: tfm.warp_images_st_call(*gpu, *pair, **kw))
    assert torch.equal(ac.cpu(), 2 * ac_p)


@pytest.mark.parametrize("schedule,exit_grad,exit_pred,converged", [
    ("fast", 4.0, 0.0, False), ("fast", 0.0, 0.0, False),
    ("fast", 4.0, 4.0, False), ("reference", 0.0, 0.0, False),
    ("fast", 4.0, 4.0, True), ("reference", 0.0, 0.0, True)])
def test_megastep_finish_kernel_matches_twin(cuda, schedule, exit_grad,
                                             exit_pred, converged):
    d = slice_inputs(3)
    if converged:                      # tiny deltas and gradients: CONT -> 0
        d["st"][0, 24:28] *= 1e-3
        d["st"][0, 18:22] = [1e-6, 1e-6, 1e-6, -1e-6]
    cpu, _ = _both(d, ("stat", "act", "pr", "st", "geo"), cuda)
    _, at, ac = tfm.warp_images_st_call(*cpu, *tfm.image_pair("cpu", H, W),
                                        scale=SCALE, H=H, W=W, time_lo=False)
    kw = dict(scale=SCALE, H=H, W=W, **statics(schedule, exit_grad,
                                               exit_pred))
    st, geo = cpu[3], cpu[4]
    pair = (at.to(cuda), ac.to(cuda))
    st_g, geo_g = st.to(cuda), geo.to(cuda)
    plain = tfm.megastep_finish_plain(pair[0].clone(), pair[1].clone(), st_g,
                                      geo_g, **kw)
    got = _launched("megastep_finish", lambda: tfm.megastep_finish_call(
        *pair, st_g, geo_g, **kw))
    assert torch.equal(got, plain)             # the twin on the card's copy
    assert not pair[0].any() and not pair[1].any()   # left zero for B1
    got = got.cpu()[0]
    want = tfm.megastep_finish_call(at, ac, st, geo, **kw)[0]
    exact = [layout.ST_ITERS, layout.ST_CONT]
    assert torch.equal(got[exact], want[exact])
    # Kahan compensations are the totals' rounding residues: any ulp in a
    # delta moves them anywhere within an ulp of the total.
    comp = slice(layout.ST_CDX, layout.ST_CDIV + 1)
    tot = slice(layout.ST_TDX, layout.ST_TDIV + 1)
    assert bool(((got[comp] - want[comp]).abs()
                 <= want[tot].abs() * 2.0 ** -22).all())
    rest = [k for k in range(layout.ST_SIZE) if k not in exact
            and not layout.ST_CDX <= k <= layout.ST_CDIV]
    _close(got[rest], want[rest], rtol=1e-5)


@pytest.mark.parametrize("window_small", [0.0, 1.0])
def test_warp_uv_kernel_matches_twin(cuda, window_small):
    cpu, gpu = _both(slice_inputs(5), ("stat", "pr", "act", "st"), cuda)
    out, uvn = _launched("warp_uv",
                         lambda: tfm.warp_uv_call(*gpu, window_small))
    out_p, uvn_p = tfm.warp_uv_call(*cpu, window_small)
    _close(out, out_p, rtol=1e-6)
    _close(uvn[:, 0:2], uvn_p[:, 0:2], rtol=1e-6)
    assert torch.equal(uvn[:, 2].cpu(), uvn_p[:, 2])
    # The twin on the card's tensors (the warp in every thread): bitwise.
    twin = tfm.warp_uv_plain(*gpu, window_small)
    assert torch.equal(out, twin[0]) and torch.equal(uvn, twin[1])


@pytest.mark.parametrize("window_small", [0.0, 0.5])
def test_warp_uv_kernel_writes_the_given_rows_bitwise(cuda, window_small):
    """B4 into the caller's rows (a slice of a run's output): bitwise its
    twin on the card's tensors and its own rows, the rows around the
    caller's left alone; rows that are not contiguous are refused."""
    _, gpu = _both(slice_inputs(6, nch=8), ("stat", "pr", "act", "st"),
                   cuda)
    run = torch.zeros((3, 8, 3, CH), device=cuda)
    out, uvn = _launched("warp_uv", lambda: tfm.warp_uv_call(
        *gpu, window_small, run[1]))
    assert uvn.data_ptr() == run[1].data_ptr()
    twin = tfm.warp_uv_plain(*gpu, window_small)
    own = tfm.warp_uv_call(*gpu, window_small)
    for got in (own, (out, uvn)):
        assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
    assert not run[0].any() and not run[2].any()
    before = dict(tfm.LAUNCHES)
    with pytest.raises(ValueError, match="not contiguous"):
        tfm.warp_uv_call(*gpu, window_small, torch.zeros(
            (3, 8, CH), device=cuda).transpose(0, 1))
    assert tfm.LAUNCHES == before


@pytest.mark.parametrize("slope", [True, False])
def test_warp_uv_handoff_kernel_is_twin_bitwise(cuda, slope):
    """B4 with the slice loop's hand-off: the warp bitwise B4 without it,
    the next start state and seed row bitwise the twin's on the card's
    tensors (copies and constants, a negative zero and a NaN kept), one
    launch."""
    _, gpu = _both(slice_inputs(7), ("stat", "pr", "act", "st"), cuda)
    rng = np.random.default_rng(5)
    st, st_in = (torch.from_numpy(rng.normal(0, 3, (1, 32)).astype(
        np.float32)).to(cuda) for _ in range(2))
    st[0, layout.ST_CDY] = -0.0
    st[0, layout.ST_SL + 1] = float("nan")
    gpu[3] = st
    handoff = lambda: tfm.Handoff(
        torch.full((1, 32), 5.0, device=cuda),
        torch.full((12,), 5.0, device=cuda), st_in, 3.3, 0.7, slope)
    h = handoff()
    out, uvn = _launched("warp_uv", lambda: tfm.warp_uv_call(
        *gpu, 0.0, None, handoff=h))
    plain_h = handoff()
    twin = tfm.warp_uv_plain(*gpu, 0.0, None, plain_h)
    bits = lambda t: t.view(torch.int32)
    assert torch.equal(bits(h.st_next), bits(plain_h.st_next))
    assert torch.equal(bits(h.seed_next), bits(plain_h.seed_next))
    # Without the hand-off B4 writes the same warp and rows.
    own = _launched("warp_uv", lambda: tfm.warp_uv_call(*gpu, 0.0))
    for got in (own, twin):
        assert torch.equal(bits(got[0]), bits(out))
        assert torch.equal(bits(got[1]), bits(uvn))


def test_cold_path_device_carry_is_the_per_slice_loop(cuda, monkeypatch):
    """A 2-batch cold run on the card, its slice loop carrying the state
    on the device, bitwise the per-slice loop that rebuilt the model and
    the seed between slices (u, v, noise, iterations, reads, the carry);
    the window gate skips slices in it."""
    d = gate_stream()
    cfg = small_cfg()
    run = lambda: tscan.compensate_recording_cold(
        d["x"], d["y"], d["t_ns"], cfg, n_batch=2, device=cuda)
    got = run()
    monkeypatch.setattr(tscan, "run_slices", per_slice_run_slices)
    want = run()
    assert got["stats"]["n_batches"] == 2
    assert 0 < int((got["iters"] > 0).sum()) < len(got["iters"])
    for k in ("u", "v"):
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32))
    for k in ("noise", "iters"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["stats"]["host_syncs"] == want["stats"]["host_syncs"]
    assert carry_bits(got["carry"]) == carry_bits(want["carry"])


def test_scan_on_card_matches_cpu_twins_and_repeats(cuda):
    """The whole scan on the card against the CPU twins (the gates of
    test_torch_scan.py), every kernel of the fast path launched, and a
    second card run bitwise the same."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = small_cfg()
    run = lambda dev: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device=dev)
    rg, rc, rg2 = run(cuda), run("cpu"), run(cuda)
    launches = rg["stats"]["launches"]
    assert launches.pop("megastep") == 0        # fast(): the split pair
    for k in ("fused_warp_splat", "fused_warp_splat_images",
              "finish_partials", "splat_local", "finish_local",
              "fused_model_partials", "fused_model_partials_windowed",
              "megastep2"):
        # not the composed, the tiled, the XLA or the merged loop
        assert launches.pop(k) == 0
    # B3 once for the staged range, B4 once a slice that ran.
    assert launches["act_rows"] == 1
    assert launches["warp_uv"] == int(rg["ran"].sum())
    assert all(v > 0 for v in launches.values())
    np.testing.assert_array_equal(rg["noise"], rc["noise"])
    np.testing.assert_array_equal(rg["ran"], rc["ran"])
    assert np.mean(rg["iters"] == rc["iters"]) >= 0.9
    assert abs(int(rg["iters"].sum()) - int(rc["iters"].sum())) \
        <= 0.1 * int(rc["iters"].sum())
    ok = ~rc["noise"]
    speed = float(np.hypot(rc["u"][ok], rc["v"][ok]).mean())
    assert np.median(np.abs(rg["u"][ok] - rc["u"][ok])) < 0.01 * speed
    assert np.median(np.abs(rg["v"][ok] - rc["v"][ok])) < 0.01 * speed
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rg[k], rg2[k])


@pytest.mark.parametrize("case", ["subpixel", "max_events_70000"])
def test_numpy_staged_scan_on_card_matches_cpu_twins(cuda, case):
    """The numpy staging route on the card: sub-pixel coordinates, and
    slices past the u16 offsets (36 chunks a slice), against the CPU twins
    under the scan gates, the fast path's kernels launched, a repeat
    bitwise."""
    rng = np.random.default_rng(7)
    if case == "subpixel":
        d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32,
                             vx=20.0, vy=-14.0, seed=2)
        for k, r in (("x", 24), ("y", 32)):
            d[k] = np.clip(d[k] + rng.uniform(0, 1, len(d[k])), 0,
                           np.nextafter(r, 0))
        cfg = small_cfg()
    else:
        d = synthetic_events(75000, duration_s=0.3, res_x=24, res_y=32,
                             vx=20.0, vy=-14.0, seed=2)
        cfg = small_cfg().replace(slice=dataclasses.replace(
            small_cfg().slice, max_events=70_000, span_ns=int(0.5e9),
            refresh_events=70_000, refresh_time_ns=int(1e9)))
    prep = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device=cuda)
    assert not prep["compact"] and "numpy_staging" in prep["plan_breakdown"]
    rg = tscan.compensate_recording_scan(None, None, None, cfg,
                                         prepared=prep)
    rg2 = tscan.compensate_recording_scan(None, None, None, cfg,
                                          prepared=prep)
    rc = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    launches = rg["stats"]["launches"]
    assert launches["act_rows"] == 1
    assert launches["warp_uv"] == int(rg["ran"].sum()) > 0
    assert launches["warp_images_st"] == launches["megastep_finish"] \
        == int(rg["iters"].sum()) > 0
    flow_gates(rg, rc)
    assert np.mean(rg["iters"] == rc["iters"]) >= 0.9
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rg[k], rg2[k])


@pytest.mark.parametrize("schedule", ["reference", "fast"])
@pytest.mark.parametrize("scale", [1, 3])
def test_megastep_kernel_is_twin_and_chain_bitwise(cuda, scale, schedule):
    """B5 on the production sensor at both scales: new positions and state
    bitwise those of its twin and of the B1 -> B2 kernel chain."""
    res = (180, 240)
    Hs, Ws = image_shape(res, scale)
    opt = OptimizerConfig() if schedule == "reference" \
        else OptimizerConfig.fast()
    kw = dict(scale=scale, H=Hs, W=Ws, time_lo=True, **finish_statics(opt))
    keys = ("stat", "act", "pr", "st", "geo")
    _, gpu = _both(slice_inputs(2, res=res, scale=scale, nch=8), keys, cuda)
    npr, st = _launched("megastep", lambda: tfm.megastep_call(*gpu, **kw))
    npr_p, st_p = tfm.megastep_plain(*gpu, **kw)
    chain = {k: v for k, v in kw.items() if k != "time_lo"}
    npr_c, at, ac = tfm.warp_images_st_call(
        *gpu, *tfm.image_pair(cuda, Hs, Ws), scale=scale, H=Hs, W=Ws,
        time_lo=True)
    assert int(ac.sum()) > 10_000
    st_c = tfm.megastep_finish_call(at, ac, gpu[3], gpu[4], **chain)
    assert not at.any() and not ac.any()
    for got in ((npr_p, st_p), (npr_c, st_c)):
        assert torch.equal(npr, got[0]) and torch.equal(st, got[1])


def test_megastep_refused_launch_raises(cuda):
    """A cooperative launch the card cannot hold resident raises; nothing
    runs in its place."""
    keys = ("stat", "act", "pr", "st", "geo")
    _, gpu = _both(slice_inputs(0), keys, cuda)
    kw = dict(scale=SCALE, H=H, W=W, **statics("reference", 0.0))
    before = dict(tfm.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        tfm.megastep_call(*gpu, grid_blocks=10_000_000, **kw)
    assert tfm.LAUNCHES == before
    npr, st = _launched("megastep", lambda: tfm.megastep_call(*gpu, **kw))
    torch.cuda.synchronize()
    assert torch.isfinite(st).all()


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_stream_on_card_matches_cpu_twins_and_repeats(cuda, schedule):
    """The streaming path on the card against the CPU twins, through B5
    (reference) or B1 + B2 (fast), and a second card run bitwise the
    same."""
    d = synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=4)
    cfg = small_cfg()
    if schedule == "reference":
        cfg = cfg.replace(optimizer=OptimizerConfig(scale=3, min_events=500))

    def run(dev):
        before = dict(tfm.LAUNCHES)
        r = toff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg,
                                      device=dev)
        r["launches"] = {k: tfm.LAUNCHES[k] - before[k] for k in before}
        acc, sl = r["accumulated"], r["engine"].slices
        r["iters"] = np.array([s.iters for s in sl])
        r.update(noise=acc["noise"], u=acc["u"], v=acc["v"],
                 ran=r["iters"] > 0)
        return r

    rg, rc, rg2 = run(cuda), run("cpu"), run(cuda)
    n_iters = int(rg["iters"].sum())
    if schedule == "reference":
        assert rg["launches"]["megastep"] == n_iters
        assert rg["launches"]["warp_images_st"] == 0
    else:
        assert rg["launches"]["warp_images_st"] == n_iters
        assert rg["launches"]["megastep"] == 0
    assert rg["launches"]["warp_uv"] == int(rg["ran"].sum())
    flow_gates(rg, rc)
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rg[k], rg2[k])


def _carry_models(st, dev):
    """The model of state ``st`` (an f32 carry) and an f64 carry of the
    same warp whose angle's f32 rounding changes the row's sine."""
    from better_flow_tpu_torch.models.global_flow import model_from_state

    m32 = model_from_state(st)
    f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    m64 = m32.replace(
        total_dx=f64(float(m32.total_dx)), total_dy=f64(float(m32.total_dy)),
        total_rot=f64(0.02603218874814671),
        total_div=f64(float(m32.total_div)), comp_dx=f64(0.0),
        comp_dy=f64(0.0), comp_rot=f64(0.0), comp_div=f64(0.0))
    return {"f32": m32, "f64": m64}


@pytest.mark.parametrize("carry", ["f32", "f64"])
@pytest.mark.parametrize("res,nch", [((24, 32), NCH), ((180, 240), 8)])
def test_fused_warp_splat_kernel_matches_twin(cuda, res, nch, carry):
    """B6 against its twin on the card, on the warp row of an f32 and of
    an f64 carry: new positions and the seven sums bitwise, the eighth
    value (the TPU kernel's window fallbacks) 0."""
    Hs, Ws = image_shape(res, SCALE)
    keys = ("stat", "act", "pr", "st", "geo")
    _, gpu = _both(slice_inputs(2, res=res, nch=nch), keys, cuda)
    stat, act, pr, st, geo = gpu
    scal = tfm.warp_scal_row(geo, _carry_models(st, cuda)[carry])
    kw = dict(scale=SCALE, H=Hs, W=Ws)
    npr, vals = _launched("fused_warp_splat",
                          lambda: tfm.fused_warp_splat_call(stat, act, pr,
                                                            scal, **kw))
    npr_p, vals_p = tfm.fused_warp_splat_plain(stat, act, pr, scal, **kw)
    assert torch.equal(npr, npr_p) and torch.equal(vals, vals_p)
    assert float(vals[0]) > 3000 and float(vals[7]) == 0.0
    # ... and equal to B1's splat of the time pair followed by B2's sums.
    cpu = [t.cpu() for t in (stat, act, pr, scal)]
    npr_c, vals_c = tfm.fused_warp_splat_call(*cpu, **kw)
    assert torch.equal(npr.cpu(), npr_c)
    np.testing.assert_array_equal(vals.cpu().numpy(), vals_c.numpy())


def test_image_pair_stays_zero_across_interleaved_kernels(cuda):
    """Three B5 calls on different states and images, interleaved on the
    same device and image shape with B6, B1 -> B2 and B7a -> B7b calls:
    every output bitwise its twin's, so the image pair that B5 and B6 splat
    into and leave zero is zero at each call's start and no other kernel
    disturbs it; the pair that B1 and B2 share is zero after each B2."""
    res = (180, 240)
    Hs, Ws = image_shape(res, SCALE)
    kw = dict(scale=SCALE, H=Hs, W=Ws)
    kw5 = dict(kw, time_lo=True, **finish_statics(OptimizerConfig()))
    chain = {k: v for k, v in kw5.items() if k != "time_lo"}
    keys = ("stat", "act", "pr", "st", "geo")
    pair12 = tfm.image_pair(cuda, Hs, Ws)
    for k, seed in enumerate((2, 5, 8)):
        d = slice_inputs(seed, res=res, nch=8)
        d["st"][0, 0:4] *= 1.0 + 0.25 * k
        d["st"][0, 24:28] *= 1.0 - 0.2 * k
        _, gpu = _both(d, keys, cuda)
        stat, act, pr, st, geo = gpu
        npr, st5 = _launched("megastep",
                             lambda: tfm.megastep_call(*gpu, **kw5))
        npr_p, st5_p = tfm.megastep_plain(*gpu, **kw5)
        assert torch.equal(npr, npr_p) and torch.equal(st5, st5_p)
        scal = tfm.warp_scal_row(geo, _carry_models(st, cuda)["f32"])
        npr6, vals = _launched(
            "fused_warp_splat",
            lambda: tfm.fused_warp_splat_call(stat, act, pr, scal, **kw))
        npr6_p, vals_p = tfm.fused_warp_splat_plain(stat, act, pr, scal,
                                                    **kw)
        assert torch.equal(npr6, npr6_p) and torch.equal(vals, vals_p)
        _, at, ac = tfm.warp_images_st_call(*gpu, *pair12, **kw,
                                            time_lo=True)
        n_acc = int(ac.sum())
        st2 = _launched("megastep_finish",
                        lambda: tfm.megastep_finish_call(at, ac, st, geo,
                                                         **chain))
        assert torch.equal(st2, st5)
        assert not pair12[0].any() and not pair12[1].any()
        _, at7, ac7, _ = tfm.fused_warp_splat_images_call(
            stat, act, pr, scal, *tfm.image_pair(cuda, Hs, Ws), **kw)
        vals7 = _launched("finish_partials",
                          lambda: tfm.finish_partials_call(at7, ac7, **kw))
        assert torch.equal(vals7, vals)
        assert n_acc > 10_000


@pytest.mark.parametrize("kernel,res,scale", [
    ("megastep", (100, 1220), 3), ("fused_warp_splat", (100, 1220), 3),
    ("megastep", (720, 1280), 1), ("megastep_finish", (100, 1220), 3),
    ("megastep2", (100, 1220), 3), ("megastep2", (720, 1280), 1),
    ("megastep_finish", (720, 1280), 3)])
def test_iteration_kernels_at_other_band_heights(cuda, kernel, res, scale):
    """B5, B6, B2 and B12 where a band holds one row (303x3663 images at
    scale 3: two rows exceed the shared-memory budget; 303 bands on a grid
    of two blocks an SM, so the band loop strides), B1 then B2 at the
    benchmark's megapixel image (720x1280 at scale 3: 2163x3843, one row
    a band, 2163 bands), and B5 and B12 at 720x1280, scale 1 (three rows
    a band), bitwise their twins; B2's and B12's pair zero after the
    finish."""
    Hs, Ws = image_shape(res, scale)
    R, _ = tfm.band_rows(Hs, Ws, scale)
    assert R == (1 if scale == 3 else 3) and -(-Hs // 2) >= 132
    keys = ("stat", "act", "pr", "st", "geo")
    _, gpu = _both(slice_inputs(2, res=res, scale=scale, nch=8), keys, cuda)
    stat, act, pr, st, geo = gpu
    kw = dict(scale=scale, H=Hs, W=Ws, time_lo=True,
              **finish_statics(OptimizerConfig()))
    chain = {k: v for k, v in kw.items() if k != "time_lo"}
    if kernel == "megastep":
        got = _launched("megastep", lambda: tfm.megastep_call(*gpu, **kw))
        want = tfm.megastep_plain(*gpu, **kw)
    elif kernel == "megastep_finish":
        npr, at, ac = tfm.warp_images_st_call(
            *gpu, *tfm.image_pair(cuda, Hs, Ws), scale=scale, H=Hs, W=Ws)
        st2 = _launched("megastep_finish", lambda: tfm.megastep_finish_call(
            at, ac, st, geo, **chain))
        assert not at.any() and not ac.any()
        got, want = (npr, st2), tfm.megastep_plain(*gpu, **kw)
    elif kernel == "megastep2":
        # A later call: the head finishes the pair of B1's splat.
        pr4 = torch.cat([pr, torch.zeros_like(pr)], dim=1)
        st1 = st.clone()
        st1[0, layout.ST_HAS] = 1.0
        pair = tfm.image_pair(cuda, Hs, Ws)
        tfm.warp_images_st_call(stat, act, pr, st1, geo, *pair, scale=scale,
                                H=Hs, W=Ws)
        copy = tuple(t.clone() for t in pair)
        got = _launched("megastep2", lambda: tfm.megastep2_call(
            stat, act, pr4, st1, *pair, geo, **kw))
        want = tfm.megastep2_plain(stat, act, pr4, st1, *copy, geo, **kw)
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        got, want = got[0:2], want[0:2]
    else:
        scal = tfm.warp_scal_row(geo, _carry_models(st, cuda)["f64"])
        kw = dict(scale=scale, H=Hs, W=Ws)
        got = _launched("fused_warp_splat",
                        lambda: tfm.fused_warp_splat_call(stat, act, pr,
                                                          scal, **kw))
        want = tfm.fused_warp_splat_plain(stat, act, pr, scal, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[1]).all()


def test_megapixel_scan_on_card_matches_cpu_twins(cuda):
    """A 1M-event stretch of the benchmark's megapixel cell's scene (a
    1280x720 sensor at scale 3, the cell's slicing and ``fast()``) through
    ``compensate_recording_scan`` on the card, its slice loop carrying the
    state on the device, against the CPU twins (the gates of
    test_torch_scan.py), from the scene's own motion as in
    ``test_torch_megapixel_scan.py``."""
    d = gen4_stream(1_000_000, seed=2 ** 31 + 29)
    cfg = gen4_cfg()
    first = tscan.plan_slices(d["t_ns"], cfg).ends[0] + 1
    tot, cx, cy = gen4_start(d["x"][:first], d["y"][:first])
    run = lambda dev: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device=dev,
        init_model=gen4_model(tot, cx, cy, dev))
    rg, rc = run(cuda), run("cpu")
    assert len(rg["iters"]) >= 50 and rg["ran"].all()
    assert rg["stats"]["launches"]["warp_uv"] == len(rg["iters"])
    flow_gates(rg, rc)


@pytest.mark.parametrize("case", ["f64_scan", "f64_stream",
                                  "fast_nomega_stream"])
def test_composed_path_on_card_matches_cpu_twins(cuda, case):
    """The composed loop on the card against the CPU twins: the f64 scan,
    the f64 stream (reference schedule) and ``fast(use_megastep=False)``
    on 24x32 recordings; one B6 launch per iteration and no megastep
    kernel; the f64 carry stays f64; a second card run bitwise the same."""
    d = synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=4)
    if case == "fast_nomega_stream":
        cfg = small_cfg(use_megastep=False)
    else:
        cfg = small_cfg().replace(
            f64_totals=True, optimizer=OptimizerConfig(scale=3,
                                                       min_events=500))

    def run(dev):
        before = dict(tfm.LAUNCHES)
        if case == "f64_scan":
            r = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"],
                                                cfg, device=dev)
            model = r["model"]
        else:
            r = toff.compensate_recording(d["x"], d["y"], d["t_ns"], cfg,
                                          device=dev)
            acc, sl = r["accumulated"], r["engine"].slices
            r = dict(noise=acc["noise"], u=acc["u"], v=acc["v"],
                     iters=np.array([s.iters for s in sl]))
            r["ran"] = r["iters"] > 0
            model = sl[-1].model
        r["launches"] = {k: tfm.LAUNCHES[k] - before[k] for k in before}
        r["dtype"] = model.total_rot.dtype
        return r

    rg, rc, rg2 = run(cuda), run("cpu"), run(cuda)
    want = torch.float32 if case == "fast_nomega_stream" else torch.float64
    assert rg["dtype"] == rc["dtype"] == want
    assert rg["launches"]["fused_warp_splat"] == int(rg["iters"].sum())
    for k in ("megastep", "warp_images_st", "megastep_finish"):
        assert rg["launches"][k] == 0, k
    flow_gates(rg, rc)
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rg[k], rg2[k])


@pytest.mark.parametrize("carry", ["f32", "f64"])
@pytest.mark.parametrize("res,nch", [((24, 32), NCH), ((180, 240), 8)])
def test_b7_kernels_match_twins_and_chain_is_b6(cuda, res, nch, carry):
    """B7a (warp + splat added into the caller's pair) and B7b (finish to
    the seven sums, leaving the pair zero) against their twins on the card,
    bitwise, on the warp row of an f32 and of an f64 carry; the B7a -> B7b
    chain bitwise B6; B7a over 4 resident shards in one launch, and in one
    launch a shard into one pair, bitwise the unsharded launch."""
    Hs, Ws = image_shape(res, SCALE)
    keys = ("stat", "act", "pr", "st", "geo")
    _, gpu = _both(slice_inputs(2, res=res, nch=nch), keys, cuda)
    stat, act, pr, st, geo = gpu
    scal = tfm.warp_scal_row(geo, _carry_models(st, cuda)[carry])
    kw = dict(scale=SCALE, H=Hs, W=Ws)
    pair = tfm.image_pair(cuda, Hs, Ws)
    npr, at, ac, fb = _launched(
        "fused_warp_splat_images",
        lambda: tfm.fused_warp_splat_images_call(stat, act, pr, scal, *pair,
                                                 **kw))
    assert at is pair[0] and ac is pair[1] and fb == 0
    npr_p, at_p, ac_p, _ = tfm.fused_warp_splat_images_plain(
        stat, act, pr, scal, *tfm.image_pair(cuda, Hs, Ws), **kw)
    assert torch.equal(npr, npr_p)
    assert torch.equal(at, at_p) and torch.equal(ac, ac_p)
    assert int(ac.sum()) > 2000
    at0, ac0 = at.clone(), ac.clone()
    vals_p = tfm.finish_partials_plain(at_p, ac_p, **kw)
    vals = _launched("finish_partials",
                     lambda: tfm.finish_partials_call(at, ac, **kw))
    assert torch.equal(vals, vals_p)
    assert not at.any() and not ac.any()      # left zero for the next B7a
    assert float(vals[0]) > 3000 and float(vals[7]) == 0.0
    npr6, vals6 = tfm.fused_warp_splat_call(stat, act, pr, scal, **kw)
    assert torch.equal(npr, npr6) and torch.equal(vals, vals6)
    # The twins on the CPU give the same bits as the kernels on the card.
    cpu = [t.cpu() for t in (stat, act, pr, scal)]
    _, at_c, ac_c, _ = tfm.fused_warp_splat_images_call(
        *cpu, *tfm.image_pair("cpu", Hs, Ws), **kw)
    assert torch.equal(at0.cpu(), at_c) and torch.equal(ac0.cpu(), ac_c)
    np.testing.assert_array_equal(
        vals.cpu().numpy(), tfm.finish_partials_call(at_c, ac_c, **kw).numpy())
    # Four resident shards (as many as there are chunks, up to four): made
    # separately and joined, one launch; or a launch each into one pair.
    n_sh = min(4, nch)
    cuts = [slice(k * nch // n_sh, (k + 1) * nch // n_sh)
            for k in range(n_sh)]
    joined = [torch.cat([a[c].clone() for c in cuts]) for a in (stat, act,
                                                                 pr)]
    for how in ("joined", "per shard"):
        two = tfm.image_pair(cuda, Hs, Ws)
        before = tfm.LAUNCHES["fused_warp_splat_images"]
        if how == "per shard":
            got = torch.cat([tfm.fused_warp_splat_images_call(
                stat[c], act[c], pr[c], scal, *two, **kw)[0] for c in cuts])
        else:
            got = tfm.fused_warp_splat_images_call(*joined, scal, *two,
                                                   **kw)[0]
        torch.cuda.synchronize()
        assert tfm.LAUNCHES["fused_warp_splat_images"] - before == \
            (n_sh if how == "per shard" else 1)
        assert torch.equal(got, npr), how
        assert torch.equal(two[0], at0) and torch.equal(two[1], ac0), how


def test_b7b_refused_launch_raises_and_leaves_the_pair(cuda, monkeypatch):
    """A B7b launch with too little shared memory for its band, or a band
    height of 0, raises, counts no launch and runs nothing: the pair still
    holds its images, which the next launch reads and clears."""
    keys = ("stat", "act", "pr", "st", "geo")
    _, (stat, act, pr, st, geo) = _both(slice_inputs(0), keys, cuda)
    scal = tfm.warp_scal_row(geo, _carry_models(st, cuda)["f32"])
    kw = dict(scale=SCALE, H=H, W=W)
    _, at, ac, _ = tfm.fused_warp_splat_images_call(
        stat, act, pr, scal, *tfm.image_pair(cuda, H, W), **kw)
    at0, ac0 = at.clone(), ac.clone()
    want = tfm.finish_partials_plain(at0.clone(), ac0.clone(), **kw)
    R, smem = tfm.band_rows(H, W, SCALE)
    for bad in ((R, smem - 16), (0, smem), (R, tfm.BAND_SMEM_BUDGET + 16)):
        monkeypatch.setattr(tfm, "_device_bands", lambda *a, bad=bad: bad)
        before = dict(tfm.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            tfm.finish_partials_call(at, ac, **kw)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES == before
        assert torch.equal(at, at0) and torch.equal(ac, ac0), bad
    monkeypatch.undo()
    got = _launched("finish_partials",
                    lambda: tfm.finish_partials_call(at, ac, **kw))
    assert torch.equal(got, want) and not at.any() and not ac.any()


def test_megastep_finish_refused_launch_raises_and_leaves_the_pair(
        cuda, monkeypatch):
    """A B2 launch with too little shared memory for its band, a band
    height of 0 or more than the budget raises, counts no launch and runs
    nothing: the pair still holds B1's splat, which the next launch reads
    and clears."""
    keys = ("stat", "act", "pr", "st", "geo")
    _, gpu = _both(slice_inputs(0), keys, cuda)
    st, geo = gpu[3], gpu[4]
    kw = dict(scale=SCALE, H=H, W=W, **statics("fast", 4.0))
    _, at, ac = tfm.warp_images_st_call(*gpu, *tfm.image_pair(cuda, H, W),
                                        scale=SCALE, H=H, W=W)
    at0, ac0 = at.clone(), ac.clone()
    want = tfm.megastep_finish_plain(at0.clone(), ac0.clone(), st, geo, **kw)
    R, smem = tfm.band_rows(H, W, SCALE)
    for bad in ((R, smem - 16), (0, smem), (R, tfm.BAND_SMEM_BUDGET + 16)):
        monkeypatch.setattr(tfm, "_device_bands", lambda *a, bad=bad: bad)
        before = dict(tfm.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            tfm.megastep_finish_call(at, ac, st, geo, **kw)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES == before
        assert torch.equal(at, at0) and torch.equal(ac, ac0), bad
    monkeypatch.undo()
    got = _launched("megastep_finish",
                    lambda: tfm.megastep_finish_call(at, ac, st, geo, **kw))
    assert torch.equal(got, want) and not at.any() and not ac.any()


@pytest.mark.parametrize("case", ["fast", "reference", "f64",
                                  "fast_nomega"])
def test_sharded_scan_on_card_is_unsharded_and_cpu_twins(cuda, case):
    """The event-parallel scan with 4 shards resident on the card: bitwise
    the unsharded card run on the same staging, equal to the CPU twins'
    4-shard run within the scan's gates, through B1 + B2 (megastep drives,
    never B5) or B7a + B7b (composed drives): B1 or B7a once an iteration
    for all four shards, one finish an iteration and one B3 launch a
    slice."""
    d = synthetic_events(20000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=4)
    cfg = {"fast": small_cfg(),
           "fast_nomega": small_cfg(use_megastep=False),
           "reference": small_cfg().replace(
               optimizer=OptimizerConfig(scale=3, min_events=500)),
           "f64": small_cfg().replace(
               f64_totals=True,
               optimizer=OptimizerConfig(scale=3, min_events=500))}[case]
    n = 4
    run = lambda dev: compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(n, device=dev))
    rg, rc = run(cuda), run("cpu")
    prep = tscan.prepare_recording(d["x"], d["y"], d["t_ns"], cfg,
                                   device=cuda, pad_quantum=n * layout.CHUNK)
    ru = tscan.compensate_recording_scan(None, None, None, cfg, prepared=prep)
    for k in ("u", "v", "noise", "iters", "ran"):
        np.testing.assert_array_equal(rg[k], ru[k])
    flow_gates(rg, rc)
    lc, total = rg["stats"]["launches"], int(rg["iters"].sum())
    assert rg["stats"]["n_devices"] == n and total > 0
    event, finish = (("warp_images_st", "megastep_finish")
                     if case in ("fast", "reference")
                     else ("fused_warp_splat_images", "finish_partials"))
    assert lc[event] == lc[finish] == total
    assert lc["megastep"] == 0 and lc["fused_warp_splat"] == 0
    # B3 once for the staged range; B4 (megastep drives) once a slice that
    # ran, for all four shards.
    assert lc["act_rows"] == 1
    assert lc["warp_uv"] == (int(rg["ran"].sum())
                             if case in ("fast", "reference") else 0)


@pytest.mark.parametrize("time_lo", [True, False])
@pytest.mark.parametrize("sort", [True, False])
def test_splat_local_kernel_matches_twin(cuda, sort, time_lo):
    """B8 on three tiles against its twin, bitwise: sorted and unsorted
    slots, the hi+lo pair and hi only, a chunk whose slot 0 is rejected, a
    ragged slot count (the wrapper pads to whole chunks); it adds into the
    caller's padded pair (a second launch doubles it) and leaves the
    padding zero."""
    Hs, Ws = 250, 300
    HP, WP = layout.padded_image_shape(Hs, Ws)
    cpu = [torch.from_numpy(a) for a in local_splat_inputs(
        seed=3, n_tiles=3, H=Hs, W=Ws, sort=sort)]
    gpu = [a.to(cuda) for a in cpu]
    kw = dict(H=Hs, W=Ws, time_lo=time_lo)
    pair = tfm.image_pair(cuda, Hs, Ws, n_tiles=3)
    at, ac = _launched("splat_local", lambda: tfm.splat_local_call(
        *gpu, *pair, **kw))
    assert at is pair[0] and ac is pair[1]
    at_p, ac_p = tfm.splat_local_plain(
        *(tfm._chunk_padded(a, v) for a, v in zip(gpu, (-1.0, -1.0, 0.0))),
        *tfm.image_pair(cuda, Hs, Ws, n_tiles=3), **kw)
    at_c, ac_c = tfm.splat_local_call(
        *cpu, *tfm.image_pair("cpu", Hs, Ws, n_tiles=3), **kw)
    assert tuple(at.shape) == (3, HP, WP) and int(ac.sum()) > 12000
    for a, b, c in ((at, at_p, at_c), (ac, ac_p, ac_c)):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
        assert not a[:, Hs:].any() and not a[:, :, Ws:].any()
    at0, ac0 = at.clone(), ac.clone()
    _launched("splat_local", lambda: tfm.splat_local_call(*gpu, *pair, **kw))
    assert torch.equal(pair[0], 2 * at0) and torch.equal(pair[1], 2 * ac0)


@pytest.mark.parametrize("scale", [1, 3])
def test_finish_local_kernel_matches_twin_and_whole_image_is_b7b(cuda, scale):
    """B9 on three tiles against its twin, bitwise, with a window strictly
    inside the image, each call on its own copy of B8's pair, which it
    leaves zero; with the whole image as the window, bitwise B7b tile by
    tile."""
    Hs, Ws, own = 250, 300, (16, 230, 24, 270)
    lx, ly, t = (torch.from_numpy(a).to(cuda) for a in local_splat_inputs(
        seed=9, n_tiles=3, n=12000, H=Hs, W=Ws))
    at, ac = tfm.splat_local_call(lx, ly, t, *tfm.image_pair(
        cuda, Hs, Ws, n_tiles=3), H=Hs, W=Ws)
    kw = dict(scale=scale, H=Hs, W=Ws)
    pair = (at.clone(), ac.clone())
    got = _launched("finish_local", lambda: tfm.finish_local_call(
        *pair, own=own, **kw))
    assert not pair[0].any() and not pair[1].any()
    assert torch.equal(got, tfm.finish_local_plain(at.clone(), ac.clone(),
                                                   own=own, **kw))
    assert torch.equal(got.cpu(), tfm.finish_local_call(
        at.cpu(), ac.cpu(), own=own, **kw))
    assert float(got[:, 0].min()) > 1000 and float(got[:, 7].abs().max()) == 0
    whole = tfm.finish_local_call(at.clone(), ac.clone(), own=(0, Hs, 0, Ws),
                                  **kw)
    for k in range(3):
        assert torch.equal(whole[k], tfm.finish_partials_call(
            at[k].clone(), ac[k].clone(), **kw))
    assert not torch.equal(whole, got)


def test_finish_local_on_more_tiles_than_blocks(cuda):
    """B9 on 450 small tiles, more than the resident grid (three blocks an
    SM): blocks take several tiles' bands and, in the tail, several tiles'
    sums, and every block zeroes its share of the pair afterwards; bitwise
    its twin, the pair zero."""
    Hs, Ws, n_tiles = 40, 40, 450
    assert tfm.iteration_grid("finish_local", cuda, Hs, Ws, 3,
                              n_tiles)[1] < n_tiles
    lx, ly, t = (torch.from_numpy(a).to(cuda) for a in local_splat_inputs(
        seed=4, n_tiles=n_tiles, n=2 * CH, H=Hs, W=Ws))
    at, ac = tfm.splat_local_call(lx, ly, t, *tfm.image_pair(
        cuda, Hs, Ws, n_tiles=n_tiles), H=Hs, W=Ws)
    kw = dict(scale=3, H=Hs, W=Ws, own=(4, 36, 2, 38))
    want = tfm.finish_local_plain(at.clone(), ac.clone(), **kw)
    got = _launched("finish_local",
                    lambda: tfm.finish_local_call(at, ac, **kw))
    assert torch.equal(got, want) and float(got[:, 0].min()) > 50
    assert not at.any() and not ac.any()


def test_finish_local_refused_launch_raises_and_leaves_the_pair(
        cuda, monkeypatch):
    """A B9 launch with too little shared memory for its band, a band
    height of 0 or more than the budget raises, counts no launch and runs
    nothing: the pair still holds B8's splat, which the next launch reads
    and clears."""
    Hs, Ws, own = 245, 705, (32, 213, 32, 673)
    lx, ly, t = (torch.from_numpy(a).to(cuda) for a in local_splat_inputs(
        seed=2, n_tiles=8, n=12000, H=Hs, W=Ws))
    at, ac = tfm.splat_local_call(lx, ly, t, *tfm.image_pair(
        cuda, Hs, Ws, n_tiles=8), H=Hs, W=Ws)
    at0, ac0 = at.clone(), ac.clone()
    kw = dict(scale=1, H=Hs, W=Ws, own=own)
    want = tfm.finish_local_plain(at0.clone(), ac0.clone(), **kw)
    R, smem = tfm.band_rows(Hs, Ws, 1, 132, 8)
    assert R == 3
    for bad in ((R, smem - 16), (0, smem), (R, tfm.BAND_SMEM_BUDGET + 16)):
        monkeypatch.setattr(tfm, "_device_bands", lambda *a, bad=bad: bad)
        before = dict(tfm.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            tfm.finish_local_call(at, ac, **kw)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES == before
        assert torch.equal(at, at0) and torch.equal(ac, ac0), bad
    monkeypatch.undo()
    got = _launched("finish_local",
                    lambda: tfm.finish_local_call(at, ac, **kw))
    assert torch.equal(got, want) and not at.any() and not ac.any()


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_tiled_recording_on_card_is_1x1_and_cpu_twins(cuda, schedule):
    """A 4x2 tiled recording on the card (B8 and B9 once per iteration for
    all eight tiles): repeats bitwise; noise and iterations of the 1x1 card
    run, flow within the tiled gates (median |du|, |dv| <= 0.5% of the mean
    speed); and the CPU twins' 4x2 run within the scan's gates."""
    res = (180, 240)
    d = tiled_stream(res=res, n_points=150)
    opt = None if schedule == "reference" else OptimizerConfig.fast(
        scale=1, min_events=300)
    cfg = tiled_cfg(res=res, optimizer=opt)
    run = lambda shape, dev: compensate_recording_tiled(
        d["x"], d["y"], d["t_ns"], cfg, make_tiled_mesh(shape, device=dev),
        halo=8, esc_cap=4096)
    rg, rg2 = run((4, 2), cuda), run((4, 2), cuda)
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rg[k], rg2[k])
    st = rg["stats"]
    total = int(rg["iters"].sum())
    assert st["escaped_dropped"] == 0 and total > len(rg["iters"])
    assert st["launches"]["splat_local"] == total
    assert st["launches"]["finish_local"] == total
    with_ran = lambda r: dict(r, ran=r["iters"] > 0)
    flow_gates(with_ran(rg), with_ran(run((4, 2), "cpu")))
    if schedule == "reference":
        r1 = run((1, 1), cuda)
        np.testing.assert_array_equal(rg["noise"], r1["noise"])
        np.testing.assert_array_equal(rg["iters"], r1["iters"])
        ok = ~r1["noise"]
        speed = float(np.hypot(r1["u"][ok], r1["v"][ok]).mean())
        assert speed > 30.0
        for k in ("u", "v"):
            assert np.median(np.abs(rg[k][ok] - r1[k][ok])) <= 0.005 * speed


@pytest.mark.parametrize("spread", ["wide", "tight"])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("res,n", [((24, 32), 2 * CH + 700),
                                   ((180, 240), 30 * CH - 333),
                                   ((24, 32), 0), ((24, 32), 1),
                                   ((180, 240), CH)])
def test_partials_kernels_match_twin_and_each_other(cuda, res, n, sort,
                                                    spread):
    """B10 and B11 on sorted and unsorted events, spread wide or piled up
    (many events on few pixels), a ragged last chunk, no event, one event
    and one whole chunk: each bitwise its twin on the padded rows, and B11
    bitwise B10."""
    scale = SCALE
    Hs, Ws = image_shape(res, scale)
    d = partials_inputs(5, res=res, scale=scale, n=n, spread=spread,
                        sort=sort)
    keys = ("pr_x", "pr_y", "t_ns", "active", "geo")
    cpu, gpu = _both(d, keys, cuda)
    kw = dict(scale=scale, H=Hs, W=Ws)
    b10 = _launched("fused_model_partials",
                    lambda: tfm.fused_model_partials_call(*gpu, **kw))
    b11 = _launched("fused_model_partials_windowed",
                    lambda: tfm.fused_model_partials_windowed_call(*gpu,
                                                                   **kw))
    want = tfm.fused_model_partials_plain(*tfm.partials_rows(*cpu[:4]),
                                          cpu[4], **kw)
    assert torch.equal(b10.cpu(), want) and torch.equal(b11.cpu(), want)
    assert float(want[7]) == 0.0
    if n == 0:
        assert not want.any()
    elif n > CH:
        assert float(want[0]) > 100


@pytest.mark.parametrize("name", ["fused_model_partials",
                                  "fused_model_partials_windowed"])
def test_partials_call_is_one_device_operation(cuda, name):
    """A B10 or B11 call on the card is one cooperative launch of
    ``iteration_kernel`` and nothing else: no elementwise kernel, pad or
    memset in front of it, and the workspace pair zero after it."""
    res, n = (180, 240), 30 * CH - 333
    Hs, Ws = image_shape(res, SCALE)
    _, gpu = _both(partials_inputs(6, res=res, n=n),
                   ("pr_x", "pr_y", "t_ns", "active", "geo"), cuda)
    call = getattr(tfm, name + "_call")
    ops = _device_ops(lambda: call(*gpu, scale=SCALE, H=Hs, W=Ws))
    assert all("iteration_kernel" in o for o in ops), set(ops)
    ws = tfm._workspace(gpu[0].device, Hs, Ws)
    assert not ws["acc_t"].any() and not ws["acc_c"].any()


def test_partials_refused_launch_raises_and_leaves_the_pair_zero(
        cuda, monkeypatch):
    """A B10 launch with too little shared memory for its band, a band
    height of 0 or more than the budget raises, counts no launch and runs
    nothing: the workspace pair stays zero, and the next call is its
    twin's."""
    res, n = (180, 240), 30 * CH - 333
    Hs, Ws = image_shape(res, SCALE)
    cpu, gpu = _both(partials_inputs(6, res=res, n=n),
                     ("pr_x", "pr_y", "t_ns", "active", "geo"), cuda)
    kw = dict(scale=SCALE, H=Hs, W=Ws)
    ws = tfm._workspace(gpu[0].device, Hs, Ws)
    R, smem = tfm.band_rows(Hs, Ws, SCALE)
    for bad in ((R, smem - 16), (0, smem), (R, tfm.BAND_SMEM_BUDGET + 16)):
        monkeypatch.setattr(tfm, "_device_bands", lambda *a, bad=bad: bad)
        before = dict(tfm.LAUNCHES)
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            tfm.fused_model_partials_call(*gpu, **kw)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES == before
        assert not ws["acc_t"].any() and not ws["acc_c"].any(), bad
    monkeypatch.undo()
    got = _launched("fused_model_partials",
                    lambda: tfm.fused_model_partials_call(*gpu, **kw))
    assert torch.equal(got.cpu(), tfm.fused_model_partials_call(*cpu, **kw))


@pytest.mark.parametrize("exits", [False, True])
@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_megastep2_kernel_is_twin_and_b1_b2_b4_chain(cuda, schedule, exits):
    """B12 on the production sensor: a slice's first call (no head finish)
    and its second (the finish of the first call's images, then the warp
    and, unless the head ends the loop, the splat) bitwise their twins, and
    bitwise the B1 -> B2 chain with B4's final warp: positions, direction
    vectors, state and images."""
    res, scale = (180, 240), 3
    Hs, Ws = image_shape(res, scale)
    opt = OptimizerConfig() if schedule == "reference" \
        else OptimizerConfig.fast()
    if exits:                  # the second call's head passes max_iter
        opt = dataclasses.replace(opt, max_iter=1)
    kw = dict(scale=scale, H=Hs, W=Ws, time_lo=True, **finish_statics(opt))
    chain = {k: v for k, v in kw.items() if k != "time_lo"}
    keys = ("stat", "act", "pr", "st", "geo")
    d = slice_inputs(2, res=res, scale=scale, nch=8)
    d["st"][0, layout.ST_HAS] = 0.0
    _, (stat, act, pr, st, geo) = _both(d, keys, cuda)
    HP, WP = layout.padded_image_shape(Hs, Ws)
    z_t = torch.zeros((HP, WP), dtype=torch.int64, device=cuda)
    z_c = torch.zeros((HP, WP), dtype=torch.int32, device=cuda)
    pr4 = torch.cat([pr, torch.zeros_like(pr)], dim=1)
    # Each call reads, clears and splats into the pair it is given: the
    # calls and their twins get copies, so that each call's images stay.
    first = _launched("megastep2", lambda: tfm.megastep2_call(
        stat, act, pr4, st, z_t.clone(), z_c.clone(), geo, **kw))
    second = _launched("megastep2", lambda: tfm.megastep2_call(
        stat, act, first[0], first[1], first[2].clone(), first[3].clone(),
        geo, **kw))
    for got, args in ((first, (pr4, st, z_t, z_c)),
                      (second, (first[0], first[1], first[2], first[3]))):
        want = tfm.megastep2_plain(stat, act, args[0], args[1],
                                   args[2].clone(), args[3].clone(), geo,
                                   **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # The chain: B1 from the first call's state, B2 on its images, then the
    # next B1 (or, when the head ends the loop, B4) from B2's state.
    st_a = first[1]
    assert float(st_a[0, layout.ST_CONT]) == 1.0
    npr1, at1, ac1 = tfm.warp_images_st_call(
        stat, act, pr, st_a, geo, *tfm.image_pair(cuda, Hs, Ws), scale=scale,
        H=Hs, W=Ws)
    assert torch.equal(first[0][:, 0:2], npr1)
    assert torch.equal(first[2], at1) and torch.equal(first[3], ac1)
    st_2 = tfm.megastep_finish_call(at1, ac1, st_a, geo, **chain)
    assert torch.equal(second[1], st_2)
    out, _ = tfm.warp_uv_call(stat, npr1, act, st_2)
    assert torch.equal(second[0], out)
    cont = float(st_2[0, layout.ST_CONT])
    assert cont == 0.0 or not exits
    if cont == 0.0:
        assert int(second[3].abs().sum()) == 0
    else:
        _, at2, ac2 = tfm.warp_images_st_call(
            stat, act, npr1, st_2, geo, *tfm.image_pair(cuda, Hs, Ws),
            scale=scale, H=Hs, W=Ws)
        assert torch.equal(second[2], at2) and torch.equal(second[3], ac2)


def test_megastep2_refused_launch_raises(cuda):
    """A cooperative B12 launch the card cannot hold resident raises,
    counts no launch and runs nothing: a pair that holds a splat for the
    head stays as it was."""
    keys = ("stat", "act", "pr", "st", "geo")
    _, (stat, act, pr, st, geo) = _both(slice_inputs(0), keys, cuda)
    HP, WP = layout.padded_image_shape(H, W)
    z_t = torch.zeros((HP, WP), dtype=torch.int64, device=cuda)
    z_c = torch.zeros((HP, WP), dtype=torch.int32, device=cuda)
    pr4 = torch.cat([pr, torch.zeros_like(pr)], dim=1)
    kw = dict(scale=SCALE, H=H, W=W, **statics("reference", 0.0))
    before = dict(tfm.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        tfm.megastep2_call(stat, act, pr4, st, z_t, z_c, geo,
                           grid_blocks=10_000_000, **kw)
    assert tfm.LAUNCHES == before
    st1 = st.clone()
    st1[0, layout.ST_HAS] = 1.0
    tfm.warp_images_st_call(stat, act, pr, st1, geo, z_t, z_c, scale=SCALE,
                            H=H, W=W)
    at0, ac0 = z_t.clone(), z_c.clone()
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        tfm.megastep2_call(stat, act, pr4, st1, z_t, z_c, geo,
                           grid_blocks=10_000_000, **kw)
    torch.cuda.synchronize()
    assert torch.equal(z_t, at0) and torch.equal(z_c, ac0)


def test_xla_scan_on_card_matches_cpu_and_repeats(cuda):
    """The XLA-composed branch on the card: no kernel launched, the same
    noise and iterations as the CPU run and median |du| = |dv| = 0, and a
    second card run bitwise the first."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = small_cfg(scatter_mode="xla")
    run = lambda dev: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device=dev)
    rg, rc, rg2 = run(cuda), run("cpu"), run(cuda)
    assert not any(rg["stats"]["launches"].values())
    for k in ("noise", "iters", "ran"):
        np.testing.assert_array_equal(rg[k], rc[k])
    assert float(np.median(np.abs(rg["u"] - rc["u"]))) == 0.0
    for k in ("u", "v", "noise", "iters"):
        np.testing.assert_array_equal(rg[k], rg2[k])


@pytest.mark.parametrize("mode", ["xla", "mxu"])
def test_sharded_xla_scan_on_card_is_unsharded_and_cpu(cuda, mode):
    """The XLA branch under an event group on the card: 4 shards resident
    on the card bitwise the single-device card run, no kernel launched,
    and the same noise, iterations and median |du| = |dv| = 0 as the
    4-shard CPU run."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    cfg = small_cfg(scatter_mode=mode)
    run = lambda dev: compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], cfg, make_event_mesh(4, device=dev))
    rg, rc = run(cuda), run("cpu")
    r1 = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device=cuda)
    assert not any(rg["stats"]["launches"].values())
    for k in ("u", "v", "noise", "iters", "ran"):
        np.testing.assert_array_equal(rg[k], r1[k])
    for k in ("noise", "iters", "ran"):
        np.testing.assert_array_equal(rg[k], rc[k])
    for k in ("u", "v"):
        assert float(np.median(np.abs(rg[k] - rc[k]))) == 0.0


def test_tiled_xla_on_card_matches_cpu_and_kernels(cuda):
    """The tiled XLA branch on the card (2x2 tiles, no launch): the same
    noise and iterations as its CPU run, and within the gate of
    tests/test_spatial.py:350-354 of the card's B8/B9 run."""
    res = (180, 240)
    d = tiled_stream(res=res, n_points=150)
    cfg = lambda mode: tiled_cfg(res=res, optimizer=OptimizerConfig(
        scale=1, max_iter=10, min_events=300, scatter_mode=mode))
    run = lambda mode, dev: compensate_recording_tiled(
        d["x"], d["y"], d["t_ns"], cfg(mode), make_tiled_mesh((2, 2),
                                                              device=dev),
        halo=8, esc_cap=4096)
    rg, rc, rk = run("xla", cuda), run("xla", "cpu"), run("pallas", cuda)
    assert not any(rg["stats"]["launches"].values())
    assert rg["stats"]["escaped_dropped"] == 0
    for k in ("noise", "iters"):
        np.testing.assert_array_equal(rg[k], rc[k])
        np.testing.assert_array_equal(rg[k], rk[k])
    ok = ~rk["noise"]
    speed = float(np.hypot(rk["u"][ok], rk["v"][ok]).mean())
    assert speed > 20.0
    for k in ("u", "v"):
        assert float(np.median(np.abs(rg[k] - rc[k]))) == 0.0
        dk = np.abs(rg[k][ok] - rk[k][ok])
        assert np.median(dk) <= 0.001 * speed and dk.max() <= 0.05 * speed


def test_merged_scan_on_card_is_the_split_scan(cuda):
    """``megastep_merged`` on the card: bitwise the B1 + B2 + B4 scan, one
    B12 launch an iteration plus one a slice that runs, and no B4."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    run = lambda cfg: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], cfg, device=cuda)
    rs = run(small_cfg())
    rm = run(small_cfg(megastep_merged=True))
    for k in ("u", "v", "noise", "iters", "ran"):
        np.testing.assert_array_equal(rm[k], rs[k])
    lm = rm["stats"]["launches"]
    assert lm["megastep2"] == int(rm["iters"].sum()) + int(rm["ran"].sum())
    assert lm["warp_uv"] == lm["warp_images_st"] == lm["megastep"] == 0
    assert lm["act_rows"] == 1


@pytest.mark.parametrize("order", ["sorted", "staged"])
def test_run_optimizer_pallas_branch_on_card(cuda, order):
    """``run_optimizer`` with "pallas": one B11 launch an iteration, on
    events sorted by ``sort_key_blocks`` or in their staged order; the CPU
    run's iterations, and its warp and totals within f32 rounding."""
    from better_flow_tpu_torch.core.events import make_slice
    from better_flow_tpu_torch.core.model import MotionModel
    from better_flow_tpu_torch.models import global_flow as tgf

    d = synthetic_events(3000, duration_s=0.1, res_x=24, res_y=32, vx=18.0,
                         vy=-12.0, n_points=60, seed=6)
    t = (d["t_ns"] - d["t_ns"][0]).astype(np.float32)
    key = (d["x"].astype(np.int64) // 32) * 4096 + d["y"]
    o = np.argsort(key, kind="stable") if order == "sorted" \
        else np.arange(len(t))
    bbox = (int(d["x"].min()), int(d["x"].max()), int(d["y"].min()),
            int(d["y"].max()))
    geom = tgf.geometry_from_bbox(*bbox, 3, small_cfg().sensor)
    opt = OptimizerConfig(scale=3, scatter_mode="pallas")
    name = "fused_model_partials_windowed"

    def run(dev):
        ev = make_slice(d["x"][o], d["y"][o], t[o], capacity=4096,
                        device=dev)
        before = tfm.LAUNCHES[name]
        final, _ = tgf.run_optimizer(tgf.warp_init(ev, MotionModel.zero(dev)),
                                     ev, geom, 3, H, W, opt)
        return final, tfm.LAUNCHES[name] - before

    (fg, n), (fc, _) = run(cuda), run(torch.device("cpu"))
    assert n == fg.iters == fc.iters > 2
    _close(fg.pr_x, fc.pr_x, rtol=1e-5, atol=1e-4)
    _close(fg.model.totals4(), fc.model.totals4(), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("cont", [0.0, 1.0])
def test_predicated_b1_b2_kernels(cuda, cont):
    """B1 and B2 with ``predicated=1`` on the card (the unrolled drive of
    ``megastep_unroll``): on a state whose CONT is 0, B1 copies ``pr``
    into ``new_pr`` and adds nothing, B2 copies the state and leaves the
    pair as it is, bitwise; on a live state each is bitwise the
    unpredicated kernel, and the twins' results on the CPU."""
    d = slice_inputs(0)
    d["st"][0, layout.ST_CONT] = cont
    keys = ("stat", "act", "pr", "st", "geo")
    cpu, gpu = _both(d, keys, cuda)
    kw = dict(scale=SCALE, H=H, W=W, time_lo=False)
    fin = dict(scale=SCALE, H=H, W=W, **statics())
    pair = tfm.image_pair(cuda, H, W)
    npr, at, ac = _launched("warp_images_st", lambda: tfm.warp_images_st_call(
        *gpu, *pair, predicated=1, **kw))
    npr_p, at_p, ac_p = tfm.warp_images_st_call(
        *cpu, *tfm.image_pair("cpu", H, W), predicated=1, **kw)
    filled = (at.clone(), ac.clone())
    st = _launched("megastep_finish", lambda: tfm.megastep_finish_call(
        *pair, gpu[3], gpu[4], predicated=1, **fin))
    if cont == 0.0:
        assert torch.equal(npr, gpu[2]) and torch.equal(npr_p, cpu[2])
        assert not filled[0].any() and not filled[1].any()
        assert torch.equal(st, gpu[3])
        ones = (torch.ones_like(at), torch.ones_like(ac))
        tfm.megastep_finish_call(*ones, gpu[3], gpu[4], predicated=1, **fin)
        assert bool((ones[0] == 1).all() and (ones[1] == 1).all())
        return
    ref = tfm.warp_images_st_call(*gpu, *tfm.image_pair(cuda, H, W), **kw)
    assert all(torch.equal(a, b) for a, b in zip((npr,) + filled, ref))
    assert not pair[0].any() and not pair[1].any()   # B2 left it zero
    assert torch.equal(st, tfm.megastep_finish_call(*ref[1:], gpu[3],
                                                     gpu[4], **fin))
    _close(npr, npr_p, rtol=1e-6)
    assert torch.equal(filled[1].cpu(), ac_p) and int(ac_p.sum()) > 3000


def test_unrolled_scan_on_card_is_bitwise_one_iteration_a_trip(cuda):
    """``fast(megastep_unroll=2)`` and ``=4`` on the card: bitwise the
    ``megastep_unroll=1`` scan, one blocking read a loop trip (fewer than
    one an iteration), and ``unroll`` predicated B1 + B2 pairs a trip."""
    d = synthetic_events(30000, duration_s=0.5, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    run = lambda u: tscan.compensate_recording_scan(
        d["x"], d["y"], d["t_ns"], small_cfg(megastep_unroll=u), device=cuda)
    r1 = run(1)
    assert r1["stats"]["host_syncs"] == int(r1["iters"].sum())
    for u in (2, 4):
        ru = run(u)
        for k in ("u", "v", "noise", "iters", "ran"):
            np.testing.assert_array_equal(ru[k], r1[k])
        syncs, lc = ru["stats"]["host_syncs"], ru["stats"]["launches"]
        assert syncs < r1["stats"]["host_syncs"]
        assert lc["warp_images_st"] == lc["megastep_finish"] == u * syncs
        assert lc["warp_uv"] == int(ru["ran"].sum())
