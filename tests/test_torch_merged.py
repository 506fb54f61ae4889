"""B12, the merged megastep, and its drive: the PyTorch port's
``megastep2_call`` (its plain twin on the CPU) and
``OptimizerConfig.megastep_merged`` against the JAX package's (Pallas in
interpret mode), and against the port's own B5 / B1 + B2 chain with B4.

A merged call runs the previous call's finish and model update at its
head, then warps every event and, while the loop continues, splats it; the
call whose head ends the loop is the final warp.  The port builds it from
the same arithmetic as its B1, B2 and B4 (the kernels share their device
functions), so a merged slice is BITWISE the megastep drive's: iterations,
state, positions, u and v.  Against the JAX package: iterations equal as
in its own merged gate (``tests/test_fast_schedule.py:286-329``; the TPU
kernel's merged expression is contracted differently from its split
kernels'); u and v within its rtol 1e-5 atol 1e-4 under the reference
schedule, and under ``fast()`` no further from its merged drive than from
its megastep drive (see ``test_merged_slice_matches_jax``); the state
within the finish kernel's tolerances (``torch_inputs.assert_state_close``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from better_flow_tpu.config import OptimizerConfig as JaxOpt  # noqa: E402
from better_flow_tpu.core.events import EventSlice  # noqa: E402
from better_flow_tpu.core.model import MotionModel as JaxModel  # noqa: E402
from better_flow_tpu.models.global_flow import (  # noqa: E402
    process_slice as jax_process_slice,
)
from better_flow_tpu.ops.pallas import fused_model as jfm  # noqa: E402
from better_flow_tpu.runtime import scan_pipeline as jscan  # noqa: E402
from better_flow_tpu_torch.config import OptimizerConfig  # noqa: E402
from better_flow_tpu_torch.core.model import MotionModel  # noqa: E402
from better_flow_tpu_torch.io.synthetic import synthetic_events  # noqa: E402
from better_flow_tpu_torch.models import global_flow as tgf  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from better_flow_tpu_torch.ops import layout  # noqa: E402
from better_flow_tpu_torch.ops.layout import pack_act  # noqa: E402
from better_flow_tpu_torch.parallel.mesh import make_event_mesh  # noqa: E402
from better_flow_tpu_torch.runtime import scan_pipeline as tscan  # noqa: E402
from torch_inputs import (  # noqa: E402
    SENSOR, assert_state_close, image_shape, slice_inputs, small_cfg,
)

KEYS = ("stat", "act", "pr", "st", "geo")
SCHEDULES = {"reference": OptimizerConfig(scale=3, min_events=500),
             "fast": OptimizerConfig.fast(scale=3, min_events=500)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _merged(opt, **kw):
    return dataclasses.replace(opt, megastep_merged=True, **kw)


# ------------------------------------------------------------- the call


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("res,scale,nch", [((24, 32), 3, 3),
                                           ((180, 240), 3, 2)])
def test_megastep2_twin_matches_pallas(res, scale, nch, schedule):
    """A slice's first call (state copied, CONT forced) and its second (the
    head finish of the first call's images) against the Pallas kernels.
    The first call's warp and images are bitwise the Pallas B1's from the
    same state; the Pallas B12 itself compiles the warp differently from
    its own B1 (up to ~1e-3 px here), so it is held to that; the states
    to the finish kernel's tolerances."""
    d = slice_inputs(0, res=res, scale=scale, nch=nch)
    d["st"][0, layout.ST_HAS] = 0.0
    H, W = image_shape(res, scale)
    opt = SCHEDULES[schedule]
    time_lo = opt.splat_time_lo or schedule != "fast"
    kw = dict(scale=scale, H=H, W=W, time_lo=time_lo,
              **tgf.finish_statics(opt))
    HP, WP = layout.padded_image_shape(H, W)
    pr4 = np.concatenate([d["pr"], np.zeros_like(d["pr"])], axis=1)
    zj = jnp.zeros((HP, WP), jnp.float32)
    j1 = jfm.megastep2_call(d["stat"], d["act"], pr4, d["st"], zj, zj,
                            d["geo"], **kw)
    j2 = jfm.megastep2_call(d["stat"], d["act"], j1[0], j1[1], j1[2], j1[3],
                            d["geo"], **kw)
    z_t = torch.zeros((HP, WP), dtype=torch.int64)
    z_c = torch.zeros((HP, WP), dtype=torch.int32)
    stat, act, geo = _t(d["stat"]), _t(d["act"]), _t(d["geo"])
    t1 = tfm.megastep2_call(stat, act, _t(pr4), _t(d["st"]), z_t, z_c, geo,
                            **kw)
    # The second call reads the pair, clears it and splats into it: give it
    # a copy, so that t1 keeps the first call's images.
    t2 = tfm.megastep2_call(stat, act, t1[0], t1[1], t1[2].clone(),
                            t1[3].clone(), geo, **kw)
    # The head of a first call: the state copied, CONT and HAS set.
    want = d["st"].copy()
    want[0, layout.ST_CONT] = want[0, layout.ST_HAS] = 1.0
    np.testing.assert_array_equal(t1[1].numpy(), want)
    b1 = jfm.warp_images_st_call(d["stat"], d["act"], d["pr"], want,
                                 d["geo"], scale=scale, H=H, W=W,
                                 time_lo=time_lo)
    np.testing.assert_array_equal(t1[0][:, 0:2].numpy(), np.asarray(b1[0]))
    np.testing.assert_array_equal(t1[3].numpy(), np.asarray(b1[2]))
    np.testing.assert_allclose(tfm.time_image_f32(t1[2]).numpy(),
                               np.asarray(b1[1]), rtol=1e-5, atol=1e-6)
    for t, j in ((t1, j1), (t2, j2)):
        np.testing.assert_allclose(t[0][:, 0:2].numpy(),
                                   np.asarray(j[0])[:, 0:2], rtol=1e-5,
                                   atol=2e-3)
        np.testing.assert_allclose(t[0][:, 2:4].numpy(),
                                   np.asarray(j[0])[:, 2:4], rtol=1e-5,
                                   atol=5e-5)
        assert int(t[3].sum()) == int(np.asarray(j[3]).sum())
    assert_state_close(t2[1].numpy()[0], np.asarray(j2[1])[0],
                       skip=(layout.ST_FB,))
    assert float(t2[1][0, layout.ST_ITERS]) == d["st"][0, layout.ST_ITERS] + 1
    assert int(t1[3].sum()) > 1000


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_megastep2_twin_is_b1_b2_b4_chain(schedule):
    """The second call bitwise: B2 on the first call's images gives its
    state, B4 (or the next B1) from that state its warp."""
    d = slice_inputs(1)
    d["st"][0, layout.ST_HAS] = 0.0
    opt = SCHEDULES[schedule]
    kw = dict(scale=3, H=image_shape()[0], W=image_shape()[1],
              time_lo=True, **tgf.finish_statics(opt))
    chain = {k: v for k, v in kw.items() if k != "time_lo"}
    geo_kw = dict(scale=3, H=kw["H"], W=kw["W"])
    stat, act, pr, st, geo = (_t(d[k]) for k in KEYS)
    HP, WP = layout.padded_image_shape(kw["H"], kw["W"])
    pr4 = torch.cat([pr, torch.zeros_like(pr)], dim=1)
    first = tfm.megastep2_plain(stat, act, pr4, st,
                                torch.zeros((HP, WP), dtype=torch.int64),
                                torch.zeros((HP, WP), dtype=torch.int32),
                                geo, **kw)
    second = tfm.megastep2_plain(stat, act, first[0], first[1],
                                 first[2].clone(), first[3].clone(), geo,
                                 **kw)
    npr1, at1, ac1 = tfm.warp_images_st_call(
        stat, act, pr, first[1], geo, *tfm.image_pair("cpu", kw["H"], kw["W"]),
        **geo_kw)
    assert torch.equal(first[0][:, 0:2], npr1)
    assert torch.equal(first[2], at1) and torch.equal(first[3], ac1)
    st2 = tfm.megastep_finish_call(at1, ac1, first[1], geo, **chain)
    assert torch.equal(second[1], st2)
    out, _ = tfm.warp_uv_call(stat, npr1, act, st2)
    assert torch.equal(second[0], out)


@pytest.mark.parametrize("twin", ["b1", "b2", "b12", "b12_exit"])
def test_twins_hold_the_pair_contract(twin):
    """The image pair's contract, which the kernels keep on the card and
    the twins on the CPU: B1 adds its splat into the given pair; B2 reads
    the pair and leaves it zero; B12 reads the pair, clears it and splats
    into those very tensors, and leaves it zero on the call that clears
    CONT."""
    d = slice_inputs(1)
    opt = SCHEDULES["fast"]
    H, W = image_shape()
    geo_kw = dict(scale=3, H=H, W=W)
    chain = dict(geo_kw, **tgf.finish_statics(
        dataclasses.replace(opt, max_iter=1) if twin == "b12_exit" else opt))
    stat, act, pr, st, geo = (_t(d[k]) for k in KEYS)
    _, at, ac = tfm.warp_images_st_call(stat, act, pr, st, geo,
                                        *tfm.image_pair("cpu", H, W),
                                        time_lo=True, **geo_kw)
    assert int(ac.sum()) > 1000
    pair = (at.clone(), ac.clone())          # holds one call's splat
    if twin == "b1":
        _, t, c = tfm.warp_images_st_call(stat, act, pr, st, geo, *pair,
                                          time_lo=True, **geo_kw)
        assert t is pair[0] and c is pair[1]
        assert torch.equal(t, 2 * at) and torch.equal(c, 2 * ac)
    elif twin == "b2":
        st2 = tfm.megastep_finish_call(*pair, st, geo, **chain)
        assert not pair[0].any() and not pair[1].any()
        assert torch.equal(st2, tfm.megastep_plain(
            stat, act, pr, st, geo, time_lo=True, **chain)[1])
    else:
        st[0, layout.ST_HAS] = 1.0       # a later call: the head runs
        pr4 = torch.cat([pr, torch.zeros_like(pr)], dim=1)
        npr, st_out, t, c = tfm.megastep2_call(stat, act, pr4, st, *pair, geo,
                                               time_lo=True, **chain)
        assert t is pair[0] and c is pair[1]
        st2 = tfm.megastep_finish_call(at, ac, st, geo, **chain)
        assert torch.equal(st_out, st2)
        if twin == "b12_exit":
            assert float(st_out[0, layout.ST_CONT]) == 0.0
            assert not t.any() and not c.any()
        else:
            assert float(st_out[0, layout.ST_CONT]) == 1.0
            _, at2, ac2 = tfm.warp_images_st_call(
                stat, act, pr, st2, geo, *tfm.image_pair("cpu", H, W),
                time_lo=True, **geo_kw)
            assert torch.equal(t, at2) and torch.equal(c, ac2)
            assert torch.equal(npr[:, 0:2], tfm.warp_images_st_call(
                stat, act, pr, st2, geo, *tfm.image_pair("cpu", H, W),
                time_lo=True, **geo_kw)[0])


# --------------------------------------------------------- the drive


def _slice(seed=3):
    """tests/test_fast_schedule.py:286-291's slice, sorted by
    ``sort_key_blocks`` as the JAX package's pallas branch sorts it."""
    d = synthetic_events(3000, duration_s=0.1, res_x=24, res_y=32,
                         n_points=60, seed=seed, vx=8.0, vy=-5.0, rot=0.05,
                         div=0.02)
    x, y = d["x"].astype(np.float32), d["y"].astype(np.float32)
    t = (d["t_ns"] - d["t_ns"][0]).astype(np.float32)
    o = np.argsort((x.astype(np.int64) // 32) * 4096 + y, kind="stable")
    x, y, t = x[o], y[o], t[o]
    cap = 3 * layout.CHUNK
    pad = lambda a: np.concatenate([a, np.zeros(cap - len(a), a.dtype)])
    valid = pad(np.ones(len(x), bool))
    bbox = (int(x.min()), int(x.max()), int(y.min()), int(y.max()))
    return dict(x=pad(x), y=pad(y), t=pad(t), valid=valid, bbox=bbox,
                n=len(x))


def _port_slice(s, opt, group=None):
    stat = layout.prepare_chunk_layouts(_t(s["x"]), _t(s["y"]), _t(s["t"]))
    act = pack_act(_t(s["valid"]))
    return tgf.process_slice(stat, act, MotionModel.zero(), opt, SENSOR,
                             s["bbox"], s["n"], group=group)


def _jax_slice(s, opt):
    ev = EventSlice(x=jnp.asarray(s["x"]), y=jnp.asarray(s["y"]),
                    t=jnp.asarray(s["t"]), valid=jnp.asarray(s["valid"]),
                    noise=jnp.zeros(len(s["x"]), bool))
    return jax_process_slice(ev, JaxModel.zero(), opt, SENSOR,
                             presorted=True)


def _merged_drives(schedule):
    """The port's merged drive, the JAX package's merged drive and its
    megastep drive on the slice of the JAX merged gate."""
    s = _slice()
    opt = _merged(SCHEDULES[schedule])
    jopt = lambda o: JaxOpt(**{**dataclasses.asdict(o),
                               "scatter_mode": "pallas"})
    return (_port_slice(s, opt)[0], _jax_slice(s, jopt(opt)),
            _jax_slice(s, jopt(SCHEDULES[schedule])))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_merged_slice_matches_jax(schedule):
    """The merged drive against the JAX package's merged drive on the
    slice of its own merged gate: iterations equal; u and v within the
    port's cross-package bound of the kernel branch (rtol 1e-3, atol 1e-2,
    ``tests/test_torch_slice.py``), and no further from the JAX merged
    drive than from the JAX megastep drive plus the JAX package's own
    merged gate (rtol 1e-5, atol 1e-4): what separates the two packages is
    the chain's sums, not B12.  Under the reference schedule the JAX merged
    gate itself holds; under ``fast()`` a few events miss it by as much as
    they miss the JAX megastep drive (``python tests/test_torch_merged.py``
    prints the gaps)."""
    rt, rj, rm = _merged_drives(schedule)
    assert rt.ran and rt.iters >= 2
    assert rt.iters == int(rj.iters) == int(rm.iters)
    for f in ("u", "v"):
        got, j, m = (np.asarray(getattr(r, f)) for r in (rt, rj, rm))
        np.testing.assert_allclose(got, j, rtol=1e-3, atol=1e-2)
        assert np.all(np.abs(got - j)
                      <= np.abs(got - m) + 1e-4 + 1e-5 * np.abs(m)), f
        if schedule == "reference":
            np.testing.assert_allclose(got, j, rtol=1e-5, atol=1e-4)


def _counted(monkeypatch):
    calls = {"megastep2": 0, "megastep": 0, "warp_images_st": 0,
             "megastep_finish": 0, "warp_uv": 0, "fused_warp_splat": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    for name in calls:
        monkeypatch.setattr(tgf, f"{name}_call",
                            counted(name, getattr(tfm, f"{name}_call")))
    return calls


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_merged_slice_is_the_megastep_drive_bitwise(monkeypatch, schedule):
    """Merged against the port's B5 (reference) or B1 + B2 (fast) drive
    with B4: iterations, model, seed, positions, direction vectors, u, v
    and the scan's pack bitwise; one B12 call more than iterations and no
    B4."""
    s = _slice()
    rm, um = _port_slice(s, SCHEDULES[schedule])
    calls = _counted(monkeypatch)
    rg, ug = _port_slice(s, _merged(SCHEDULES[schedule]))
    assert calls["megastep2"] == rg.iters + 1
    assert sum(calls.values()) == calls["megastep2"]     # no B4, no B5/B1
    assert rg.iters == rm.iters >= 2
    for f in ("pr_x", "pr_y", "nx", "ny", "u", "v", "seed"):
        assert torch.equal(getattr(rg, f), getattr(rm, f)), f
    assert torch.equal(rg.model.totals4(), rm.model.totals4())
    assert torch.equal(rg.model.cx, rm.model.cx)
    assert torch.equal(ug, um)


def test_merged_flag_ignored_under_a_group_and_on_the_composed_loop(
        monkeypatch):
    """As in the JAX package: an event group (the split drive around the
    image sum) and the composed loop (``use_megastep=False``) run as
    without the flag, bitwise, and never call B12."""
    s = _slice()
    group = make_event_mesh(3, device="cpu")   # a chunk a shard
    base = SCHEDULES["fast"]
    cases = [(dict(group=group), base),
             (dict(), dataclasses.replace(base, use_megastep=False))]
    for kw, opt in cases:
        want, uw = _port_slice(s, opt, **kw)
        calls = _counted(monkeypatch)
        got, ug = _port_slice(s, _merged(opt), **kw)
        assert calls["megastep2"] == 0 and got.iters == want.iters >= 2
        assert torch.equal(got.u, want.u) and torch.equal(ug, uw)


@pytest.mark.parametrize("schedule", ["reference", "fast"])
def test_merged_scan_is_the_megastep_scan_and_matches_jax(schedule):
    """The scan with ``megastep_merged``: bitwise the port's megastep scan
    (B5 or B1 + B2, then B4), and against the JAX package's merged scan the
    same noise flags and iterations slice for slice while the 24x32 chain
    does not drift (every slice under the reference schedule, the first
    two under ``fast()``, see ``tests/test_torch_xla_branch.py``)."""
    d = synthetic_events(12000, duration_s=0.2, res_x=24, res_y=32, vx=20.0,
                         vy=-14.0, seed=2)
    kw = dict(scatter_mode="pallas")
    if schedule == "reference":
        kw.update(schedule="reference", exit_grad_factor=0.0,
                  megastep_split=False)
    base = small_cfg(**kw)
    cfg = small_cfg(megastep_merged=True, **kw)
    rm = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], base,
                                         device="cpu")
    rg = tscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg,
                                         device="cpu")
    for k in ("u", "v", "noise", "iters", "ran"):
        np.testing.assert_array_equal(rg[k], rm[k])
    rj = jscan.compensate_recording_scan(d["x"], d["y"], d["t_ns"], cfg)
    assert len(rg["iters"]) >= 6 and rg["ran"].all()
    agree = len(rg["iters"]) if schedule == "reference" else 2
    np.testing.assert_array_equal(rg["iters"][:agree], rj["iters"][:agree])
    np.testing.assert_array_equal(rg["noise"], rj["noise"])


if __name__ == "__main__":
    # The merged drive's largest |du|, |dv| against the JAX package's merged
    # and megastep drives, and the events outside the JAX merged gate:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_merged.py
    for schedule in sorted(SCHEDULES):
        rt, rj, rm = _merged_drives(schedule)
        for f in ("u", "v"):
            got, j, m = (np.asarray(getattr(r, f)) for r in (rt, rj, rm))
            miss = int((~np.isclose(got, j, rtol=1e-5, atol=1e-4)).sum())
            print(f"{schedule} {f}: iterations {rt.iters}; max |d| against "
                  f"JAX merged {np.abs(got - j).max():.6g}, against JAX "
                  f"megastep {np.abs(got - m).max():.6g}; JAX merged against "
                  f"JAX megastep {np.abs(j - m).max():.6g}; outside rtol "
                  f"1e-5 atol 1e-4 of JAX merged: {miss} of {got.size}")
