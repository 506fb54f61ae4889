"""Numpy-seeded inputs for the PyTorch port's kernel tests.

Shared by the CPU tests against the JAX package (``test_torch_kernels.py``)
and the card tests (``test_torch_cuda.py``); imports no JAX and nothing of
the JAX package (the configs are the port's own dataclasses, which both
packages read by attribute).  Shapes are
small: by default 3 chunks, a 24x32 sensor at scale 3 (images 128x256).
"""

import json
import pathlib

import numpy as np
import torch

from better_flow_tpu_torch.config import (
    OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
)
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.io.synthetic import synthetic_events
from better_flow_tpu_torch.models import global_flow as tgf
from better_flow_tpu_torch.ops import layout
from better_flow_tpu_torch.ops.warp import UV_K

CH = layout.CHUNK
RES_X, RES_Y, SCALE = 24, 32, 3
SENSOR = SensorConfig(RES_X, RES_Y)
H, W = RES_X * SCALE + SCALE, RES_Y * SCALE + SCALE
NCH = 3


def slice_inputs(seed=0, res=(RES_X, RES_Y), scale=SCALE, nch=NCH):
    """A slice of ``nch`` chunks on a ``res`` sensor at ``scale`` (by
    default 3 chunks, 24x32, scale 3): integer pixels, f32 ns times,
    padding slots (slot 0 of chunk 1 among them, so that chunk's time base
    is a padding slot's t = 0), a few inactive events, positions one warp
    away from the pixels, the full-sensor geometry and a mid-optimization
    state."""
    rng = np.random.default_rng(seed)
    res_x, res_y = res
    n = nch * CH
    x = rng.integers(0, res_x, n).astype(np.float32)
    y = rng.integers(0, res_y, n).astype(np.float32)
    t = rng.uniform(0, 0.1e9, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[CH:CH + 100] = False
    valid[-500:] = False
    x[~valid] = y[~valid] = t[~valid] = 0
    stat = np.stack([x, y, t]).reshape(3, nch, CH).transpose(1, 0, 2).copy()
    act = (valid & (rng.uniform(size=n) > 0.05)).astype(np.float32)
    act = act.reshape(nch, 1, CH)
    pr = (stat[:, 0:2] + rng.normal(0, 0.3, (nch, 2, CH))).astype(np.float32)
    g = tgf.geometry_from_bbox(0, res_x - 1, 0, res_y - 1, scale,
                               SensorConfig(res_x, res_y))
    geo = tgf.geo_row(g)
    st = np.zeros((1, 32), np.float32)
    st[0, 0:4] = [0.02, -0.015, 3e-3, 2e-3]           # totals dx dy rot div
    st[0, 8:10] = ([12.3, 15.7] if res == (RES_X, RES_Y)   # centroid
                   else [res_x / 2 + 0.3, res_y / 2 - 0.3])
    st[0, 10:14] = [1.0, 2.0, 1e4, 2e4]               # dividers
    st[0, 14:18] = [-2e3, -1e3, -40.0, -35.0]         # slope memory
    st[0, 18:22] = [1e-4, 2e-4, 1e-3, -1e-3]          # last deltas
    st[0, layout.ST_ITERS] = 2.0
    st[0, layout.ST_CONT] = 1.0
    st[0, 24:28] = [0.3, -0.2, 0.5, 0.4]              # last gradient
    return dict(stat=stat, act=act, pr=pr, geo=geo, st=st, valid=valid)


def image_shape(res=(RES_X, RES_Y), scale=SCALE):
    """The static (H, W) of a ``res`` sensor at ``scale``."""
    return tgf.static_image_shape(scale, SensorConfig(*res))


def assert_state_close(got, want, skip=()):
    """(32,) states: ITERS and CONT exact, the Kahan compensations within
    2^-22 of their totals, the other slots (but ``skip``) to rtol 1e-5."""
    exact = [layout.ST_ITERS, layout.ST_CONT]
    np.testing.assert_array_equal(got[exact], want[exact])
    # Kahan compensations are the totals' rounding residues: any ulp in a
    # delta moves them anywhere within an ulp of the total.
    comp = slice(layout.ST_CDX, layout.ST_CDIV + 1)
    tot = slice(layout.ST_TDX, layout.ST_TDIV + 1)
    assert np.all(np.abs(got[comp] - want[comp])
                  <= np.abs(want[tot]) * 2.0 ** -22)
    rest = [k for k in range(32) if k not in exact and k not in skip
            and not layout.ST_CDX <= k <= layout.ST_CDIV]
    np.testing.assert_allclose(got[rest], want[rest], rtol=1e-5)


def statics(schedule="fast", exit_grad=4.0, exit_pred=0.0):
    """``megastep_finish_call``'s static arguments for a schedule and its
    exit options."""
    return tgf.finish_statics(OptimizerConfig.fast(
        schedule=schedule, exit_grad_factor=exit_grad,
        exit_predict_cap=exit_pred))


def small_cfg(**opt):
    """The 24x32 scan configuration of tests/test_fast_schedule.py."""
    return PipelineConfig(
        sensor=SENSOR,
        slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=OptimizerConfig.fast(scale=3, min_events=500, **opt))


def flow_gates(rt, rj, ran=True):
    """Two runs' per-event outputs (``noise``, ``u``, ``v`` in the original
    event order) and per-slice ``ran`` and ``iters``: noise and ran
    identical, the iteration sums within 10%, median |du| and |dv| under
    1% of the mean speed.  Returns the mask of non-noise events.
    ``ran=False`` leaves out the ``ran`` check, for results that have no
    ``ran`` (the cold path's)."""
    np.testing.assert_array_equal(rt["noise"], rj["noise"])
    if ran:
        np.testing.assert_array_equal(rt["ran"], rj["ran"])
    st, sj = int(rt["iters"].sum()), int(rj["iters"].sum())
    assert abs(st - sj) <= 0.1 * sj, (rt["iters"], rj["iters"])
    ok = ~rj["noise"]
    speed = float(np.hypot(rj["u"][ok], rj["v"][ok]).mean())
    assert np.median(np.abs(rt["u"][ok] - rj["u"][ok])) < 0.01 * speed
    assert np.median(np.abs(rt["v"][ok] - rj["v"][ok])) < 0.01 * speed
    return ok


def bench_stream(n):
    """The first ``n`` events of bench.py's stream (its 0.5 s segment)."""
    d = synthetic_events(500_000, duration_s=0.5, res_x=180, res_y=240,
                         vx=60.0, vy=-40.0, rot=0.12, div=0.05, n_points=800,
                         seed=42)
    return {k: v[:n] for k, v in d.items()}


# The benchmark's megapixel cell: its configuration (a 1280x720 Gen4
# sensor at scale 3, the upstream offline tool's slicing, fast()) and its
# traffic (3 M events/s).
_PORTBENCH = pathlib.Path(__file__).resolve().parents[1] / "portbench"
GEN4_CONFIG = json.loads(
    (_PORTBENCH / "configs" / "gen4-720p-offline-fast.json").read_text())
GEN4_MIX = json.loads(
    (_PORTBENCH / "traffic" / "gen4-long-64m.json").read_text())
GEN4_SCENE = GEN4_MIX["scene"]
GEN4_RATE = GEN4_MIX["rate_eps"]


def gen4_cfg():
    """The port's ``PipelineConfig`` of the megapixel configuration."""
    c = GEN4_CONFIG
    return PipelineConfig(sensor=SensorConfig(**c["sensor"]),
                          slice=SliceConfig(**c["slice"]),
                          optimizer=OptimizerConfig(**c["optimizer"]),
                          stm_disable=c["stm_disable"],
                          f64_totals=c["f64_totals"])


def gen4_stream(n, seed):
    """The first ``n`` events of a seeded stretch of the megapixel cell's
    scene, with their true flow u, v."""
    m = n + n // 10            # a few events leave the sensor
    d = synthetic_events(m, duration_s=m / GEN4_RATE, seed=seed,
                         **GEN4_SCENE)
    return {k: v[:n] for k, v in d.items()}


def gen4_start(x, y):
    """The scene's motion as the optimizer's model about the centroid
    (cx, cy) of the events (x, y): the totals (rot, div, dx, dy), in the
    warp's units (a flow of u px/s is a direction of -u / UV_K), and
    (cx, cy).  A warm start near the answer: from a zero model the first
    slice takes some 75 iterations of the whole 2163x3843 image."""
    s = GEN4_SCENE
    cx, cy = float(np.mean(x)), float(np.mean(y))
    ox, oy = cx - s["res_x"] / 2, cy - s["res_y"] / 2
    u = s["vx"] - s["rot"] * oy + s["div"] * ox
    v = s["vy"] + s["rot"] * ox + s["div"] * oy
    tot = [-c / UV_K for c in (s["rot"], s["div"], u, v)]
    return tot, cx, cy


def gen4_model(tot, cx, cy, device="cpu"):
    """The port's f32 model of ``gen4_start``'s numbers."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    z = f(0.0)
    return MotionModel(cx=f(cx), cy=f(cy), dx=z, dy=z, rot=z, div=z, cnt=z,
                       total_rot=f(tot[0]), total_div=f(tot[1]),
                       total_dx=f(tot[2]), total_dy=f(tot[3]),
                       comp_dx=z, comp_dy=z, comp_rot=z, comp_div=z)


def gate_stream():
    """tests/test_scan_pipeline.py's stream whose window gate fires
    mid-recording: structureless noise, one pixel, noise."""
    rng = np.random.default_rng(3)

    def phase(n, t0, gen):
        t = np.sort(rng.integers(0, int(0.15e9), n)) + t0
        x, y = gen(n)
        return x.astype(np.float64), y.astype(np.float64), t

    healthy = lambda n: (rng.integers(0, 24, n), rng.integers(0, 32, n))
    point = lambda n: (np.full(n, 7), np.full(n, 9))
    xs, ys, ts = zip(phase(3000, 0, healthy),
                     phase(3000, int(0.15e9), point),
                     phase(3000, int(0.30e9), healthy))
    return {"x": np.concatenate(xs), "y": np.concatenate(ys),
            "t_ns": np.concatenate(ts).astype(np.int64)}


def local_splat_inputs(seed=0, n_tiles=3, n=5000, H=250, W=300, sort=True):
    """B8's inputs for ``n_tiles`` tiles of ``n`` slots: f32 integer
    positions in an H x W frame drawn around 60 cluster centres (dense 3x3
    neighbourhoods, so that the finish has gradients), about 5% rejected
    (-1), times in [0, 0.2) s; slot CHUNK of every tile (the second chunk's
    time base) is a rejected slot with t = 0.  ``sort`` orders each tile's
    slots by (x, y), as the tiled staging does."""
    rng = np.random.default_rng(seed)
    lx = np.empty((n_tiles, n), np.float32)
    ly = np.empty((n_tiles, n), np.float32)
    for k in range(n_tiles):
        c = rng.integers(0, 60, n)
        cx, cy = rng.uniform(0, H, 60), rng.uniform(0, W, 60)
        lx[k] = np.clip(np.rint(cx[c] + rng.normal(0, 2.0, n)), 0, H - 1)
        ly[k] = np.clip(np.rint(cy[c] + rng.normal(0, 2.0, n)), 0, W - 1)
    t = (rng.random((n_tiles, n)) * 0.2).astype(np.float32)
    rej = rng.uniform(size=(n_tiles, n)) < 0.05
    lx[rej] = ly[rej] = -1
    if sort:
        for k in range(n_tiles):
            o = np.lexsort((ly[k], lx[k]))
            lx[k], ly[k], t[k] = lx[k][o], ly[k][o], t[k][o]
    if n > CH:
        lx[:, CH] = ly[:, CH] = -1
        t[:, CH] = 0
    return lx, ly, t


def tiled_cfg(res=(96, 128), optimizer=None):
    """A small-sensor cut of the tiled recording protocol of
    tests/test_spatial.py (slices of <= 6000 events / 70 ms, a retrigger
    every 2500 events / 30 ms; scale 1, at most 10 iterations by
    default)."""
    return PipelineConfig(
        sensor=SensorConfig(*res),
        slice=SliceConfig(max_events=6000, span_ns=int(0.07e9),
                          refresh_events=2500, refresh_time_ns=int(0.03e9)),
        optimizer=optimizer or OptimizerConfig(scale=1, max_iter=10,
                                               min_events=300))


def tiled_stream(n=30_000, res=(96, 128), seed=4, **kw):
    """A dense moving scene on a small sensor (jitter fattens the clusters
    so that 3x3 neighbourhoods fill at scale 1)."""
    args = dict(duration_s=n / 150_000, res_x=res[0], res_y=res[1], vx=60.0,
                vy=-40.0, rot=0.1, div=0.03, n_points=60, jitter_px=1.5,
                seed=seed)
    args.update(kw)
    return synthetic_events(n, **args)


def partials_inputs(seed=0, res=(RES_X, RES_Y), scale=SCALE, n=None,
                    spread="wide", sort=True):
    """B10's and B11's flat inputs on a ``res`` sensor: f32 warped
    positions ``pr_x``, ``pr_y`` (pixels drawn around 40 cluster centres,
    ``spread`` "wide" with 2.5 px around them, "tight" with 0.3 px around
    three, as a converged slice piles events up), f32 ``t_ns`` in [0, 0.1)
    s, ``active`` with about 5% inactive slots and a ragged padded tail
    (n not a chunk multiple), the original pixels ``x``, ``y`` and the
    full-sensor (1, 8) geometry row.  ``sort`` orders the events by
    ``sort_key_blocks`` of their original pixels, inactive ones last."""
    rng = np.random.default_rng(seed)
    res_x, res_y = res
    n = n if n is not None else 2 * CH + 700
    k_c, sd = (40, 2.5) if spread == "wide" else (3, 0.3)
    c = rng.integers(0, k_c, n)
    cx, cy = rng.uniform(2, res_x - 2, k_c), rng.uniform(2, res_y - 2, k_c)
    x = np.clip(np.rint(cx[c] + rng.normal(0, sd, n)), 0, res_x - 1)
    y = np.clip(np.rint(cy[c] + rng.normal(0, sd, n)), 0, res_y - 1)
    pr_x = (x + rng.normal(0, 0.3, n)).astype(np.float32)
    pr_y = (y + rng.normal(0, 0.3, n)).astype(np.float32)
    t = rng.uniform(0, 0.1e9, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.05
    if sort:
        key = np.where(active, (x.astype(np.int64) // 32) * 4096 + y,
                       1 << 30)
        o = np.argsort(key, kind="stable")
        x, y, pr_x, pr_y, t, active = (a[o] for a in
                                       (x, y, pr_x, pr_y, t, active))
    g = tgf.geometry_from_bbox(0, res_x - 1, 0, res_y - 1, scale,
                               SensorConfig(res_x, res_y))
    return dict(pr_x=pr_x, pr_y=pr_y, t_ns=t, active=active,
                x=x.astype(np.float32), y=y.astype(np.float32),
                geo=tgf.geo_row(g))


def per_slice_run_slices(prepared, cfg, carry0, group=None):
    """``run_slices`` as the slice loop ran it on the megastep drives
    before the device carry: one B3 launch for the range, then per slice
    ``process_slice`` from the model (``initial_state`` of it inside the
    drive), the model out of the final state (``model_from_state``) and
    the seed row ``torch.cat([seed, totals])``.  Warm start, no
    extrapolation.  Same arguments and returns as ``run_slices``."""
    import torch

    from better_flow_tpu_torch.ops import fused_model as tfm
    from better_flow_tpu_torch.runtime import scan_pipeline as tscan

    hist_np, hist_end = tscan.staged_histories(prepared, carry0)
    stat, geo = prepared["stat"], prepared["geo"]
    act_all = tfm.act_rows_call(prepared["sidx"],
                                torch.from_numpy(hist_np).to(stat.device))
    S = stat.shape[0]
    uvn = torch.empty((S, stat.shape[1], 3, CH), dtype=torch.float32,
                      device=stat.device)
    iters, ran = np.zeros(S, np.int32), np.zeros(S, bool)
    model, sd = carry0[:2]
    syncs = 0
    for s in range(S):
        cur_tot = model.totals4().to(torch.float32)
        res, _ = tgf.process_slice(
            stat[s], act_all[s], model, cfg.optimizer, cfg.sensor,
            prepared["bbox"][s], int(prepared["nval"][s]), seed=sd[:8],
            geo=geo[s], group=group, uvn_out=uvn[s])
        model, sd = res.model, torch.cat([res.seed, cur_tot])
        iters[s], ran[s] = res.iters, res.ran
        syncs += res.reads
    return (model, sd) + hist_end, uvn, iters, ran, syncs


def carry_bits(carry):
    """A carry's model fields and seed row as dtype and raw bytes, for
    bitwise comparisons that tell -0.0 from 0.0 and keep NaNs."""
    import torch

    from better_flow_tpu_torch.core.model import FIELDS

    raw = lambda t: (str(t.dtype), t.detach().cpu().reshape(-1).contiguous()
                     .view(torch.uint8).numpy().tobytes())
    model, sd = carry[:2]
    return {**{f: raw(getattr(model, f)) for f in FIELDS}, "seed": raw(sd)}
