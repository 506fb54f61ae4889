"""Offline pipeline over the slices of a recording, on one device.

Counterpart of ``better_flow_tpu/runtime/scan_pipeline.py`` (the path
``bench.py`` measures):

1. Host: the trigger plan (``plan_slices``) and the native counting sort
   into band-padded compact slabs (``better_flow_tpu.io.native``), copied
   to the device from pinned memory without blocking, batch by batch, so a
   batch's copy overlaps the next batch's sort.
2. Device: a Python loop over the slices.  Per slice the activity rows are
   built from the window-gate history (B3) and the optimizer runs through
   the kernels: the megastep drive (B5, or B1 + B2) with B4, or, for f64
   totals (``PipelineConfig.f64_totals``) or ``use_megastep=False``, the
   composed loop on B6.  The gates, the history and the geometry are host
   values known after staging, so the loop reads the device only for the
   optimizer's continue flag.
3. First-slice-wins accumulation into per-event arrays on the device, one
   slice at a time in reverse order, then one fetch to the host.

The carry between slices is (model, seed, gate history): the model (f64
totals under ``f64_totals``) and the (12,) f32 seed live on the device,
the (K,) gate history [fired, start, end] on the host.  Recordings the
JAX package routes to its cold path, range staging (``slice_range``) and
the numpy staging fallback are not ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from better_flow_tpu.config import PipelineConfig
from better_flow_tpu.io import native
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.models.global_flow import (
    check_supported, geo_row, geometry_from_bbox, process_slice,
)
from better_flow_tpu_torch.ops.fused_model import LAUNCHES, act_rows_call
from better_flow_tpu_torch.ops.layout import BAND_ROWS, CHUNK, PERM_SENTINEL


class SlicePlan(NamedTuple):
    starts: np.ndarray          # [S] first original index of each slice
    ends: np.ndarray            # [S] last original index (the trigger)
    slice_start_ns: np.ndarray  # [S] slice-local time origin


def plan_slices(t_ns: np.ndarray, cfg: PipelineConfig) -> SlicePlan:
    """Trigger points and slice windows (dvs_flow.h:163-193): a trigger
    every ``refresh_events`` events or ``refresh_time_ns``, whichever comes
    first, plus a final flush; the window at a trigger is the newest
    events within ``max_events`` and ``span_ns``."""
    sl = cfg.slice
    n = len(t_ns)
    if n == 0:
        z = np.zeros(0, np.int64)
        return SlicePlan(starts=z, ends=z.copy(), slice_start_ns=z.copy())
    ends = []
    last_slice_time = 0
    start = 0
    while start < n:
        i_count = start + sl.refresh_events - 1
        i_time = int(np.searchsorted(t_ns[start:],
                                     last_slice_time + sl.refresh_time_ns,
                                     "left")) + start
        i = min(i_count, i_time)
        if i >= n:
            break
        ends.append(i)
        last_slice_time = int(t_ns[i])
        start = i + 1
    if not ends or ends[-1] != n - 1:
        ends.append(n - 1)
    ends = np.asarray(ends, np.int64)
    latest = t_ns[ends]
    span_first = np.searchsorted(t_ns, latest - sl.span_ns, side="left")
    cap_first = np.maximum(ends - sl.max_events + 1, 0)
    starts = np.maximum(span_first, cap_first)
    lens = ends - starts + 1
    full = lens == sl.max_events
    slice_start = np.where(full, t_ns[starts],
                           np.maximum(latest - sl.span_ns, 0))
    return SlicePlan(starts=starts, ends=ends, slice_start_ns=slice_start)


def history_depth(plan: SlicePlan) -> int:
    """K, the number of earlier slices whose windows can overlap a slice's
    window: the depth of the window-gate history."""
    S = len(plan.ends)
    first_overlap = np.searchsorted(plan.ends, plan.starts)
    return max(1, int(np.max(np.arange(S) - first_overlap, initial=1)))


def row_bands(cfg: PipelineConfig) -> int:
    """Row bands of the host spatial sort."""
    return max(cfg.sensor.res_x + BAND_ROWS - 1, BAND_ROWS) // BAND_ROWS


def padded_capacity(cfg: PipelineConfig) -> int:
    """Slots per slice: the ring capacity plus a chunk of padding per row
    band, rounded up to a chunk."""
    cap = cfg.slice.max_events
    return -(-(cap + row_bands(cfg) * (CHUNK - 1)) // CHUNK) * CHUNK


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host -> device copy; on a card from a pinned copy, without blocking
    the host (PyTorch keeps the pinned buffer until the copy is done)."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def prepare_recording(x, y, t_ns, cfg: PipelineConfig, device=None) -> dict:
    """Host staging: trigger plan, native sort into band-padded slabs,
    and the device copies ``stat`` (S, nch, 3, CHUNK) f32 and ``sidx``
    (S, capp) int32 (original index, -1 on padding).  Reusable across runs
    of the same recording."""
    dev = torch.device(device) if device is not None else default_device()
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    t0 = last = time.perf_counter()
    phases = {}

    def _mark(name):
        nonlocal last
        now = time.perf_counter()
        phases[name] = round(phases.get(name, 0.0) + now - last, 4)
        last = now

    plan = plan_slices(t_ns, cfg)
    _mark("plan")
    S = len(plan.ends)
    hist_k = history_depth(plan)
    capp = padded_capacity(cfg)
    nch = capp // CHUNK
    n_bands = row_bands(cfg)
    lens = (plan.ends - plan.starts + 1).astype(np.int32)

    stat_parts, perm_parts, bbox_parts = [], [], []
    if S > 0:
        if capp >= 0xFFFF:
            raise NotImplementedError(
                f"padded slice capacity {capp} exceeds the u16 staging "
                "layout")
        x16y16 = native.coords_u16(x, y)
        if x16y16 is None:
            raise RuntimeError(
                "native staging unavailable (build native/bf_native.cpp "
                "with python native/build.py) or coordinates that are not "
                "integers in [0, 65535)")
        _mark("coords_u16")
        n_batch = 4 if S >= 64 else 1
        bounds = np.linspace(0, S, n_batch + 1).astype(np.int64)
        for b in range(n_batch):
            b0, b1 = int(bounds[b]), int(bounds[b + 1])
            out = native.materialize_bandpad_u16(
                x16y16[0], x16y16[1], t_ns, plan.starts[b0:b1],
                plan.ends[b0:b1], plan.slice_start_ns[b0:b1], capp,
                BAND_ROWS, CHUNK, n_bands, cfg.sensor.res_y)
            if out is None:
                raise RuntimeError("native band-pad staging failed")
            xs16, ys16, ts, perm, bbox = out
            _mark("native_sort")
            # u16 slabs travel as int16 bit patterns and are widened on
            # the device (PyTorch has few uint16 operations).
            host = (xs16.view(np.int16), ys16.view(np.int16), ts,
                    perm.view(np.int16))
            stat_parts.append(tuple(to_device(a, dev) for a in host[:3]))
            perm_parts.append(to_device(host[3], dev))
            bbox_parts.append(bbox)
            _mark("device_put")
        u16 = lambda a: a.to(torch.int32) & 0xFFFF
        xs = torch.cat([u16(p[0]) for p in stat_parts]).to(torch.float32)
        ys = torch.cat([u16(p[1]) for p in stat_parts]).to(torch.float32)
        ts = torch.cat([p[2] for p in stat_parts])
        perm = torch.cat([u16(p) for p in perm_parts])
        starts_d = torch.from_numpy(plan.starts.astype(np.int32)).to(dev)
        sidx = torch.where(perm != PERM_SENTINEL,
                           starts_d[:, None] + perm,
                           torch.full_like(perm, -1))
        stat = torch.stack([xs, ys, ts], dim=1).reshape(
            S, 3, nch, CHUNK).transpose(1, 2).contiguous()
        bbox = np.concatenate(bbox_parts)
    else:
        stat = torch.zeros((0, nch, 3, CHUNK), dtype=torch.float32,
                           device=dev)
        sidx = torch.zeros((0, capp), dtype=torch.int32, device=dev)
        bbox = np.zeros((0, 4), np.int32)
    opt = cfg.optimizer
    geoms = [geometry_from_bbox(*bbox[s], opt.scale, cfg.sensor,
                                opt.min_window_fraction) for s in range(S)]
    geo = torch.from_numpy(
        np.stack([geo_row(g) for g in geoms]) if S
        else np.zeros((0, 1, 8), np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)   # plan_s includes the copies
    _mark("device_wait")
    return {
        "plan": plan, "n": len(t_ns), "hist_k": hist_k, "device": dev,
        "stat": stat, "sidx": sidx, "geo": geo, "geoms": geoms,
        "bbox": bbox, "nval": lens,
        "plan_s": time.perf_counter() - t0, "plan_breakdown": phases,
    }


def make_carry(init_model: MotionModel, hist_k: int):
    """Initial carry: (model, (12,) seed, ws_h, st_h, en_h).  The seed is
    [slope memory (4), last deltas (4), totals of the model that entered
    the previous slice (4)], here zeros and the model's own totals; the
    (K,) gate history is host numpy (bool fired, int32 start, int32 end,
    -1 when empty).  ``convert.carry_from_numpy`` builds a hand-off carry."""
    tot0 = init_model.totals4().to(torch.float32)
    seed12 = torch.cat([torch.zeros(8, dtype=torch.float32,
                                    device=tot0.device), tot0])
    return (init_model, seed12, np.zeros(hist_k, bool),
            np.zeros(hist_k, np.int32), np.full(hist_k, -1, np.int32))


def _histories(ws_h, st_h, en_h, plan: SlicePlan, small):
    """Per slice, the (3, K) gate history the slice reads, and the history
    after the last slice."""
    S = len(plan.ends)
    K = len(ws_h)
    hist = np.zeros((S, 3, K), np.int32)
    h = np.stack([np.asarray(ws_h, np.int32), np.asarray(st_h, np.int32),
                  np.asarray(en_h, np.int32)])
    for s in range(S):
        hist[s] = h
        h = np.concatenate(
            [h[:, 1:], np.array([[int(small[s])], [plan.starts[s]],
                                 [plan.ends[s]]], np.int32)], axis=1)
    return hist, (h[0].astype(bool), h[1].copy(), h[2].copy())


def run_slices(prepared: dict, cfg: PipelineConfig, carry0):
    """The slice loop.  Returns (final carry, uvn (S, nch, 3, CHUNK),
    iters [S], ran [S], host_syncs)."""
    dev = prepared["device"]
    plan = prepared["plan"]
    opt = cfg.optimizer
    S = len(plan.ends)
    stat, sidx, geo = prepared["stat"], prepared["sidx"], prepared["geo"]
    model, sd, ws_h, st_h, en_h = carry0
    if len(ws_h) != prepared["hist_k"]:
        raise ValueError(f"carry history depth {len(ws_h)} != the "
                         f"recording's {prepared['hist_k']}")
    small = [g.window_small for g in prepared["geoms"]]
    hist_np, hist_end = _histories(ws_h, st_h, en_h, plan, small)
    hist = torch.from_numpy(hist_np).to(dev)
    uvn = torch.empty((S, stat.shape[1], 3, CHUNK), dtype=torch.float32,
                      device=dev)
    iters = np.zeros(S, np.int32)
    ran = np.zeros(S, bool)
    syncs = 0
    for s in range(S):
        act = act_rows_call(sidx[s], hist[s])
        cur_tot = model.totals4().to(torch.float32)   # the seed row is f32
        res, uvn_s = process_slice(
            stat[s], act, model, opt, cfg.sensor,
            prepared["bbox"][s], int(prepared["nval"][s]),
            warm_start=not cfg.stm_disable, seed=sd[:8], geo=geo[s])
        uvn[s] = uvn_s
        model = res.model
        sd = torch.cat([res.seed, cur_tot])
        iters[s] = res.iters
        ran[s] = res.ran
        syncs += res.iters   # one continue-flag read per iteration
        # (either drive: the megastep's state flag or the composed loop's)
    return (model, sd) + hist_end, uvn, iters, ran, syncs


def accumulate_device(uvn: torch.Tensor, sidx: torch.Tensor, n: int):
    """First-slice-wins accumulation: scatter each slice's [u, v, noise]
    to its events' original indices, in REVERSE slice order so that the
    first slice holding an event writes last.  Indices are unique within a
    slice; padding slots go to a dump slot at ``n``.  One slice per
    scatter: several slices in one call would hold duplicate indices,
    whose winner is undefined on the card."""
    dev = uvn.device
    au = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    av = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    an = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    dump = torch.full_like(sidx[0], n) if len(sidx) else None
    for s in reversed(range(uvn.shape[0])):
        idx = sidx[s]
        tgt = torch.where(idx >= 0, idx, dump).to(torch.int64)
        au.index_copy_(0, tgt, uvn[s, :, 0, :].reshape(-1))
        av.index_copy_(0, tgt, uvn[s, :, 1, :].reshape(-1))
        an.index_copy_(0, tgt, uvn[s, :, 2, :].reshape(-1))
    return au[:n], av[:n], an[:n] != 0


def compensate_recording_scan(x, y, t_ns, cfg: Optional[PipelineConfig] = None,
                              init_model: Optional[MotionModel] = None,
                              prepared: Optional[dict] = None,
                              carry_in=None, device=None) -> dict:
    """Process a whole recording.  Returns first-slice-wins per-event
    flow ``u``, ``v`` and ``noise`` (numpy, original event order), the
    final ``model`` and ``carry``, per-slice ``iters`` and ``ran``, the
    ``plan``, and ``stats`` (events_per_s, run_s, plan_s, mean_iters,
    host_syncs, launches).  Pass ``prepared`` from prepare_recording to
    reuse the staging across runs, ``carry_in`` (a carry tuple, see
    ``make_carry`` and ``convert.carry_from_numpy``) to continue a
    warm-start chain."""
    cfg = cfg or PipelineConfig()
    check_supported(cfg.optimizer, cfg.f64_totals)
    if prepared is None:
        prepared = prepare_recording(x, y, t_ns, cfg, device=device)
    dev = prepared["device"]
    plan = prepared["plan"]
    n = prepared["n"]
    S = len(plan.ends)
    if carry_in is not None:
        carry0 = carry_in
    else:
        model0 = init_model if init_model is not None \
            else MotionModel.zero(dev, f64_totals=cfg.f64_totals)
        carry0 = make_carry(model0, prepared["hist_k"])

    launches0 = dict(LAUNCHES)
    t_run0 = time.perf_counter()
    carry, uvn, iters, ran, syncs = run_slices(prepared, cfg, carry0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_run = time.perf_counter() - t_run0
    launches = {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}

    au, av, an = accumulate_device(uvn, prepared["sidx"], n)
    return {
        "u": au.cpu().numpy(),
        "v": av.cpu().numpy(),
        "noise": an.cpu().numpy(),
        "model": carry[0],
        "carry": carry,
        "iters": iters,
        "ran": ran,
        "plan": plan,
        "stats": {
            "n_events": n,
            "n_slices": S,
            "plan_s": prepared["plan_s"],
            "run_s": t_run,
            "events_per_s": n / t_run if t_run > 0 else 0.0,
            "mean_iters": float(np.mean(iters)) if S else 0.0,
            "host_syncs": syncs,
            "launches": launches,
        },
    }
