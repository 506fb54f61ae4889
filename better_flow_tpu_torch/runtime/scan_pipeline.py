"""Offline pipeline over the slices of a recording, on one device.

Counterpart of ``better_flow_tpu/runtime/scan_pipeline.py`` (the path
``bench.py`` measures):

1. Host staging, in two steps.  Once a call, ``staging_source`` derives
   what belongs to the whole recording: the trigger plan
   (``plan_slices``), the history depth, the coordinates (u16 from
   ``io.native`` when every one is an integer in [0, 65535) and a slice
   holds at most 65,535 events, else f32) and whether it is compact.
   Then ``stage_range`` sorts a range's slices into band-padded slabs,
   the native counting sort on u16 or the numpy staging
   (``materialize_slices``) on f32, both giving the device the same
   tensors, copied from pinned memory without blocking.
2. Device: the activity rows of every slice from its window-gate history,
   in one launch (B3), then a Python loop over the slices, in which the
   optimizer runs through the kernels (the megastep drive, B5 or B1 + B2
   with B4; the merged drive, B12; the composed loop on B6) or, with
   ``scatter_mode="xla"``, the XLA branch (``slice_events``).  The gates,
   the history and the geometry are host values, so the loop reads the
   device only for the optimizer's continue flag.  The carry between
   slices is (model, seed, gate history), the last on the host; on the
   megastep drives the model stays the optimizer's (1, 32) start state,
   which each slice's B4 writes for the next (``_run_carried``).
3. First-slice-wins accumulation into per-event arrays on the device, one
   slice at a time in reverse order, then one fetch to the host.

Ranges and shards.  ``stage_range`` stages one contiguous range of the
whole plan (``parallel.multihost``, the cold path's batches); the gate
history of the slices before it (``hist0``) comes from the recording, so
a range run from ``hist0`` and the previous range's carry reproduces the
full run, claiming only the events whose first slice is in the range.
``pad_quantum`` rounds the padded capacity up so that it splits into
event shards on chunk boundaries; ``chunk_range`` keeps only this
process's chunks of every slice on the device.

The cold path.  ``compensate_recording_cold`` runs the recording as
``n_batch`` slice ranges chained by their carry: a worker thread stages
batch k+1 on its own CUDA stream while the main thread drives batch k's
slice loop; each batch's claimed events are accumulated into a compact
buffer (``accumulate_device_range``), optionally packed
(``pack_results``), and copied to pinned host memory on a third stream,
which the worker decodes while the next batch runs; the checkpoint is
written one batch behind.  The device holds about two batches.
``compensate_recording_scan`` routes a recording there when
``estimate_scan_device_bytes`` exceeds ``BF_SCAN_DEVICE_BUDGET_GB``,
handing over its staging source.  A recording that is not compact is not
packed, and cannot be checkpointed, as in the JAX package.

Spans.  While ``profiling.program_spans`` is open, each phase above is a
span of the program's recorder (names in ``PERF.md`` §3); the cold
path's worker spans name the main thread's span that handed them over.
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from better_flow_tpu_torch import profiling
from better_flow_tpu_torch.config import PipelineConfig
from better_flow_tpu_torch.convert import carry_from_jax, carry_to_jax
from better_flow_tpu_torch.io import native
from better_flow_tpu_torch.core.events import EventSlice
from better_flow_tpu_torch.core.model import FIELDS, TOTAL_FIELDS, MotionModel
from better_flow_tpu_torch.models import global_flow
from better_flow_tpu_torch.models.global_flow import (
    SliceHandoff, check_supported, geo_row, geometry_from_bbox,
    initial_state, model_from_state, process_slice, static_image_shape,
    uses_megastep, xla_branch,
)
from better_flow_tpu_torch.ops.fused_model import (
    LAUNCHES, act_rows_call, history_noise, image_pair,
)
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


def host_bbox(x, y, plan: SlicePlan):
    """Per-slice integer bbox (S, 4) int32 (x_min, x_max, y_min, y_max) and
    event count (S,) int32 of each slice's chronological window: what
    OptimizerRolling::set_cloud scans per slice
    (optimizer_rolling.h:252-261), taken on the host, which touches every
    event anyway."""
    S = len(plan.ends)
    bbox = np.zeros((S, 4), np.int32)
    for s in range(S):
        a, b = int(plan.starts[s]), int(plan.ends[s]) + 1
        xw, yw = x[a:b], y[a:b]
        bbox[s] = (int(xw.min()), int(xw.max()), int(yw.min()), int(yw.max()))
    return bbox, (plan.ends - plan.starts + 1).astype(np.int32)


def materialize_slices(x, y, t_ns, plan: SlicePlan, cap: int,
                       spatial_sort: bool = True, band_rows: int = BAND_ROWS,
                       band_pad: bool = False, res_x: int = 0,
                       indices_only: bool = False):
    """(S, cap) slabs of the slices' x, y (f32), slice-local t (f32 of the
    int64 ns difference) and original index (int32, -1 on padding), and
    the (S,) lengths: the numpy staging, element for element the JAX
    package's ``materialize_slices``.

    ``spatial_sort`` orders each slice by a stable sort on (row band of
    the f32 x, truncated; truncated y), padding last.  ``band_pad`` also
    pads every row band to a CHUNK boundary, so that no chunk spans two
    bands; the capacity grows to ``padded_capacity``'s and padding is then
    interleaved inside a slice: mask on ``idx >= 0``, never on a prefix.
    ``indices_only`` builds ``idx`` alone (xs, ys, ts None).
    ``stage_range`` uses only ``band_pad=True`` with the default
    ``band_rows``; the other settings are kept for parity with the JAX
    function, which the tests hold this one against."""
    S = len(plan.ends)
    lens = (plan.ends - plan.starts + 1).astype(np.int32)
    offsets = np.arange(cap, dtype=np.int64)[None, :]
    gidx = plan.starts[:, None] + offsets
    valid = offsets < lens[:, None]
    safe = np.minimum(gidx, len(x) - 1)
    xs = np.where(valid, x[safe], 0).astype(np.float32)
    ys = np.where(valid, y[safe], 0).astype(np.float32)
    ts = None if indices_only else np.where(
        valid, t_ns[safe] - plan.slice_start_ns[:, None], 0
    ).astype(np.float32)
    idx = np.where(valid, gidx, -1).astype(np.int32)
    if spatial_sort:
        # The band key truncates the f32 coordinate, as the kernels see it.
        band = xs.astype(np.int64) // band_rows
        key = band * 4096 + ys.astype(np.int64)
        key = np.where(valid, key, np.int64(1) << 40)
        order = np.argsort(key, axis=1, kind="stable")
        take = lambda a: np.take_along_axis(a, order, axis=1)
        if indices_only:
            xs, idx = take(xs), take(idx)
        else:
            xs, ys, ts, idx = take(xs), take(ys), take(ts), take(idx)
        if band_pad:
            n_bands = max(int(res_x) + band_rows - 1, band_rows) // band_rows
            capp = -(-(cap + n_bands * (CHUNK - 1)) // CHUNK) * CHUNK
            valid_s = idx >= 0
            band_s = np.where(valid_s, xs.astype(np.int64) // band_rows,
                              n_bands)
            # Per (slice, band) counts give chunk-aligned band bases.
            flat = (np.arange(S)[:, None] * (n_bands + 1) + band_s).ravel()
            cnt = np.bincount(flat, minlength=S * (n_bands + 1)).reshape(
                S, n_bands + 1)[:, :n_bands].astype(np.int64)
            padded = -(-cnt // CHUNK) * CHUNK
            base = np.concatenate(
                [np.zeros((S, 1), np.int64), np.cumsum(padded, axis=1)],
                axis=1)
            first = np.concatenate(
                [np.zeros((S, 1), np.int64), np.cumsum(cnt, axis=1)], axis=1)
            j = np.arange(xs.shape[1], dtype=np.int64)[None, :]
            bs = np.minimum(band_s, n_bands - 1)
            rows_s = np.arange(S)[:, None]
            pos = base[rows_s, bs] + (j - first[rows_s, bs])
            rows = np.repeat(np.arange(S), xs.shape[1])[valid_s.ravel()]
            cols = pos.ravel()[valid_s.ravel()]

            def scatter(a, fill=0):
                out = np.full((S, capp), fill, a.dtype)
                out[rows, cols] = a[valid_s]
                return out

            idx = scatter(idx, fill=-1)
            if not indices_only:
                xs, ys, ts = scatter(xs), scatter(ys), scatter(ts)
    if indices_only:
        xs = ys = None
    return xs, ys, ts, idx, lens


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


def staged_capacity(cfg: PipelineConfig, pad_quantum: int = 0) -> int:
    """Slots per staged slice: ``padded_capacity`` rounded up to a multiple
    of ``pad_quantum`` when it is given."""
    capp = padded_capacity(cfg)
    return -(-capp // pad_quantum) * pad_quantum if pad_quantum else capp


def default_device() -> torch.device:
    """The card.  An entry point runs on the CPU (the plain twins) only when
    its caller asks for it; with no card and no ``device="cpu"`` it raises."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available: pass device="cpu" to run the '
            "plain PyTorch twins on the CPU")
    return torch.device("cuda")


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host -> device copy; on a card from a pinned copy, without blocking
    the host (PyTorch keeps the pinned buffer until the copy is done)."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class StagingSource(NamedTuple):
    """What staging derives from a whole recording, once a call
    (``staging_source``); each range is staged from it (``stage_range``)."""
    t_ns: np.ndarray     # int64, contiguous
    n: int
    plan: SlicePlan      # the whole trigger plan
    hist_k: int          # the gate history's depth, from the whole plan
    xa: np.ndarray       # the coordinates the ranges are sorted from: u16
    ya: np.ndarray       # on the native route, else f32
    native_route: bool
    compact: bool        # the cold path packs and checkpoints only these
    phases: dict         # its ``plan_breakdown`` phases
    seconds: float


class _Phases:
    """The ``plan_breakdown`` phases of staging (seconds by name) and its
    spans, timed from construction."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.phases = {}

    def mark(self, name: str, span: str) -> None:
        """The phase ``name``, and the span ``span``, end now."""
        now = time.perf_counter()
        self.phases[name] = round(self.phases.get(name, 0.0)
                                  + now - self.last, 4)
        if profiling.RECORDER is not None:
            profiling.RECORDER.add(span, self.last, now)
        self.last = now


def staging_source(x, y, t_ns, cfg: PipelineConfig) -> StagingSource:
    """The trigger plan, the history depth and the staged coordinates of
    a recording (phases ``plan``, ``coords_u16``, ``coords_f32``; spans
    ``stage.plan``, ``stage.coords``).  The native route narrows them to
    u16 (``native.coords_u16``) when the library is there, every one is an
    integer in [0, 65535) and ``max_events`` is at most 65,535 (a u16 slot
    holds its offset into the slice's window, 0xFFFF padding, so the padded
    capacity itself may pass 0xFFFF); else the numpy route keeps f32
    copies.  ``compact``, the one rule: the native route, or, as in the JAX
    package, f32 coordinates that are integers in [0, 65535) and a padded
    capacity below 0xFFFF."""
    clock = _Phases()
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    plan = plan_slices(t_ns, cfg)
    hist_k = history_depth(plan)
    clock.mark("plan", "stage.plan")
    xa = None
    if cfg.slice.max_events <= PERM_SENTINEL:
        xa, ya = native.coords_u16(x, y) or (None, None)
        clock.mark("coords_u16", "stage.coords")
    native_route = compact = xa is not None
    if not native_route:
        xa = np.ascontiguousarray(x, np.float32)
        ya = np.ascontiguousarray(y, np.float32)
        compact = padded_capacity(cfg) < 0xFFFF and all(
            a.size == 0 or bool(np.all(a == np.floor(a)) and a.min() >= 0
                                and a.max() < 0xFFFF) for a in (xa, ya))
        clock.mark("coords_f32", "stage.coords")
    return StagingSource(t_ns, len(t_ns), plan, hist_k, xa, ya, native_route,
                         compact, clock.phases, time.perf_counter() - clock.t0)


def _gate_history_before(src: StagingSource, lo: int, cfg: PipelineConfig):
    """The window-gate history (fired, start, end; (K,) each) that slice
    ``lo`` of ``src``'s plan reads: the gate is purely geometric (bbox and
    ``min_window_fraction``), so the outcomes of the ``hist_k`` slices
    before a range are computed here from the recording itself, on the
    staged coordinates (u16, or f32 whose bbox is truncated)."""
    plan, hist_k = src.plan, src.hist_k
    ws_h = np.zeros(hist_k, bool)
    st_h = np.zeros(hist_k, np.int32)
    en_h = np.full(hist_k, -1, np.int32)
    opt = cfg.optimizer
    for j, s in enumerate(reversed(range(max(0, lo - hist_k), lo))):
        a, b = int(plan.starts[s]), int(plan.ends[s]) + 1
        xw, yw = src.xa[a:b], src.ya[a:b]
        g = geometry_from_bbox(xw.min(), xw.max(), yw.min(), yw.max(),
                               opt.scale, cfg.sensor, opt.min_window_fraction)
        k = hist_k - 1 - j
        ws_h[k] = g.window_small
        st_h[k] = plan.starts[s]
        en_h[k] = plan.ends[s]
    return ws_h, st_h, en_h


def stage_range(src: StagingSource, cfg: PipelineConfig, device=None,
                slice_range=None, pad_quantum: int = 0,
                chunk_range=None) -> dict:
    """A sort of the slices of ``slice_range`` of ``src``'s plan (all of
    them when None) into band-padded slabs, and their device copies:
    ``prepare_recording``'s result, its ``plan_s`` and ``plan_breakdown``
    this range's own."""
    dev = torch.device(device) if device is not None else default_device()
    clock = _Phases()
    lo, hi = (0, len(src.plan.ends)) if slice_range is None \
        else map(int, slice_range)
    plan = SlicePlan(*(a[lo:hi] for a in src.plan))
    S = len(plan.ends)
    capp = staged_capacity(cfg, pad_quantum)
    c0, c1 = (0, capp // CHUNK) if chunk_range is None else chunk_range
    if not 0 <= c0 < c1 <= capp // CHUNK:
        raise ValueError(f"chunk_range {chunk_range} outside the "
                         f"{capp // CHUNK} chunks of a slice")
    nch = c1 - c0
    lens = (plan.ends - plan.starts + 1).astype(np.int32)

    parts, bbox_parts = [], []
    xa, ya = src.xa, src.ya
    # The gate history before the range (empty before an empty range).
    hist0 = _gate_history_before(src, lo if S else 0, cfg)
    if S > 0:
        n_batch = 4 if S >= 64 else 1
        bounds = np.linspace(0, S, n_batch + 1).astype(np.int64)
        for b in range(n_batch):
            b0, b1 = int(bounds[b]), int(bounds[b + 1])
            sub = SlicePlan(*(a[b0:b1] for a in plan))
            if src.native_route:
                out = native.materialize_bandpad_u16(
                    xa, ya, src.t_ns, sub.starts, sub.ends,
                    sub.slice_start_ns, capp, BAND_ROWS, CHUNK,
                    row_bands(cfg), cfg.sensor.res_y)
                if out is None:
                    raise RuntimeError("native band-pad staging failed")
                xs16, ys16, ts, perm, bbox = out
                clock.mark("native_sort", "stage.sort")
                # u16 slabs travel as int16 bit patterns and are widened on
                # the device (PyTorch has few uint16 operations).
                host = (xs16.view(np.int16), ys16.view(np.int16), ts,
                        perm.view(np.int16))
            else:
                xs, ys, ts, idx, _ = materialize_slices(
                    xa, ya, src.t_ns, sub, cfg.slice.max_events,
                    band_pad=True, res_x=cfg.sensor.res_x)
                # pad_quantum's extra slots are padding at the tail, where
                # the native sort leaves them too.
                tail = ((0, 0), (0, capp - idx.shape[1]))
                host = tuple(np.pad(a, tail, constant_values=fill)
                             for a, fill in ((xs, 0), (ys, 0), (ts, 0),
                                             (idx, -1)))
                bbox = host_bbox(xa, ya, sub)[0]
                clock.mark("numpy_staging", "stage.sort")
            if chunk_range is not None:
                host = tuple(np.ascontiguousarray(a[:, c0 * CHUNK:c1 * CHUNK])
                             for a in host)
            parts.append(tuple(to_device(a, dev) for a in host))
            bbox_parts.append(bbox)
            clock.mark("device_put", "stage.upload")
        cat = lambda k: torch.cat([p[k] for p in parts])
        if src.native_route:
            u16 = lambda a: a.to(torch.int32) & 0xFFFF
            xs, ys = (u16(cat(k)).to(torch.float32) for k in (0, 1))
            perm = u16(cat(3))
            starts_d = torch.from_numpy(plan.starts.astype(np.int32)).to(dev)
            sidx = torch.where(perm != PERM_SENTINEL,
                               starts_d[:, None] + perm,
                               torch.full_like(perm, -1))
        else:
            xs, ys, sidx = cat(0), cat(1), cat(3)
        stat = torch.stack([xs, ys, cat(2)], dim=1).reshape(
            S, 3, nch, CHUNK).transpose(1, 2).contiguous()
        bbox = np.concatenate(bbox_parts)
    else:
        stat = torch.zeros((0, nch, 3, CHUNK), dtype=torch.float32,
                           device=dev)
        sidx = torch.zeros((0, nch * CHUNK), dtype=torch.int32, device=dev)
        bbox = np.zeros((0, 4), np.int32)
    opt = cfg.optimizer
    geoms = [geometry_from_bbox(*bbox[s], opt.scale, cfg.sensor,
                                opt.min_window_fraction) for s in range(S)]
    geo = torch.from_numpy(
        np.stack([geo_row(g) for g in geoms]) if S
        else np.zeros((0, 1, 8), np.float32)).to(dev)
    if dev.type == "cuda":
        # plan_s includes the copies.  Only the current stream is waited
        # on: the cold path stages on a stream of its own while its main
        # thread runs the previous batch.
        torch.cuda.current_stream(dev).synchronize()
    clock.mark("device_wait", "stage.device_wait")
    return {
        "plan": plan, "n": src.n, "hist_k": src.hist_k, "device": dev,
        "stat": stat, "sidx": sidx, "geo": geo, "geoms": geoms,
        "bbox": bbox, "nval": lens, "hist0": hist0, "slice_range": (lo, hi),
        "prev_end": int(src.plan.ends[lo - 1]) if lo > 0 else -1,
        "chunks": (c0, c1), "chunks_total": capp // CHUNK,
        "compact": src.compact,
        "plan_s": time.perf_counter() - clock.t0,
        "plan_breakdown": clock.phases,
    }


def _with_source(src: StagingSource, prepared: dict) -> dict:
    """``prepared`` with ``src``'s phases and seconds counted in."""
    phases = dict(src.phases)
    for k, v in prepared["plan_breakdown"].items():
        phases[k] = round(phases.get(k, 0.0) + v, 4)
    return dict(prepared, plan_s=src.seconds + prepared["plan_s"],
                plan_breakdown=phases)


def prepare_recording(x, y, t_ns, cfg: PipelineConfig, device=None,
                      slice_range=None, pad_quantum: int = 0,
                      chunk_range=None) -> dict:
    """Host staging, ``staging_source`` then ``stage_range``: the trigger
    plan, a sort of every slice into band-padded slabs, and the device
    copies ``stat`` (S, nch, 3, CHUNK) f32 and ``sidx`` (S, capp) int32
    (original index, -1 on padding), reusable across runs of the
    recording.  ``device`` stands where the JAX package's signature has
    ``slice_range`` (by design: pass ``slice_range`` by keyword).

    ``slice_range=(lo, hi)`` stages only that range of the global plan;
    ``hist_k``, ``hist0`` (the gate history before the range) and
    ``prev_end`` (the last trigger before it: events up to it belong to
    earlier ranges) still come from the whole plan.  ``pad_quantum`` rounds
    the padded capacity up to a multiple (event sharding asks for
    ``n_shards * CHUNK``).  ``chunk_range=(c0, c1)`` copies only those
    chunks of every slice to the device (this process's event shards);
    bbox and counts stay those of the whole slices."""
    src = staging_source(x, y, t_ns, cfg)
    return _with_source(src, stage_range(src, cfg, device, slice_range,
                                         pad_quantum, chunk_range))


def make_carry(init_model: MotionModel, hist_k: int, seed=None, ws_h=None,
               st_h=None, en_h=None):
    """Initial or hand-off carry: (model, (12,) seed, ws_h, st_h, en_h), the
    JAX package's signature.  The seed is [slope memory (4), last deltas
    (4), totals of the model that entered the previous slice (4)]: a (12,)
    ``seed`` (a range's ``carry[1]``) is taken as given, an (8,) one is
    padded with the model's f32 totals, and None gives zeros and those
    totals (so the first slice's extrapolation delta is zero, see
    ``OptimizerConfig.warm_extrapolate``).  The (K,) gate history is host
    numpy (bool fired, int32 start, int32 end, -1 when empty), empty
    unless given (a range run passes ``prepared["hist0"]``).
    ``convert.carry_from_numpy`` builds a hand-off carry from numpy."""
    tot0 = init_model.totals4().to(torch.float32)
    if seed is None:
        seed12 = torch.cat([torch.zeros(8, dtype=torch.float32,
                                        device=tot0.device), tot0])
    else:
        seed12 = torch.as_tensor(seed).to(device=tot0.device,
                                          dtype=torch.float32).reshape(-1)
        if seed12.shape[0] == 8:
            seed12 = torch.cat([seed12, tot0])
        elif seed12.shape[0] != 12:
            raise ValueError(f"seed: {seed12.shape[0]} values, expected 8 "
                             "or 12")
    return (init_model, seed12,
            np.zeros(hist_k, bool) if ws_h is None
            else np.asarray(ws_h, bool).copy(),
            np.zeros(hist_k, np.int32) if st_h is None
            else np.asarray(st_h, np.int32).copy(),
            np.full(hist_k, -1, np.int32) if en_h is None
            else np.asarray(en_h, np.int32).copy())


def initial_model(cfg: PipelineConfig, device) -> MotionModel:
    """The model a chain starts from, honouring ``cfg.f64_totals``: shared by
    the scan, sharded and multihost entry points so that the accumulator
    precision cannot differ between them for one config."""
    return MotionModel.zero(device, f64_totals=cfg.f64_totals)


def initial_carry(prepared: dict, cfg: PipelineConfig, init_model=None):
    """The carry a run of ``prepared`` starts from without a hand-off: the
    initial model and the gate history before the staged range."""
    model0 = init_model if init_model is not None \
        else initial_model(cfg, prepared["device"])
    ws_h, st_h, en_h = prepared["hist0"]
    return make_carry(model0, prepared["hist_k"], ws_h=ws_h, st_h=st_h,
                      en_h=en_h)


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


def staged_histories(prepared: dict, carry0):
    """The (S, 3, K) int32 gate histories that the staged slices read,
    from the carry's history on (host numpy), and the history after the
    last slice."""
    small = [g.window_small for g in prepared["geoms"]]
    return _histories(*carry0[2:], prepared["plan"], small)


def slice_events(stat_s: torch.Tensor, sidx_s: torch.Tensor,
                 hist_s: torch.Tensor) -> EventSlice:
    """The flat ``EventSlice`` of one staged slice for the XLA branch
    (``scan_pipeline.py:298-307`` of the JAX package): x, y and t of the
    (nch, 3, CHUNK) pack, valid where the slot holds an event (``sidx >=
    0``), noise where the (3, K) window-gate history covers its original
    index."""
    valid = sidx_s >= 0
    x, y, t = (stat_s[:, k].reshape(-1) for k in range(3))
    return EventSlice(x=x, y=y, t=t, valid=valid,
                      noise=history_noise(sidx_s, hist_s) & valid)


def run_slices(prepared: dict, cfg: PipelineConfig, carry0, group=None):
    """The slice loop.  Returns (final carry, uvn (S, nch, 3, CHUNK),
    iters [S], ran [S], host_syncs).  Under an event ``group``
    (``parallel.mesh.EventGroup``) the staged chunks are this process's,
    its ``n_local`` shards as equal chunk ranges in order (every chunk, and
    so its time base, is the unsharded one), and each drive's event phase
    (one B1 or B7a launch) and the megastep drive's final warp (one B4
    launch) run once over them.  On the kernel branch the activity rows of
    every staged slice come from one B3 launch before the loop (every
    slice's gate history is a host value); each slice writes its [u, v,
    noise] rows straight into ``uvn[s]`` (B4 on the megastep drive).  On
    the megastep drives under a warm start without extrapolation the
    carry between slices stays on the device (``_run_carried``)."""
    dev = prepared["device"]
    plan = prepared["plan"]
    opt = cfg.optimizer
    S = len(plan.ends)
    stat, sidx, geo = prepared["stat"], prepared["sidx"], prepared["geo"]
    model, sd, ws_h = carry0[:3]
    if len(ws_h) != prepared["hist_k"]:
        raise ValueError(f"carry history depth {len(ws_h)} != the "
                         f"recording's {prepared['hist_k']}")
    rec = profiling.RECORDER
    t_rows = time.perf_counter() if rec is not None else 0.0
    hist_np, hist_end = staged_histories(prepared, carry0)
    hist = torch.from_numpy(hist_np).to(dev)
    uvn = torch.empty((S, stat.shape[1], 3, CHUNK), dtype=torch.float32,
                      device=dev)
    iters = np.zeros(S, np.int32)
    ran = np.zeros(S, bool)
    syncs = 0
    nch = stat.shape[1]
    if group is not None and nch % group.n_local != 0:
        raise ValueError(f"{nch} staged chunks do not divide into "
                         f"{group.n_local} local shards")
    xla = xla_branch(opt)
    act_all = None if xla else act_rows_call(sidx, hist)
    if rec is not None:
        rec.add("loop.rows", t_rows, time.perf_counter())
    warm = not cfg.stm_disable
    extrapolate = warm and opt.warm_extrapolate > 0
    if (warm and not extrapolate and opt.scatter_mode in ("auto", "pallas")
            and uses_megastep(opt, model.totals_dtype)
            and (group is not None or not opt.megastep_merged)):
        model, sd, syncs = _run_carried(prepared, cfg, model, sd, act_all,
                                        uvn, iters, ran, group)
        return (model, sd) + hist_end, uvn, iters, ran, syncs
    if extrapolate:
        alpha = torch.full((), opt.warm_extrapolate, dtype=torch.float32,
                           device=dev)
    for s in range(S):
        if rec is not None:
            span = rec.open("slice")
        ev = None
        if xla:
            ev = slice_events(stat[s], sidx[s], hist[s])
            stat_s = act = None
        else:
            stat_s, act = stat[s], act_all[s]
        cur_tot = model.totals4().to(torch.float32)   # the seed row is f32
        start_model = None
        if extrapolate:
            # The extrapolated warm start (scan_pipeline.py:327-342 of the
            # JAX package): the optimizer starts at model + alpha * (the
            # totals' drift over the previous slice), sd[8:12] holding the
            # totals of the model that entered it; f32, then the totals'
            # dtype.
            dlt = (alpha * (cur_tot - sd[8:12])).to(model.totals_dtype)
            start_model = model.add_totals(*dlt.unbind())
        res, _ = process_slice(
            stat_s, act, model, opt, cfg.sensor,
            prepared["bbox"][s], int(prepared["nval"][s]),
            warm_start=warm, seed=sd[:8], geo=geo[s], ev=ev,
            group=group, uvn_out=uvn[s], start_model=start_model)
        model = res.model
        sd = torch.cat([res.seed, cur_tot])
        iters[s] = res.iters
        ran[s] = res.ran
        syncs += res.reads   # the blocking reads the slice's drive took
        if rec is not None:
            rec.close(span)
            rec.count("iters", res.iters)
    return (model, sd) + hist_end, uvn, iters, ran, syncs


def _run_carried(prepared: dict, cfg: PipelineConfig, model, sd, act_all,
                 uvn, iters, ran, group):
    """``run_slices``' loop on the megastep drives (B5, or B1 + B2; not
    the merged drive) under a warm start without extrapolation: the
    optimizer's carry stays the (1, 32) start state on the device.  A
    slice that runs is the drive's trips from that state and one B4 launch
    into ``uvn[s]`` that also writes the next slice's start state and seed
    row into the spare one of two rows (``run_fused_mega``'s ``handoff``),
    with one image pair and, on the card's single-device split drive, one
    launch plan of the trips (``global_flow.trip_plan``) for the whole
    call; a skipped slice takes
    ``process_slice`` with the model of the last state, and the next start
    state is built from it as before.  The gates, the geometry and the
    image shape are host values read once.  The returned model is read
    from the last run slice's final state.  Bitwise the per-slice loop
    (``initial_state`` and ``model_from_state`` around ``process_slice``,
    the seed ``cat``).  Fills ``iters`` and ``ran``; returns (model, seed
    row, blocking reads)."""
    opt = cfg.optimizer
    dev = prepared["device"]
    scale = opt.scale
    H, W = static_image_shape(scale, cfg.sensor)
    runs = [not g.window_small and int(n) >= opt.min_events
            for g, n in zip(prepared["geoms"], prepared["nval"])]
    split = group is not None or opt.megastep_split
    pair = image_pair(dev, H, W) if split else None
    row = initial_state(model, opt, sd[:8])
    spare = torch.empty_like(row)
    seed = torch.empty(12, dtype=torch.float32, device=dev)
    staged = prepared["stat"]
    warp_out = torch.empty((staged.shape[1], 4, CHUNK), dtype=torch.float32,
                           device=dev)
    plan = global_flow.trip_plan(staged.shape[1], pair, opt, scale, H, W,
                                 group) if any(runs) else None
    stat, xy, act, geo, out = (t.unbind(0) for t in (
        staged, staged[:, :, 0:2], act_all, prepared["geo"], uvn))
    final = None                  # the last run slice's final state
    syncs = 0
    rec = profiling.RECORDER
    for s, run in enumerate(runs):
        if rec is not None:
            span = rec.open("slice")
        if run:
            final, _, _, n_iter, sd, reads = global_flow.run_fused_mega(
                stat[s], act[s], geo[s], None, opt, scale, H, W,
                group=group, uvn_out=out[s], handoff=SliceHandoff(
                    row, xy[s].contiguous(), spare, seed, pair, warp_out,
                    plan))
            row, spare = spare, row
        else:
            m = model if final is None else model_from_state(final)
            cur_tot = m.totals4().to(torch.float32)
            res, _ = process_slice(
                stat[s], act[s], m, opt, cfg.sensor, prepared["bbox"][s],
                int(prepared["nval"][s]), seed=sd[:8], geo=geo[s],
                group=group, uvn_out=out[s])
            n_iter, reads = res.iters, res.reads
            sd = torch.cat([res.seed, cur_tot])
            row = initial_state(m, opt, res.seed)
        iters[s] = n_iter
        ran[s] = run
        syncs += reads
        if rec is not None:
            rec.close(span)
            rec.count("iters", n_iter)
            if run:
                rec.count("handoff")
                global_flow.count_finishes(rec, n_iter, H, W,
                                           prepared["geoms"][s])
    return (model if final is None else model_from_state(final)), sd, syncs


def _first_wins(uvn: torch.Tensor, sidx: torch.Tensor, lo: int, hi: int,
                base: int, size: int):
    """Scatter each slice's [u, v, noise] of the events whose original
    index lies in [lo, hi) to ``index - base`` of (size,) buffers, in
    REVERSE slice order so that the first slice holding an event writes
    last; padding slots (index -1) and the other events go to a dump slot
    at ``size``.  One slice per scatter: indices are unique within a slice,
    and several slices in one call would hold duplicate indices, whose
    winner is undefined on the card."""
    dev = uvn.device
    au = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    av = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    an = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    dump = torch.full_like(sidx[0], size) if len(sidx) else None
    for s in reversed(range(uvn.shape[0])):
        idx = sidx[s]
        tgt = torch.where((idx >= lo) & (idx < hi), idx - base,
                          dump).to(torch.int64)
        au.index_copy_(0, tgt, uvn[s, :, 0, :].reshape(-1))
        av.index_copy_(0, tgt, uvn[s, :, 1, :].reshape(-1))
        an.index_copy_(0, tgt, uvn[s, :, 2, :].reshape(-1))
    return au[:size], av[:size], an[:size] != 0


def accumulate_device(uvn: torch.Tensor, sidx: torch.Tensor, n: int,
                      claim_from: int = 0):
    """First-slice-wins accumulation into per-event (n,) u, v and noise
    at the events' original indices.  Events before ``claim_from`` are
    left out: a range run claims only the events whose first slice is in
    the range, those after the previous range's last trigger, so
    consecutive ranges' claims are disjoint."""
    return _first_wins(uvn, sidx, claim_from, n, 0, n)


def accumulate_device_range(uvn: torch.Tensor, sidx: torch.Tensor,
                            claim_from: int, claim_to: int, claim_cap: int):
    """``accumulate_device`` narrowed to the events whose original index
    lies in [claim_from, claim_to), into compact (claim_cap,) buffers at
    ``index - claim_from``.  A cold batch's claims are such a contiguous
    range (from the previous batch's last trigger + 1), so the batches'
    buffers put end to end are the whole recording's result."""
    return _first_wins(uvn, sidx, claim_from, claim_to, claim_from,
                       claim_cap)


def pack_results(au: torch.Tensor, av: torch.Tensor, an: torch.Tensor):
    """The compact wire format of a batch's results, on their device: one
    uint8 tensor of 4 m + ceil(m / 8) bytes, f16 u then f16 v byte-planar
    (all low bytes, then all high bytes) and the noise flags bit-packed
    little-endian, byte for byte the JAX package's ``_pack_results``.
    f16 rounds u and v by up to 2^-11 of their value; noise is exact.
    ``unpack_results`` decodes it."""
    m = au.shape[0]
    f16 = torch.stack([au.to(torch.float16), av.to(torch.float16)])
    planes = f16.view(torch.uint8).reshape(2, m, 2).transpose(1, 2)
    flags = torch.zeros(-(-m // 8) * 8, dtype=torch.uint8, device=au.device)
    flags[:m] = an.to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.int32, device=au.device)
    bits = (flags.view(-1, 8).to(torch.int32) << shifts).sum(1)
    return torch.cat([planes.reshape(4 * m), bits.to(torch.uint8)])


def unpack_results(buf, m: int):
    """Host-side decode of ``pack_results`` (numpy): u, v (f32) and noise
    (bool) of length ``m``."""
    buf = np.asarray(buf)
    head = buf[: 4 * m].reshape(2, 2, m)
    f16 = np.ascontiguousarray(np.moveaxis(head, 1, 2)).view(np.float16)
    u = f16[0, :, 0].astype(np.float32)
    v = f16[1, :, 0].astype(np.float32)
    bits = np.unpackbits(buf[4 * m:], bitorder="little")[:m]
    return u, v, bits.astype(bool)


def gather_shards(uvn: torch.Tensor, sidx: torch.Tensor, group):
    """Every rank's (S, nch_local, 3, CHUNK) outputs and (S, capp_local)
    index slabs, put together in rank order into the whole slices'
    layout, on every rank (first-slice-wins needs every copy of an event).
    The identity for a group of one rank."""
    if group is None or group.comm.size == 1:
        return uvn, sidx
    S = uvn.shape[0]
    u = group.comm.all_gather(uvn)          # (ranks, S, nch_l, 3, CHUNK)
    i = group.comm.all_gather(sidx)         # (ranks, S, capp_l)
    return (u.transpose(0, 1).reshape(S, -1, 3, CHUNK),
            i.transpose(0, 1).reshape(S, -1))


def scan_prepared(prepared: dict, cfg: PipelineConfig, carry0,
                  group=None) -> dict:
    """Run the staged slices from ``carry0`` and accumulate: the result of
    ``compensate_recording_scan`` (see there).  Under an event ``group``
    the slices run sharded (``run_slices``) and the shards' outputs are
    gathered before the accumulation; a staged range claims its own
    events only."""
    dev = prepared["device"]
    plan = prepared["plan"]
    n = prepared["n"]
    S = len(plan.ends)
    rec = profiling.RECORDER
    launches0 = dict(LAUNCHES)
    t_run0 = time.perf_counter()
    if rec is not None:
        span = rec.open("scan.run", t_run0)
    carry, uvn, iters, ran, syncs = run_slices(prepared, cfg, carry0,
                                               group=group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_acc = time.perf_counter()
    t_run = t_acc - t_run0
    launches = {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}
    if rec is not None:
        rec.close(span, t_acc, launches=launches)

    uvn, sidx = gather_shards(uvn, prepared["sidx"], group)
    au, av, an = accumulate_device(uvn, sidx, n,
                                   claim_from=prepared["prev_end"] + 1)
    if rec is not None:
        t_fetch = time.perf_counter()
        rec.add("scan.accumulate", t_acc, t_fetch)
    u, v, noise = (a.cpu().numpy() for a in (au, av, an))
    if rec is not None:
        rec.add("scan.fetch", t_fetch, time.perf_counter())
    return {
        "u": u,
        "v": v,
        "noise": noise,
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
    warm-start chain.  When ``prepared`` was staged with a ``slice_range``
    the run starts from the range's gate history and claims only the
    range's own events (zeros elsewhere), so the outputs of consecutive
    ranges are disjoint and their union is the full run's.

    Given none of ``prepared``, ``carry_in`` and ``init_model``, a
    recording whose ``estimate_scan_device_bytes`` exceeds
    ``BF_SCAN_DEVICE_BUDGET_GB`` (default 5.0) runs through
    ``compensate_recording_cold`` instead, with ``n_batch = max(4,
    ceil(2 * estimate / budget))``: bitwise the same u, v, noise and
    iters, the cold path's keys (no ``ran``, no ``plan``), and
    ``routed_cold``, ``est_device_gb``, ``plan_s`` 0 and ``run_s`` the
    cold path's ``total_s`` in ``stats``; the route hands the cold path
    the ``staging_source`` its estimate read."""
    cfg = cfg or PipelineConfig()
    check_supported(cfg.optimizer, cfg.f64_totals)
    with profiling.span("scan"):
        if prepared is None:
            # Bounded memory: a recording whose resident tensors would
            # exceed the budget runs through the cold path, whose peak is
            # about two batches, with bitwise the same outputs.  A caller
            # that staged (``prepared``) or continues a chain
            # (``carry_in``, ``init_model``) has chosen the one-program
            # scan.
            with profiling.span("scan.route"):
                budget = float(os.environ.get("BF_SCAN_DEVICE_BUDGET_GB",
                                              5.0)) * 1e9
                src = staging_source(x, y, t_ns, cfg)
                est = _resident_bytes(len(src.plan.ends), src.n, cfg)
            if est > budget and carry_in is None and init_model is None:
                n_batch = max(4, math.ceil(est / budget * 2))
                out = _cold(lambda: src, cfg, n_batch, device=device)
                out["stats"].update(plan_s=0.0,
                                    run_s=out["stats"]["total_s"],
                                    routed_cold=True,
                                    est_device_gb=round(est / 1e9, 2))
                return out
            with profiling.span("stage"):
                prepared = _with_source(src, stage_range(src, cfg, device))
        carry0 = carry_in if carry_in is not None \
            else initial_carry(prepared, cfg, init_model)
        return scan_prepared(prepared, cfg, carry0)


def _resident_bytes(S: int, n: int, cfg: PipelineConfig,
                    pad_quantum: int = 0) -> float:
    """``estimate_scan_device_bytes`` of S slices and n events."""
    return float(S) * staged_capacity(cfg, pad_quantum) * 32 + n * 13.0


def estimate_scan_device_bytes(t_ns, cfg: PipelineConfig,
                               pad_quantum: int = 0) -> float:
    """Bytes the one-program scan keeps resident on the device: per slot
    of the S x capp staged slices (``staged_capacity``), ``stat`` (12 B),
    ``sidx`` (4 B), B3's rows (4 B) and ``uvn`` (12 B), 32 B; per event
    the three f32 (n + 1) accumulators and the noise flags, 13 B.
    Both staging routes leave these tensors.  While ``stage_range`` runs,
    its parts and ``torch.cat`` add about 10 B a slot (native route) or
    16 B (numpy route) for a while."""
    plan = plan_slices(np.ascontiguousarray(t_ns, np.int64), cfg)
    return _resident_bytes(len(plan.ends), len(t_ns), cfg, pad_quantum)


_CKPT_VERSION = 2


def config_digest(cfg: PipelineConfig) -> str:
    """The configuration's repr, which names every field of the frozen
    dataclasses, so that any change (tolerances, schedule, exit factors,
    slicing, f64_totals) changes it.  The port's configuration has the JAX
    package's classes, fields and defaults, so equal configurations give
    equal digests in both packages."""
    return repr(cfg)


def save_offline_checkpoint(path, *, n, S, n_batch, done, carry,
                            batch_results, cfg: PipelineConfig = None):
    """The cold path's state at a batch boundary, in the JAX package's
    ``.npz`` layout (version 2), so either package resumes the other's:
    the carry after batch ``done - 1`` (each model field in its own dtype,
    the seed and the gate history) and every completed batch's claimed
    (u, v, noise, iters).  Written to a temporary file and moved into
    place, so a reader finds the old checkpoint or the new one."""
    vals, seed, ws_h, st_h, en_h = carry_to_jax(carry)
    state = {
        "version": np.int64(_CKPT_VERSION), "n": np.int64(n),
        "S": np.int64(S), "n_batch": np.int64(n_batch),
        "done_batches": np.int64(done),
        "carry_seed": seed, "carry_ws": ws_h, "carry_st": st_h,
        "carry_en": en_h,
    }
    if cfg is not None:
        state["config_digest"] = np.asarray(config_digest(cfg))
    for f, v in zip(FIELDS, vals):
        state[f"carry_model_{f}"] = v
    for b, (au, av, an, iters) in enumerate(batch_results):
        state[f"acc_u_{b}"] = au
        state[f"acc_v_{b}"] = av
        state[f"acc_n_{b}"] = an
        state[f"iters_{b}"] = iters
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **state)
    os.replace(tmp, str(path))


def load_offline_checkpoint(path, *, n, S, n_batch, hist_k,
                            cfg: PipelineConfig = None, claims=None,
                            device="cpu"):
    """Load and check a cold-path checkpoint.  Returns (done_batches,
    carry, batch_results), the carry's model and seed on ``device``, or
    None when there is no file.  Raises when the checkpoint belongs to
    another recording or batch split (n, S, n_batch), another
    configuration (``config_digest``), holds f32 totals for an
    ``f64_totals`` run, or is truncated (gate history shorter than
    ``hist_k``, a batch's results not the length of its claim)."""
    if not os.path.exists(str(path)):
        return None
    with np.load(str(path), allow_pickle=False) as z:
        if int(z["version"]) != _CKPT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {int(z['version'])}")
        for key, want in (("n", n), ("S", S), ("n_batch", n_batch)):
            if int(z[key]) != want:
                raise ValueError(
                    f"checkpoint mismatch: {key}={int(z[key])} but this run "
                    f"has {want} -- wrong recording, config, or n_batch")
        if cfg is not None and "config_digest" in z:
            have, want_d = str(z["config_digest"]), config_digest(cfg)
            if have != want_d:
                raise ValueError(
                    "checkpoint config mismatch: the checkpoint was written "
                    f"under a different PipelineConfig.\n  checkpoint: "
                    f"{have}\n  this run:  {want_d}\nResuming would stitch "
                    "batches computed under two different configs.")
        model = tuple(z[f"carry_model_{f}"] for f in FIELDS)
        if cfg is not None and cfg.f64_totals and any(
                model[FIELDS.index(f)].dtype != np.float64
                for f in TOTAL_FIELDS):
            raise ValueError(
                "cfg.f64_totals: the checkpoint's carry totals are not f64; "
                "resuming would continue the f64 chain from f32 totals")
        ws_h, st_h, en_h = z["carry_ws"], z["carry_st"], z["carry_en"]
        if len(ws_h) != hist_k:
            raise ValueError("checkpoint hist_k mismatch")
        if len(st_h) != hist_k or len(en_h) != hist_k:
            raise ValueError(
                f"checkpoint carry history truncated: st/en lengths "
                f"{len(st_h)}/{len(en_h)} != hist_k {hist_k}")
        carry = carry_from_jax((model, z["carry_seed"], ws_h, st_h, en_h),
                               device=device)
        done = int(z["done_batches"])
        batch_results = []
        for b in range(done):
            row = (z[f"acc_u_{b}"], z[f"acc_v_{b}"], z[f"acc_n_{b}"],
                   z[f"iters_{b}"])
            if claims is not None:
                want_len = claims[b][1] - claims[b][0]
                for name, a in zip(("acc_u", "acc_v", "acc_n"), row[:3]):
                    if len(a) != want_len:
                        raise ValueError(
                            f"checkpoint batch {b} {name} length {len(a)} "
                            f"!= claim range {want_len} -- truncated or "
                            "edited checkpoint")
            batch_results.append(row)
    return done, carry, batch_results


def _stage_batch(src: StagingSource, cfg: PipelineConfig, dev, lo: int,
                 hi: int, stream, ctx=None):
    """The cold path's staging of slices [lo, hi), on its worker thread:
    ``stage_range`` under ``stream`` on a card (it then waits for that
    stream alone), with an event recorded behind it for the main stream to
    wait on; the span ``stage`` under ``ctx`` (the recorder's
    ``context()`` of the span that handed it over).  Returns (prepared,
    event or None, seconds)."""
    rec = profiling.RECORDER
    t0 = time.perf_counter()
    if rec is not None:
        span = rec.open("stage", t0, ctx)
    ready = None
    with torch.cuda.stream(stream):   # no-op for None
        prep = stage_range(src, cfg, dev, (lo, hi))
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(stream)
    t1 = time.perf_counter()
    if rec is not None:
        rec.close(span, t1)
    return prep, ready, t1 - t0


class _Fetch:
    """One batch's accumulated buffers on their way to the host.  On a
    card they are copied into pinned host memory on ``stream`` once the
    main stream's work so far (the accumulation) is done, without blocking
    the host, and kept from the caching allocator until the copies are
    done; ``result`` waits for them.  On the CPU the buffers are the
    result."""

    def __init__(self, bufs, stream, start):
        self.start, self.stream = start, stream
        if stream is None:
            self.host, self.end = bufs, time.perf_counter()
            return
        stream.wait_stream(torch.cuda.current_stream(bufs[0].device))
        with torch.cuda.stream(stream):
            self.host = tuple(torch.empty(b.shape, dtype=b.dtype,
                                          pin_memory=True) for b in bufs)
            for h, b in zip(self.host, bufs):
                h.copy_(b, non_blocking=True)
                b.record_stream(stream)
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(stream)

    def wait(self) -> float:
        """Wait for the copies; the seconds from the accumulation's start
        to the copy's end."""
        if self.stream is None:
            return self.end - self.start
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3

    def result(self, m: int, claim_cap: int):
        """(u, v, noise) of the batch's ``m`` claimed events, numpy (views
        of the host buffers, decoded when packed), once ``wait`` has
        returned."""
        host = [h.numpy() for h in self.host]
        if len(host) == 1:
            host = unpack_results(host[0], claim_cap)
        return tuple(a[:m] for a in host)


def compensate_recording_cold(x, y, t_ns, cfg: Optional[PipelineConfig] = None,
                              n_batch: int = 4, checkpoint_path=None,
                              resume: bool = False,
                              compact_results: bool = False,
                              device=None) -> dict:
    """Process a recording once, with staging, the device's work and the
    results' fetch overlapped; bitwise the result of
    ``compensate_recording_scan`` (with ``compact_results``, u and v
    rounded to f16).

    The main thread derives the plan and coordinates once
    (``staging_source``) and splits the S slices into ``n_batch``
    contiguous ranges of ceil(S / n_batch) slices (fewer when S is small).
    A worker thread stages batch k+1 from them (``stage_range``; the native
    sort releases the interpreter lock) on a CUDA stream of its own while
    the main thread drives batch k's slice loop (``run_slices``) from the
    previous batch's carry.  Batch k claims the events whose first slice is
    in it, a contiguous range of original indices; as soon as its loop
    returns, their accumulation (``accumulate_device_range``), packed
    under ``compact_results`` when the recording is compact
    (``pack_results``: 4.125 B an event instead of 9), is copied into
    pinned host memory on a third stream and the batch's slabs and outputs
    are dropped, so the device holds about two batches.  The worker decodes
    the copy while batch k+1 runs; the main thread waits for it when it
    writes the checkpoint one batch behind, and at the end.  An exception
    on the worker reaches the caller as raised, after the worker has
    stopped.  On the CPU the same threads run, without streams.

    ``checkpoint_path`` saves (carry, completed batches' results) at
    every batch boundary (``save_offline_checkpoint``); with ``resume``
    a matching checkpoint restarts after its last completed batch, bitwise
    an uninterrupted run.  A recording that is not compact raises
    ``ValueError`` under ``checkpoint_path``, with the JAX package's
    message, before anything is staged.

    Returns ``u``, ``v``, ``noise`` (numpy, original event order), the
    final ``model`` and ``carry`` (None for an empty recording), per-slice
    ``iters`` and ``stats``: n_events, n_slices, n_batches,
    resumed_batches, total_s, events_per_s, mean_iters, host_syncs,
    launches and ``batches``, one entry a batch run here with its
    ``stage_s`` (host time of its ``stage_range``, copies included),
    ``run_s`` (host time of its slice loop) and ``fetch_s`` (its
    accumulation, pack and copy, device time on a card, plus the host time
    of its decode)."""
    cfg = cfg or PipelineConfig()
    return _cold(lambda: staging_source(x, y, t_ns, cfg), cfg, n_batch,
                 checkpoint_path, resume, compact_results, device)


def _cold(source, cfg: PipelineConfig, n_batch: int, checkpoint_path=None,
          resume: bool = False, compact_results: bool = False, device=None):
    """``compensate_recording_cold`` of the recording ``source()`` gives
    (its ``StagingSource``, derived under ``cold.plan``)."""
    check_supported(cfg.optimizer, cfg.f64_totals)
    dev = torch.device(device) if device is not None else default_device()
    rec = profiling.RECORDER

    def collect(b, fetch, ctx):
        """On the worker: wait for batch b's copy, decode its claimed
        events into the result arrays and keep them with its iters; the
        span ``fetch`` under ``ctx``."""
        cfrom, cto = claims[b]
        t = time.perf_counter()
        if rec is not None:
            span = rec.open("fetch", t, ctx)
        fetch_s = fetch.wait()
        if rec is not None:
            t_copied = time.perf_counter()
            rec.add("fetch.wait", t, t_copied)
        u[cfrom:cto], v[cfrom:cto], noise[cfrom:cto] = fetch.result(
            cto - cfrom, claim_cap)
        results[b] = (u[cfrom:cto], v[cfrom:cto], noise[cfrom:cto],
                      iters_run[b])
        t_end = time.perf_counter()
        timing[b]["fetch_s"] = fetch_s + t_end - t
        if rec is not None:
            rec.add("fetch.decode", t_copied, t_end)
            rec.close(span, t_end)

    def wait_fetch(future):
        """The main thread waits for a batch's ``collect``."""
        t = time.perf_counter() if rec is not None else 0.0
        future.result()
        if rec is not None:
            rec.add("cold.wait_fetch", t, time.perf_counter())

    def checkpoint(b, carry_b):
        wait_fetch(collected.pop(b))
        save_offline_checkpoint(
            checkpoint_path, n=n, S=S, n_batch=n_batch, done=b + 1,
            carry=carry_b, batch_results=results[:b + 1], cfg=cfg)

    t0 = time.perf_counter()
    launches0 = dict(LAUNCHES)
    if rec is not None:
        call = rec.open("cold", t0)
        plan_span = rec.open("cold.plan", t0)
    try:
        src = source()
        if checkpoint_path is not None and not src.compact:
            raise ValueError("offline checkpointing requires the compact "
                             "staging path (integral u16 coordinates)")
        plan, n, S = src.plan, src.n, len(src.plan.ends)
        n_batch = max(1, min(n_batch, S))
        per = -(-S // n_batch)
        bounds = [(b * per, min((b + 1) * per, S))
                  for b in range(n_batch) if b * per < S]
        # Batch b claims the indices after the previous batch's last
        # trigger, up to its own: contiguous, disjoint, known from the plan.
        claims = [(int(plan.ends[lo - 1]) + 1 if lo > 0 else 0,
                   int(plan.ends[hi - 1]) + 1 if hi < S else n)
                  for lo, hi in bounds]
        claim_cap = max([cto - cfrom for cfrom, cto in claims] + [1])

        done, carry, results = 0, None, []
        if resume and checkpoint_path is not None:
            loaded = load_offline_checkpoint(
                checkpoint_path, n=n, S=S, n_batch=n_batch, hist_k=src.hist_k,
                cfg=cfg, claims=claims, device=dev)
            if loaded is not None:
                done, carry, results = loaded
        u, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
        noise = np.zeros(n, bool)
        for b, (au, av, an, _) in enumerate(results):
            cfrom, cto = claims[b]
            u[cfrom:cto], v[cfrom:cto], noise[cfrom:cto] = au, av, an
        results = list(results) + [None] * (len(bounds) - done)

        cuda = dev.type == "cuda"
        stage_stream = torch.cuda.Stream(dev) if cuda else None
        fetch_stream = torch.cuda.Stream(dev) if cuda else None
        collected, iters_run, timing = {}, {}, {}
        syncs = 0
        if rec is not None:
            rec.close(plan_span)
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix=profiling.WORKER) as pool:
            def stage(b):
                ctx = rec.context() if rec is not None else None
                return pool.submit(_stage_batch, src, cfg, dev, *bounds[b],
                                   stage_stream, ctx) \
                    if b < len(bounds) else None

            # The worker's queue: stage k+1 while batch k runs, then decode
            # batch k while batch k+1 runs.
            staging = stage(done)
            pending = None   # (batch, carry after it), not yet checkpointed
            for b in range(done, len(bounds)):
                t_wait = time.perf_counter() if rec is not None else 0.0
                prep, ready, stage_s = staging.result()
                if rec is not None:
                    rec.add("cold.wait_stage", t_wait, time.perf_counter())
                staging = stage(b + 1)
                t_run = time.perf_counter()
                if rec is not None:
                    span = rec.open("cold.run", t_run)
                if cuda:
                    main = torch.cuda.current_stream(dev)
                    main.wait_event(ready)
                    for t in (prep["stat"], prep["sidx"], prep["geo"]):
                        t.record_stream(main)
                if carry is None:
                    carry = initial_carry(prep, cfg)
                carry, uvn, iters_run[b], _, n_sync = run_slices(prep, cfg,
                                                                 carry)
                syncs += n_sync
                start = time.perf_counter()
                timing[b] = {"stage_s": stage_s, "run_s": start - t_run}
                if rec is not None:
                    rec.close(span, start)
                    span = rec.open("cold.accumulate", start)
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(main)
                acc = accumulate_device_range(uvn, prep["sidx"], *claims[b],
                                              claim_cap)
                if compact_results and src.compact:
                    acc = (pack_results(*acc),)
                collected[b] = pool.submit(
                    collect, b, _Fetch(acc, fetch_stream, start),
                    rec.context() if rec is not None else None)
                if rec is not None:
                    rec.close(span)
                # Nothing reads this batch's slabs, rows or outputs again:
                # dropping them now bounds the device's memory to ~2
                # batches.
                prep = uvn = acc = None
                # The previous batch's checkpoint waits only on work already
                # done, so writing it one batch behind keeps the overlap.
                if checkpoint_path is not None and pending is not None:
                    checkpoint(*pending)
                pending = (b, carry)
            if checkpoint_path is not None and pending is not None:
                checkpoint(*pending)
            for future in collected.values():
                wait_fetch(future)
    finally:
        t1 = time.perf_counter()
        launches = {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}
        if rec is not None:
            rec.close(call, t1, launches=launches)

    iters = np.concatenate([np.asarray(r[3], np.int32) for r in results]) \
        if results else np.zeros(0, np.int32)
    return {
        "u": u, "v": v, "noise": noise,
        "model": carry[0] if carry is not None else initial_model(cfg, dev),
        "carry": carry,
        "iters": iters,
        "stats": {
            "n_events": n,
            "n_slices": S,
            "n_batches": len(bounds),
            "resumed_batches": done,
            "total_s": t1 - t0,
            "events_per_s": n / (t1 - t0) if t1 > t0 else 0.0,
            "mean_iters": float(iters.mean()) if S else 0.0,
            "host_syncs": syncs,
            "launches": launches,
            "batches": [timing[b] for b in sorted(timing)],
        },
    }
