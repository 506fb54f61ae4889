"""Global 4-parameter flow on one slice.

Counterpart of ``better_flow_tpu/models/global_flow.py``.  ``process_slice``
takes a staged slice (the kernels' chunk layout, spatially sorted);
``process_event_slice`` is the JAX package's ``process_slice`` on a flat
``EventSlice`` in any order, which it sorts, lays out and un-permutes
around the staged call.  Either takes one of two branches, by
``OptimizerConfig.scatter_mode``: "auto" and "pallas" the kernel branch
(``_run_fused`` of the JAX package, below), "xla" (and the JAX package's
TPU scatter strategies "rep" and "mxu", ``XLA_MODES``) the XLA-composed
branch (``_run_optimizer``, the program the JAX package runs off the TPU): per iteration ``iteration_step`` builds the time image
(``ops.time_image``), its centroid, masked Scharr gradients and the four
model means (``ops.gradient``, ``ops.reductions``) in plain tensor
operations, updates the model and re-warps every event, under the same
``adaptive_loop`` / ``fast_loop`` drive as the composed loop.
``run_optimizer`` with "pallas" (or "auto") takes the step's other branch,
the seven sums of B11 (``fused_model_partials_windowed_call``) in place of
the image chain.  Under an event group the XLA branch sums each
iteration's exact integer pre-filter pair across the ranks
(``ops.time_image``'s ``comm``, one ``psum`` of the JAX package's
``axis_name``), so a group of any size is bitwise one device; the tiled
path has its own XLA chain (``parallel.spatial``).

The kernel branch takes one of three drives:

- the megastep drive (``_run_fused_mega``), for f32 totals with
  ``OptimizerConfig.use_megastep``: an iteration is one megastep (B5: warp +
  splat, finish, model update in one launch) unless
  ``OptimizerConfig.megastep_split`` or the ``fast`` presets ask for the
  split pair (B1 warp + splat, then B2 finish + model update), of which
  ``OptimizerConfig.megastep_unroll`` > 1 runs that many a loop trip in
  the kernels' predicated mode;
- under ``OptimizerConfig.megastep_merged`` on one device the merged drive
  (``_run_fused_mega2``): one B12 launch an iteration, whose head runs the
  previous iteration's finish and model update; the call whose head ends
  the loop is the final warp, so no B4 runs;
- the composed drive (``_run_fused``'s loop), for f64 totals or
  ``use_megastep=False``: an iteration is one B6 launch (warp + splat +
  finish to seven sums), then the scalar model update as 0-d tensor
  operations on the device, under ``adaptive_loop`` (the reference
  schedule) or ``fast_loop`` (the secant schedule).

The slice gates depend only on the host-side bbox and event count, so the
host decides them without reading the device; every loop reads one
continue flag from the device per iteration (per trip of the unrolled
drive), and a slice's result counts those reads (``SliceResult.reads``).

Event parallelism (the JAX package's ``axis_name`` seam).  Given an
``EventGroup`` (``parallel.mesh``), ``process_slice`` takes the local
shards' ``stat`` and ``act`` (one tensor each, holding their chunks in
order) and every iteration splits where the shards'
pre-filter images are summed: each drive runs one splat launch over all the
local shards (B1 in the megastep drive, B7a in the composed drive) into the
image pair it owns for the slice, the all-reduce of that pair across ranks
in place (``ops.fused_model.sum_images``), then one finish (B2, never B5,
as in the JAX package; B7b), which reads the pair and leaves it zero for
the next iteration.  The images are
integers, so the sum is exact and every rank computes the same state from
it: the continue flag needs no collective, and a sharded slice is bitwise
the unsharded one when the shards are cut on chunk boundaries.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from better_flow_tpu_torch import profiling
from better_flow_tpu_torch.config import OptimizerConfig, SensorConfig
from better_flow_tpu_torch.core.events import EventSlice, bounding_box
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.ops.fused_model import (
    Handoff, TripPlan, finish_partials_call,
    fused_model_partials_windowed_call, fused_warp_splat_call,
    fused_warp_splat_images_call, image_pair, megastep2_call, megastep_call,
    megastep_finish_call, plans_trips, sum_images, warp_images_st_call,
    warp_scal_row, warp_uv_call,
)
from better_flow_tpu_torch.ops.gradient import masked_scharr
from better_flow_tpu_torch.ops.layout import (
    CHUNK, ST_CDIV, ST_CDX, ST_CDY, ST_CNT, ST_CONT, ST_CROT, ST_CX, ST_CY,
    ST_DDIV, ST_DIV, ST_DX, ST_DY, ST_ITERS, ST_PD, ST_RDIV, ST_ROT, ST_SIZE,
    ST_SL, ST_TDIV, ST_TDX, ST_TDY, ST_TROT, ST_XDIV, ST_YDIV, pack_act,
    prepare_chunk_layouts, sort_key_blocks,
)
from better_flow_tpu_torch.ops.reductions import (
    center_of_mass, model_compute, model_from_partials,
)
from better_flow_tpu_torch.ops.time_image import time_image
from better_flow_tpu_torch.ops.warp import (
    UV_K, compute_uv, project_4param_reinit, recip,
)

F64_FAST_DEFECT = (
    "PipelineConfig.f64_totals with OptimizerConfig.schedule='fast': the JAX "
    "package's _fast_loop starts its while-loop carry (slope memory, "
    "deltas) as f32 and its body returns them as f64 once the totals are "
    "f64, so lax.while_loop raises TypeError (a known reference defect, "
    "ROADMAP C); the port does not invent a result for it")


class SliceGeometry(NamedTuple):
    """Scaled-window geometry of one slice (host values)."""

    x_shift: float   # exact f32 values
    y_shift: float
    w_dyn: int
    h_dyn: int
    window_small: bool


def static_image_shape(scale: int, sensor: SensorConfig) -> Tuple[int, int]:
    """Static (H, W) covering any dynamic window: scale*res + scale."""
    return sensor.res_x * scale + scale, sensor.res_y * scale + scale


def geometry_from_bbox(x_min, x_max, y_min, y_max, scale: int,
                       sensor: SensorConfig,
                       min_window_fraction: int = 15) -> SliceGeometry:
    """Window geometry from an integer bbox, with the reference's integer
    divisions (optimizer_rolling.h:279-283) and f32 arithmetic."""
    x_min, x_max, y_min, y_max = (int(v) for v in (x_min, x_max, y_min, y_max))
    f32 = np.float32
    wx = scale * (x_max - x_min)
    wy = scale * (y_max - y_min)
    half = f32(scale // 2)
    x_shift = (-f32((x_max - x_min) // 2 + x_min) * f32(scale)
               + f32(wx) / f32(2.0) + half)
    y_shift = (-f32((y_max - y_min) // 2 + y_min) * f32(scale)
               + f32(wy) / f32(2.0) + half)
    frac = min_window_fraction
    window_small = ((wx + scale) < (scale * sensor.res_x) // frac) and (
        (wy + scale) < (scale * sensor.res_y) // frac)
    return SliceGeometry(float(x_shift), float(y_shift), wx, wy,
                         bool(window_small))


def slice_geometry(ev, scale: int, sensor: SensorConfig,
                   min_window_fraction: int = 15, comm=None) -> SliceGeometry:
    """Window geometry from the events themselves: the bbox of ``ev`` (an
    ``EventSlice`` or this process's shards of one), reduced over ``comm``."""
    return geometry_from_bbox(*bounding_box(ev, comm), scale, sensor,
                              min_window_fraction)


def count_finishes(rec: profiling.Spans, iters: int, H: int, W: int,
                   geom: SliceGeometry) -> None:
    """Add a slice's ``iters`` finishes on a megastep drive (B2, or the
    same band pass inside B5 and B12) to the recorder's counters:
    ``finish_px`` the pixels the band pass sweeps, the whole H x W image
    each time, and ``window_px`` those of the slice's dynamic window,
    ``w_dyn * h_dyn``.  Their ratio is the share of the sweep that the
    events' window does not need."""
    rec.count("finish_px", iters * H * W)
    rec.count("window_px", iters * geom.w_dyn * geom.h_dyn)


def geo_row(geom: SliceGeometry) -> np.ndarray:
    """The kernels' (1, 8) f32 geometry row [x_sh, y_sh, w_dyn, h_dyn, 0..]."""
    return np.array([[geom.x_shift, geom.y_shift, geom.w_dyn, geom.h_dyn,
                      0, 0, 0, 0]], np.float32)


class SliceResult(NamedTuple):
    model: MotionModel
    pr_x: torch.Tensor      # (capp,) final warped positions
    pr_y: torch.Tensor
    nx: torch.Tensor        # (capp,) final direction vectors
    ny: torch.Tensor
    u: torch.Tensor         # (capp,) flow, px/s
    v: torch.Tensor
    iters: int
    ran: bool
    window_small: bool
    seed: torch.Tensor      # (8,) [slope memory (4), last deltas (4)]
    noise: Optional[torch.Tensor] = None   # (cap,) bool, given ``ev``
    reads: int = 0          # blocking reads of the device the drive took


class ExitReads:
    """A drive's blocking reads of its exit flag, counted in one place:
    called with the flag's device tensor, it returns the host value
    (``item`` of a 0-d flag, else ``tolist``) and counts the read in
    ``n``; ``take(read)`` does the same for a read given as a function
    (the planned trip's wait, ``TripPlan.wait``).  While the program's
    spans are recorded (``profiling.program_spans``) each read is a
    ``drive.read`` span, and the trip before it, from the previous read's
    end (from this object's creation for the first), a ``drive.launch``
    span."""

    __slots__ = ("n", "t")

    def __init__(self):
        self.n = 0
        self.t = time.perf_counter() if profiling.RECORDER is not None \
            else 0.0

    def __call__(self, flag: torch.Tensor):
        return self.take(flag.item if flag.dim() == 0 else flag.tolist)

    def take(self, read):
        self.n += 1
        rec = profiling.RECORDER
        if rec is None:
            return read()
        t0 = time.perf_counter()
        value = read()
        t1 = time.perf_counter()
        rec.add("drive.launch", self.t, t0)
        rec.add("drive.read", t0, t1)
        self.t = t1
        return value


# The scatter modes of the XLA branch.  "rep" and "mxu" are the JAX
# package's TPU scatter strategies (8 f32 replicas; a 3-way bf16 split on
# the matrix unit); the port computes all three with its exact integer
# scatter (``ops.time_image``).
XLA_MODES = ("xla", "rep", "mxu")


def xla_branch(cfg: OptimizerConfig) -> bool:
    """``cfg`` runs the XLA-composed branch (``process_slice_xla``)."""
    return cfg.scatter_mode in XLA_MODES


def check_supported(cfg: OptimizerConfig, f64_totals: bool = False) -> None:
    """Raise for the configurations this port does not run: f64 totals
    with the fast schedule (the JAX package's defect), an unknown
    ``scatter_mode`` and an unknown schedule.  The rest runs on one device,
    under an event group (the event-parallel and multi-process paths) and
    on the tiled pipeline, in the kernel branch and in the XLA branch's
    modes alike.  Every other option runs:

    - ``megastep_unroll``: predicated B1 + B2 pairs a loop trip on the
      single-device split drive (``run_fused_mega``), ignored elsewhere as
      in the JAX package;
    - ``warm_extrapolate``: the scan's extrapolated optimizer start
      (``runtime.scan_pipeline.run_slices``), ignored by the stream and the
      tiled path as in the JAX package;
    - ``splat_pair``: the TPU kernel's chunks a grid step, bit-exact by the
      JAX package's own account; B1 runs one slot a thread on the card, so
      it selects nothing;
    - ``scatter_mode`` "rep" and "mxu": the XLA branch with the port's
      exact integer scatter (``XLA_MODES``), on one device, under an event
      group and on the tiled path, as "xla"."""
    if f64_totals and cfg.schedule == "fast":
        raise NotImplementedError(F64_FAST_DEFECT)
    if cfg.scatter_mode not in ("auto", "pallas") + XLA_MODES:
        raise NotImplementedError(
            f"OptimizerConfig.scatter_mode={cfg.scatter_mode!r}")
    if cfg.schedule not in ("fast", "reference"):
        raise NotImplementedError(f"OptimizerConfig.schedule={cfg.schedule!r}")


def uses_megastep(cfg: OptimizerConfig, totals_dtype: torch.dtype) -> bool:
    """The megastep drive for a built-in schedule on an f32 carry with
    ``use_megastep``, else the composed loop (global_flow.py:608-611 of the
    JAX package)."""
    return (cfg.use_megastep and cfg.schedule in ("reference", "fast")
            and totals_dtype == torch.float32)


def finish_statics(cfg: OptimizerConfig) -> dict:
    """The static arguments of ``megastep_finish_call`` for ``cfg``."""
    return dict(
        schedule=cfg.schedule, rot_tol=cfg.rot_tol, div_tol=cfg.div_tol,
        dx_tol=cfg.dx_tol, dy_tol=cfg.dy_tol,
        xy_cap=cfg.xy_divider_cap, rotdiv_cap=cfg.rotdiv_divider_cap,
        max_iter=cfg.max_iter, hard_cap=cfg.iter_hard_cap,
        exit_grad=cfg.exit_grad_factor, exit_pred=cfg.exit_predict_cap,
    )


def initial_state(model: MotionModel, cfg: OptimizerConfig,
                  seed: Optional[torch.Tensor]) -> torch.Tensor:
    """The (1, 32) state of a slice's first iteration, built on the
    model's device without a host round trip: the model's totals,
    compensations, centroid and count, the initial dividers, CONT = 1, and
    for the fast schedule the seed's slope memory.  The host numbers go in
    by ``fill_``: an assignment of a host number to a card tensor copies it
    from pageable memory, which waits for the stream (five blocking calls
    a slice, found by ``chip_smoke.count_syncs_in``)."""
    dev = model.total_dx.device
    st = torch.zeros((1, ST_SIZE), dtype=torch.float32, device=dev)
    st[0, ST_TDX:ST_TDIV + 1] = torch.stack(
        [model.total_dx, model.total_dy, model.total_rot, model.total_div])
    st[0, ST_CDX:ST_CDIV + 1] = torch.stack(
        [model.comp_dx, model.comp_dy, model.comp_rot, model.comp_div])
    st[0, ST_CX] = model.cx
    st[0, ST_CY] = model.cy
    st[0, ST_XDIV:ST_YDIV + 1].fill_(cfg.init_xy_divider)
    st[0, ST_RDIV:ST_DDIV + 1].fill_(cfg.init_rotdiv_divider)
    st[0, ST_CNT] = model.cnt
    st[0, ST_CONT].fill_(1.0)
    if seed is not None and cfg.schedule == "fast":
        st[0, ST_SL:ST_SL + 4] = seed[:4]
    return st


def model_from_state(st: torch.Tensor) -> MotionModel:
    """The motion model held in a state vector (views of ``st``)."""
    s = st[0]
    return MotionModel(
        cx=s[ST_CX], cy=s[ST_CY], dx=s[ST_DX], dy=s[ST_DY], rot=s[ST_ROT],
        div=s[ST_DIV], cnt=s[ST_CNT], total_dx=s[ST_TDX],
        total_dy=s[ST_TDY], total_rot=s[ST_TROT], total_div=s[ST_TDIV],
        comp_dx=s[ST_CDX], comp_dy=s[ST_CDY], comp_rot=s[ST_CROT],
        comp_div=s[ST_CDIV])


def _check_shards(nch: int, group) -> None:
    """Under an event group a drive's ``stat`` and ``act`` hold the local
    shards' chunks in order: ``group.n_local`` equal chunk ranges."""
    if group is not None and nch % group.n_local != 0:
        raise ValueError(f"{nch} chunks do not divide into "
                         f"{group.n_local} local shards")


class SliceHandoff(NamedTuple):
    """One slice of the scan's loop when it carries the state on the
    device (``run_fused_mega``'s ``handoff``): where the slice starts,
    where B4 writes where the next one starts, and the buffers the loop
    holds for its whole range."""

    st0: torch.Tensor         # (1, 32) the start state (initial_state's)
    pr0: torch.Tensor         # (nch, 2, CHUNK) the start positions
    st_next: torch.Tensor     # (1, 32) B4 writes the next start state
    seed_next: torch.Tensor   # (12,) and the next seed row
    pair: Optional[tuple]     # the split drive's image pair (zero)
    warp_out: torch.Tensor    # (nch, 4, CHUNK) B4's [pr_x, pr_y, nx, ny]
    plan: Optional[TripPlan] = None   # the range's launch plan (trip_plan)


def trip_plan(nch: int, pair, cfg: OptimizerConfig, scale: int, H: int,
              W: int, group=None) -> Optional[TripPlan]:
    """The launch plan of ``run_fused_mega``'s trips (``TripPlan``) for
    slices of ``nch`` chunks with the image ``pair``, where the drive takes
    one: the single-device split drive on the card, at any
    ``megastep_unroll``.  None elsewhere, where the trips go through the
    wrappers: the CPU's twins, an event group (its sum sits between B1 and
    B2), the unsplit drive (B5) and the merged drive."""
    if (group is not None or not cfg.megastep_split or cfg.megastep_merged
            or not plans_trips(pair[0].device)):
        return None
    return TripPlan(nch, *pair, scale=scale, H=H, W=W,
                    time_lo=cfg.splat_time_lo or cfg.schedule != "fast",
                    unroll=max(1, cfg.megastep_unroll),
                    statics=finish_statics(cfg))


def _planned_trips(plan: TripPlan, reads: ExitReads, stat, act, geo, pr,
                   st):
    """``run_fused_mega``'s trips from ``plan``, from the positions ``pr``
    and the state ``st``: one ``bf_trip`` call and one wait a trip, until
    CONT is clear.  Returns (positions, final state, ITERS)."""
    plan.start(stat, act, geo, pr, st)
    rec = profiling.RECORDER
    while True:
        plan.trip()
        if rec is not None:
            rec.count("planned_trips")
        iters, cont = reads.take(plan.wait)
        if not cont > 0:
            break
    return (*plan.final(), iters)


def run_fused_mega(stat, act, geo, model0: Optional[MotionModel],
                   cfg: OptimizerConfig, scale: int, H: int, W: int,
                   seed=None, group=None, uvn_out=None,
                   handoff: Optional[SliceHandoff] = None):
    """The megastep drive: one unconditional loop trip, then trips while
    the state's CONT flag is set, then the final-warp epilogue.  An
    iteration is one B5 launch, or the B1 + B2 pair under
    ``cfg.megastep_split`` (B1 adds into an image pair allocated once per
    call, which B2 reads and leaves zero); under an event ``group``
    (``stat`` and ``act`` the local shards' chunks in order) one B1 launch
    over all the local shards, the in-place sum of the pair across ranks
    (``sum_images``), then B2; the final warp is one B4 launch over all
    the local shards too, into ``uvn_out`` when given (``warp_uv_call``).
    A trip is one iteration, or on the single-device split drive
    ``cfg.megastep_unroll`` of them as predicated B1 + B2 pairs
    (``global_flow.py:767-791`` of the JAX package): a pair past the exit
    finds CONT clear and passes the state and the positions through on
    the card, so the result is bitwise one iteration a trip.  The host
    reads CONT and ITERS together once a trip, and takes the iteration
    count from ITERS.  On one device ``cfg.megastep_merged`` takes the
    merged drive (``run_fused_mega2``, which returns its own ``uvn``:
    ``process_slice`` copies it into ``uvn_out``); under a group it and
    ``megastep_unroll`` are ignored, as in the JAX package.  Returns
    (model, out (nch, 4, CHUNK), uvn, iters, seed_out, reads): ``reads``
    the blocking reads taken; under a group ``out`` and ``uvn`` hold the
    local shards' chunks in order.

    The scan's slice loop (``runtime.scan_pipeline.run_slices``) carries
    the state on the device: given a ``SliceHandoff``, the drive starts
    from its state and positions (``model0`` and ``seed`` are not read),
    the split drive uses its image pair, and B4 also writes the next
    slice's start state and seed row (``ops.fused_model.Handoff``); the
    first item returned is then the final state itself
    (``model_from_state`` reads the model from it) and ``seed_out`` is
    ``handoff.seed_next``.  Not on the merged drive.

    Where ``trip_plan`` gives a launch plan (the single-device split drive
    on the card; the hand-off's ``plan``, else one made for this call), a
    trip is one native call and its read one wait on the plan's event,
    bitwise the wrappers' trips; while the program's spans are recorded
    the counter ``planned_trips`` counts those trips."""
    if group is None and cfg.megastep_merged:
        return run_fused_mega2(stat, act, geo, model0, cfg, scale, H, W,
                               seed=seed)
    _check_shards(stat.shape[0], group)
    statics = finish_statics(cfg)
    time_lo = cfg.splat_time_lo or cfg.schedule != "fast"
    split = group is not None or cfg.megastep_split
    unroll = max(1, cfg.megastep_unroll) if split and group is None else 1
    pred = int(unroll > 1)
    if handoff is None:
        st = initial_state(model0, cfg, seed)
        pr = stat[:, 0:2].contiguous()
        pair = image_pair(stat.device, H, W) if split else None
        plan = trip_plan(stat.shape[0], pair, cfg, scale, H, W, group)
    else:
        st, pr, pair = handoff.st0, handoff.pr0, handoff.pair
        plan = handoff.plan
    reads = ExitReads()
    if plan is not None:
        pr, st, iters = _planned_trips(plan, reads, stat, act, geo, pr, st)
    else:
        while True:
            for _ in range(unroll):
                if not split:
                    pr, st = megastep_call(stat, act, pr, st, geo,
                                           scale=scale, H=H, W=W,
                                           time_lo=time_lo, **statics)
                    continue
                pr, acc_t, acc_c = warp_images_st_call(
                    stat, act, pr, st, geo, *pair, scale=scale, H=H, W=W,
                    time_lo=time_lo, predicated=pred)
                if group is not None:
                    acc_t, acc_c = sum_images(acc_t, acc_c, group.comm)
                st = megastep_finish_call(acc_t, acc_c, st, geo,
                                          scale=scale, H=H, W=W,
                                          predicated=pred, **statics)
            # ITERS and CONT are adjacent slots: one copy, one blocking read.
            (iters, cont), = reads(st.narrow(1, ST_ITERS, 2))
            if not cont > 0:
                break
    if handoff is not None:
        h = Handoff(handoff.st_next, handoff.seed_next, handoff.st0,
                    cfg.init_xy_divider, cfg.init_rotdiv_divider,
                    cfg.schedule == "fast")
        out, uvn = warp_uv_call(stat, pr, act, st, 0.0, uvn_out, handoff=h,
                                out=handoff.warp_out)
        return st, out, uvn, int(iters), h.seed_next, reads.n
    seed_out = torch.cat([st[0, ST_SL:ST_SL + 4], st[0, ST_PD:ST_PD + 4]])
    out, uvn = warp_uv_call(stat, pr, act, st, 0.0, uvn_out)
    return model_from_state(st), out, uvn, int(iters), seed_out, reads.n


def run_fused_mega2(stat, act, geo, model0: MotionModel,
                    cfg: OptimizerConfig, scale: int, H: int, W: int,
                    seed=None):
    """The merged megastep drive (``_run_fused_mega2`` of the JAX
    package): one unconditional B12 call (its head copies the state and
    sets CONT), then calls while the state's CONT flag is set; each call's
    head runs the previous call's finish and model update, and the call
    whose head clears CONT warps every event with the final model and
    writes the direction vectors, so it is the final warp.  The calls share
    one image pair, allocated once per call of this drive: each call reads
    the previous call's splat, leaves the pair zero and splats into it.  The
    first call always leads to a second, so the host reads the CONT flag
    after every later call: once an iteration, as in the megastep drive.
    Returns (model, out (nch, 4, CHUNK) [pr_x, pr_y, nx, ny], uvn (nch, 3,
    CHUNK) [nx * k, ny * k, 1 - act], iters, seed_out, reads), bitwise
    those of the megastep drive (B5, or B1 + B2, then B4)."""
    statics = finish_statics(cfg)
    time_lo = cfg.splat_time_lo or cfg.schedule != "fast"
    pair = image_pair(stat.device, H, W)
    step = lambda pr, st: megastep2_call(
        stat, act, pr, st, *pair, geo, scale=scale, H=H, W=W,
        time_lo=time_lo, **statics)
    st0 = initial_state(model0, cfg, seed)
    reads = ExitReads()
    out = step(torch.cat([stat[:, 0:2], torch.zeros_like(stat[:, 0:2])],
                         dim=1), st0)
    iters = 0          # the first call runs no finish: one update a call
    while True:
        out = step(out[0], out[1])
        iters += 1
        if not reads(out[1][0, ST_CONT]) > 0:
            break
    pr, st = out[0], out[1]
    seed_out = torch.cat([st[0, ST_SL:ST_SL + 4], st[0, ST_PD:ST_PD + 4]])
    uvn = torch.stack([pr[:, 2] * UV_K, pr[:, 3] * UV_K, 1.0 - act[:, 0]],
                      dim=1)
    # One read after every call but the first.
    return model_from_state(st), pr, uvn, iters, seed_out, reads.n


class FusedFlowState(NamedTuple):
    """The composed loop's state: the warped positions in the kernels'
    (nch, 2, CHUNK) layout (all local shards' chunks), the model, the four
    f32 step dividers as 0-d device tensors, the iteration count, which
    the host keeps, and the blocking reads the loop took (set by
    ``adaptive_loop`` and ``fast_loop`` on the state they return)."""

    pr: torch.Tensor
    model: MotionModel
    x_div: torch.Tensor
    y_div: torch.Tensor
    rot_div: torch.Tensor
    div_div: torch.Tensor
    iters: int
    reads: int = 0

    def divs4(self) -> torch.Tensor:
        """The dividers in (rot, div, dx, dy) order."""
        return torch.stack([self.rot_div, self.div_div, self.x_div,
                            self.y_div])


def _with_dividers(s: FusedFlowState, cfg: OptimizerConfig
                   ) -> FusedFlowState:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                 device=s.model.cx.device)
    return s._replace(x_div=f32(cfg.init_xy_divider),
                      y_div=f32(cfg.init_xy_divider),
                      rot_div=f32(cfg.init_rotdiv_divider),
                      div_div=f32(cfg.init_rotdiv_divider), iters=0)


def _grad4(m: MotionModel) -> torch.Tensor:
    return torch.stack([m.rot, m.div, m.dx, m.dy])


def adaptive_loop(init: FusedFlowState, step_fn, cfg: OptimizerConfig
                  ) -> FusedFlowState:
    """OptimizerRolling::run's adaptive loop (optimizer_rolling.h:60-111,
    ``_adaptive_loop`` of the JAX package): one unconditional step, then
    steps while a divider is open, the divided gradient is above tolerance
    and the iteration caps allow; a divider doubles when its gradient
    component flips sign.  ``step_fn(state)`` is one iteration.  The
    returned state's ``reads`` counts the blocking reads of the exit
    test."""
    reads = ExitReads()
    s = step_fn(_with_dividers(init, cfg))
    caps = (cfg.xy_divider_cap, cfg.rotdiv_divider_cap)

    def go_on(s):
        m = s.model
        over_max = cfg.max_iter > 0 and s.iters > cfg.max_iter
        if over_max or s.iters >= cfg.iter_hard_cap:
            return False     # the caps are host values: no read
        dividers_open = ((s.x_div < caps[0]) | (s.y_div < caps[0])
                         | (s.rot_div < caps[1]) | (s.div_div < caps[1]))
        small = ((torch.abs(m.dx / s.x_div) < cfg.dx_tol)
                 & (torch.abs(m.dy / s.y_div) < cfg.dy_tol)
                 & (torch.abs(m.rot / s.rot_div) < cfg.rot_tol)
                 & (torch.abs(m.div / s.div_div) < cfg.div_tol))
        return bool(reads(dividers_open & ~small))     # the one read

    while go_on(s):
        old = s.model
        s = step_fn(s)
        m = s.model
        dbl = lambda new, prev, div: torch.where(new * prev < 0, div * 2,
                                                 div)
        s = s._replace(x_div=dbl(m.dx, old.dx, s.x_div),
                       y_div=dbl(m.dy, old.dy, s.y_div),
                       rot_div=dbl(m.rot, old.rot, s.rot_div),
                       div_div=dbl(m.div, old.div, s.div_div))
    return s._replace(reads=reads.n)


def fast_loop(init: FusedFlowState, step_fn, cfg: OptimizerConfig,
              seed: Optional[torch.Tensor] = None):
    """The secant schedule (``_fast_loop`` of the JAX package): each
    component's step is a damped Newton step on the slope between the last
    two iterates (or the carried slope memory, seeded from ``seed[:4]``),
    clamped to 4x (fresh slope) or 1x (carried) the reference step, and the
    reference step when no slope is usable; the exit takes every delta
    below tolerance, qualified by ``exit_grad_factor`` and widened by the
    predicted exit of ``exit_predict_cap``.  ``step_fn(state, update_fn)``
    applies ``update_fn(model, state) -> model`` in place of the reference
    step.  The secant carry is f32, as in the JAX package's f32 path.
    Returns (final state, (8,) [slope memory, last deltas]); the state's
    ``reads`` counts the blocking reads of the exit test."""
    state = _with_dividers(init, cfg)
    dev = init.model.cx.device
    f32 = torch.float32
    zeros4 = torch.zeros(4, dtype=f32, device=dev)
    slope0 = zeros4 if seed is None else seed[:4]
    tol = torch.tensor([cfg.rot_tol, cfg.div_tol, cfg.dx_tol, cfg.dy_tol],
                       dtype=f32, device=dev)
    tol4 = 4.0 * tol
    grad_tol = cfg.exit_grad_factor * tol
    pred_tol = cfg.exit_predict_cap * tol

    def body(carry):
        s, prev_g, prev_d, slope_mem, _ = carry
        slope_used_prev = slope_mem

        def two_point(g):
            slope2 = (g - prev_g) / prev_d
            valid2 = ((torch.abs(prev_d) > 0) & torch.isfinite(slope2)
                      & (slope2 < 0))
            return torch.where(valid2, slope2, slope_mem), valid2

        def update(model, st):
            g = _grad4(model)
            ref = g / st.divs4()
            slope, valid2 = two_point(g)
            newton = (-0.9 * g) / slope
            lim = torch.where(valid2, 4.0, 1.0) * torch.abs(ref)
            ok = (slope < 0) & torch.isfinite(newton)
            delta = torch.where(
                ok, torch.minimum(torch.maximum(newton, -lim), lim), ref)
            return model.add_totals(*delta.unbind())

        tot_before = s.model.totals4()
        s = step_fn(s, update)
        m = s.model
        g = _grad4(m)
        d = m.totals4() - tot_before
        slope_mem, _ = two_point(g)
        # The reference's divider doubling, gated on a real previous step.
        dbl = (torch.abs(prev_d) > 0) & (g * prev_g < 0)
        divs = torch.where(dbl, s.divs4() * 2, s.divs4())
        s = s._replace(rot_div=divs[0], div_div=divs[1], x_div=divs[2],
                       y_div=divs[3])
        exit_c = torch.abs(d) < tol
        if cfg.exit_grad_factor > 0:
            exit_c = exit_c & (torch.abs(g) / divs < grad_tol)
        if cfg.exit_predict_cap > 0:
            # The model-validated one-step-ahead exit.
            g_pred = prev_g + slope_used_prev * prev_d
            relerr = torch.abs(g - g_pred) / torch.clamp(torch.abs(prev_g),
                                                         min=1e-30)
            pred_next_g = g + slope_mem * d
            pred_next_d = torch.abs(0.9 * pred_next_g / torch.where(
                slope_mem < 0, slope_mem, -1e-30))
            pred_ok = ((torch.abs(prev_d) > 0) & (relerr < 0.75)
                       & (slope_mem < 0) & (pred_next_d < tol)
                       & (torch.abs(pred_next_g) / divs < tol)
                       & (torch.abs(d) < pred_tol))
            exit_c = exit_c | pred_ok
        return (s, g, d, slope_mem, exit_c.all())

    def go_on(carry):
        s, g, _d, _sl, exit_small = carry
        over_max = cfg.max_iter > 0 and s.iters > cfg.max_iter
        if over_max or s.iters >= cfg.iter_hard_cap:
            return False
        small = exit_small
        if s.iters < 2:
            small = small & (torch.abs(g) / s.divs4() < tol4).all()
        return bool(reads(~small))                     # the one read

    reads = ExitReads()
    carry = body((state, zeros4, zeros4, slope0, None))
    while go_on(carry):
        carry = body(carry)
    final, _g, d, slope_mem, _ = carry
    return final._replace(reads=reads.n), torch.cat([slope_mem, d])


def drive_loop(init: FusedFlowState, step_fn, cfg: OptimizerConfig,
               seed=None):
    """The configured schedule.  ``step_fn(state, update_fn)``.  Returns
    (final state, (8,) seed_out): the secant slope memory and last deltas
    (zeros for the reference schedule)."""
    if cfg.schedule == "fast":
        return fast_loop(init, step_fn, cfg, seed=seed)
    return (adaptive_loop(init, lambda s: step_fn(s, None), cfg),
            torch.zeros(8, dtype=torch.float32,
                        device=init.model.cx.device))


class GlobalFlowState(NamedTuple):
    """The XLA branch's loop state (``GlobalFlowState`` of the JAX
    package): the current warp of every event of the flat slice, its
    direction vectors, the model, the four f32 step dividers as 0-d device
    tensors, the iteration count, which the host keeps, and the loop's
    blocking reads (``FusedFlowState.reads``)."""

    pr_x: torch.Tensor
    pr_y: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    model: MotionModel
    x_div: torch.Tensor
    y_div: torch.Tensor
    rot_div: torch.Tensor
    div_div: torch.Tensor
    iters: int
    reads: int = 0

    def divs4(self) -> torch.Tensor:
        """The dividers in (rot, div, dx, dy) order."""
        return torch.stack([self.rot_div, self.div_div, self.x_div,
                            self.y_div])


def warp_init(ev: EventSlice, model: MotionModel) -> GlobalFlowState:
    """The warm-start warp (set_model, optimizer_rolling.h:289-299): every
    event re-projected from its pixel with ``model``'s totals about its
    event-coordinate centroid (the identity for a zero model), dividers 1,
    no iteration."""
    pr_x, pr_y, nx, ny = project_4param_reinit(
        ev.x, ev.y, ev.t, ev.x, ev.y, -model.total_dx, -model.total_dy,
        model.cx, model.cy, model.total_div, -model.total_rot, sin_fma=True)
    one = torch.ones((), dtype=torch.float32, device=ev.x.device)
    return GlobalFlowState(pr_x=pr_x, pr_y=pr_y, nx=nx, ny=ny, model=model,
                           x_div=one, y_div=one, rot_div=one, div_div=one,
                           iters=0)


def iteration_step(state: GlobalFlowState, ev: EventSlice,
                   geom: SliceGeometry, scale: int, H: int, W: int,
                   scatter_mode: str = "xla", update_fn=None,
                   geo: Optional[torch.Tensor] = None,
                   group=None) -> GlobalFlowState:
    """One optimizer iteration (OptimizerRolling::iteration_step,
    optimizer_rolling.h:305-347; ``_iteration_step`` of the JAX package).
    "xla", "rep" or "mxu" (``XLA_MODES``, one exact integer scatter): the
    time image of the current warp, its centroid, the masked
    Scharr gradients and the four model means; "pallas" or "auto": the seven
    sums of B11 (``fused_model_partials_windowed_call``), for events sorted
    by ``ops.layout.sort_key_blocks`` as ``process_slice`` of the JAX
    package sorts them (exact in any order).  The (1, 8)
    geometry row ``geo`` is built from ``geom`` when not given.  Then the
    reference step (or ``update_fn(model, state)``, the
    secant schedule's), the centroid back to event coordinates and the
    re-warp of every event with the new totals.  The warp here (and in
    ``warp_init``) fuses the rotation as XLA compiles this loop
    (``sin_fma``, measured bit for bit on the CPU with the events traced,
    as the JAX scan has them).  Under an event ``group`` (``ev`` this
    process's shards' events) the XLA modes sum the pre-filter pair across
    its ranks (``time_image``'s ``comm``), and "pallas" or "auto" take the
    XLA chain too, as the JAX package's composed step does under an
    ``axis_name`` (B11 has no image seam)."""
    if scatter_mode in ("pallas", "auto") and group is not None:
        scatter_mode = "xla"
    if scatter_mode in ("pallas", "auto"):
        if geo is None:
            geo = torch.from_numpy(geo_row(geom)).to(ev.x.device)
        p = fused_model_partials_windowed_call(state.pr_x, state.pr_y, ev.t,
                                               ev.active, geo, scale=scale,
                                               H=H, W=W)
        cx_img, cy_img, terms = model_from_partials(p)
    elif scatter_mode in XLA_MODES:
        img = time_image(state.pr_x, state.pr_y, ev.t, ev.active, scale,
                         geom.x_shift, geom.y_shift, geom.w_dyn, geom.h_dyn,
                         H, W, scatter_mode=scatter_mode,
                         comm=None if group is None else group.comm)
        cx_img, cy_img, _ = center_of_mass(img)
        gx, gy = masked_scharr(img)
        terms = model_compute(img, gx, gy, cx_img, cy_img)
    else:
        raise NotImplementedError(f"scatter_mode={scatter_mode!r}")
    model = state.model.replace(cx=cx_img, cy=cy_img, dx=terms.dx,
                                dy=terms.dy, rot=terms.rot, div=terms.div,
                                cnt=terms.cnt)
    if update_fn is None:
        model = model.update_accumulators(state.rot_div, state.div_div,
                                          state.x_div, state.y_div)
    else:
        model = update_fn(model, state)
    model = model.replace(cx=_to_event(model.cx, geom.x_shift, scale),
                          cy=_to_event(model.cy, geom.y_shift, scale))
    pr_x, pr_y, nx, ny = project_4param_reinit(
        ev.x, ev.y, ev.t, state.pr_x, state.pr_y, -model.total_dx,
        -model.total_dy, model.cx, model.cy, model.total_div,
        -model.total_rot, sin_fma=True)
    return state._replace(pr_x=pr_x, pr_y=pr_y, nx=nx, ny=ny, model=model,
                          iters=state.iters + 1)


def run_optimizer(init: GlobalFlowState, ev: EventSlice,
                  geom: SliceGeometry, scale: int, H: int, W: int,
                  cfg: OptimizerConfig, seed=None,
                  geo: Optional[torch.Tensor] = None, group=None):
    """The XLA-composed optimizer loop (``_run_optimizer`` of the JAX
    package): ``iteration_step`` with ``cfg.scatter_mode`` under the
    configured schedule (``drive_loop``), its images summed over the event
    ``group`` when given (JAX's ``axis_name``).  Returns (final state,
    (8,) seed_out)."""
    step = lambda s, u: iteration_step(s, ev, geom, scale, H, W,
                                       cfg.scatter_mode, update_fn=u,
                                       geo=geo, group=group)
    return drive_loop(init, step, cfg, seed=seed)


def uvn_pack(u: torch.Tensor, v: torch.Tensor, noise: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """The scan's (nch, 3, CHUNK) [u, v, noise] pack of a flat slice
    (``scan_pipeline.py:360-369`` of the JAX package), zero-padded to whole
    chunks: noise as 0/1 f32, 1 on padding slots."""
    n = u.shape[0]
    nch = -(-n // CHUNK)
    pad = lambda a: torch.nn.functional.pad(
        a, (0, nch * CHUNK - n)).reshape(nch, CHUNK)
    noisef = torch.maximum(noise.to(torch.float32),
                           1.0 - valid.to(torch.float32))
    return torch.stack([pad(u), pad(v), pad(noisef)], dim=1)


def _to_event(c_img: torch.Tensor, shift: float, scale: int) -> torch.Tensor:
    """An image-coordinate centroid back in event coordinates
    (optimizer_rolling.h:330-331): the division by the constant scale is a
    multiplication by its f32 reciprocal, as XLA compiles it."""
    return (c_img - shift) * recip(scale)


def run_fused_composed(stat, act, geo, geom: SliceGeometry,
                       model0: MotionModel, cfg: OptimizerConfig, scale: int,
                       H: int, W: int, seed=None, group=None):
    """The composed drive (``_run_fused``'s loop without the megastep): per
    iteration one B6 launch on the warp of the current model, then the
    model update from its seven sums in 0-d tensor operations on the
    device (the model's dtype: f64 totals stay f64), the centroid back to
    event coordinates, and the schedule's exit test, read once by the host.
    Under an event ``group`` the B6 launch becomes one B7a launch over all
    the local shards' chunks (``stat`` and ``act`` as one range) into an
    image pair allocated once per call, the in-place sum of that pair
    across ranks (``sum_images``), then B7b, which reads it and leaves it
    zero for the next iteration: bitwise the same seven sums.
    The epilogue warps the events once more with the f32-cast totals and
    packs [u, v, noise] in plain tensor operations, as the JAX package's
    XLA epilogue does (its arithmetic differs from B4's, see
    ``project_4param_reinit_cs``).
    Returns (model, out (nch, 4, CHUNK), uvn, iters, seed_out, reads);
    under a group ``out`` and ``uvn`` hold the local shards' chunks in
    order."""
    pair = None if group is None else image_pair(stat.device, H, W)

    def step(s: FusedFlowState, update_fn=None) -> FusedFlowState:
        m = s.model
        scal = warp_scal_row(geo, m)
        if group is None:
            pr, p = fused_warp_splat_call(stat, act, s.pr, scal, scale=scale,
                                          H=H, W=W)
        else:
            pr, acc_t, acc_c, _fb = fused_warp_splat_images_call(
                stat, act, s.pr, scal, *pair, scale=scale, H=H, W=W)
            acc_t, acc_c = sum_images(acc_t, acc_c, group.comm)
            p = finish_partials_call(acc_t, acc_c, scale=scale, H=H, W=W)
        cx_img, cy_img, terms = model_from_partials(p)
        model = m.replace(cx=cx_img, cy=cy_img, dx=terms.dx, dy=terms.dy,
                          rot=terms.rot, div=terms.div, cnt=terms.cnt)
        if update_fn is None:
            model = model.update_accumulators(s.rot_div, s.div_div, s.x_div,
                                              s.y_div)
        else:
            model = update_fn(model, s)
        model = model.replace(cx=_to_event(model.cx, geom.x_shift, scale),
                              cy=_to_event(model.cy, geom.y_shift, scale))
        return s._replace(pr=pr, model=model, iters=s.iters + 1)

    one = torch.ones((), dtype=torch.float32, device=stat.device)
    init = FusedFlowState(pr=stat[:, 0:2].contiguous(), model=model0,
                          x_div=one, y_div=one, rot_div=one, div_div=one,
                          iters=0)
    final, seed_out = drive_loop(init, step, cfg, seed=seed)
    m = final.model
    pr_x, pr_y, nx, ny = project_4param_reinit(
        stat[:, 0], stat[:, 1], stat[:, 2], final.pr[:, 0], final.pr[:, 1],
        -m.total_dx, -m.total_dy, m.cx, m.cy, m.total_div, -m.total_rot,
        sin_fma=True)
    out = torch.stack([pr_x, pr_y, nx, ny], dim=1)
    uvn = torch.stack([nx * UV_K, ny * UV_K, 1.0 - act[:, 0]], dim=1)
    return m, out, uvn, final.iters, seed_out, final.reads


def process_slice(stat, act, last_model: MotionModel, cfg: OptimizerConfig,
                  sensor: SensorConfig, bbox, n_valid: int,
                  warm_start: bool = True, seed=None,
                  geo: Optional[torch.Tensor] = None,
                  ev: Optional[EventSlice] = None, group=None,
                  uvn_out: Optional[torch.Tensor] = None,
                  start_model: Optional[MotionModel] = None):
    """Process one spatially pre-sorted slice.

    ``start_model`` (``OptimizerConfig.warm_extrapolate``'s extrapolated
    warm start) replaces ``last_model`` as the optimizer's starting model
    when the slice runs and ``warm_start`` holds; the skipped slice's warp
    of record, the gates and the noise keep ``last_model``
    (``global_flow.py:929-935`` of the JAX package).

    With a ``cfg.scatter_mode`` of ``XLA_MODES`` the XLA branch runs on
    the flat slice ``ev`` alone (``stat`` and ``act`` are not read and may
    be None; under a group ``ev`` holds the local shards' slots; see
    ``process_slice_xla``).  Otherwise the kernel branch:
    ``stat`` (nch, 3, CHUNK) and ``act`` (nch, 1, CHUNK) are the slice's
    event pack and activity rows; ``bbox`` (x_min, x_max, y_min, y_max)
    and ``n_valid`` come from host staging (or, for shards, from
    ``core.events.bounding_box`` and a summed count: the whole slice's, the
    same on every rank); ``geo`` optionally gives the (1, 8) geometry row
    already on the device.  Given the slice's flat events ``ev``, the
    result's ``noise`` is ``ev.noise | (window_small & ev.valid)`` (the
    streaming path reads it; the scan reads the noise row of uvn).

    Under an event ``group`` (``parallel.mesh.EventGroup``) ``stat`` and
    ``act`` hold the local shards: one tensor each with their chunks in
    order (``group.n_local`` equal ranges); the optimizer splits at the
    image sum (see the module docstring), and the per-event results hold
    the local shards' slots in order.

    Returns (SliceResult, uvn) where uvn is the (nch, 3, CHUNK)
    [u, v, noise] pack: ``uvn_out`` itself when given (a contiguous f32
    tensor of that shape, such as the scan's output at the slice), which
    the megastep drive's B4 writes and every other branch copies into.
    The result's ``reads`` counts the blocking reads its drive took."""
    check_supported(cfg, last_model.totals_dtype == torch.float64)
    if xla_branch(cfg):
        if ev is None:
            raise ValueError(f"scatter_mode={cfg.scatter_mode!r} runs on "
                             "the flat slice: pass ev")
        res, uvn = process_slice_xla(ev, last_model, cfg, sensor, bbox,
                                     n_valid, warm_start=warm_start,
                                     seed=seed, start_model=start_model,
                                     group=group)
        return res, _into(uvn, uvn_out)
    scale = cfg.scale
    H, W = static_image_shape(scale, sensor)
    geom = geometry_from_bbox(*bbox, scale, sensor, cfg.min_window_fraction)
    dev = stat.device
    # As in the JAX package, a cold start is an f32 zero model.
    model = last_model if warm_start else MotionModel.zero(dev)
    ran = (not geom.window_small) and int(n_valid) >= cfg.min_events

    reads = 0
    if ran:
        if geo is None:
            geo = torch.from_numpy(geo_row(geom)).to(dev)
        mega = uses_megastep(cfg, model.totals_dtype)
        drive = functools.partial(run_fused_mega, uvn_out=uvn_out) \
            if mega else functools.partial(run_fused_composed, geom=geom)
        model_out, out, uvn, iters, seed_out, reads = drive(
            stat, act, geo,
            model0=_start(model, start_model, warm_start), cfg=cfg,
            scale=scale, H=H, W=W, seed=seed, group=group)
        pr_x, pr_y, nx, ny = (out[:, k].reshape(-1) for k in range(4))
        if mega and profiling.RECORDER is not None:
            count_finishes(profiling.RECORDER, iters, H, W, geom)
    else:
        # The skipped slice keeps the warm-start warp (set_model) and the
        # incoming model; its events are noise when the window gate fired.
        fx, fy, t = (stat[:, k].reshape(-1) for k in range(3))
        pr_x, pr_y, nx, ny = project_4param_reinit(
            fx, fy, t, fx, fy, -model.total_dx, -model.total_dy, model.cx,
            model.cy, model.total_div, -model.total_rot)
        noise = torch.clamp(1.0 - act[:, 0],
                            min=float(geom.window_small))
        uvn = torch.stack([nx.reshape(-1, CHUNK) * UV_K,
                           ny.reshape(-1, CHUNK) * UV_K, noise], dim=1)
        model_out, iters = model, 0
        seed_out = torch.zeros(8, dtype=torch.float32, device=dev)
    u, v = compute_uv(nx, ny)
    # The degenerate-window gate marks every event noise
    # (optimizer_rolling.h:52-54); the too-few gate does not.
    noise = None if ev is None else \
        ev.noise | (ev.valid & geom.window_small)
    res = SliceResult(model=model_out, pr_x=pr_x, pr_y=pr_y, nx=nx, ny=ny,
                      u=u, v=v, iters=iters, ran=ran,
                      window_small=geom.window_small, seed=seed_out,
                      noise=noise, reads=reads)
    return res, _into(uvn, uvn_out)


def process_event_slice(ev: EventSlice, last_model: MotionModel,
                        cfg: OptimizerConfig, sensor: SensorConfig,
                        warm_start: bool = True, presorted: bool = False,
                        seed=None, bbox=None, n_valid=None,
                        start_model: Optional[MotionModel] = None
                        ) -> SliceResult:
    """One slice given as a flat ``EventSlice`` in any order, the JAX
    package's ``process_slice(ev, last_model, cfg, sensor, ...)``
    (``global_flow.py:906-1103``).  On the kernel branch the events are
    sorted by ``ops.layout.sort_key_blocks`` (stable) unless
    ``presorted``, laid out in chunks (``prepare_chunk_layouts``, and
    ``pack_act`` of the valid events that are not noise) and run by the
    staged ``process_slice``; the XLA branch's modes run on ``ev`` as it
    is, as in the JAX package.  ``bbox`` (x_min, x_max, y_min, y_max) and
    ``n_valid`` are the valid events' when not given (one device read
    each).  Returns the ``SliceResult`` with every per-event field (pr_x,
    pr_y, nx, ny, u, v, noise; ``ev.capacity`` long) in ``ev``'s order,
    ``noise = ev.noise | (window_small & ev.valid)``.

    Divergences by design: JAX's ``axis_name`` (the port's event groups
    run through the staged form's ``group``), ``stat3`` and ``act3``
    (the staged form takes its chunk tensors) and ``want_uvn`` (the staged
    form returns the [u, v, noise] pack) have no counterpart here."""
    if bbox is None:
        bbox = bounding_box(ev)
    if n_valid is None:
        n_valid = int(ev.valid.sum())
    if xla_branch(cfg):
        res, _ = process_slice(None, None, last_model, cfg, sensor, bbox,
                               n_valid, warm_start=warm_start, seed=seed,
                               ev=ev, start_model=start_model)
        return res
    cap = ev.capacity
    order = None
    if not presorted:
        order = torch.argsort(sort_key_blocks(ev.x, ev.y, ev.valid),
                              stable=True)
        ev = EventSlice(*(f[order] for f in ev))
    res, _ = process_slice(prepare_chunk_layouts(ev.x, ev.y, ev.t),
                           pack_act(ev.active), last_model, cfg, sensor,
                           bbox, n_valid, warm_start=warm_start, seed=seed,
                           ev=ev, start_model=start_model)
    fields = ("pr_x", "pr_y", "nx", "ny", "u", "v", "noise")
    if order is None:
        return res._replace(**{f: getattr(res, f)[:cap] for f in fields})
    inv = torch.empty_like(order)
    inv[order] = torch.arange(cap, device=order.device)
    return res._replace(**{f: getattr(res, f)[:cap][inv] for f in fields})


def _start(model: MotionModel, start_model: Optional[MotionModel],
           warm_start: bool) -> MotionModel:
    """The optimizer's starting model: ``start_model`` under a warm
    start when given, else ``model``."""
    return start_model if start_model is not None and warm_start else model


def _into(uvn: torch.Tensor, uvn_out: Optional[torch.Tensor]):
    """``uvn_out`` holding ``uvn`` (unless it is that tensor already);
    ``uvn`` without one.  Refuses an ``uvn_out`` of another shape, dtype,
    device or layout."""
    if uvn_out is None or uvn is uvn_out:
        return uvn
    if (uvn_out.shape != uvn.shape or uvn_out.dtype != uvn.dtype
            or uvn_out.device != uvn.device
            or not uvn_out.is_contiguous()):
        raise ValueError(f"uvn_out: {uvn_out.dtype} {tuple(uvn_out.shape)} "
                         f"on {uvn_out.device}, expected a contiguous "
                         f"{uvn.dtype} {tuple(uvn.shape)} on {uvn.device}")
    return uvn_out.copy_(uvn)


def process_slice_xla(ev: EventSlice, last_model: MotionModel,
                      cfg: OptimizerConfig, sensor: SensorConfig, bbox,
                      n_valid: int, warm_start: bool = True, seed=None,
                      start_model: Optional[MotionModel] = None,
                      group=None):
    """``process_slice``'s XLA branch (``global_flow.py:1034-1077`` of the
    JAX package) on the flat slice ``ev``: the warm-start warp of every
    event, then, when the slice passes the gates, ``run_optimizer`` from
    it; a gated slice keeps the warm-start warp and the incoming model.
    With ``start_model`` (and ``warm_start``) a slice that runs warps and
    optimizes from it instead, and a gated one still keeps
    ``last_model``.  Per-event outputs are in ``ev``'s order; ``noise`` is
    ``ev.noise | (window_small & ev.valid)``.  Under an event ``group``
    ``ev`` holds this process's shards' slots (in order) and every
    iteration's images are summed over the group (``run_optimizer``);
    ``bbox`` and ``n_valid`` are the whole slice's, and the per-event
    outputs hold the local slots.  Returns (SliceResult, uvn) with uvn the
    scan's (nch, 3, CHUNK) pack (``uvn_pack``)."""
    scale = cfg.scale
    H, W = static_image_shape(scale, sensor)
    geom = geometry_from_bbox(*bbox, scale, sensor, cfg.min_window_fraction)
    dev = ev.x.device
    # As in the JAX package, a cold start is an f32 zero model.
    model = last_model if warm_start else MotionModel.zero(dev)
    ran = (not geom.window_small) and int(n_valid) >= cfg.min_events
    opt_start = _start(model, start_model, warm_start)
    # The plain warm start: one warm-start warp serves both outcomes.
    final = warp_init(ev, model) if not ran or opt_start is model \
        else warp_init(ev, opt_start)
    seed_out = torch.zeros(8, dtype=torch.float32, device=dev)
    if ran:
        final, seed_out = run_optimizer(final, ev, geom, scale, H, W, cfg,
                                        seed=seed, group=group)
    noise = ev.noise | (ev.valid & geom.window_small)
    u, v = compute_uv(final.nx, final.ny)
    res = SliceResult(model=final.model, pr_x=final.pr_x, pr_y=final.pr_y,
                      nx=final.nx, ny=final.ny, u=u, v=v, iters=final.iters,
                      ran=ran, window_small=geom.window_small, seed=seed_out,
                      noise=noise, reads=final.reads)
    return res, uvn_pack(u, v, noise, ev.valid)


def final_time_image(ev: EventSlice, res: SliceResult, scale: int,
                     sensor: SensorConfig) -> torch.Tensor:
    """The time image of the converged (motion-compensated) slice: its
    events that are valid and not noise, at their final warp, in the
    window of the slice's own bbox (``final_time_image`` of the JAX
    package, the image of the PSNR gate)."""
    H, W = static_image_shape(scale, sensor)
    geom = slice_geometry(ev, scale, sensor)
    active = ev.valid & ~res.noise
    return time_image(res.pr_x, res.pr_y, ev.t, active, scale, geom.x_shift,
                      geom.y_shift, geom.w_dyn, geom.h_dyn, H, W)
