"""Global 4-parameter flow on one slice, driven through the kernels.

Counterpart of ``better_flow_tpu/models/global_flow.py`` for its kernel
branch: ``process_slice`` and ``_run_fused_mega``, whose iteration is one
megastep (B5: warp + splat, finish, model update in one launch) unless
``OptimizerConfig.megastep_split`` or the ``fast`` presets ask for the split
pair (B1 warp + splat, then B2 finish + model update).  The slice gates
depend only on the host-side bbox and event count, so the host decides them
without reading the device; the optimizer loop reads the state's continue
flag once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from better_flow_tpu.config import OptimizerConfig, SensorConfig
from better_flow_tpu_torch.core.events import EventSlice
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.ops.fused_model import (
    megastep_call, megastep_finish_call, warp_images_st_call, warp_uv_call,
)
from better_flow_tpu_torch.ops.layout import (
    CHUNK, ST_CDIV, ST_CDX, ST_CDY, ST_CNT, ST_CONT, ST_CROT, ST_CX, ST_CY,
    ST_DDIV, ST_DIV, ST_DX, ST_DY, ST_PD, ST_RDIV, ST_ROT, ST_SIZE, ST_SL,
    ST_TDIV, ST_TDX, ST_TDY, ST_TROT, ST_XDIV, ST_YDIV,
)
from better_flow_tpu_torch.ops.warp import UV_K, compute_uv, project_4param_reinit


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


def check_supported(cfg: OptimizerConfig) -> None:
    """Raise for the configurations this port does not run."""
    if cfg.warm_extrapolate > 0:
        raise NotImplementedError("OptimizerConfig.warm_extrapolate")
    if cfg.megastep_merged:
        raise NotImplementedError("OptimizerConfig.megastep_merged")
    if cfg.splat_pair > 1:
        raise NotImplementedError("OptimizerConfig.splat_pair")
    if cfg.megastep_unroll > 1:
        raise NotImplementedError("OptimizerConfig.megastep_unroll")
    if not cfg.use_megastep:
        raise NotImplementedError("OptimizerConfig.use_megastep")
    if cfg.scatter_mode not in ("auto", "pallas"):
        raise NotImplementedError(
            f"OptimizerConfig.scatter_mode={cfg.scatter_mode!r}")
    if cfg.schedule not in ("fast", "reference"):
        raise NotImplementedError(f"OptimizerConfig.schedule={cfg.schedule!r}")


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
    for the fast schedule the seed's slope memory."""
    dev = model.total_dx.device
    st = torch.zeros((1, ST_SIZE), dtype=torch.float32, device=dev)
    st[0, ST_TDX:ST_TDIV + 1] = torch.stack(
        [model.total_dx, model.total_dy, model.total_rot, model.total_div])
    st[0, ST_CDX:ST_CDIV + 1] = torch.stack(
        [model.comp_dx, model.comp_dy, model.comp_rot, model.comp_div])
    st[0, ST_CX] = model.cx
    st[0, ST_CY] = model.cy
    st[0, ST_XDIV] = cfg.init_xy_divider
    st[0, ST_YDIV] = cfg.init_xy_divider
    st[0, ST_RDIV] = cfg.init_rotdiv_divider
    st[0, ST_DDIV] = cfg.init_rotdiv_divider
    st[0, ST_CNT] = model.cnt
    st[0, ST_CONT] = 1.0
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


def run_fused_mega(stat, act, geo, model0: MotionModel,
                   cfg: OptimizerConfig, scale: int, H: int, W: int,
                   seed=None):
    """The megastep drive: one unconditional iteration, then iterations
    while the state's CONT flag is set, then the final-warp epilogue.  An
    iteration is one B5 launch, or the B1 + B2 pair under
    ``cfg.megastep_split``.  The host reads the CONT flag once per
    iteration.  Returns (model, out (nch, 4, CHUNK), uvn, iters,
    seed_out)."""
    statics = finish_statics(cfg)
    time_lo = cfg.splat_time_lo or cfg.schedule != "fast"
    st = initial_state(model0, cfg, seed)
    pr = stat[:, 0:2].contiguous()
    iters = 0
    while True:
        if cfg.megastep_split:
            pr, acc_t, acc_c = warp_images_st_call(
                stat, act, pr, st, geo, scale=scale, H=H, W=W,
                time_lo=time_lo)
            st = megastep_finish_call(acc_t, acc_c, st, geo, scale=scale,
                                      H=H, W=W, **statics)
        else:
            pr, st = megastep_call(stat, act, pr, st, geo, scale=scale, H=H,
                                   W=W, time_lo=time_lo, **statics)
        iters += 1
        if not st[0, ST_CONT].item() > 0:
            break
    seed_out = torch.cat([st[0, ST_SL:ST_SL + 4], st[0, ST_PD:ST_PD + 4]])
    out, uvn = warp_uv_call(stat, pr, act, st, 0.0)
    return model_from_state(st), out, uvn, iters, seed_out


def process_slice(stat: torch.Tensor, act: torch.Tensor,
                  last_model: MotionModel, cfg: OptimizerConfig,
                  sensor: SensorConfig, bbox, n_valid: int,
                  warm_start: bool = True, seed=None,
                  geo: Optional[torch.Tensor] = None,
                  ev: Optional[EventSlice] = None):
    """Process one spatially pre-sorted slice (the kernel branch).

    ``stat`` (nch, 3, CHUNK) and ``act`` (nch, 1, CHUNK) are the slice's
    event pack and activity rows; ``bbox`` (x_min, x_max, y_min, y_max)
    and ``n_valid`` come from host staging; ``geo`` optionally gives the
    (1, 8) geometry row already on the device.  Given the slice's flat
    events ``ev``, the result's ``noise`` is ``ev.noise | (window_small &
    ev.valid)`` (the streaming path reads it; the scan reads the noise row
    of uvn).  Returns (SliceResult, uvn) where uvn is the (nch, 3, CHUNK)
    [u, v, noise] pack."""
    check_supported(cfg)
    scale = cfg.scale
    H, W = static_image_shape(scale, sensor)
    geom = geometry_from_bbox(*bbox, scale, sensor, cfg.min_window_fraction)
    dev = stat.device
    model = last_model if warm_start else MotionModel.zero(dev)
    ran = (not geom.window_small) and int(n_valid) >= cfg.min_events

    if ran:
        if geo is None:
            geo = torch.from_numpy(geo_row(geom)).to(dev)
        model_out, out, uvn, iters, seed_out = run_fused_mega(
            stat, act, geo, model, cfg, scale, H, W, seed=seed)
        pr_x, pr_y, nx, ny = (out[:, k].reshape(-1) for k in range(4))
    else:
        # The skipped slice keeps the warm-start warp (set_model) and the
        # incoming model; its events are noise when the window gate fired.
        fx, fy, t = (stat[:, k].reshape(-1) for k in range(3))
        pr_x, pr_y, nx, ny = project_4param_reinit(
            fx, fy, t, fx, fy, -model.total_dx, -model.total_dy, model.cx,
            model.cy, model.total_div, -model.total_rot)
        noise = torch.clamp(1.0 - act[:, 0], min=float(geom.window_small))
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
                      noise=noise)
    return res, uvn
