"""Plain reference of the motion compensation that the benchmark checks.

A straightforward PyTorch implementation of the semantics of the reference
C++ program (DVS_flow and OptimizerRolling: dvs_flow.h, optimizer_rolling.h,
object_model.h, event.h, accel_lib.h), written for this benchmark.  It
imports nothing of the program under test and takes nothing the program
made: it works out the trigger plan, every slice's window, bbox, window
gate, noise history, the optimizer and the final warp from the events
alone.  The events of a slice are kept flat, in time order; sums are taken
in float64 (the program sums exactly in integers or in a fixed order), the
per-event and per-pixel arithmetic is in ``dtype``.

``dtype=torch.bfloat16`` is the benchmark's control: the same reference
computed one precision below the float32 that the configurations state, with
every sum in bfloat16 as well.  A comparison that cannot tell it from the
program is not a check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NZ = 127.0                  # z component of the direction vector
WARP_TIME_DIV = 1e4         # t (ns) / 1e4 in the warp
UV_FACTOR = 1e5             # px/s per unit of n at nz = 1
NONZERO_EPS = 1e-6


@dataclass(frozen=True)
class Settings:
    """What a configuration states: sensor, slicing, optimizer."""

    res_x: int
    res_y: int
    max_events: int
    span_ns: int
    refresh_events: int
    refresh_time_ns: int
    scale: int
    max_iter: int
    min_events: int
    init_xy_divider: float
    init_rotdiv_divider: float
    xy_divider_cap: float
    rotdiv_divider_cap: float
    dx_tol: float
    dy_tol: float
    rot_tol: float
    div_tol: float
    min_window_fraction: int
    schedule: str
    exit_grad_factor: float
    iter_hard_cap: int
    warm_start: bool = True

    @staticmethod
    def from_config(cfg: dict) -> "Settings":
        """The settings of a configuration file.  Refuses what the
        reference does not model: f64 totals, the predicted exit, the
        extrapolated warm start."""
        s, sl, o = cfg["sensor"], cfg["slice"], cfg["optimizer"]
        if cfg.get("f64_totals") or o["exit_predict_cap"] or \
                o["warm_extrapolate"]:
            raise NotImplementedError(
                "the reference models float32 totals, no predicted exit "
                "and the plain warm start")
        return Settings(
            res_x=s["res_x"], res_y=s["res_y"],
            max_events=sl["max_events"], span_ns=sl["span_ns"],
            refresh_events=sl["refresh_events"],
            refresh_time_ns=sl["refresh_time_ns"],
            scale=o["scale"], max_iter=o["max_iter"],
            min_events=o["min_events"],
            init_xy_divider=o["init_xy_divider"],
            init_rotdiv_divider=o["init_rotdiv_divider"],
            xy_divider_cap=o["xy_divider_cap"],
            rotdiv_divider_cap=o["rotdiv_divider_cap"],
            dx_tol=o["dx_tol"], dy_tol=o["dy_tol"], rot_tol=o["rot_tol"],
            div_tol=o["div_tol"],
            min_window_fraction=o["min_window_fraction"],
            schedule=o["schedule"],
            exit_grad_factor=o["exit_grad_factor"],
            iter_hard_cap=o["iter_hard_cap"],
            warm_start=not cfg.get("stm_disable", False))


# ------------------------------------------------------------------ slicing

@dataclass
class Plan:
    starts: np.ndarray          # first event of each slice's window
    ends: np.ndarray            # its triggering (newest) event
    slice_start_ns: np.ndarray  # the window's time origin


def plan_slices(t_ns: np.ndarray, st: Settings, flush: bool) -> Plan:
    """Trigger points (dvs_flow.h:163-181): a slice fires on the event that
    makes ``refresh_events`` new events, or on the first event at least
    ``refresh_time_ns`` after the last trigger (the clock starts at 0).
    Its window is the newest events within ``max_events`` and ``span_ns``
    of the trigger (datastructures.h:31-59).  ``flush`` adds a last slice
    at the final event, as an offline run ends."""
    n = len(t_ns)
    ends = []
    last_t, start = 0, 0
    while start < n:
        by_count = start + st.refresh_events - 1
        by_time = start + int(np.searchsorted(
            t_ns[start:], last_t + st.refresh_time_ns, "left"))
        i = min(by_count, by_time)
        if i >= n:
            break
        ends.append(i)
        last_t = int(t_ns[i])
        start = i + 1
    if flush and n and (not ends or ends[-1] != n - 1):
        ends.append(n - 1)
    ends = np.asarray(ends, np.int64)
    newest = t_ns[ends]
    starts = np.maximum(
        np.searchsorted(t_ns, newest - st.span_ns, "left"),
        np.maximum(ends - st.max_events + 1, 0))
    full = ends - starts + 1 == st.max_events
    origin = np.where(full, t_ns[starts], np.maximum(newest - st.span_ns, 0))
    return Plan(starts=starts, ends=ends, slice_start_ns=origin)


@dataclass(frozen=True)
class Geometry:
    x_shift: float
    y_shift: float
    w_dyn: int
    h_dyn: int
    small: bool


def geometry(x_min, x_max, y_min, y_max, st: Settings) -> Geometry:
    """The scaled window of a slice's integer bbox and its window gate
    (optimizer_rolling.h:49-54, 274-283)."""
    s = st.scale
    wx, wy = s * (x_max - x_min), s * (y_max - y_min)
    x_shift = -((x_max - x_min) // 2 + x_min) * s + wx / 2 + s // 2
    y_shift = -((y_max - y_min) // 2 + y_min) * s + wy / 2 + s // 2
    frac = st.min_window_fraction
    small = ((wx + s) < (s * st.res_x) // frac
             and (wy + s) < (s * st.res_y) // frac)
    return Geometry(float(x_shift), float(y_shift), wx, wy, bool(small))


def slice_bboxes(x32: np.ndarray, y32: np.ndarray, plan: Plan) -> np.ndarray:
    """(S, 4) integer bbox (x_min, x_max, y_min, y_max) of every window,
    the coordinates truncated to pixels."""
    out = np.zeros((len(plan.ends), 4), np.int64)
    for s, (a, b) in enumerate(zip(plan.starts, plan.ends + 1)):
        xw, yw = x32[a:b], y32[a:b]
        out[s] = (int(xw.min()), int(xw.max()), int(yw.min()), int(yw.max()))
    return out


def first_gated(plan: Plan, small: np.ndarray, n: int) -> np.ndarray:
    """For every event, the first slice whose window holds it and whose
    window gate fired (len(plan.ends) where none did).  An event is noise
    in a later slice once such a slice held it (dvs_flow.h:196-222)."""
    S = len(plan.ends)
    out = np.full(n, S, np.int64)
    for s in np.flatnonzero(small):
        a, b = int(plan.starts[s]), int(plan.ends[s]) + 1
        seg = out[a:b]
        np.minimum(seg, s, out=seg)
    return out


# ---------------------------------------------------------------- the model

class Model:
    """The 4-parameter model: totals and their Kahan compensations in the
    order (rot, div, dx, dy), the centroid (event coordinates), and the
    last gradient terms (rot, div, dx, dy)."""

    def __init__(self, tot, comp, cx, cy, grad):
        self.tot, self.comp, self.cx, self.cy, self.grad = \
            tot, comp, cx, cy, grad

    @staticmethod
    def zero(device, dtype) -> "Model":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return Model(z(4), z(4), z(), z(), z(4))

    @staticmethod
    def from_numbers(tot, comp, cx, cy, device, dtype) -> "Model":
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return Model(t(tot), t(comp), t(cx), t(cy),
                     torch.zeros(4, dtype=dtype, device=device))

    def add(self, delta) -> "Model":
        """Kahan-compensated ``tot += delta`` (object_model.h:48-53)."""
        y = delta - self.comp
        t = self.tot + y
        return Model(t, (t - self.tot) - y, self.cx, self.cy, self.grad)


def warp(fx, fy, t, bx, by, m: Model):
    """Event::project_4param_reinit (event.h:99-110): rotate and scale the
    current position (bx, by) about the centroid by the totals, add the
    translation, and re-project from the pixel.  Returns (px, py, nx, ny)."""
    rot, div, tdx, tdy = m.tot.unbind()
    ang = -rot.double()
    c, s = torch.cos(ang).to(fx.dtype), torch.sin(ang).to(fx.dtype)
    rx, ry = bx - m.cx, by - m.cy
    qx, qy = c * rx - s * ry, s * rx + c * ry
    nx = -qx * div + (qx - rx) - tdx
    ny = -qy * div + (qy - ry) - tdy
    k = t / WARP_TIME_DIV / NZ
    return fx - nx * k, fy - ny * k, nx, ny


class Images:
    """The per-iteration image work on one slice (accel_lib.h:147-178,
    513-615; object_model.cpp:4-39, 103-126): the footprint splat of the
    time and count images, their scale x scale box sums, the time image,
    its centroid, the Scharr gradients where all nine pixels are set, and
    the four model terms.  Box sums, masks and stencils are separable; the
    sums over the image are row and column sums of three maps."""

    def __init__(self, t, act, geo: Geometry, st: Settings, dtype):
        s = st.scale
        self.H, self.W = st.res_x * s + s, st.res_y * s + s
        self.s, self.geo, self.dtype = s, geo, dtype
        dev = t.device
        self.acc = torch.float64 if dtype == torch.float32 else dtype
        tsec = (t.double() / 1e9).to(dtype).to(self.acc)
        self.src = torch.stack([tsec, torch.ones_like(tsec)], dim=1)
        self.act = act
        self.rows = torch.arange(self.H, device=dev, dtype=self.acc)
        self.cols = torch.arange(self.W, device=dev, dtype=self.acc)

    @staticmethod
    def _window3(a, dim, op):
        """``op`` of each entry and its two neighbours along ``dim`` (zero
        beyond the edge): op(a[i-1], a[i], a[i+1])."""
        n = a.shape[dim]
        p = torch.nn.functional.pad(a, (1, 1) if dim == -1 else (0, 0, 1, 1))
        sl = lambda k: p.narrow(dim, k, n)
        return op(sl(0), sl(1), sl(2))

    def box(self, a):
        """Sums over the scale x scale window centred on each pixel."""
        h = self.s // 2
        for dim in (-1, -2):
            n = a.shape[dim]
            pad = (h, h) if dim == -1 else (0, 0, h, h)
            p = torch.nn.functional.pad(a, pad)
            out = p.narrow(dim, 0, n)
            for k in range(1, self.s):
                out = out + p.narrow(dim, k, n)
            a = out
        return a

    def terms(self, px, py):
        """(cx_img, cy_img, grad (rot, div, dx, dy)) of the time image of
        the positions (px, py)."""
        s, g, H, W = self.s, self.geo, self.H, self.W
        half = s // 2
        ix = torch.trunc(px * s + g.x_shift).to(torch.int64)
        iy = torch.trunc(py * s + g.y_shift).to(torch.int64)
        ok = (self.act & (ix >= half) & (ix < g.w_dyn + half)
              & (iy >= half) & (iy < g.h_dyn + half))
        lin = torch.where(ok, ix * W + iy, torch.full_like(ix, H * W))
        acc = torch.zeros((H * W + 1, 2), dtype=self.acc, device=px.device)
        acc.index_add_(0, lin, self.src)
        tc = self.box(acc[:-1].t().reshape(2, H, W).to(self.dtype))
        tsum, cnt = tc[0], tc[1]
        img = torch.where(cnt >= 1, tsum / torch.clamp(cnt, min=1),
                          torch.zeros_like(tsum))
        mask = img > NONZERO_EPS
        both = lambda a, b, c: a & b & c
        nine = self._window3(self._window3(mask, -1, both), -2, both)
        sm3 = lambda a, b, c: 3 * a + 10 * b + 3 * c
        diff = lambda a, b, c: a - c
        gx = self._window3(self._window3(img, -1, sm3), -2, diff)
        gy = self._window3(self._window3(img, -2, sm3), -1, diff)
        zero = torch.zeros_like(img)
        gx, gy = torch.where(nine, gx, zero), torch.where(nine, gy, zero)
        maps = torch.stack([mask.to(self.dtype), gx, gy]).to(self.acc)
        rs, cs = maps.sum(2), maps.sum(1)             # (3, H), (3, W)
        tot = rs.sum(1)                               # n, sum gx, sum gy
        r_m, r_gx, r_gy = rs @ self.rows              # sums of row * map
        c_m, c_gx, c_gy = cs @ self.cols              # sums of col * map
        d = self.dtype
        n = torch.clamp(tot[0].to(d), min=1)
        cx, cy = r_m.to(d) / n, c_m.to(d) / n
        a, c = cx.to(self.acc), cy.to(self.acc)
        rot = (r_gy - a * tot[2]) - (c_gx - c * tot[1])
        div = (r_gx - a * tot[1]) + (c_gy - c * tot[2])
        grad = torch.stack([rot, div, tot[1], tot[2]]).to(d) / n
        return cx, cy, grad


@dataclass
class SliceOut:
    u: torch.Tensor
    v: torch.Tensor
    model: Model
    iters: int
    ran: bool
    small: bool
    seed: torch.Tensor        # (8,) slope memory and last deltas


def run_slice(x, y, t, act, bbox, model_in: Model, seed_in, st: Settings,
              dtype) -> SliceOut:
    """One slice (optimizer_rolling.h:48-111, 252-347) on flat events:
    x, y, t (slice-local ns) in ``dtype``, ``act`` the events that are not
    noise.  The window gate and the too-few gate skip the optimizer, and the
    slice keeps the warm-start warp and the incoming model."""
    geo = geometry(*bbox, st)
    dev = x.device
    model = model_in if st.warm_start else Model.zero(dev, dtype)
    n = int(x.shape[0])
    ran = (not geo.small) and n >= st.min_events
    px, py, nx, ny = warp(x, y, t, x, y, model)
    zeros8 = torch.zeros(8, dtype=dtype, device=dev)
    if not ran:
        uvk = UV_FACTOR / NZ
        return SliceOut(nx * uvk, ny * uvk, model, 0, False, geo.small,
                        zeros8)
    img = Images(t, act, geo, st, dtype)
    loop = fast_loop if st.schedule == "fast" else reference_loop
    model, px, py, nx, ny, iters, seed = loop(
        img, x, y, t, px, py, model, seed_in, st)
    uvk = UV_FACTOR / NZ
    return SliceOut(nx * uvk, ny * uvk, model, iters, True, geo.small, seed)


def _step(img: Images, x, y, t, px, py, model: Model, delta_fn):
    """One iteration: the time image of the current warp, the model terms,
    the step ``delta_fn(grad)`` into the totals, the centroid back in event
    coordinates, and the re-warp from the current positions."""
    cx_img, cy_img, grad = img.terms(px, py)
    m = Model(model.tot, model.comp, model.cx, model.cy, grad)
    m = m.add(delta_fn(grad))
    g = img.geo
    m.cx = (cx_img - g.x_shift) / img.s
    m.cy = (cy_img - g.y_shift) / img.s
    npx, npy, nx, ny = warp(x, y, t, px, py, m)
    return m, npx, npy, nx, ny


def reference_loop(img, x, y, t, px, py, model, seed_in, st: Settings):
    """The reference schedule (optimizer_rolling.h:60-111): step by the
    gradient over per-parameter dividers, each doubling when its gradient
    changes sign; run while a divider is below its cap and a divided
    gradient is above tolerance, within the iteration caps."""
    dt, dev = x.dtype, x.device
    divs = torch.tensor([st.init_rotdiv_divider, st.init_rotdiv_divider,
                         st.init_xy_divider, st.init_xy_divider],
                        dtype=dt, device=dev)
    caps = torch.tensor([st.rotdiv_divider_cap, st.rotdiv_divider_cap,
                         st.xy_divider_cap, st.xy_divider_cap],
                        dtype=dt, device=dev)
    tol = torch.tensor([st.rot_tol, st.div_tol, st.dx_tol, st.dy_tol],
                       dtype=dt, device=dev)
    model, px, py, nx, ny = _step(img, x, y, t, px, py, model,
                                  lambda g: g / divs)
    iters = 1
    while True:
        if (st.max_iter > 0 and iters > st.max_iter) \
                or iters >= st.iter_hard_cap:
            break
        g = model.grad
        if not bool(((divs < caps).any() & ~(torch.abs(g / divs) < tol).all()
                     ).item()):
            break
        old = g
        model, px, py, nx, ny = _step(img, x, y, t, px, py, model,
                                      lambda g: g / divs)
        iters += 1
        divs = torch.where(model.grad * old < 0, divs * 2, divs)
    return model, px, py, nx, ny, iters, torch.zeros(8, dtype=dt, device=dev)


def fast_loop(img, x, y, t, px, py, model, seed_in, st: Settings):
    """The secant schedule of the configurations' ``fast`` presets: a damped
    Newton step on the slope between the last two gradients (or the slope
    carried from the previous slice), clamped to 4x the reference step
    (1x with the carried slope), the reference step when no slope is
    usable; exit when every step is below tolerance, qualified by the
    divided gradient (``exit_grad_factor``), with the stricter test of 4x
    tolerance on the gradient before the third iteration.  The predicted
    exit (``exit_predict_cap``) is not modelled: ``Settings`` refuses it."""
    dt, dev = x.dtype, x.device
    divs = torch.tensor([st.init_rotdiv_divider, st.init_rotdiv_divider,
                         st.init_xy_divider, st.init_xy_divider],
                        dtype=dt, device=dev)
    tol = torch.tensor([st.rot_tol, st.div_tol, st.dx_tol, st.dy_tol],
                       dtype=dt, device=dev)
    zeros4 = torch.zeros(4, dtype=dt, device=dev)
    prev_g, prev_d = zeros4, zeros4
    slope_mem = zeros4 if seed_in is None else seed_in[:4].to(dt)
    iters = 0
    while True:
        def two_point(g):
            s2 = (g - prev_g) / prev_d
            ok = (prev_d != 0) & torch.isfinite(s2) & (s2 < 0)
            return torch.where(ok, s2, slope_mem), ok

        def delta(g):
            ref = g / divs
            slope, ok2 = two_point(g)
            newton = (-0.9 * g) / slope
            lim = torch.where(ok2, 4.0, 1.0) * torch.abs(ref)
            ok = (slope < 0) & torch.isfinite(newton)
            return torch.where(ok, torch.clamp(newton, -lim, lim), ref)

        before = model.tot
        model, px, py, nx, ny = _step(img, x, y, t, px, py, model, delta)
        iters += 1
        g = model.grad
        d = model.tot - before
        slope_mem, _ = two_point(g)
        divs = torch.where((prev_d != 0) & (g * prev_g < 0), divs * 2, divs)
        done = torch.abs(d) < tol
        if st.exit_grad_factor > 0:
            done = done & (torch.abs(g) / divs < st.exit_grad_factor * tol)
        prev_g, prev_d = g, d
        if (st.max_iter > 0 and iters > st.max_iter) \
                or iters >= st.iter_hard_cap:
            break
        small = done.all()
        if iters < 2:
            small = small & (torch.abs(g) / divs < 4 * tol).all()
        if bool(small.item()):
            break
    return model, px, py, nx, ny, iters, torch.cat([slope_mem, prev_d])


# ------------------------------------------------------------- recordings

@dataclass
class Prep:
    """A recording's or stream's slices, worked out from its events."""

    x32: np.ndarray
    y32: np.ndarray
    t_ns: np.ndarray
    plan: Plan
    bbox: np.ndarray          # (S, 4)
    small: np.ndarray         # (S,) the window gate fired
    gated: np.ndarray         # (n,) first gated slice holding each event
    device_copy: Optional[tuple] = None

    @property
    def n_slices(self) -> int:
        return len(self.plan.ends)

    def window(self, s: int):
        return int(self.plan.starts[s]), int(self.plan.ends[s]) + 1


def prepare(x, y, t_ns, st: Settings, flush: bool) -> Prep:
    """The trigger plan, windows, bboxes and window gates of the events
    (x, y as the f32 coordinates the sensor gives, t in ns)."""
    x32 = np.ascontiguousarray(x, np.float32)
    y32 = np.ascontiguousarray(y, np.float32)
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    plan = plan_slices(t_ns, st, flush)
    bbox = slice_bboxes(x32, y32, plan)
    small = np.array([geometry(*bb, st).small for bb in bbox], bool)
    return Prep(x32, y32, t_ns, plan, bbox, small,
                first_gated(plan, small, len(t_ns)))


@dataclass
class SliceResult:
    u: np.ndarray             # every event of the window, in time order
    v: np.ndarray
    noise: np.ndarray
    out: SliceOut


def _on(prep: Prep, device):
    """The events on ``device``, put there once per device."""
    key = str(device)
    if prep.device_copy is None or prep.device_copy[0] != key:
        to = lambda v: torch.from_numpy(v).to(device)
        prep.device_copy = (key, to(prep.x32), to(prep.y32), to(prep.t_ns))
    return prep.device_copy[1:]


def run_one(prep: Prep, s: int, model: Model, seed, st: Settings, device,
            dtype=torch.float32, host: bool = True) -> SliceResult:
    """Slice ``s`` from the incoming ``model`` and secant ``seed``; u and v
    come back as numpy arrays (``host``) or as tensors on ``device``."""
    a, b = prep.window(s)
    x, y, t = _on(prep, device)
    tl = (t[a:b] - int(prep.plan.slice_start_ns[s])).to(torch.float32)
    act = torch.from_numpy(prep.gated[a:b] >= s).to(device)
    out = run_slice(x[a:b].to(dtype), y[a:b].to(dtype), tl.to(dtype), act,
                    prep.bbox[s], model, seed, st, dtype)
    noise = (prep.gated[a:b] < s) | out.small
    u, v = out.u.float(), out.v.float()
    if host:
        u, v = u.cpu().numpy(), v.cpu().numpy()
    return SliceResult(u=u, v=v, noise=noise, out=out)


@dataclass
class Result:
    """Per event u, v (px/s) and noise, first slice wins; per slice the
    iterations."""

    u: np.ndarray
    v: np.ndarray
    noise: np.ndarray
    iters: np.ndarray


def compensate(prep: Prep, st: Settings, device,
               dtype=torch.float32) -> Result:
    """The whole recording: every slice in order from a zero model, the
    model and the secant slope handed from slice to slice, each event's
    outputs from the first slice that holds it (events that no slice holds
    stay zero)."""
    n = len(prep.t_ns)
    S = prep.n_slices
    u = torch.zeros(n, dtype=torch.float32, device=device)
    v = torch.zeros(n, dtype=torch.float32, device=device)
    noise = np.zeros(n, bool)
    iters = np.zeros(S, np.int32)
    model, seed = Model.zero(device, dtype), None
    for s in range(S):
        r = run_one(prep, s, model, seed, st, device, dtype, host=False)
        model, seed = r.out.model, r.out.seed
        iters[s] = r.out.iters
        a, b = prep.window(s)
        first = max(a, int(prep.plan.ends[s - 1]) + 1) if s > 0 else a
        k = first - a
        u[first:b], v[first:b], noise[first:b] = r.u[k:], r.v[k:], r.noise[k:]
    return Result(u=u.cpu().numpy(), v=v.cpu().numpy(), noise=noise,
                  iters=iters)
