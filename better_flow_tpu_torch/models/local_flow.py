"""Local 2-parameter flow: per-window sharpness ascent over a grid of
windows, chained coarse-to-fine into a dense per-pixel flow field
(BASELINE.json configuration 3), in plain PyTorch.

Counterpart of ``better_flow_tpu/models/local_flow.py`` (OptimizerLocal,
optimizer_sampler.h/.cpp; ``local_flow_window`` the descent of one window,
``local_flow_field`` of a batch of them): each window owns the first K events within
``wsz / 2`` of its centre; a round projects them with (nx, ny), splats a
saturating count image of (wsz * scale + scale)^2 pixels shifted so that
the warped centre stays centred, blurs it with OpenCV's Gaussian kernel,
scores its nonzero mean, and steps nx, then ny, halving and flipping a
step whose score did not improve (optimizer_sampler.cpp:90-153).

The JAX package ``vmap``s a ``lax.while_loop`` over the windows.  Here all
G windows advance together as (G, H, W) images, and a window whose
condition has gone false is frozen, which is what the batched
``while_loop`` does.  The host reads "any window still active" once every
``CHECK_EVERY`` rounds (one blocking read); the rounds in between change
no frozen window, so the result does not depend on it.

Arithmetic, as XLA compiles ``local_flow_field`` on the CPU (read from its
HLO and measured bit for bit): the warp of ``ops.warp.apply_project_per_n``
(a window's n times one folded constant); the centre's shift
``-ccx * scale + wsz * scale / 2`` and the scaled pixel ``fx = prx * scale +
x_sh`` each one fused multiply-add; ``hypot`` as ``ops.gradient.hypot``.
The count image holds integers, and the blur's kernel for ksize <= 7 is
dyadic, so the box sum, the blur (shifted
multiply-adds in f32 with zero padding, no library convolution whose
precision hangs on a global flag), ``floor(x + 0.5)`` and the score's sum
are exact in any order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from better_flow_tpu_torch.config import NZ, T_DIVIDER
from better_flow_tpu_torch.ops.gradient import hypot
from better_flow_tpu_torch.ops.time_image import box_sum_int
from better_flow_tpu_torch.ops.warp import apply_project_per_n, compute_uv, fma
from better_flow_tpu_torch.runtime.scan_pipeline import default_device

# Rounds between two reads of "any window active" (a blocking read each).
CHECK_EVERY = 8

_CV_SMALL_GAUSS = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]),
}


def gaussian_kernel_1d(ksize: int) -> np.ndarray:
    """OpenCV's getGaussianKernel(ksize, 0) (the blur of
    optimizer_sampler.cpp:148-150): hard-coded for ksize <= 7, else
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8."""
    if ksize in _CV_SMALL_GAUSS:
        return _CV_SMALL_GAUSS[ksize].astype(np.float32)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _correlate(img: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """``img`` zero-padded by ``len(k) // 2`` on both sides of ``dim`` and
    correlated with ``k`` along it (VALID), as f32 multiply-adds in kernel
    order."""
    n, pad = len(k), len(k) // 2
    x = img.movedim(dim, -1)
    p = torch.nn.functional.pad(x, (pad, pad))
    m = p.shape[-1] - n + 1
    out = None
    for j in range(n):
        v = p[..., j:j + m] * float(k[j])
        out = v if out is None else out + v
    return out.movedim(-1, dim)


def _gauss_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) images with zero padding,
    rows (dim -2) first, as the JAX package's two convolutions; ksize <= 1
    is the identity."""
    if ksize <= 1:
        return img
    k = gaussian_kernel_1d(ksize)
    return _correlate(_correlate(img, k, -2), k, -1)


class LocalWindow(NamedTuple):
    """G windows' fixed event subsets: (G, K) fields and (G,) centres."""

    x: torch.Tensor       # f32 original pixels
    y: torch.Tensor
    t: torch.Tensor       # f32 slice-local ns
    valid: torch.Tensor   # bool
    cx: torch.Tensor      # f32 window centres (original pixel coordinates)
    cy: torch.Tensor


class LocalState(NamedTuple):
    """One window's descent state (``LocalState`` of the JAX package): the
    direction (nx, ny), the steps (dnx, dny), the last score and the
    iterations taken, 0-d tensors."""

    nx: torch.Tensor
    ny: torch.Tensor
    dnx: torch.Tensor
    dny: torch.Tensor
    last_score: torch.Tensor
    iters: torch.Tensor


def gather_windows(x, y, t, valid, centers_x, centers_y, wsz: int, k: int,
                   device=None) -> LocalWindow:
    """Each window's event subset: the first ``k`` events (in event order)
    with ``|x - cx| <= wsz / 2`` and ``|y - cy| <= wsz / 2``, then the
    events outside in their order, invalid, up to ``k`` (fewer when there
    are fewer events), as the JAX package's stable ``argsort``.  Events and
    centres are taken as f32."""
    dev = torch.device(device) if device is not None else default_device()
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    x, y, t = f(x), f(y), f(t)
    valid = torch.tensor(np.asarray(valid, bool), device=dev)
    cx, cy = f(centers_x), f(centers_y)
    h = wsz / 2
    inside = (valid[None] & ((x[None] - cx[:, None]).abs() <= h)
              & ((y[None] - cy[:, None]).abs() <= h))
    order = torch.sort((~inside).to(torch.uint8), dim=1,
                       stable=True).indices[:, :k]
    return LocalWindow(x=x[order], y=y[order], t=t[order],
                       valid=torch.gather(inside, 1, order), cx=cx, cy=cy)


def _count_image(win: LocalWindow, nx: torch.Tensor, ny: torch.Tensor,
                 scale: int, wsz: int) -> torch.Tensor:
    """OptimizerLocal::iteration_step (optimizer_sampler.cpp:120-153) for
    every window at its own (nx, ny), (G,) each: the blurred, saturating
    count image, (G, H, W) f32 of integers."""
    G = nx.shape[0]
    prx, pry = apply_project_per_n(win.x, win.y, win.t, nx[:, None],
                                   ny[:, None])
    ccx, ccy = apply_project_per_n(win.cx, win.cy, torch.zeros_like(win.cx),
                                   nx, ny)
    wsx = wsy = wsz * scale
    H, W = wsx + scale, wsy + scale
    f = lambda v: torch.full((), float(v), dtype=torch.float32,
                             device=nx.device)
    x_sh = fma(-ccx, f(scale), f(wsx / 2.0))[:, None]
    y_sh = fma(-ccy, f(scale), f(wsy / 2.0))[:, None]
    ix = fma(prx, f(scale), x_sh).to(torch.int32)
    iy = fma(pry, f(scale), y_sh).to(torch.int32)
    ok = win.valid & (ix >= 0) & (ix < wsx) & (iy >= 0) & (iy < wsy)
    half = scale // 2
    lin = (ix + half).to(torch.int64) * W + (iy + half)
    lin = torch.where(ok, lin, torch.full_like(lin, H * W))
    flat = torch.zeros((G, H * W + 1), dtype=torch.int32, device=nx.device)
    flat.scatter_add_(1, lin, torch.ones_like(lin, dtype=torch.int32))
    cnt = box_sum_int(flat[:, :H * W].reshape(G, H, W), scale).clamp(max=255)
    blur = _gauss_blur(cnt.to(torch.float32), scale if scale > 1 else 0)
    return torch.floor(blur + 0.5)


def _score(img: torch.Tensor) -> torch.Tensor:
    """Nonzero mean of each (..., H, W) image (optimizer_sampler.cpp:
    192-204); the sums of these integer images are exact."""
    mask = img != 0
    n = mask.sum((-2, -1)).to(torch.float32)
    s = img.to(torch.float64).sum((-2, -1)).to(torch.float32)
    return torch.where(n == 0, torch.zeros_like(s), s / torch.clamp(n, min=1))


def _descend(win: LocalWindow, scale: int, wsz: int, nx, ny, dn0: float,
             max_time_ms: int = 100, max_iters: int = 100):
    """The 2-parameter descent of every window (OptimizerLocal::run,
    optimizer_sampler.cpp:4-38) from (nx, ny), (G,) each: returns (nx, ny,
    iters, rounds, reads), ``rounds`` the rounds run (the longest window's
    iterations rounded up to a check) and ``reads`` the host's blocking
    reads."""
    dn_th = float(np.float32((NZ * T_DIVIDER * 1000.0)
                             / (10.0 * scale * (1e6 * max_time_ms))))
    score_at = lambda a, b: _score(_count_image(win, a, b, scale, wsz))
    dnx = torch.full_like(nx, float(np.float32(dn0)))
    dny = dnx.clone()
    last = score_at(nx, ny)
    iters = torch.zeros(nx.shape, dtype=torch.int32, device=nx.device)
    active = (hypot(dnx, dny) > dn_th) & (iters < max_iters)
    rounds = reads = 0
    while rounds < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - rounds)):
            # compute_new_nx, then compute_new_ny (optimizer_sampler.cpp:
            # 90-117); a frozen window keeps its state.
            nx_new = nx + dnx
            sc = score_at(nx_new, ny)
            dnx_new = torch.where(sc - last <= 0, -dnx / 2.0, dnx)
            ny_new = ny + dny
            sc2 = score_at(nx_new, ny_new)
            dny_new = torch.where(sc2 - sc <= 0, -dny / 2.0, dny)
            nx = torch.where(active, nx_new, nx)
            ny = torch.where(active, ny_new, ny)
            dnx = torch.where(active, dnx_new, dnx)
            dny = torch.where(active, dny_new, dny)
            last = torch.where(active, sc2, last)
            iters = iters + active.to(torch.int32)
            active = active & (hypot(dnx, dny) > dn_th) & (iters < max_iters)
            rounds += 1
        reads += 1
        if not bool(active.any()):
            break
    return nx, ny, iters, rounds, reads


def local_flow_window(win: LocalWindow, scale: int, wsz: int,
                      max_time_ms: int = 100, max_iters: int = 100,
                      nx0=None, ny0=None, dn0: float = 0.01):
    """One window's 2-parameter descent (OptimizerLocal::run,
    optimizer_sampler.cpp:4-38; ``local_flow_window`` of the JAX package):
    ``win`` holds one window, (K,) fields and 0-d centres; ``nx0``/``ny0``
    seed the descent (default 0), ``dn0`` is the initial step.  It runs
    the descent ``local_flow_field`` runs for every window, on a batch of
    one, so its result is bitwise that window's there.  Unlike
    ``local_flow_field`` it applies no ``min_events`` gate, as in the JAX
    package.  Returns (nx, ny, iters), 0-d tensors on the window's
    device."""
    one = LocalWindow(*(f.reshape(1, -1) if f.dim() else f.reshape(1)
                        for f in win))
    dev = one.x.device
    seed = lambda a: torch.zeros(1, dtype=torch.float32, device=dev) \
        if a is None else torch.as_tensor(a, device=dev).to(
            torch.float32).reshape(1)
    nx, ny, iters, _, _ = _descend(one, scale, wsz, seed(nx0), seed(ny0),
                                   dn0, max_time_ms=max_time_ms,
                                   max_iters=max_iters)
    return nx[0], ny[0], iters[0]


def local_flow_field(windows: LocalWindow, scale: int, wsz: int,
                     min_events: int = 30, init_nx=None, init_ny=None,
                     dn0: float = 0.01, stats: Optional[dict] = None):
    """Every window's descent -> (u, v, n_events, iters, nx, ny), (G,)
    tensors on the windows' device.  Windows with fewer than
    ``min_events`` events keep zero flow (optimizer_sampler.cpp:9-13).
    ``init_nx``/``init_ny`` seed the descent (the coarse-to-fine hand-off);
    ``dn0`` is the initial step.  ``stats``, when given, gets this call's
    ``rounds`` (the loop's rounds) and ``reads`` (blocking reads) appended
    to lists of those names."""
    G = windows.x.shape[0]
    dev = windows.x.device
    seed = lambda a: (torch.zeros(G, dtype=torch.float32, device=dev)
                      if a is None else
                      torch.as_tensor(a, device=dev).to(torch.float32))
    nx, ny, iters, rounds, reads = _descend(windows, scale, wsz, seed(init_nx),
                                    seed(init_ny), dn0)
    n_ev = windows.valid.sum(1).to(torch.int32)
    ok = n_ev >= min_events
    zero = torch.zeros_like(nx)
    nx = torch.where(ok, nx, zero)
    ny = torch.where(ok, ny, zero)
    u, v = compute_uv(nx, ny)
    if stats is not None:
        stats.setdefault("rounds", []).append(rounds)
        stats.setdefault("reads", []).append(reads)
    return u, v, n_ev, torch.where(ok, iters, torch.zeros_like(iters)), nx, ny


def flow_field_grid(x, y, t_ns, res_x: int, res_y: int, step: int = 16,
                    wsz: int = 31, scales=(1, 3, 3), k: int = 1024,
                    dense: bool = False, dn0s=None, device=None,
                    stats: Optional[dict] = None) -> dict:
    """Dense local flow on a regular grid of window centres, chained
    coarse-to-fine over ``scales``: each scale's converged (nx, ny) seed
    the next, and each scale's initial step halves down the chain
    (``0.01 * 2^(m-1-i)``, the last the reference's 0.01) unless ``dn0s``
    gives them.  Returns numpy: ``grid_x``, ``grid_y``, the final scale's
    ``u``, ``v`` (px/s), ``n_events``, ``iters``, ``iters_total`` over the
    chain and ``scale``; with ``dense=True`` also ``u_dense`` and
    ``v_dense`` ([res_x, res_y], bilinear between the centres).  Events
    are a raw slice (x, y, slice-local t in ns), taken as f32 as the JAX
    package takes them (``np.asarray(t_ns, np.float32)``).  ``device``:
    the card unless ``"cpu"`` is passed; ``stats``: see
    ``local_flow_field`` (one entry a scale)."""
    centers_x, centers_y = np.meshgrid(
        np.arange(wsz // 2, res_x - wsz // 2, step),
        np.arange(wsz // 2, res_y - wsz // 2, step), indexing="ij")
    cx = centers_x.ravel().astype(np.float32)
    cy = centers_y.ravel().astype(np.float32)
    wins = gather_windows(np.asarray(x, np.float32),
                          np.asarray(y, np.float32),
                          np.asarray(t_ns, np.float32),
                          np.ones(len(x), bool), cx, cy, wsz, k,
                          device=device)
    if dn0s is None:
        dn0s = [0.01 * 2 ** (len(scales) - 1 - i) for i in range(len(scales))]
    seed_nx = seed_ny = None
    iters_total = np.zeros(centers_x.size, np.int64)
    out = {}
    for scale, dn0 in zip(scales, dn0s):
        u, v, n_ev, iters, nx, ny = local_flow_field(
            wins, scale, wsz, init_nx=seed_nx, init_ny=seed_ny, dn0=dn0,
            stats=stats)
        seed_nx, seed_ny = nx, ny
        iters = iters.cpu().numpy()
        iters_total += iters
        shape = centers_x.shape
        out = {
            "grid_x": centers_x, "grid_y": centers_y,
            "u": u.cpu().numpy().reshape(shape),
            "v": v.cpu().numpy().reshape(shape),
            "n_events": n_ev.cpu().numpy().reshape(shape),
            "iters": iters.reshape(shape),
            "iters_total": iters_total.reshape(shape),
            "scale": scale,
        }
    if dense and out:
        out["u_dense"] = interpolate_grid_to_dense(
            out["u"], centers_x, centers_y, res_x, res_y)
        out["v_dense"] = interpolate_grid_to_dense(
            out["v"], centers_x, centers_y, res_x, res_y)
    return out


def interpolate_grid_to_dense(field, centers_x, centers_y, res_x: int,
                              res_y: int) -> np.ndarray:
    """Bilinear interpolation of a [Gx, Gy] window-grid field to a
    [res_x, res_y] per-pixel map, constant beyond the outer centres
    (numpy, once a field)."""
    gx = centers_x[:, 0].astype(np.float64)
    gy = centers_y[0, :].astype(np.float64)
    px = np.arange(res_x, dtype=np.float64)
    py = np.arange(res_y, dtype=np.float64)
    ix = np.clip(np.interp(px, gx, np.arange(len(gx))), 0, len(gx) - 1)
    iy = np.clip(np.interp(py, gy, np.arange(len(gy))), 0, len(gy) - 1)
    x0 = (np.minimum(ix.astype(np.int64), len(gx) - 2) if len(gx) > 1
          else np.zeros(res_x, np.int64))
    y0 = (np.minimum(iy.astype(np.int64), len(gy) - 2) if len(gy) > 1
          else np.zeros(res_y, np.int64))
    fx = (ix - x0)[:, None]
    fy = (iy - y0)[None, :]
    f = np.asarray(field, np.float64)
    x1 = np.minimum(x0 + 1, len(gx) - 1)
    y1 = np.minimum(y0 + 1, len(gy) - 1)
    out = (f[np.ix_(x0, y0)] * (1 - fx) * (1 - fy)
           + f[np.ix_(x1, y0)] * fx * (1 - fy)
           + f[np.ix_(x0, y1)] * (1 - fx) * fy
           + f[np.ix_(x1, y1)] * fx * fy)
    return out.astype(np.float32)
