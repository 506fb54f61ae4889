"""Score-based flow search: each event's best (nx, ny) over a sweep of
candidates, in plain PyTorch.

Counterpart of ``better_flow_tpu/models/score_search.py``
(OptimizerGlobal, optimizer_global.h/.cpp): for a candidate, warp every
event, splat a saturating count image, give each event the nonzero mean of
the count image over the ``wsize`` window around its pixel, and keep each
event's best-scoring candidate (project_all, get_event_score,
Event::apply_score, optimizer_global.cpp:4-101); ``compute_flow_bruteforce``
sweeps the reference's grid of candidates (:104-148).

The JAX package scans the candidates one by one.  Here a chunk of C
candidates is scored at once as (C, Hb, W) images; inside a chunk the
first candidate with the highest score wins, and that replaces the running
best only where it is strictly greater, which together is the scan's
first-best-wins whatever C is.

Every image holds integers (counts <= 255, window sums <= wsize^2 * 255),
so the box sums are exact (``ops.time_image.box_sum_int``) and equal to
the JAX package's f32 sums.  As XLA compiles the scan on the CPU (read
from its HLO and measured bit for bit), the warp is
``ops.warp.apply_project_per_n`` (a candidate's n times one folded
constant) and the scaled pixel ``prx * scale - x_min * scale`` one fused
multiply-add.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from better_flow_tpu_torch.ops.time_image import box_sum_int
from better_flow_tpu_torch.ops.warp import apply_project_per_n, compute_uv, fma
from better_flow_tpu_torch.runtime.scan_pipeline import default_device

# Candidates scored at once: (CHUNK, Hb, W) int32 images, ~4.6 MB a
# candidate at the reference's geometry (180x240, scale 5, wsize 25).
CHUNK = 32


class BestFlow(NamedTuple):
    """Per-event best so far (Event::apply_score, event.h:113-121)."""

    max_score: torch.Tensor
    best_nx: torch.Tensor
    best_ny: torch.Tensor
    best_pr_x: torch.Tensor
    best_pr_y: torch.Tensor


def window_scores(count_img: torch.Tensor, wsize: int) -> torch.Tensor:
    """Per-pixel nonzero mean of (..., H, W) count images over a wsize
    window (OptimizerGlobal::get_event_score, optimizer_global.cpp:86-101),
    f32."""
    s = box_sum_int(count_img, wsize).to(torch.float32)
    n = box_sum_int((count_img > 0).to(torch.int32), wsize).to(torch.float32)
    return torch.where(n == 0, torch.zeros_like(s), s / torch.clamp(n, min=1))


def score_candidate(x, y, t, valid, nx, ny, scale: int, wsize: int, x_min,
                    y_min, w_img: int, h_img: int):
    """Score the candidates ``(nx, ny)``, (C,) each, for every event:
    returns (score, pr_x, pr_y), (C, N) each, the score -1 where the event
    falls outside the scaled extent.  Geometry of project_all
    (optimizer_global.cpp:14-35): positions shifted by the bbox minimum,
    rejected outside, then offset by ``wsize // 2 + scale // 2`` into a
    bordered (Hb, W) image."""
    C = nx.shape[0]
    dev = x.device
    prx, pry = apply_project_per_n(x, y, t, nx[:, None], ny[:, None])
    f = lambda v: torch.full((), float(v), dtype=torch.float32, device=dev)
    xm = -(f(x_min) * scale)
    ym = -(f(y_min) * scale)
    ix = fma(prx, f(scale), xm).to(torch.int32)
    iy = fma(pry, f(scale), ym).to(torch.int32)
    ok = (valid & (ix >= 0) & (ix < w_img - scale) & (iy >= 0)
          & (iy < h_img - scale))
    half = scale // 2
    W = h_img + wsize
    Hb = w_img + wsize
    cix = (ix + half + wsize // 2).to(torch.int64)
    ciy = (iy + half + wsize // 2).to(torch.int64)
    lin = torch.where(ok, cix * W + ciy, torch.full_like(cix, Hb * W))
    flat = torch.zeros((C, Hb * W + 1), dtype=torch.int32, device=dev)
    flat.scatter_add_(1, lin, torch.ones_like(lin, dtype=torch.int32))
    cnt = box_sum_int(flat[:, :Hb * W].reshape(C, Hb, W), scale).clamp(max=255)
    scores = window_scores(cnt, wsize).reshape(C, Hb * W)
    at = (cix.clamp(0, Hb - 1) * W + ciy.clamp(0, W - 1))
    ev = torch.gather(scores, 1, at)
    return torch.where(ok, ev, torch.full_like(ev, -1.0)), prx, pry


def sweep_candidates(x, y, t, valid, cand_nx, cand_ny, scale: int, wsize: int,
                     x_min, y_min, w_img: int, h_img: int,
                     chunk: int = CHUNK) -> BestFlow:
    """Every event's best candidate of the (C,) sweep ``cand_nx``,
    ``cand_ny`` (tensors on the events' device), ``chunk`` candidates at a
    time; the first best wins and must beat a score of 0."""
    n = x.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
    best = BestFlow(zeros, zeros, zeros, x.to(torch.float32),
                    y.to(torch.float32))
    ev = torch.arange(n, device=x.device)
    for lo in range(0, cand_nx.shape[0], chunk):
        cnx, cny = cand_nx[lo:lo + chunk], cand_ny[lo:lo + chunk]
        sc, prx, pry = score_candidate(x, y, t, valid, cnx, cny, scale,
                                       wsize, x_min, y_min, w_img, h_img)
        top = sc.max(0).values
        rank = torch.arange(sc.shape[0], device=x.device)[:, None]
        first = torch.where(sc == top, rank, sc.shape[0]).min(0).values
        better = top > best.max_score
        best = BestFlow(
            max_score=torch.where(better, top, best.max_score),
            best_nx=torch.where(better, cnx[first], best.best_nx),
            best_ny=torch.where(better, cny[first], best.best_ny),
            best_pr_x=torch.where(better, prx[first, ev], best.best_pr_x),
            best_pr_y=torch.where(better, pry[first, ev], best.best_pr_y))
    return best


def compute_flow_bruteforce(x, y, t_ns, res_x: int = 180, res_y: int = 240,
                            x_range=(-0.09, 0.09), y_range=(-0.04, 0.04),
                            step: float = 0.001, scale: int = 5,
                            wsize: int = 25, device=None) -> dict:
    """The dense sweep over the reference's default ranges
    (optimizer_global.cpp:106-108): numpy ``u``, ``v`` (px/s), ``score``,
    ``best_pr_x`` and ``best_pr_y`` an event, ``CHUNK`` candidates at a
    time.  ``device``: the card unless ``"cpu"`` is passed."""
    dev = torch.device(device) if device is not None else default_device()
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    t = np.asarray(t_ns, np.float32)
    cand_nx, cand_ny = np.meshgrid(np.arange(x_range[0], x_range[1], step),
                                   np.arange(y_range[0], y_range[1], step),
                                   indexing="ij")
    x_min = float(np.floor(x.min())) if len(x) else 0.0
    y_min = float(np.floor(y.min())) if len(y) else 0.0
    w_img = int((x.max() - x_min + 1) * scale) + scale if len(x) else scale
    h_img = int((y.max() - y_min + 1) * scale) + scale if len(y) else scale
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    best = sweep_candidates(f(x), f(y), f(t),
                            torch.ones(len(x), dtype=torch.bool, device=dev),
                            f(cand_nx.ravel()), f(cand_ny.ravel()), scale,
                            wsize, x_min, y_min, w_img, h_img)
    u, v = compute_uv(best.best_nx, best.best_ny)
    return {"u": u.cpu().numpy(), "v": v.cpu().numpy(),
            "score": best.max_score.cpu().numpy(),
            "best_pr_x": best.best_pr_x.cpu().numpy(),
            "best_pr_y": best.best_pr_y.cpu().numpy()}
