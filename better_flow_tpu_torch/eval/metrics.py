"""Quantitative evaluation — the reference's dormant metric suite, revived.

The reference implemented a full flow-error evaluation but shipped it
commented out (EventFile::evaluate, event_file.cpp:122-279).  This module is
its working transcription plus the PSNR/sharpness gates used by BASELINE.md.
A numpy copy of ``better_flow_tpu/eval/metrics.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def read_dense_gt(path, res_x: int = 180, res_y: int = 240) -> np.ndarray:
    """Dense ground-truth flow file: rows ``y x fy fx`` stored as
    flow_gt[RES_X - x][y - 1] = (fy, -fx) (event_file.cpp:135-144).
    Returns [res_x+1, res_y, 2] with NaN where undefined."""
    gt = np.full((res_x + 1, res_y, 2), np.nan)
    data = np.loadtxt(path, ndmin=2)
    for row in data:
        yy, xx, fy, fx = row[:4]
        xi = res_x - int(xx)
        yi = int(yy) - 1
        if 0 <= xi <= res_x and 0 <= yi < res_y:
            gt[xi, yi, 0] = fy
            gt[xi, yi, 1] = -fx
    return gt


@dataclass
class FlowErrors:
    """Mean per-event errors (event_file.cpp:186-218)."""

    speed: float       # |gt_projected_speed - est_speed|
    angular: float     # acos of cos between projected gt and estimate
    vector: float      # |gt_projected - est|
    endpoint: float    # the reference's endpoint-error angle
    n: int


def evaluate_flow(
    best_pr_x, best_pr_y, best_u, best_v, gt: np.ndarray, noise=None,
    res_x: int = 180, res_y: int = 240,
) -> FlowErrors:
    """Transcription of the error block of EventFile::evaluate
    (event_file.cpp:154-218): the full GT vector at the event's best
    projected pixel is first *projected onto the estimated direction*, then
    speed/angular/vector/endpoint errors are averaged per event."""
    px = np.trunc(np.asarray(best_pr_x, np.float64)).astype(np.int64)
    py = np.trunc(np.asarray(best_pr_y, np.float64)).astype(np.int64)
    u = np.asarray(best_u, np.float64)
    v = np.asarray(best_v, np.float64)
    keep = np.ones(len(px), bool)
    if noise is not None:
        keep &= ~np.asarray(noise, bool)
    keep &= (px >= 0) & (px < res_x) & (py >= 0) & (py < res_y)
    px, py, u, v = px[keep], py[keep], u[keep], v[keep]

    gt_full = gt[px, py]                   # [n, 2] = (dx_gt_full, dy_gt_full)
    finite = np.isfinite(gt_full).all(axis=1)
    px, py, u, v, gt_full = px[finite], py[finite], u[finite], v[finite], gt_full[finite]

    est_vel = np.hypot(u, v)
    nx = np.where(est_vel != 0, u / np.maximum(est_vel, 1e-300), 0.0)
    ny = np.where(est_vel != 0, v / np.maximum(est_vel, 1e-300), 0.0)
    vel = nx * gt_full[:, 0] + ny * gt_full[:, 1]
    dx_gt = np.where(est_vel != 0, nx * vel, gt_full[:, 0])
    dy_gt = np.where(est_vel != 0, ny * vel, gt_full[:, 1])
    gt_vel = np.hypot(dx_gt, dy_gt)

    speed = np.abs(gt_vel - est_vel)

    both = (gt_vel >= 1e-5) & (est_vel >= 1e-5)
    cosang = np.where(
        both,
        (dx_gt * u + dy_gt * v) / np.maximum(gt_vel * est_vel, 1e-300),
        0.0,
    ).clip(-1.0, 1.0)
    angular = np.arccos(cosang)

    vector = np.hypot(dx_gt - u, dy_gt - v)

    end_cos = (
        (dx_gt * u + dy_gt * v + 1)
        / np.sqrt((dx_gt**2 + dy_gt**2 + 1) * (u**2 + v**2 + 1))
    ).clip(-1.0, 1.0)
    endpoint = np.arccos(end_cos)

    n = len(u)
    if n == 0:
        return FlowErrors(0.0, 0.0, 0.0, 0.0, 0)
    return FlowErrors(
        speed=float(speed.mean()),
        angular=float(angular.mean()),
        vector=float(vector.mean()),
        endpoint=float(endpoint.mean()),
        n=n,
    )


def aee(best_u, best_v, gt_u, gt_v, mask=None) -> float:
    """Plain average endpoint error vs per-event ground truth (the modern
    metric; the reference only has the dense-GT variant above)."""
    u = np.asarray(best_u, np.float64)
    v = np.asarray(best_v, np.float64)
    gu = np.asarray(gt_u, np.float64)
    gv = np.asarray(gt_v, np.float64)
    if mask is not None:
        u, v, gu, gv = u[mask], v[mask], gu[mask], gv[mask]
    return float(np.hypot(u - gu, v - gv).mean()) if len(u) else 0.0


def psnr(a: np.ndarray, b: np.ndarray, peak: float = None) -> float:
    """PSNR between two images (the BASELINE.md compensated-image gate)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    peak = peak if peak is not None else max(a.max(), b.max(), 1e-12)
    return 10.0 * math.log10(peak * peak / mse)


def sharpness(img) -> float:
    """Nonzero-mean sharpness scalar — the optimization objective and health
    metric (event_file.cpp:282-294)."""
    flat = np.asarray(img, np.float64).ravel()
    nz = flat[flat != 0]
    return float(nz.sum() / len(nz)) if len(nz) else 0.0
