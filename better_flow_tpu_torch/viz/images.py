"""Visual observability — the reference's image products, vectorized.

Transcribes EventFile's visualization suite (event_file.h:292-747,
event_file.cpp:4-119).  These run host-side on numpy (visualization is not
the hot path); the count splats reuse the footprint==box-filter
factorization.  OpenCV supplies Gaussian blur / HSV conversion / arrows with
the same semantics as the reference build.

Inputs are SoA arrays in the internal (x=row, y=col) convention; ``noise``
masks excluded events (event_file.h:472).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _require_cv2():
    if cv2 is None:  # pragma: no cover
        raise ImportError("OpenCV (cv2) is required for visualization")


def _splat_counts(ix, iy, H, W, scale, clamp=True, saturate=255):
    """Saturating uint8 footprint splat via center bincount + box filter.

    Centers are already shifted by scale/2 (the caller transcribes the exact
    shift of its reference function).  ``clamp`` reproduces the footprint
    clamping of projection_img (event_file.h:498-499).
    """
    half = scale // 2
    lin = ix * W + iy
    cnt = np.bincount(lin, minlength=H * W).astype(np.float64).reshape(H, W)
    if scale > 1:
        # box filter (footprint sum); clamped edges == zero padding here
        # because centres are in-bounds and the clamp only truncates the
        # footprint at the image border.
        k = np.ones(scale)
        cnt = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 0, cnt
        )
        cnt = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, cnt
        )
    return np.minimum(cnt, saturate).astype(np.uint8)


def nonzero_average_np(img) -> float:
    flat = np.asarray(img).ravel()
    nz = flat[flat != 0]
    return float(nz.sum()) / len(nz) if len(nz) else 0.0


def projection_img(
    x,
    y,
    noise=None,
    scale: int = 1,
    res_x: int = 180,
    res_y: int = 240,
    timestamps=None,
    min_t: float = 0.0,
    max_t: float = 0.0,
) -> np.ndarray:
    """EventFile::projection_img (event_file.h:460-515): saturating count
    image of (projected) positions, Gaussian blur, normalized so the nonzero
    mean becomes 127.  Pass warped positions for the compensated view or raw
    positions for the 'show_final' view (projection_img_unopt)."""
    _require_cv2()
    H, W = res_x * scale, res_y * scale
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    keep = np.ones(len(x), bool)
    if noise is not None:
        keep &= ~np.asarray(noise, bool)
    if timestamps is not None and max_t > min_t and max_t > 0:
        ts = np.asarray(timestamps, np.int64)
        keep &= (ts >= int(min_t * 1e9)) & (ts <= int(max_t * 1e9))
    ix = np.trunc(x[keep] * scale).astype(np.int64)
    iy = np.trunc(y[keep] * scale).astype(np.int64)
    ok = (ix < scale * (res_x - 1)) & (ix >= 0) & (iy < scale * (res_y - 1)) & (iy >= 0)
    ix = ix[ok] + scale // 2
    iy = iy[ok] + scale // 2
    img = _splat_counts(ix, iy, H, W, scale)
    if scale > 1:
        img = cv2.GaussianBlur(img, (scale, scale), 0, 0)
    img_scale = 127.0 / max(nonzero_average_np(img), 1e-12)
    return cv2.convertScaleAbs(img, alpha=img_scale, beta=0)


def projection_img_unopt(x, y, noise=None, scale: int = 1,
                         res_x: int = 180, res_y: int = 240) -> np.ndarray:
    """EventFile::projection_img_unopt (event_file.h:518-557): raw
    (uncompensated) positions."""
    return projection_img(x, y, noise=noise, scale=scale, res_x=res_x, res_y=res_y)


def color_time_img(
    pr_x, pr_y, t_ns, noise=None, scale: int = 11,
    res_x: int = 180, res_y: int = 240,
) -> np.ndarray:
    """EventFile::color_time_img (event_file.h:649-747): HSV image whose hue
    is the circular mean of each event's slice-time phase angle.

    The reference forces the window to the full sensor (:668-670), making
    the centering shifts cancel to zero; angle = 2*3.14 * (t - t_min) /
    (t_max - t_min) (:706)."""
    _require_cv2()
    H = scale * res_x + scale
    W = scale * res_y + scale
    wx, wy = scale * res_x, scale * res_y
    pr_x = np.asarray(pr_x, np.float64)
    pr_y = np.asarray(pr_y, np.float64)
    t = np.asarray(t_ns, np.float64)
    keep = np.ones(len(pr_x), bool)
    if noise is not None:
        keep &= ~np.asarray(noise, bool)
    t_min, t_max = (t.min(), t.max()) if len(t) else (0.0, 1.0)
    denom = max(t_max - t_min, 1.0)

    ix = np.trunc(pr_x[keep] * scale).astype(np.int64)
    iy = np.trunc(pr_y[keep] * scale).astype(np.int64)
    ang = 2 * 3.14 * (t[keep] - t_min) / denom
    ok = (ix < wx) & (ix >= 0) & (iy < wy) & (iy >= 0)
    ix = ix[ok] + scale // 2
    iy = iy[ok] + scale // 2
    ang = ang[ok]

    lin = ix * W + iy
    half = scale // 2
    coss = np.bincount(lin, weights=np.cos(ang), minlength=H * W).reshape(H, W)
    sins = np.bincount(lin, weights=np.sin(ang), minlength=H * W).reshape(H, W)
    cnts = np.bincount(lin, minlength=H * W).astype(np.float64).reshape(H, W)
    if scale > 1:
        k = np.ones(scale)
        for arr in (coss, sins, cnts):
            arr[:] = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, arr)
            arr[:] = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, arr)

    out = np.zeros((H, W, 3), np.uint8)
    nz = cnts >= 1
    vx = np.where(nz, coss / np.maximum(cnts, 1), 0.0)
    vy = np.where(nz, sins / np.maximum(cnts, 1), 0.0)
    speed = np.hypot(vx, vy)
    angle = np.where(speed != 0, (np.arctan2(vy, vx) + 3.1416) * 180 / 3.1416, 0.0)
    out[..., 0] = np.where(nz, (angle / 2).astype(np.uint8), 0)
    out[..., 1] = np.where(nz, (speed * 255).astype(np.uint8), 0)
    out[..., 2] = np.where(nz, 255, 0)
    return cv2.cvtColor(out, cv2.COLOR_HSV2BGR)


def color_flow_img(
    best_pr_x, best_pr_y, best_u, best_v, noise=None,
    res_x: int = 180, res_y: int = 240,
) -> np.ndarray:
    """EventFile::color_flow_img (event_file.h:318-350): hue = flow
    direction, saturation = log speed, on white (value 255)."""
    _require_cv2()
    hsv = np.zeros((res_x, res_y, 3), np.uint8)
    hsv[..., 2] = 255
    px = np.trunc(np.asarray(best_pr_x, np.float64)).astype(np.int64)
    py = np.trunc(np.asarray(best_pr_y, np.float64)).astype(np.int64)
    u = np.asarray(best_u, np.float64)
    v = np.asarray(best_v, np.float64)
    keep = np.ones(len(px), bool)
    if noise is not None:
        keep &= ~np.asarray(noise, bool)
    keep &= (px >= 0) & (px < res_x) & (py >= 0) & (py < res_y)
    px, py, u, v = px[keep], py[keep], u[keep], v[keep]
    speed = np.hypot(u, v)
    angle = np.where(speed != 0, (np.arctan2(v, u) + 3.1416) * 180 / 3.1416, 0.0)
    with np.errstate(divide="ignore"):
        log_spd = np.minimum(255.0, np.log(np.maximum(speed, 1e-300)) / math.log(1.025))
    log_spd = np.where(speed > 0, np.maximum(log_spd, 0.0), 0.0)
    hsv[px, py, 0] = (angle / 2).astype(np.uint8)
    hsv[px, py, 1] = log_spd.astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def arrow_flow_img(
    best_pr_x, best_pr_y, best_u, best_v, noise=None,
    res_x: int = 180, res_y: int = 240, scale_arrow: int = 10,
) -> np.ndarray:
    """EventFile::arrow_flow_img (event_file.h:292-315)."""
    _require_cv2()
    img = np.full((res_x * scale_arrow, res_y * scale_arrow, 3), 255, np.uint8)
    px = np.trunc(np.asarray(best_pr_x, np.float64)).astype(np.int64)
    py = np.trunc(np.asarray(best_pr_y, np.float64)).astype(np.int64)
    u = np.asarray(best_u, np.float64)
    v = np.asarray(best_v, np.float64)
    keep = np.ones(len(px), bool)
    if noise is not None:
        keep &= ~np.asarray(noise, bool)
    keep &= (px >= 0) & (px < res_x) & (py >= 0) & (py < res_y)
    for xi, yi, ui, vi in zip(px[keep], py[keep], u[keep], v[keep]):
        cv2.arrowedLine(
            img,
            (int(yi * scale_arrow), int(xi * scale_arrow)),
            (int((yi + vi / 20) * scale_arrow), int((xi + ui / 20) * scale_arrow)),
            (255, 0, 0),
        )
    return img


def color_gradient_img(gx, gy) -> np.ndarray:
    """EventFile::color_gradient_img (event_file.cpp:4-56): hue = gradient
    direction, value = magnitude normalized so the mean nonzero speed maps
    to 127."""
    _require_cv2()
    gx = np.asarray(gx, np.float64)
    gy = np.asarray(gy, np.float64)
    speed = np.hypot(gx, gy)
    nz = speed != 0
    avg = speed[nz].mean() if nz.any() else 1.0
    norm = 127.0 * speed / max(avg, 1e-300)
    angle = np.where(nz, (np.arctan2(gy, gx) + 3.1416) * 180 / 3.1416, 0.0)
    hsv = np.zeros(gx.shape + (3,), np.uint8)
    hsv[..., 0] = (angle / 2).astype(np.uint8)
    hsv[..., 1] = np.where(nz, 255, 0)
    hsv[..., 2] = np.minimum(norm, 255).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def generate_color_circle() -> np.ndarray:
    """EventFile::generate_color_circle (event_file.cpp:90-119): the legend."""
    _require_cv2()
    hsv = np.zeros((4000, 4000, 3), np.uint8)
    hsv[..., 2] = 255
    uu, vv = np.meshgrid(
        np.arange(-200, 200.05, 0.1), np.arange(-200, 200.05, 0.1), indexing="ij"
    )
    speed = np.hypot(uu, vv)
    angle = np.where(speed != 0, (np.arctan2(vv, uu) + 3.1416) * 180 / 3.1416, 0.0)
    ix = ((uu + 200) * 10).astype(np.int64).clip(0, 3999)
    iy = ((vv + 200) * 10).astype(np.int64).clip(0, 3999)
    hsv[ix, iy, 0] = (angle / 2).astype(np.uint8)
    hsv[ix, iy, 1] = np.minimum(speed, 255).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def time_img_u8(time_img: np.ndarray) -> np.ndarray:
    """Min-max normalize a float time image to uint8 for writing (the 's'
    key dump of OptimizerRolling::manual, optimizer_rolling.h:173-180)."""
    _require_cv2()
    img = np.asarray(time_img, np.float32)
    return cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)


def color_clusters_img(
    pr_x, pr_y, cluster_id, noise=None, scale: int = 11,
    res_x: int = 180, res_y: int = 240, cluster_cnt: int = 6,
) -> np.ndarray:
    """EventFile::color_clusters_img (event_file.h:560-646): hue encodes the
    cluster id (modulo ``cluster_cnt``) as a phase angle, circular-averaged
    per pixel like the color-time image.  Events without a cluster
    (id < 0, the reference's NULL cl pointer, :594) are skipped."""
    _require_cv2()
    pr_x = np.asarray(pr_x, np.float64)
    pr_y = np.asarray(pr_y, np.float64)
    cid = np.asarray(cluster_id)
    keep = cid >= 0
    if noise is not None:
        keep &= ~np.asarray(noise, bool)

    # bbox window with the reference's shift (no scale/2 term, :589-590)
    if not keep.any():
        return np.zeros((0, 0, 3), np.uint8)
    xs = pr_x[keep]
    ys = pr_y[keep]
    x_min, x_max = int(xs.min()), min(int(xs.max()), res_x)
    y_min, y_max = int(ys.min()), min(int(ys.max()), res_y)
    wx = scale * (x_max - x_min)
    wy = scale * (y_max - y_min)
    H, W = wx + scale, wy + scale
    x_sh = -float((x_max - x_min) // 2 + x_min) * scale + wx / 2.0
    y_sh = -float((y_max - y_min) // 2 + y_min) * scale + wy / 2.0

    ix = np.trunc(xs * scale + x_sh).astype(np.int64)
    iy = np.trunc(ys * scale + y_sh).astype(np.int64)
    ok = (ix >= 0) & (ix < wx) & (iy >= 0) & (iy < wy)
    ix, iy = ix[ok] + scale // 2, iy[ok] + scale // 2
    ang = 2 * 3.14 * (cid[keep][ok] % cluster_cnt) / cluster_cnt

    lin = ix * W + iy
    coss = np.bincount(lin, weights=np.cos(ang), minlength=H * W).reshape(H, W)
    sins = np.bincount(lin, weights=np.sin(ang), minlength=H * W).reshape(H, W)
    cnts = np.bincount(lin, minlength=H * W).astype(np.float64).reshape(H, W)
    if scale > 1:
        k = np.ones(scale)
        for arr in (coss, sins, cnts):
            arr[:] = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, arr)
            arr[:] = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, arr)

    out = np.zeros((H, W, 3), np.uint8)
    nz = cnts > 0
    vx = np.where(nz, coss / np.maximum(cnts, 1), 0.0)
    vy = np.where(nz, sins / np.maximum(cnts, 1), 0.0)
    speed = np.hypot(vx, vy)
    angle = np.where(speed != 0, (np.arctan2(vy, vx) + 3.1416) * 180 / 3.1416, 0.0)
    out[..., 0] = (angle / 2).astype(np.uint8)
    out[..., 1] = np.minimum(speed * 255, 255).astype(np.uint8)
    out[..., 2] = np.where(nz, 255, 0)
    return cv2.cvtColor(out, cv2.COLOR_HSV2BGR)


def uvscore_images(
    best_pr_x, best_pr_y, best_u, best_v, max_score, noise=None,
    res_x: int = 180, res_y: int = 240, scale: float = 15,
) -> dict:
    """The image set of EventFile::display_uvscore (event_file.h:353-456),
    non-interactively: the hi-res best-projection image (splat, blur,
    127-normalize), the adaptively-thresholded low-res projection, the flow
    HSV image with linear-speed saturation (:430 — unlike color_flow_img's
    log speed), the arrow overlay, and the per-pixel score map."""
    _require_cv2()
    scale = int(scale)
    px = np.trunc(np.asarray(best_pr_x, np.float64)).astype(np.int64)
    py = np.trunc(np.asarray(best_pr_y, np.float64)).astype(np.int64)
    u = np.asarray(best_u, np.float64)
    v = np.asarray(best_v, np.float64)
    sc = np.asarray(max_score, np.float64)
    keep = np.ones(len(px), bool)
    if noise is not None:
        keep &= ~np.asarray(noise, bool)

    # low-res count with 255 saturation + adaptive threshold (:366-376, 404)
    inb = (px >= 0) & (px < res_x) & (py >= 0) & (py < res_y)
    low = np.zeros((res_x, res_y), np.int64)
    np.add.at(low, (px[inb], py[inb]), 1)
    low = np.minimum(low, 255).astype(np.uint8)
    ksz = scale if scale % 2 == 1 else scale + 1
    thresh = cv2.adaptiveThreshold(
        low, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, ksz, 0
    )

    # hi-res footprint splat (:378-402)
    hx = np.trunc(np.asarray(best_pr_x, np.float64) * scale).astype(np.int64)
    hy = np.trunc(np.asarray(best_pr_y, np.float64) * scale).astype(np.int64)
    ok = (hx >= 0) & (hx < scale * res_x) & (hy >= 0) & (hy < scale * res_y)
    H = (res_x + 1) * scale
    W = (res_y + 1) * scale
    hires = _splat_counts(hx[ok] + scale // 2, hy[ok] + scale // 2, H, W, scale)
    if scale > 1:
        hires = cv2.GaussianBlur(hires, (ksz, ksz), 0, 0)
    img_scale = 127.0 / max(nonzero_average_np(hires), 1e-12)
    hires = cv2.convertScaleAbs(hires, alpha=img_scale, beta=0)

    # flow hsv with LINEAR speed saturation + scores + arrows (:413-449)
    hsv = np.zeros((res_x, res_y, 3), np.uint8)
    hsv[..., 2] = 255
    scores = np.zeros((res_x, res_y), np.float32)
    sel = keep & inb
    speed = np.hypot(u[sel], v[sel])
    angle = np.where(speed != 0, (np.arctan2(v[sel], u[sel]) + 3.1416) * 180 / 3.1416, 0.0)
    hsv[px[sel], py[sel], 0] = (angle / 2).astype(np.uint8)
    hsv[px[sel], py[sel], 1] = np.minimum(speed, 255).astype(np.uint8)
    scores[px[sel], py[sel]] = sc[sel]
    flow_bgr = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    scores_u8 = cv2.convertScaleAbs(scores, alpha=10.0, beta=0)
    arrows = arrow_flow_img(best_pr_x, best_pr_y, best_u, best_v, noise,
                            res_x=res_x, res_y=res_y)
    return {
        "best_projection_hires": hires,
        "best_projection_thresholded": thresh,
        "flow": flow_bgr,
        "arrows": arrows,
        "scores": scores_u8,
    }


def display_uvscore(
    best_pr_x, best_pr_y, best_u, best_v, max_score, noise=None,
    res_x: int = 180, res_y: int = 240, scale: float = 15,
    wait_ms: int = 33,
) -> None:
    """Interactive EventFile::display_uvscore (event_file.h:353-456): shows
    the hi-res best-projection, flow, and arrow windows in a waitKey loop
    until ESC — the reference's display has no trackbars, just the three
    windows (:455-459).  Requires a display; raises cv2.error headless
    (use uvscore_images for the raw image set)."""
    _require_cv2()
    imgs = uvscore_images(best_pr_x, best_pr_y, best_u, best_v, max_score,
                          noise, res_x=res_x, res_y=res_y, scale=scale)
    names = {
        "Best Projected Hi Res": imgs["best_projection_hires"],
        "Flow": imgs["flow"],
        "Flow Arrow": imgs["arrows"],
    }
    for n in names:
        cv2.namedWindow(n, cv2.WINDOW_NORMAL)
    while cv2.waitKey(wait_ms) != 27:
        for n, im in names.items():
            cv2.imshow(n, im)
    cv2.destroyAllWindows()
