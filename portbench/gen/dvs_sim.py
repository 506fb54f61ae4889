# Frozen copy of better_flow_tpu_torch/io/dvs_sim.py, kept here so that
# later changes to the program do not change the traffic.
"""Sensor-realistic DVS event simulation (a numpy copy of
``better_flow_tpu/io/dvs_sim.py``: the same streams from the same seeds).

``synthetic_events`` (io/synthetic.py) produces clean constant-density
streams — ideal for unit tests, flattering for optimizers.  Real DVS
recordings (the reference's dataset family: shapes.txt, events_6dof_*,
bf_viewer.cpp:632-640) additionally carry the sensor's defects, and those
defects are what stress the pipeline's gates and noise handling.  This
module adds the standard DVS camera model on top of the same ground-truth
4-parameter scene motion:

* **Contrast-threshold event generation**: a moving edge fires events at a
  rate proportional to (local contrast / per-pixel threshold) x speed, not
  at a globally uniform rate — event density concentrates on fast, sharp
  edges and collapses in texture-poor regions.
* **Threshold mismatch (FPN)**: each pixel's contrast threshold is drawn
  lognormally (sigma typically 20-35% on DVS128/DAVIS), so identical edges
  yield pixel-dependent event counts.
* **Latency jitter**: per-event timestamp noise (tens to hundreds of us),
  the dominant timing noise of the sensor front end.
* **Refractory period**: a pixel cannot re-fire within tau_ref (~1 ms on
  DVS128); implemented as first-event-per-(pixel, tau bin), which floors
  the per-pixel rate at 1/tau like the hardware does.
* **Background activity (BA) noise**: Poisson junk events at ~0.1-5 Hz per
  pixel, uniform over the array, random polarity — the noise the
  reference's window/min-event gates exist for.
* **Hot pixels**: a small set of pixels firing orders of magnitude above
  the BA rate (every real array has them).
* **Burstiness**: optional sinusoidal rate modulation, so slice occupancy
  varies the way hand-held recordings do (count/time triggers then fire
  unevenly, dvs_flow.h:163-181).

The simulator stands in for the public recordings by reproducing their
statistics; `io/event_file.read_events` reads the reference's ``t x y p``
text format directly, so any real recording drops in unchanged.
"""

from __future__ import annotations

import numpy as np


def dvs_events(
    n_events: int,
    duration_s: float = 0.4,
    res_x: int = 180,
    res_y: int = 240,
    vx: float = 60.0,
    vy: float = -40.0,
    rot: float = 0.0,
    div: float = 0.0,
    n_points: int = 400,
    seed: int = 0,
    margin: float = 0.15,
    threshold_sigma: float = 0.25,
    latency_jitter_s: float = 150e-6,
    refractory_s: float = 1e-3,
    ba_rate_hz: float = 1.0,
    hot_pixel_frac: float = 2e-4,
    hot_rate_hz: float = 300.0,
    burst_depth: float = 0.5,
    burst_hz: float = 6.0,
) -> dict:
    """Generate a sensor-realistic stream with ~``n_events`` events.

    Returns x, y (integer pixel floats), t_ns (int64, sorted), ground-truth
    u, v (px/s; zero for noise events), polarity (int8), and ``is_noise``
    (True for BA/hot-pixel events, which carry no ground truth).
    """
    rng = np.random.default_rng(seed)
    cx, cy = res_x / 2.0, res_y / 2.0

    # ---- signal events: contrast-threshold firing along point tracks -----
    # Per-point contrast (edge strength) and per-pixel threshold mismatch.
    p0x = rng.uniform(margin * res_x, (1 - margin) * res_x, n_points)
    p0y = rng.uniform(margin * res_y, (1 - margin) * res_y, n_points)
    contrast = rng.lognormal(0.0, 0.5, n_points)          # edge sharpness
    thresh_map = rng.lognormal(0.0, threshold_sigma, (res_x, res_y))

    # Oversample candidate emissions, then thin by the physical acceptance
    # probability (contrast / threshold, capped at 1) — equivalent to
    # per-pixel Poisson rates without a per-pixel time loop.
    n_cand = int(n_events * 4.2) + 1024   # ~24% survive thinning + refractory
    idx = rng.integers(0, n_points, n_cand)
    t = rng.uniform(0.0, duration_s, n_cand)
    if burst_depth > 0:
        # thinning for a sinusoidally modulated rate (burstiness)
        keep_burst = rng.uniform(0, 1, n_cand) < (
            (1 + burst_depth * np.sin(2 * np.pi * burst_hz * t))
            / (1 + burst_depth)
        )
        idx, t = idx[keep_burst], t[keep_burst]
    # Sorting t while keeping idx as drawn preserves the joint distribution
    # (both are iid); the merge at the end re-sorts globally anyway.
    t = np.sort(t)

    rx = p0x[idx] - cx
    ry = p0y[idx] - cy
    ang = rot * t
    growth = np.exp(div * t)
    cos_a, sin_a = np.cos(ang), np.sin(ang)
    rtx = (cos_a * rx - sin_a * ry) * growth
    rty = (sin_a * rx + cos_a * ry) * growth
    x = cx + rtx + vx * t
    y = cy + rty + vy * t
    u = vx + (-rot * rty + div * rtx)
    v = vy + (rot * rtx + div * rty)

    inb = (x >= 0) & (x < res_x - 1) & (y >= 0) & (y < res_y - 1)
    x, y, t, u, v, idx = x[inb], y[inb], t[inb], u[inb], v[inb], idx[inb]
    xi = np.floor(x).astype(np.int64)
    yi = np.floor(y).astype(np.int64)

    # Event acceptance: edge contrast over the pixel's own threshold, scaled
    # by speed (faster edges cross more level sets per unit time).
    speed = np.hypot(u, v)
    speed_n = speed / max(np.median(speed), 1e-6)
    p_fire = np.clip(contrast[idx] / thresh_map[xi, yi], 0, 2.5) * np.clip(
        speed_n, 0.2, 2.0
    )
    p_fire = p_fire / max(np.percentile(p_fire, 90), 1e-6)
    keep = rng.uniform(0, 1, len(t)) < np.clip(p_fire, 0.02, 1.0)
    x, y, t, u, v, xi, yi = (
        a[keep] for a in (x, y, t, u, v, xi, yi)
    )

    # Latency jitter on timestamps (resort afterwards).
    t = np.clip(t + rng.normal(0, latency_jitter_s, len(t)), 0, duration_s)

    # Polarity from the sign of motion along the local "gradient" — for
    # point textures use the track direction, randomized 10% (sensor flips).
    pol = (u > 0).astype(np.int8)
    flip = rng.uniform(0, 1, len(t)) < 0.1
    pol[flip] = 1 - pol[flip]

    sig = {
        "x": xi.astype(np.float64), "y": yi.astype(np.float64),
        "t": t, "u": u, "v": v, "polarity": pol,
        "is_noise": np.zeros(len(t), bool),
    }

    # ---- background-activity noise ---------------------------------------
    n_px = res_x * res_y
    n_ba = rng.poisson(ba_rate_hz * n_px * duration_s)
    bx = rng.integers(0, res_x, n_ba)
    by = rng.integers(0, res_y, n_ba)
    bt = rng.uniform(0, duration_s, n_ba)

    # ---- hot pixels -------------------------------------------------------
    n_hot_px = max(int(hot_pixel_frac * n_px), 1)
    hot_ids = rng.choice(n_px, n_hot_px, replace=False)
    n_hot = rng.poisson(hot_rate_hz * duration_s, n_hot_px)
    hx = np.repeat(hot_ids // res_y, n_hot)
    hy = np.repeat(hot_ids % res_y, n_hot)
    ht = rng.uniform(0, duration_s, int(n_hot.sum()))

    nz_x = np.concatenate([bx, hx]).astype(np.float64)
    nz_y = np.concatenate([by, hy]).astype(np.float64)
    nz_t = np.concatenate([bt, ht])
    noise = {
        "x": nz_x, "y": nz_y, "t": nz_t,
        "u": np.zeros_like(nz_t), "v": np.zeros_like(nz_t),
        "polarity": rng.integers(0, 2, len(nz_t)).astype(np.int8),
        "is_noise": np.ones(len(nz_t), bool),
    }

    # ---- merge, sort, refractory filter -----------------------------------
    out = {k: np.concatenate([sig[k], noise[k]]) for k in sig}
    order = np.argsort(out["t"], kind="stable")
    out = {k: a[order] for k, a in out.items()}

    # Refractory: first event per (pixel, tau_ref bin).  Hardware greedily
    # re-arms tau after each event; binning approximates that with the same
    # 1/tau rate ceiling and keeps the filter vectorized.
    pix = out["x"].astype(np.int64) * res_y + out["y"].astype(np.int64)
    tbin = (out["t"] / refractory_s).astype(np.int64)
    key = pix * (int(duration_s / refractory_s) + 2) + tbin
    first = np.ones(len(key), bool)
    ordk = np.argsort(key, kind="stable")
    ks = key[ordk]
    dup = np.zeros(len(ks), bool)
    dup[1:] = ks[1:] == ks[:-1]
    first[ordk] = ~dup
    out = {k: a[first] for k, a in out.items()}

    out["t_ns"] = (out.pop("t") * 1e9).astype(np.int64)
    return out
