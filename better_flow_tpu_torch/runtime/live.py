"""Live streaming frontend, the bf_visualizer (ROS node) equivalent.

Counterpart of ``better_flow_tpu/runtime/live.py``: a large display buffer,
an embedded low-latency DVSFlow (``low_latency_config()``: 30k / 0.07 s
slices, scale 1, at most 10 iterations; bf_visualizer.cpp:33-34, 102-104),
a point cloud of the display buffer and the three images of the last slice,
handed to callbacks in place of the ROS topics, and a lag monitor.  With
``low_latency_config().replace(f64_totals=True)`` the embedded engine
carries f64 totals and runs the composed loop (B6) at scale 1.  The
numpy parts (``LagMonitor``, ``point_cloud``) are carried over as they are:
that module cannot be imported from here, because ``better_flow_tpu.runtime``
imports JAX.  The images are ``viz.images``'s (the port's copy).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from better_flow_tpu_torch.config import PipelineConfig, low_latency_config
from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow
from better_flow_tpu_torch.runtime.slice_buffer import EventRingBuffer

_GREEN = "\033[92m"
_YELLOW = "\033[93m"
_RED = "\033[91m"
_RESET = "\033[0m"


class LagMonitor:
    """Wall-clock vs event-time lag (bf_visualizer.cpp:181-200), reset when
    the event timestamps jump backwards (a new recording or a camera
    reset)."""

    def __init__(self, yellow_s: float = 0.05, red_s: float = 0.2):
        self.yellow_s = yellow_s
        self.red_s = red_s
        self.reset()

    def reset(self):
        self._wall0 = None
        self._event0 = None
        self._last_event = None

    def update(self, event_time_ns: int) -> float:
        now = time.monotonic()
        if self._last_event is not None and event_time_ns < self._last_event:
            self.reset()   # timestamp jump: a new epoch (:187-189)
        self._last_event = event_time_ns
        if self._wall0 is None:
            self._wall0 = now
            self._event0 = event_time_ns
            return 0.0
        return (now - self._wall0) - (event_time_ns - self._event0) / 1e9

    def format(self, lag: float) -> str:
        colour = _GREEN if lag < self.yellow_s else (
            _YELLOW if lag < self.red_s else _RED)
        return f"{colour}lag: {lag * 1000:+.1f} ms{_RESET}"


def point_cloud(x, y, t_ns, max_points: int = 200_000) -> np.ndarray:
    """(x, y, t-seconds) triples, uniformly downsampled to <= max_points
    (the 'density' stride of bf_visualizer.cpp:219-222)."""
    n = len(x)
    stride = max(1, int(np.ceil(n / max_points)))
    idx = np.arange(0, n, stride)
    return np.stack([np.asarray(x)[idx], np.asarray(y)[idx],
                     np.asarray(t_ns)[idx] / 1e9], axis=1)


class EventVisualizer:
    """Display buffer plus an optional embedded estimator.

    Callbacks replace the ROS publishers:
      on_cloud(points)                 -- the rviz point cloud topic
      on_images(dict of named images)  -- the three image topics
      on_lag(lag_seconds)              -- the lag print
    """

    def __init__(self, process_data: bool = True,
                 refresh_ns: int = int(0.066e9),
                 display_capacity: int = 1_000_000,
                 display_span_ns: int = int(0.5e9),
                 cfg: Optional[PipelineConfig] = None,
                 on_cloud: Optional[Callable] = None,
                 on_images: Optional[Callable] = None,
                 on_lag: Optional[Callable] = None,
                 quiet: bool = False, device=None):
        self.buffer = EventRingBuffer(display_capacity, display_span_ns)
        self.estimator: Optional[DVSFlow] = None
        self._last_rec = None
        if process_data:
            self.estimator = DVSFlow(cfg or low_latency_config(),
                                     device=device)
            self.estimator.on_slice = self._stash_slice
        self.refresh_ns = refresh_ns
        self.last_refresh = 0
        self.lag = LagMonitor()
        self.on_cloud = on_cloud
        self.on_images = on_images
        self.on_lag = on_lag
        self.quiet = quiet

    def add_events(self, x, y, t_ns) -> int:
        """Feed a batch; fires the refreshes of the event callback and
        trigger of bf_visualizer.cpp:116-128, 163-200."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        t_ns = np.asarray(t_ns, np.int64)
        self.buffer.push_batch(x, y, t_ns)
        if self.estimator is not None:
            self.estimator.add_events(x, y, t_ns)
        fired = 0
        if len(t_ns):
            newest = int(t_ns[-1])
            lag = self.lag.update(newest)
            if newest - self.last_refresh >= self.refresh_ns:
                self.last_refresh = newest
                self._refresh(lag)
                fired += 1
        return fired

    def _stash_slice(self, rec):
        self._last_rec = rec

    def _refresh(self, lag: float):
        if self.on_lag is not None:
            self.on_lag(lag)
        elif not self.quiet:
            print(self.lag.format(lag))
        snap = self.buffer.snapshot()
        if self.on_cloud is not None:
            self.on_cloud(point_cloud(snap["x"], snap["y"], snap["timestamp"]))
        if self.on_images is not None and self._last_rec is not None:
            from better_flow_tpu_torch.viz.images import (
                color_flow_img, projection_img, projection_img_unopt,
            )

            rec = self._last_rec
            sensor = self.estimator.cfg.sensor
            res = dict(res_x=sensor.res_x, res_y=sensor.res_y)
            # visualize_minimizer's three topics (bf_visualizer.cpp:246-267)
            self.on_images({
                "projection": projection_img(rec.pr_x, rec.pr_y, rec.noise,
                                             scale=1, **res),
                "color_flow": color_flow_img(rec.pr_x, rec.pr_y, rec.u,
                                             rec.v, rec.noise, **res),
                "unoptimized": projection_img_unopt(rec.x, rec.y, rec.noise,
                                                    scale=1, **res),
            })


def replay_file(path: str, visualizer: EventVisualizer, chunk: int = 4096,
                realtime: bool = False) -> int:
    """File replay (bf_visualizer.cpp:302-337): feed a recording through
    the live frontend, optionally paced to the wall clock."""
    from better_flow_tpu_torch.io.event_file import read_events

    rec = read_events(path)
    n = len(rec["x"])
    t0_wall = time.monotonic()
    t0_ev = int(rec["t_ns"][0]) if n else 0
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        if realtime:
            target = (int(rec["t_ns"][end - 1]) - t0_ev) / 1e9
            sleep = target - (time.monotonic() - t0_wall)
            if sleep > 0:
                time.sleep(sleep)
        visualizer.add_events(rec["x"][start:end], rec["y"][start:end],
                              rec["t_ns"][start:end])
    return n
