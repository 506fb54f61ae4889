"""Interactive manual minimization: OptimizerRolling::manual
(optimizer_rolling.h:128-233) with OpenCV trackbars, on the PyTorch/CUDA
port (counterpart of ``better_flow_tpu/cli/manual_mode.py``).

Sliders x tilt / y tilt / rot / div (centred at 127) and fine/coarse feed
the model's deltas each tick; the accumulators advance with the manual
mode's dividers (10000, 10000, 1000, 1000, :197), the events are warped
again with the accumulated totals, and the time image, the coloured
gradient and the colour-time views refresh.  'c' runs the optimizer under
the reference schedule from the current state (``process_event_slice``: the
megastep kernel B5 and the final warp B4 on the card); 's' writes the
normalised time image; ESC exits.

``ManualSession`` holds the state and runs one tick without a display, so
that tests can drive it; ``run_manual`` is the OpenCV loop around it and
raises ``NoDisplay`` when no window can be opened.  The tick runs op by
op on the device, as the JAX package runs its manual mode eagerly: true
divisions and every product and sum rounded on its own.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from better_flow_tpu_torch.config import NZ, WARP_TIME_DIV, OptimizerConfig
from better_flow_tpu_torch.core.events import make_slice
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.models import global_flow as gf
from better_flow_tpu_torch.ops.time_image import time_image
from better_flow_tpu_torch.ops.warp import cos_sin_f32
from better_flow_tpu_torch.runtime.scan_pipeline import default_device
from better_flow_tpu_torch.viz.debug_images import gradient_img_color
from better_flow_tpu_torch.viz.images import color_time_img, time_img_u8

# Trackbar name, initial position, maximum (optimizer_rolling.h:140-150).
SLIDERS = (("x tilt", 127, 255), ("y tilt", 127, 255), ("rot", 127, 255),
           ("div", 127, 255), ("fine/coarse", 500, 1000))
# The manual mode's dividers of rot, div, dx, dy (optimizer_rolling.h:197).
DIVIDERS = (10000.0, 10000.0, 1000.0, 1000.0)
WIN = "Minimization output"
WIN_COLOR = "Minimization output color"


class NoDisplay(RuntimeError):
    """No display to open the manual mode's windows on."""


def slider_deltas(positions):
    """The model deltas (dx, dy, rot, div) of the trackbar positions
    (x tilt, y tilt, rot, div, fine/coarse): (pos - 127) / (fine + 1)."""
    *tilt, fine = positions
    return tuple((p - 127) / (fine + 1) for p in tilt)


class ManualSession:
    """The manual mode's state on one slice of events: the slice, its
    geometry, the model and the current warp.  ``tick`` is one turn of
    the loop, ``optimize`` the 'c' key."""

    def __init__(self, x, y, t_ns, sensor, scale: int = 3, device=None):
        dev = torch.device(device) if device is not None else default_device()
        self.device, self.sensor, self.scale = dev, sensor, scale
        self.ev = make_slice(np.asarray(x, np.float64),
                             np.asarray(y, np.float64),
                             np.asarray(t_ns, np.float64), device=dev)
        self.H, self.W = gf.static_image_shape(scale, sensor)
        self.geom = gf.slice_geometry(self.ev, scale, sensor)
        self.model = MotionModel.zero(dev)
        self.pr_x, self.pr_y = self.ev.x, self.ev.y
        self.timg = None

    def _f32(self, v) -> torch.Tensor:
        return torch.full((), float(v), dtype=torch.float32,
                          device=self.device)

    def tick(self, deltas) -> torch.Tensor:
        """One tick: the deltas (dx, dy, rot, div) into the model and its
        accumulators, the warp from the accumulated totals, and the time
        image, which it returns."""
        m, g, ev = self.model, self.geom, self.ev
        cx = (float(m.cx) - float(g.x_shift)) / self.scale
        cy = (float(m.cy) - float(g.y_shift)) / self.scale
        dx, dy, rot, div = (self._f32(v) for v in deltas)
        # Tensor dividers: a division by a host scalar is a multiplication
        # by its reciprocal on the card.
        d_rot, d_div, d_x, d_y = (self._f32(v) for v in DIVIDERS)
        m = m.replace(dx=dx, dy=dy, rot=rot, div=div)
        self.model = m.add_totals(m.rot / d_rot, m.div / d_div, m.dx / d_x,
                                  m.dy / d_y)
        self.pr_x, self.pr_y = self._warp(cx, cy)
        self.timg = time_image(self.pr_x, self.pr_y, ev.t, ev.active,
                               self.scale, g.x_shift, g.y_shift, g.w_dyn,
                               g.h_dyn, self.H, self.W)
        return self.timg

    def _warp(self, cx, cy):
        """``project_4param_reinit`` with the totals' sign pattern
        (-total_dx, -total_dy, cx, cy, total_div, -total_rot), evaluated
        op by op (event.h:99-110)."""
        m, ev = self.model, self.ev
        dnx_, dny_, div, crl = (a.to(torch.float32) for a in (
            -m.total_dx, -m.total_dy, m.total_div, -m.total_rot))
        cx, cy = self._f32(cx), self._f32(cy)
        c, s = cos_sin_f32(crl)
        rx, ry = self.pr_x - cx, self.pr_y - cy
        rpx = c * rx - s * ry
        rpy = s * rx + c * ry
        nx = (-rpx * div + (rpx - rx)) + dnx_
        ny = (-rpy * div + (rpy - ry)) + dny_
        ts = ev.t / self._f32(WARP_TIME_DIV)
        nz = self._f32(NZ)
        return ev.x - nx / nz * ts, ev.y - ny / nz * ts

    def optimize(self):
        """The 'c' key: the flat-slice ``process_event_slice`` under the
        reference schedule from the current model (sorted into the
        kernels' chunk layout and back); the warp of its result becomes the
        current one.  Returns the ``SliceResult``, in the slice's order."""
        res = gf.process_event_slice(self.ev, self.model,
                                     OptimizerConfig(scale=self.scale),
                                     self.sensor)
        self.model = res.model
        self.pr_x, self.pr_y = res.pr_x, res.pr_y
        return res

    def views(self):
        """The two windows' images: the coloured Scharr gradient of the
        time image and the colour-time image of the warp."""
        return (gradient_img_color(self.timg.cpu().numpy(),
                                   device=self.device),
                color_time_img(self.pr_x.cpu().numpy(),
                               self.pr_y.cpu().numpy(),
                               self.ev.t.cpu().numpy(), scale=self.scale,
                               res_x=self.sensor.res_x,
                               res_y=self.sensor.res_y))


def _open_windows(cv2):
    """Create the two windows and the trackbars; ``NoDisplay`` when there
    is no display to put them on."""
    if sys.platform.startswith("linux") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        raise NoDisplay("no display (DISPLAY is not set)")
    try:
        cv2.namedWindow(WIN, cv2.WINDOW_NORMAL)
        cv2.namedWindow(WIN_COLOR, cv2.WINDOW_NORMAL)
    except cv2.error as e:
        raise NoDisplay(f"OpenCV cannot open a window: {e}") from e
    for name, init, maxv in SLIDERS:
        cv2.createTrackbar(name, WIN, init, maxv, lambda *_: None)


def run_manual(x, y, t_ns, sensor, scale: int = 3, device=None) -> dict:
    """The OpenCV loop of the manual mode on one slice of events (``device``
    defaults to the card).  Returns the final ``model`` and warp."""
    import cv2

    _open_windows(cv2)
    sess = ManualSession(x, y, t_ns, sensor, scale=scale, device=device)
    code = 0
    while code != 27:  # esc
        code = cv2.waitKey(33)
        if code == ord("c"):
            sess.optimize()
            for name, init, _ in SLIDERS[:4]:
                cv2.setTrackbarPos(name, WIN, init)
        timg = sess.tick(slider_deltas(
            [cv2.getTrackbarPos(name, WIN) for name, _, _ in SLIDERS]))
        if code == ord("s"):
            cv2.imwrite("./time_manual.jpg",
                        time_img_u8(timg.cpu().numpy()))
        grad, color = sess.views()
        cv2.imshow(WIN, grad)
        cv2.imshow(WIN_COLOR, color)
    cv2.destroyAllWindows()
    return {"model": sess.model, "pr_x": sess.pr_x.cpu().numpy(),
            "pr_y": sess.pr_y.cpu().numpy()}
