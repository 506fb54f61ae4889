"""OptimizerRolling's debug views (optimizer_rolling.h:351-515), in
PyTorch on the device, returned as numpy uint8 images.

Counterpart of ``better_flow_tpu/viz/debug_images.py``: the fused
low-resolution gradient magnitude, the coloured Scharr and LR-Sobel
gradients, and the misalignment map (each pixel's walk to the local
minimum plus its walk to the local maximum of the time surface,
goto_min/goto_max, :437-515).  The JAX package computes these op by op
(eagerly), so the Scharr pair is taken uncontracted
(``ops.gradient.masked_scharr(contract=False)``) and each sum rounds on
its own.

``_walk_lengths`` needs no blocking read a round: a pixel is alive after
round k only if it moved in every round so far, so then its step count is
1 + k, and the JAX loop (while any pixel is alive and the largest count is
below ``max_steps``) ends after at most ``max_steps - 1`` rounds; the same
number of masked rounds, which change nothing once no pixel is alive,
gives its result.
"""

from __future__ import annotations

import numpy as np
import torch

from better_flow_tpu_torch.config import NONZERO_EPS
from better_flow_tpu_torch.ops.gradient import (
    gradient_img_fuse,
    lr_sobel,
    lr_sobel_fuse,
    masked_scharr,
)
from better_flow_tpu_torch.runtime.scan_pipeline import default_device
from better_flow_tpu_torch.viz.images import color_gradient_img


def _on(img, device) -> torch.Tensor:
    dev = torch.device(device) if device is not None else default_device()
    return torch.tensor(np.asarray(img, np.float32), device=dev)


def gradient_img(time_img, pr_img, wsize: int = 50, device=None
                 ) -> np.ndarray:
    """OptimizerRolling::get_gradient_img (optimizer_rolling.h:351-373):
    LR_Sobel_fuse of the time image with the projection image (the fuse
    before the window mean, accel_lib.h:441-442), a second fuse on the
    result (:363), then ``0.5 * |gx| + 0.5 * |gy|`` clipped to uint8.
    ``wsize`` must be odd: the default of 50, the JAX package's, raises a
    ``ValueError`` here, where the JAX package fails on a broadcast."""
    t = _on(time_img, device)
    pr = _on(pr_img, t.device)
    gx, gy = lr_sobel_fuse(t, pr, wsize)
    gx, gy = gradient_img_fuse(pr, gx, gy)
    grad = 0.5 * gx.abs() + 0.5 * gy.abs()
    return grad.clamp(0, 255).cpu().numpy().astype(np.uint8)


def gradient_img_color(time_img, device=None) -> np.ndarray:
    """get_gradient_img_color (:375-387): the full-resolution masked Scharr
    pair in the direction-hue encoding."""
    gx, gy = masked_scharr(_on(time_img, device), contract=False)
    return color_gradient_img(gx.cpu().numpy(), gy.cpu().numpy())


def lr_gradient_img_color(time_img, wsize: int = 9, device=None
                          ) -> np.ndarray:
    """get_LR_gradient_img_color (:389-402); ``wsize`` must be odd."""
    gx, gy = lr_sobel(_on(time_img, device), wsize)
    return color_gradient_img(gx.cpu().numpy(), gy.cpu().numpy())


def _walk_lengths(img: torch.Tensor, maximize: bool, max_steps: int = 64
                  ) -> torch.Tensor:
    """goto_min/goto_max for every pixel in lock-step: from each nonzero
    pixel, step to the best (strictly smaller or larger) nonzero
    8-neighbour, the first best in row-major neighbour order, until none
    is better or the walk reaches the image border; the result is the
    step count (from 1), 0 on zero pixels.  ``max_steps`` bounds the walk,
    as in the JAX package (its 64 covers the reference's 543x723 images)."""
    H, W = img.shape
    dev = img.device
    rows = torch.arange(H, device=dev)[:, None].expand(H, W)
    cols = torch.arange(W, device=dev)[None, :].expand(H, W)
    neigh = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
             if not (dr == 0 and dc == 0)]
    start = img > NONZERO_EPS
    r, c, val = rows, cols, img
    steps = torch.ones((H, W), dtype=torch.int32, device=dev)
    alive = start
    for _ in range(max_steps - 1):
        best_r, best_c, best_v = r, c, val
        for dr, dc in neigh:
            inb = ((r + dr >= 0) & (r + dr < H) & (c + dc >= 0)
                   & (c + dc < W))
            rr = (r + dr).clamp(0, H - 1)
            cc = (c + dc).clamp(0, W - 1)
            v = img[rr, cc]
            better = inb & (v > NONZERO_EPS) & (
                v > best_v if maximize else v < best_v)
            best_r = torch.where(better, rr, best_r)
            best_c = torch.where(better, cc, best_c)
            best_v = torch.where(better, v, best_v)
        moved = alive & ((best_r != r) | (best_c != c))
        # stop at the image border like the reference (:469, :509)
        border = ((best_r <= 0) | (best_c <= 0) | (best_r >= H - 1)
                  | (best_c >= W - 1))
        steps = steps + moved.to(torch.int32)
        alive = moved & ~border
        r = torch.where(moved, best_r, r)
        c = torch.where(moved, best_c, c)
        val = torch.where(moved, best_v, val)
    return torch.where(start, steps, torch.zeros_like(steps))


def misalignment_img(time_img, max_steps: int = 64, device=None
                     ) -> np.ndarray:
    """get_misalignment_img_color (optimizer_rolling.h:405-434): each
    pixel's goto_min + goto_max walk length, min-max normalised to
    uint8."""
    img = _on(time_img, device)
    total = (_walk_lengths(img, False, max_steps)
             + _walk_lengths(img, True, max_steps)).to(torch.float32)
    lo, hi = total.min(), total.max()
    out = torch.where(hi > lo, (total - lo) * 255.0 / (hi - lo),
                      torch.zeros_like(total))
    return out.cpu().numpy().astype(np.uint8)
