"""Masked Scharr gradients of the time surface and their low-resolution
window means, in plain PyTorch.

Counterpart of ``better_flow_tpu/ops/gradient.py``: ``masked_scharr``
(AccelLib::Sobel_cpu / sobel_point, accel_lib.h:513-615) is a 3x3 Scharr
stencil where a pixel has a gradient only if all nine pixels of its
neighbourhood exceed the nonzero threshold; zero padding makes every border
pixel fail that test, as the reference excludes the border rows and
columns.

    dx = 3*a[r-1,c-1] + 10*a[r-1,c] + 3*a[r-1,c+1]
       - 3*a[r+1,c-1] - 10*a[r+1,c] - 3*a[r+1,c+1]
    dy = 3*a[r-1,c-1] - 3*a[r-1,c+1]
       + 10*a[r,c-1] - 10*a[r,c+1]
       + 3*a[r+1,c-1] - 3*a[r+1,c+1]

The sums are evaluated as XLA compiles the JAX expressions on the CPU
(measured bit for bit): left to right, each product fused into the add or
subtract that consumes it (``ops.warp.fma``), and the first two products of
``dy`` as ``fma(3, a[r-1,c-1], -(3*a[r-1,c+1]))``.  With
``contract=False`` each product is rounded on its own, as the JAX package
computes them called eagerly, op by op (its debug views do).

``lr_sobel``, ``lr_sobel_fuse`` and ``gradient_img_fuse`` (accel_lib.h:
436-510, event_file.cpp:58-87) average the gradient over a window.  The
JAX package calls them only eagerly (``viz/debug_images.py``), so they
take the uncontracted Scharr pair; inside one compiled program XLA
contracts it differently again, and ``gradient_img_fuse`` scales the
rounding residue of a flat neighbourhood (|g| ~ 1e-9) to a unit vector,
so no one arithmetic serves both.  The window sums add in
``box_filter``'s row-major order; the window must be odd
(``_window_mean_sparse``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from better_flow_tpu_torch.config import NONZERO_EPS
from better_flow_tpu_torch.ops.time_image import box_filter
from better_flow_tpu_torch.ops.warp import fma


def _shift(padded: torch.Tensor, dr: int, dc: int, H: int, W: int
           ) -> torch.Tensor:
    """View of the zero-padded image shifted by (dr, dc) in [-1, 1]."""
    return padded[1 + dr:1 + dr + H, 1 + dc:1 + dc + W]


def masked_scharr(img: torch.Tensor, contract: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_x, grad_y) with the all-nine-nonzero mask; zeros elsewhere.
    ``contract``: the products fused into the sums as compiled (the XLA
    branch), or each rounded on its own as run op by op (the views)."""
    H, W = img.shape
    p = torch.nn.functional.pad(img, (1, 1, 1, 1))
    a = {(dr, dc): _shift(p, dr, dc, H, W)
         for dr in (-1, 0, 1) for dc in (-1, 0, 1)}
    ok = None
    for v in a.values():
        nz = v > NONZERO_EPS
        ok = nz if ok is None else ok & nz
    if not contract:
        dx = (3.0 * a[(-1, -1)] + 10.0 * a[(-1, 0)] + 3.0 * a[(-1, 1)]
              - 3.0 * a[(1, -1)] - 10.0 * a[(1, 0)] - 3.0 * a[(1, 1)])
        dy = (3.0 * a[(-1, -1)] - 3.0 * a[(-1, 1)] + 10.0 * a[(0, -1)]
              - 10.0 * a[(0, 1)] + 3.0 * a[(1, -1)] - 3.0 * a[(1, 1)])
        zero = torch.zeros_like(img)
        return torch.where(ok, dx, zero), torch.where(ok, dy, zero)
    c = lambda v: torch.full((), v, dtype=torch.float32, device=img.device)
    dx = fma(c(3.0), a[(-1, -1)], 10.0 * a[(-1, 0)])
    dx = fma(c(3.0), a[(-1, 1)], dx)
    dx = fma(c(-3.0), a[(1, -1)], dx)
    dx = fma(c(-10.0), a[(1, 0)], dx)
    dx = fma(c(-3.0), a[(1, 1)], dx)
    dy = fma(c(3.0), a[(-1, -1)], -(3.0 * a[(-1, 1)]))
    dy = fma(c(10.0), a[(0, -1)], dy)
    dy = fma(c(-10.0), a[(0, 1)], dy)
    dy = fma(c(3.0), a[(1, -1)], dy)
    dy = fma(c(-3.0), a[(1, 1)], dy)
    zero = torch.zeros_like(img)
    return torch.where(ok, dx, zero), torch.where(ok, dy, zero)


def hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``hypot`` in ``jnp.hypot``'s formula, ``m * sqrt(1 + (n/m)^2)``
    with ``m = max(|a|, |b|)``, ``n = min(|a|, |b|)`` (0 where ``m`` is
    0, inf where either is), the square fused into the add as XLA
    compiles it on the CPU (measured bit for bit), so that a comparison
    with a threshold decides as the JAX package's does.  The square root
    is taken in f64 and rounded once, which is the correctly rounded f32
    root: PyTorch's own f32 ``sqrt`` on the CPU is not (it differed from
    numpy's and XLA's on 652 of 100,000 values)."""
    a, b = a.abs(), b.abs()
    m, n = torch.maximum(a, b), torch.minimum(a, b)
    zero = m == 0
    r = n / torch.where(zero, torch.ones_like(m), m)
    one = torch.ones((), dtype=r.dtype, device=r.device)
    h = torch.where(zero, m, m * torch.sqrt(fma(r, r, one).double()).float())
    return torch.where(torch.isposinf(a) | torch.isposinf(b),
                       torch.full_like(h, float("inf")), h)


def _check_odd(wsize: int) -> None:
    if wsize % 2 == 0:
        raise ValueError(
            f"wsize={wsize} is even: the window mean takes an odd window "
            "centred on each pixel (the JAX package fails on a broadcast "
            "there)")


def _window_mean_sparse(g: torch.Tensor, wsize: int) -> torch.Tensor:
    """Window mean over the entries with |g| > 1e-8 where at least
    ``wsize^2 // 4`` of them lie in the window, else 0; only the interior
    ``[wsize // 2, n - wsize // 2)`` of both axes is filled
    (LR_sobel_point, accel_lib.h:495-510).

    ``wsize`` must be odd.  The JAX package pads ``wsize // 2`` on each
    side, so an even window gives an (H + 1, W + 1) sum that fails to
    broadcast (``viz/debug_images.py:27``'s default of 50); here an even
    window raises a ``ValueError`` that names it."""
    _check_odd(wsize)
    half = wsize // 2
    H, W = g.shape
    nz = (g.abs() > 1e-8).to(torch.float32)
    ssum = box_filter(g, wsize)
    scnt = box_filter(nz, wsize)
    zero = torch.zeros_like(g)
    out = torch.where(scnt >= (wsize * wsize) // 4,
                      ssum / torch.clamp(scnt, min=1.0), zero)
    rows = torch.arange(H, device=g.device)[:, None]
    cols = torch.arange(W, device=g.device)[None, :]
    interior = ((rows >= half) & (rows < H - half) & (cols >= half)
                & (cols < W - half))
    return torch.where(interior, out, zero)


def lr_sobel(img: torch.Tensor, wsize: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-resolution gradient: the window mean of the masked Scharr pair
    (AccelLib::LR_Sobel / LR_sobel_point, accel_lib.h:466-510)."""
    _check_odd(wsize)
    gx, gy = masked_scharr(img, contract=False)
    return _window_mean_sparse(gx, wsize), _window_mean_sparse(gy, wsize)


def gradient_img_fuse(pr_img: torch.Tensor, gx: torch.Tensor,
                      gy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unit gradient scaled by ``255 - pr_img`` where the gradient is
    nonzero (EventFile::gradient_img_fuse, event_file.cpp:58-87);
    ``pr_img`` is a uint8-range f32 image."""
    speed = hypot(gx, gy)
    safe = torch.clamp(speed, min=1e-30)
    zero = torch.zeros_like(gx)
    ux = torch.where(speed == 0, zero, gx / safe)
    uy = torch.where(speed == 0, zero, gy / safe)
    mag = torch.where(speed != 0, 255.0 - pr_img, zero)
    return ux * mag, uy * mag


def lr_sobel_fuse(img: torch.Tensor, pr_img: torch.Tensor, wsize: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AccelLib::LR_Sobel_fuse (accel_lib.h:436-464): the masked Scharr
    pair, fused with the projection image, then the window mean (the fuse
    comes before the averaging)."""
    _check_odd(wsize)
    gx, gy = masked_scharr(img, contract=False)
    gx, gy = gradient_img_fuse(pr_img, gx, gy)
    return _window_mean_sparse(gx, wsize), _window_mean_sparse(gy, wsize)
