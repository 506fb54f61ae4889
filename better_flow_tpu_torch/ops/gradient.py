"""Masked Scharr gradients of the time surface, in plain PyTorch.

Counterpart of ``better_flow_tpu/ops/gradient.py``'s ``masked_scharr``
(AccelLib::Sobel_cpu / sobel_point, accel_lib.h:513-615): a 3x3 Scharr
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
``dy`` as ``fma(3, a[r-1,c-1], -(3*a[r-1,c+1]))``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from better_flow_tpu_torch.config import NONZERO_EPS
from better_flow_tpu_torch.ops.warp import fma


def _shift(padded: torch.Tensor, dr: int, dc: int, H: int, W: int
           ) -> torch.Tensor:
    """View of the zero-padded image shifted by (dr, dc) in [-1, 1]."""
    return padded[1 + dr:1 + dr + H, 1 + dc:1 + dc + W]


def masked_scharr(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_x, grad_y) with the all-nine-nonzero mask; zeros elsewhere."""
    H, W = img.shape
    p = torch.nn.functional.pad(img, (1, 1, 1, 1))
    a = {(dr, dc): _shift(p, dr, dc, H, W)
         for dr in (-1, 0, 1) for dc in (-1, 0, 1)}
    ok = None
    for v in a.values():
        nz = v > NONZERO_EPS
        ok = nz if ok is None else ok & nz
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
