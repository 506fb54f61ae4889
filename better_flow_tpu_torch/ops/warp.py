"""The per-event warp in f32 (Event::project_4param_reinit, event.h:99-110).

The arithmetic is that of the JAX package as XLA compiles it, measured bit
for bit on the CPU: a multiply feeding an add is one fused multiply-add
(``fma``), and a division by a constant is a multiplication by the
constant's f32 reciprocal (``mul_recip``).  Nothing else is fused or
reordered.  The CUDA kernels use ``fmaf`` at the same places and are
compiled with ``--fmad=false``; the plain versions here emulate the fused
operation in f64, which is exact for the product and rounds the sum twice
(f64, then f32) -- the same result except when the f64 sum lands on an
f32 rounding tie, about once in 2^29 operations.

Cosine and sine are taken in f64 and rounded to f32 once, here and in the
kernels alike, so that the card and the CPU warp with the same two f32
numbers.

The public warp functions take the JAX package's ``nz=float(NZ)`` keyword
(the direction vector's z component); at the default the arithmetic is the
fixed-NZ arithmetic of the kernels, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from better_flow_tpu_torch.config import NZ, UV_FACTOR, WARP_TIME_DIV

# An exact f32 value held as a Python float: multiplying an f32 tensor by it
# rounds once, as the f32 product does (compute_uv and n_from_u make theirs
# the same way).
UV_K = float(np.float32(UV_FACTOR / NZ))   # the kernels' packed-output factor


def recip(c: float) -> float:
    """The f32 reciprocal of a constant, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def mul_recip(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` for a constant ``c``, computed as ``a * f32(1 / c)``."""
    return a * recip(c)


def fma(a, b, c):
    """f32 ``a * b + c`` with one rounding (emulated in f64)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def cos_sin_f32(crl: torch.Tensor):
    """f32 cos and sin of an f32 or f64 angle, each taken in f64 and
    rounded to f32 once."""
    a = crl.to(torch.float64)
    return torch.cos(a).to(torch.float32), torch.sin(a).to(torch.float32)


def apply_project(fr_x, fr_y, t, nx, ny, nz=float(NZ)):
    """``pr = fr - (n / nz) * t / 1e4`` (Event::apply_project,
    event.h:164-168), as XLA compiles it: both divisions by constants are
    multiplications by their f32 reciprocals and the product is fused into
    the subtraction (measured bit for bit on the CPU)."""
    kx = mul_recip(nx, nz)
    ky = mul_recip(ny, nz)
    ts = mul_recip(t, WARP_TIME_DIV)
    return fma(-kx, ts, fr_x), fma(-ky, ts, fr_y)


# (1 / NZ) * (1 / WARP_TIME_DIV), the two f32 reciprocals' f32 product.
K_NT = float(np.float32(np.float32(recip(float(NZ)))
                        * np.float32(recip(WARP_TIME_DIV))))


def apply_project_per_n(fr_x, fr_y, t, nx, ny):
    """``apply_project`` as XLA compiles it where (nx, ny) are constant
    over the events of a loop body (one window of the local field, one
    candidate of the score search): the two constant reciprocals fold into
    one, ``K_NT``, that multiplies n once, ``pr = fma(-t, n * K_NT, fr)``
    (read from the compiled HLO and measured bit for bit on the CPU).  It
    differs from ``apply_project`` in the last bit of ~3% of positions."""
    return (fma(-t, nx * K_NT, fr_x), fma(-t, ny * K_NT, fr_y))


def project_4param_reinit(fr_x, fr_y, t, pr_x, pr_y, dnx_, dny_, cx, cy,
                          div, crl, nz=float(NZ), sin_fma: bool = False):
    """Rotate/diverge the current ``pr`` about (cx, cy), overwrite n with
    that delta plus (dnx_, dny_) and re-project from the original pixel
    ``fr``.  Returns (pr_x, pr_y, nx, ny).  Call sites pass the model's
    totals with the sign pattern (-total_dx, -total_dy, cx, cy, total_div,
    -total_rot).  The model scalars are cast to f32 on entry, as the JAX
    package does for an f64 carry (the angle too, before its cos/sin).
    ``sin_fma``: see ``project_4param_reinit_cs``."""
    dnx_, dny_, cx, cy, div, crl = (torch.as_tensor(a).to(torch.float32)
                                    for a in (dnx_, dny_, cx, cy, div, crl))
    c, s = cos_sin_f32(crl)
    return project_4param_reinit_cs(fr_x, fr_y, t, pr_x, pr_y, dnx_, dny_,
                                    cx, cy, div, c, s, sin_fma=sin_fma,
                                    nz=nz)


def _divcrl_dn(pr_x, pr_y, cx, cy, div, c, s, sin_fma: bool = False):
    """The rotation and divergence delta about (cx, cy) (event.h:78-86):
    ``r = pr - c``, ``r' = R(crl) r``, ``dn = -r' * div + (r' - r)``,
    with the f32 cosine ``c`` and sine ``s`` of the angle."""
    rx = pr_x - cx
    ry = pr_y - cy
    if sin_fma:
        rpx = fma(-s, ry, c * rx)
        rpy = fma(c, ry, s * rx)
    else:
        rpx = fma(c, rx, -(s * ry))
        rpy = fma(s, rx, c * ry)
    return fma(-rpx, div, rpx - rx), fma(-rpy, div, rpy - ry)


def project_4param_reinit_cs(fr_x, fr_y, t, pr_x, pr_y, dnx_, dny_, cx, cy,
                             div, c, s, sin_fma: bool = False,
                             nz=float(NZ)):
    """``project_4param_reinit`` with the f32 cosine ``c`` and sine ``s``
    of the angle given (as the kernels' warp-scalar rows carry them).
    The rotation ``rpx = c*rx - s*ry``, ``rpy = s*rx + c*ry`` fuses its
    first product into the add, as XLA compiles the warp alone and inside
    the kernels; ``sin_fma`` fuses the other product (``rpx = fma(-s, ry,
    c*rx)``, ``rpy = fma(c, ry, s*rx)``), as XLA compiles the composed
    loop's epilogue (measured on the CPU, see ROADMAP C)."""
    dnx, dny = _divcrl_dn(pr_x, pr_y, cx, cy, div, c, s, sin_fma=sin_fma)
    nx = dnx + dnx_
    ny = dny + dny_
    return (*apply_project(fr_x, fr_y, t, nx, ny, nz), nx, ny)


def _f32(*a):
    return (torch.as_tensor(v).to(torch.float32) for v in a)


def project_dn(fr_x, fr_y, t, nx, ny, dnx, dny, nz=float(NZ)):
    """Event::project_dn (event.h:72-76): ``n += dn``, then re-project
    from the original pixel.  Returns (pr_x, pr_y, nx, ny)."""
    nx = nx + dnx
    ny = ny + dny
    return (*apply_project(fr_x, fr_y, t, nx, ny, nz), nx, ny)


def project_divcrl(fr_x, fr_y, t, pr_x, pr_y, nx, ny, cx, cy, div, crl,
                   nz=float(NZ)):
    """Event::project_divcrl (event.h:78-86): ``n`` plus the rotation and
    divergence delta of the current ``pr``, then re-project.  Returns
    (pr_x, pr_y, nx, ny)."""
    cx, cy, div, crl = _f32(cx, cy, div, crl)
    dnx, dny = _divcrl_dn(pr_x, pr_y, cx, cy, div, *cos_sin_f32(crl))
    nx = nx + dnx
    ny = ny + dny
    return (*apply_project(fr_x, fr_y, t, nx, ny, nz), nx, ny)


def project_4param(fr_x, fr_y, t, pr_x, pr_y, nx, ny, dnx_, dny_, cx, cy,
                   div, crl, nz=float(NZ)):
    """Event::project_4param (event.h:88-96): ``n += dn + (dnx_, dny_)``
    (added in that order), then re-project.  Returns (pr_x, pr_y, nx,
    ny)."""
    dnx_, dny_, cx, cy, div, crl = _f32(dnx_, dny_, cx, cy, div, crl)
    dnx, dny = _divcrl_dn(pr_x, pr_y, cx, cy, div, *cos_sin_f32(crl))
    nx = nx + dnx + dnx_
    ny = ny + dny + dny_
    return (*apply_project(fr_x, fr_y, t, nx, ny, nz), nx, ny)


def compute_uv(nx, ny, nz=float(NZ)):
    """Direction vector -> optical flow in px/s (u = nx * UV_FACTOR/nz,
    the factor an f32 quotient)."""
    f = float(np.float32(UV_FACTOR) / np.float32(nz))
    return nx * f, ny * f


def n_from_u(vel, nz=float(NZ)):
    """Flow in px/s -> direction vector (Event::n_from_u, event.h:131-133):
    ``vel * f32(nz / UV_FACTOR)``."""
    f = float(np.float32(nz) / np.float32(UV_FACTOR))
    return vel * f
