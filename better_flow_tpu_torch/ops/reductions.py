"""Masked reductions over the time image, the model's partial sums and
the model terms made from them.

Counterpart of ``better_flow_tpu/ops/reductions.py``'s
``nonzero_average``, ``center_of_mass`` and ``model_compute`` (the XLA
branch's reductions over the whole image), ``ModelTerms``,
``model_compute_partial`` and ``model_from_partials``
(ObjectModel::compute, object_model.cpp:4-39), and
``model_compute_sampled`` (the event-sampled overload, :42-99).  The
seven partial sums (cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg) are sums
over the pixels with img > 1e-6 that do not depend on the centroid, so
the centroid is applied after the sum:

    rot = (S_rg - cx*S_gy + cy*S_gx) / cnt
    div = (S_dg - cx*S_gx - cy*S_gy) / cnt
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from better_flow_tpu_torch.config import NONZERO_EPS
from better_flow_tpu_torch.ops.warp import fma


class ModelTerms(NamedTuple):
    dx: torch.Tensor
    dy: torch.Tensor
    rot: torch.Tensor
    div: torch.Tensor
    cnt: torch.Tensor


def _sum32(v: torch.Tensor) -> torch.Tensor:
    """Sum in f64, rounded to f32 once."""
    return v.to(torch.float64).sum().to(torch.float32)


def nonzero_average(img: torch.Tensor) -> torch.Tensor:
    """Mean over the strictly nonzero pixels, 0 if none
    (EventFile::nonzero_average, event_file.cpp:282-294)."""
    mask = img != 0
    cnt = mask.sum().to(torch.float32)
    s = _sum32(torch.where(mask, img, torch.zeros_like(img)))
    return torch.where(cnt == 0, torch.zeros_like(s),
                       s / torch.clamp(cnt, min=1.0))


def _pixel_grid(img: torch.Tensor):
    H, W = img.shape
    rows = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    return rows, cols


def center_of_mass(img: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cx, cy, cnt): the mean (row, col) over pixels > 1e-6
    (object_model.cpp:103-126); (0, 0, 0) for an empty image.  The sums
    are f64, rounded to f32 once (the JAX package sums in f32 in XLA's
    order), then divided in f32."""
    mask = img > NONZERO_EPS
    rows, cols = _pixel_grid(img)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    cnt = _sum32(mask)
    denom = torch.clamp(cnt, min=1.0)
    cx = _sum32(torch.where(mask, rows, zero)) / denom
    cy = _sum32(torch.where(mask, cols, zero)) / denom
    return cx, cy, cnt


def model_compute(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                  cx, cy) -> ModelTerms:
    """The four model reductions (ObjectModel::compute,
    object_model.cpp:4-39) over every pixel with img > 1e-6 (pixels whose
    gradient the all-nine mask zeroed still count):

        dx = mean(gx)   dy = mean(gy)   rot = mean(r x g)   div = mean(r . g)

    with r = (row - cx, col - cy).  The integrands are f32 as XLA compiles
    them on the CPU (``rx*gy - ry*gx`` as ``fma(rx, gy, -(ry*gx))``,
    ``rx*gx + ry*gy`` as ``fma(rx, gx, ry*gy)``, measured bit for bit); the
    sums are f64, rounded to f32 once, then divided in f32."""
    mask = img > NONZERO_EPS
    rows, cols = _pixel_grid(img)
    rx = rows - cx
    ry = cols - cy
    m = mask.to(torch.float32)
    cnt = _sum32(m)
    denom = torch.clamp(cnt, min=1.0)
    rot = fma(rx, gy, -(ry * gx))
    div = fma(rx, gx, ry * gy)
    return ModelTerms(dx=_sum32(gx * m) / denom, dy=_sum32(gy * m) / denom,
                      rot=_sum32(rot * m) / denom,
                      div=_sum32(div * m) / denom, cnt=cnt)


def model_compute_partial(img: torch.Tensor, gx: torch.Tensor,
                          gy: torch.Tensor) -> torch.Tensor:
    """The seven sums of an (H, W) image and its gradients as a (7,) f32
    tensor.  Each sum is taken in f64 and rounded to f32 once, as the
    kernels take them; the rot and div sums are each the difference or sum
    of two such separable sums (rows times gy minus columns times gx, rows
    times gx plus columns times gy), as the kernels and the TPU kernel form
    them."""
    f64 = torch.float64
    m = (img > NONZERO_EPS).to(f64)
    gxm = gx.to(f64) * m
    gym = gy.to(f64) * m
    ri = torch.arange(img.shape[0], device=img.device)[:, None].to(f64)
    ci = torch.arange(img.shape[1], device=img.device)[None, :].to(f64)
    f32 = lambda v: v.to(torch.float32)
    return torch.stack([
        f32(m.sum()), f32((m * ri).sum()), f32((m * ci).sum()),
        f32(gxm.sum()), f32(gym.sum()),
        f32((gym * ri).sum()) - f32((gxm * ci).sum()),
        f32((gxm * ri).sum()) + f32((gym * ci).sum()),
    ])


def model_from_partials(p: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, ModelTerms]:
    """(cx, cy, ModelTerms) of the partial sums ``p`` (a (7,) or (8,) f32
    tensor in the order above; an eighth value is ignored), as 0-d f32
    tensors on ``p``'s device, in the arithmetic XLA compiles for the JAX
    package's composed loop (measured on the CPU, see ROADMAP C): the
    centroid corrections of rot and div are fused multiply-adds, as in the
    megastep kernels."""
    cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg = p[:7].unbind()
    denom = torch.clamp(cnt, min=1.0)
    cx = s_row / denom
    cy = s_col / denom
    rot = fma(cy, s_gx, fma(-cx, s_gy, s_rg)) / denom
    div = fma(-cy, s_gy, fma(-cx, s_gx, s_dg)) / denom
    return cx, cy, ModelTerms(dx=s_gx / denom, dy=s_gy / denom, rot=rot,
                              div=div, cnt=cnt)


def model_compute_sampled_at(img: torch.Tensor, pr_x: torch.Tensor,
                             pr_y: torch.Tensor, valid: torch.Tensor, cx, cy,
                             scale: int, x_shift, y_shift, idx: torch.Tensor
                             ) -> ModelTerms:
    """The model terms of the events ``idx`` (an int64 tensor of event
    indices, drawn with replacement): the unmasked Scharr pair of ``img``
    at each sampled event's projected pixel, kept where its 3x3
    neighbourhood is all above 1e-6 and inside the image; dx and dy are
    the kept samples' mean gradient, rot and div the means over the
    mean-subtracted gradients (object_model.cpp:82-90, unlike the pixel
    path).  The per-sample arithmetic is the JAX package's run op by op
    (each product rounded on its own); the sums are f64, rounded to f32
    once, where the JAX package sums in f32 in XLA's order."""
    H, W = img.shape
    sx = (pr_x[idx] * scale + x_shift).to(torch.int32)
    sy = (pr_y[idx] * scale + y_shift).to(torch.int32)
    ok = (valid[idx] & (sx >= 1) & (sx < H - 1) & (sy >= 1)
          & (sy < W - 1))
    sxc = sx.clamp(1, H - 2).to(torch.int64)
    syc = sy.clamp(1, W - 2).to(torch.int64)
    kx = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
    ky = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))
    dx = torch.zeros(idx.shape, dtype=torch.float32, device=img.device)
    dy = torch.zeros_like(dx)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            v = img[sxc + dr, syc + dc]
            ok = ok & (v > NONZERO_EPS)
            dx = dx + v * kx[dr + 1][dc + 1]
            dy = dy + v * ky[dr + 1][dc + 1]
    m = ok.to(torch.float32)
    n = _sum32(m)
    cnt = torch.clamp(n, min=1.0)
    mdx = _sum32(dx * m) / cnt
    mdy = _sum32(dy * m) / cnt
    rx = sxc.to(torch.float32) - cx
    ry = syc.to(torch.float32) - cy
    gu = dx - mdx
    gv = dy - mdy
    rot = _sum32((rx * gv - ry * gu) * m) / cnt
    div = _sum32((rx * gu + ry * gv) * m) / cnt
    return ModelTerms(dx=mdx, dy=mdy, rot=rot, div=div, cnt=n)


def model_compute_sampled(img: torch.Tensor, pr_x: torch.Tensor,
                          pr_y: torch.Tensor, valid: torch.Tensor, cx, cy,
                          scale: int, x_shift, y_shift,
                          generator: torch.Generator, p: float = 0.1
                          ) -> ModelTerms:
    """Monte-Carlo model terms over ``max(int(n * p), 1)`` events drawn
    uniformly with replacement by ``generator`` (on the events' device),
    then ``model_compute_sampled_at``.  A fixed sample count with a
    validity mask replaces the reference's resample-until-count loop,
    which can spin forever on a sparse image.  Where the JAX package takes
    a PRNG ``key``, the port takes a ``torch.Generator`` (a divergence by
    design: the two streams of draws differ)."""
    n = pr_x.shape[0]
    idx = torch.randint(0, n, (max(int(n * p), 1),), generator=generator,
                        device=pr_x.device)
    return model_compute_sampled_at(img, pr_x, pr_y, valid, cx, cy, scale,
                                    x_shift, y_shift, idx)
