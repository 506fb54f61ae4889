"""Time and count images of the XLA branch, in plain PyTorch.

Counterpart of ``better_flow_tpu/ops/time_image.py`` (AccelLib::
get_time_img_cpu, accel_lib.h:147-178): every accepted event adds its time
in seconds and a count of one to its centre pixel, a scale x scale box
filter spreads the sums over the footprint, and the time image is the sum
over the count where the count is at least one.  Images have the static
(H, W) shape of ``models.global_flow.static_image_shape``; the dynamic
window enters only as acceptance bounds.

Accumulation.  The JAX package adds f32 ``t / 1e9`` in event order through
XLA's scatter.  A float atomic add on the card would sum in another order
on every run, so the port adds each event's time as int64 fixed point
(``FIXED_PER_SEC`` units a second, the kernels' convention of
``csrc/common.cuh``) and its count as an integer, with ``index_add_``:
integer sums are exact, so the images are the same in any order, on the
CPU and on the card, and a run repeats bit for bit.  The sums become f32
once, before the box filter.  Against the JAX package's f32 sums they
differ by that sum's rounding (~1e-7 relative).

Arithmetic, as XLA compiles the JAX functions on the CPU (measured bit for
bit): the scaled position is a fused multiply-add, ``t / 1e9`` a
multiplication by the f32 reciprocal, and the box filter adds the window
in row-major order in f32.

The scatter modes.  The JAX package has three: "xla" (one f32 scatter in
event order), "rep" (8 f32 replicas summed, ``time_image.py:114-126``) and
"mxu" (a one-hot product on the matrix unit with the time as a 3-way bf16
split, ~2^-24 relative error, counts exact; ``:139-175``): strategies of
the TPU for one and the same sums.  The port computes all three with its
exact integer scatter, so they give the same images here; against each JAX
mode they differ by that mode's rounding of the time sums, and the counts
are exact.

Under an event group (``comm``, the counterpart of the JAX package's
``axis_name``) each process scatters its own events into the exact
integer pair and the pair is summed across the ranks
(``ops.fused_model.sum_images``) before it becomes f32 and is box
filtered, where the JAX package ``psum``s its f32 pre-filter images.  The
sums are integers, so the images of a group of any size are bitwise those
of one device holding every event.
"""

from __future__ import annotations

from typing import Tuple

import torch

from better_flow_tpu_torch.ops.fused_model import (
    FIXED_PER_SEC, sum_images, to_fixed,
)
from better_flow_tpu_torch.ops.warp import fma, mul_recip


SCATTER_MODES = ("xla", "rep", "mxu")


def _check_mode(scatter_mode: str) -> None:
    if scatter_mode not in SCATTER_MODES:
        raise ValueError(f"scatter_mode={scatter_mode!r}: expected one of "
                         f"{SCATTER_MODES}")


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Sum over a size x size window of the last two dims, zero padding,
    stride 1 (size odd), over any leading batch dims: ``out[..., p]`` is
    the sum of ``img[...]`` over the window centred at ``p``, added in
    row-major window order as XLA's ``reduce_window`` adds it."""
    if size == 1:
        return img
    half = size // 2
    H, W = img.shape[-2:]
    p = torch.nn.functional.pad(img, (half, half, half, half))
    out = None
    for dr in range(size):
        for dc in range(size):
            v = p[..., dr:dr + H, dc:dc + W]
            out = v if out is None else out + v
    return out


def _window_sum(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Sums of ``size`` consecutive entries along ``dim`` centred on each
    entry, zero padding: differences of an inclusive prefix sum in ``x``'s
    dtype."""
    half = size // 2
    x = x.movedim(dim, -1)
    c = torch.nn.functional.pad(x, (half + 1, half)).cumsum(-1,
                                                           dtype=x.dtype)
    return (c[..., size:] - c[..., :-size]).movedim(-1, dim)


def box_sum_int(img: torch.Tensor, size: int) -> torch.Tensor:
    """``box_filter`` of an image of integer values (counts), as a row
    pass and then a column pass of int32 prefix-sum differences: exact
    while a row's or a column's prefix sums stay below 2^31, so equal to
    ``reduce_window``'s f32 sum wherever that sum's partial sums stay below
    2^24 (a 25 x 25 window of counts <= 255 reaches 159,375).  Returns
    ``img``'s dtype; O(1) operations a pixel whatever the window."""
    if size == 1:
        return img
    x = img.to(torch.int32)
    return _window_sum(_window_sum(x, size, -1), size, -2).to(img.dtype)


def splat_indices(pr_x, pr_y, mask, scale: int, x_sh, y_sh, w_dyn, h_dyn,
                  H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre pixels and acceptance of the footprint splat
    (accel_lib.h:154-158): ``ix = int(pr_x * scale + x_sh)`` truncated
    toward zero, accepted iff ``scale // 2 <= ix < w_dyn + scale // 2``
    (and likewise for y) and ``mask``.  Returns (flat index (n,) int64,
    accept (n,) bool); the index is the sentinel ``H * W`` where rejected."""
    half = scale // 2
    dev = pr_x.device
    # A fill on the device, not an upload: a copy of a host scalar to the
    # card blocks the host once per call.
    f = lambda v: torch.full((), float(v), dtype=torch.float32, device=dev)
    ix = fma(pr_x, f(scale), f(x_sh)).to(torch.int32)   # toward zero
    iy = fma(pr_y, f(scale), f(y_sh)).to(torch.int32)
    ok = (mask & (ix >= half) & (ix < int(w_dyn) + half)
          & (iy >= half) & (iy < int(h_dyn) + half))
    lin = ix.to(torch.int64) * W + iy.to(torch.int64)
    return torch.where(ok, lin, torch.full_like(lin, H * W)), ok


def scatter_fixed(lin: torch.Tensor, t_sec: torch.Tensor, H: int, W: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-filter sums of accepted events (``lin`` from
    ``splat_indices``): (H, W) int64 fixed-point time and (H, W) int32
    count, exact in any order."""
    n = H * W
    acc_t = torch.zeros(n + 1, dtype=torch.int64, device=lin.device)
    acc_c = torch.zeros(n + 1, dtype=torch.int32, device=lin.device)
    acc_t.index_add_(0, lin, to_fixed(t_sec))
    acc_c.index_add_(0, lin, torch.ones_like(lin, dtype=torch.int32))
    return acc_t[:n].reshape(H, W), acc_c[:n].reshape(H, W)


def scatter_images(pr_x, pr_y, t_ns, mask, scale: int, x_sh, y_sh, w_dyn,
                   h_dyn, H: int, W: int, scatter_mode: str = "xla",
                   comm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (time-sum, count) f32 images after the footprint splat,
    with ``t_ns / 1e9`` seconds a contribution (accel_lib.h:151-166); every
    ``scatter_mode`` takes the exact integer sums.  ``comm`` (a
    ``parallel.comm`` communicator, the JAX package's ``axis_name``): this
    process's events' pre-filter pair summed across its ranks first."""
    _check_mode(scatter_mode)
    lin, _ = splat_indices(pr_x, pr_y, mask, scale, x_sh, y_sh, w_dyn,
                           h_dyn, H, W)
    acc_t, acc_c = sum_images(
        *scatter_fixed(lin, mul_recip(t_ns, 1e9), H, W), comm)
    t_sum = (acc_t.to(torch.float64) / FIXED_PER_SEC).to(torch.float32)
    return box_filter(t_sum, scale), box_filter(acc_c.to(torch.float32),
                                                scale)


def time_image(pr_x, pr_y, t_ns, mask, scale: int, x_sh, y_sh, w_dyn, h_dyn,
               H: int, W: int, scatter_mode: str = "xla",
               comm=None) -> torch.Tensor:
    """Average-timestamp image: the time sum over the count where the
    count is at least one, else 0 (accel_lib.h:168-175); ``comm`` as in
    ``scatter_images``."""
    t_sum, cnt = scatter_images(pr_x, pr_y, t_ns, mask, scale, x_sh, y_sh,
                                w_dyn, h_dyn, H, W,
                                scatter_mode=scatter_mode, comm=comm)
    return torch.where(cnt >= 1, t_sum / torch.clamp(cnt, min=1.0),
                       torch.zeros_like(t_sum))


def count_image(pr_x, pr_y, mask, scale: int, x_sh, y_sh, w_dyn, h_dyn,
                H: int, W: int) -> torch.Tensor:
    """Footprint count image with the uint8 saturation of the reference's
    projection images (event_file.h:500-505): ``min(count, 255)``, f32."""
    lin, _ = splat_indices(pr_x, pr_y, mask, scale, x_sh, y_sh, w_dyn,
                           h_dyn, H, W)
    _, acc_c = scatter_fixed(lin, torch.zeros_like(pr_x), H, W)
    return torch.clamp(box_filter(acc_c.to(torch.float32), scale),
                       max=255.0)
