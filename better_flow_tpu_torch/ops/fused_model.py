"""The kernels of the port: wrappers, plain twins and launch counts.

Each ``*_call`` checks its tensors and then, for tensors on the card,
launches the hand-written CUDA kernel of ``csrc/`` (and raises if the
launch fails); for tensors on the CPU it returns its ``*_plain`` twin,
which is the same function in plain PyTorch.  ``LAUNCHES`` counts the
kernel launches of each wrapper.

The wrappers replace the functions of the same name in
``better_flow_tpu/ops/pallas/fused_model.py``: ``act_rows_call``,
``warp_images_st_call``, ``megastep_finish_call``, ``warp_uv_call``,
``megastep_call``, ``splat_local_call``, ``finish_local_call`` and
``megastep2_call``; and, without the ``_call``, ``fused_warp_splat``,
``fused_warp_splat_images``, ``finish_partials``, ``fused_model_partials``
and ``fused_model_partials_windowed``.

Images.  The splats accumulate the time image as int64 fixed point
(``FIXED_PER_SEC`` units per second) and the count image as int32, so that
the card's atomic accumulation is exact and the same on every run (see
csrc/warp_images_st.cu); ``time_image_f32`` gives the f32 time image that
the JAX kernel returns.  The pair is its caller's (``image_pair``) and
zero when a splat starts: ``warp_images_st_call`` (B1) and
``fused_warp_splat_images_call`` (B7a) add into it, ``sum_images`` sums it
across ranks in place, and ``megastep_finish_call`` (B2) and
``finish_partials_call`` (B7b) read it and leave it zero;
``megastep2_call`` (B12) reads it, leaves it zero and splats into it.
B10 and B11 splat into a workspace pair of their own and leave it zero in
the same launch (a launch the card refuses runs nothing).  An integer sum
is exact whatever the order and the number of launches, shards and ranks.
The plain twins keep the same contract on the CPU.  The tiled
pipeline holds a batch of such pairs, one a tile (``image_pair(...,
n_tiles=)``), for a whole run: ``splat_local_call`` (B8) adds into it (and
the halo fold-in and escape lane, exactly), ``finish_local_call`` (B9)
reads it and leaves it zero.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from better_flow_tpu_torch.config import NONZERO_EPS
from better_flow_tpu_torch.ops.layout import (
    CHUNK, ST_CNT, ST_CONT, ST_CX, ST_CY, ST_DDIV, ST_FB, ST_HAS, ST_ITERS,
    ST_PD, ST_RDIV, ST_SIZE, ST_SL, ST_TDIV, ST_TDX, ST_TDY, ST_TROT,
    ST_XDIV, ST_YDIV, padded_image_shape,
)
from better_flow_tpu_torch.ops.reductions import model_compute_partial
from better_flow_tpu_torch.ops.warp import (
    UV_K, cos_sin_f32, fma, mul_recip, project_4param_reinit,
    project_4param_reinit_cs, recip,
)

FIXED_PER_SEC = 2.0 ** 32

LAUNCHES = {"act_rows": 0, "warp_images_st": 0, "megastep_finish": 0,
            "warp_uv": 0, "megastep": 0, "fused_warp_splat": 0,
            "fused_warp_splat_images": 0, "finish_partials": 0,
            "splat_local": 0, "finish_local": 0, "fused_model_partials": 0,
            "fused_model_partials_windowed": 0, "megastep2": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- checks


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_aligned(name, t: torch.Tensor) -> None:
    """For a kernel that loads or stores ``t`` 16 bytes at a time."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _on_cpu(device: torch.device) -> bool:
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def _pair_shape(H: int, W: int, n_tiles=None):
    HP, WP = padded_image_shape(H, W)
    return (HP, WP) if n_tiles is None else (n_tiles, HP, WP)


def _check_pair(acc_t, acc_c, H: int, W: int, device, n_tiles=None) -> None:
    shape = _pair_shape(H, W, n_tiles)
    _check("acc_t", acc_t, torch.int64, shape, device)
    _check("acc_c", acc_c, torch.int32, shape, device)


def image_pair(device, H: int, W: int, n_tiles=None):
    """A zero image pair for ``H`` x ``W`` images on ``device``: the (HP,
    WP) int64 fixed-point time image and int32 count image that B1 and B7a
    add into, B2 and B7b read and leave zero, and B12 reads, leaves zero and
    splats into.  With ``n_tiles``, (n_tiles, HP, WP): one pair a tile, which
    B8 adds into and B9 reads and leaves zero."""
    shape = _pair_shape(H, W, n_tiles)
    return (torch.zeros(shape, dtype=torch.int64, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


# ------------------------------------------------------------ B3 act rows


def history_noise(sidx: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """(..., n) bool: the original index ``sidx`` lies inside a gated
    [start, end] of the (..., 3, K) window-gate history [gate fired, start,
    end]; leading axes (slices) broadcast."""
    s = sidx[..., None]
    h = hist[..., None, :, :]
    return ((h[..., 0, :] > 0) & (s >= h[..., 1, :])
            & (s <= h[..., 2, :])).any(dim=-1)


def act_rows_plain(sidx: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """(..., nch, 1, CHUNK) f32: 1 where ``sidx`` (..., capp) is >= 0 and
    the original index is outside every gated [start, end] of the
    (..., 3, K) history [gate fired, start, end]."""
    return ((sidx >= 0) & ~history_noise(sidx, hist)).to(
        torch.float32).reshape(*sidx.shape[:-1], sidx.shape[-1] // CHUNK, 1,
                               CHUNK)


def act_rows_call(sidx: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Activity rows.  One slice: ``sidx`` the (capp,) int32 original index
    slab (-1 on padding, capp a CHUNK multiple) and ``hist`` the (3, K)
    int32 window-gate history [fired, start, end] of the last K slices give
    (capp // CHUNK, 1, CHUNK) f32.  A staged range: ``sidx`` (S, capp) and
    ``hist`` (S, 3, K), slice s's history at s, give (S, capp // CHUNK, 1,
    CHUNK) in one launch.  The result holds 4 B a slot: beside the 12 B of
    the staged ``stat``, 24.6 MB for a 2M-event scan's 100 slices of
    61,440 slots."""
    dev = sidx.device
    batched = sidx.dim() == 2
    n = sidx.shape[-1] if sidx.dim() in (1, 2) else -1
    S = sidx.shape[0] if batched else 1
    if n % CHUNK != 0 or n <= 0:
        raise ValueError(f"sidx: shape {tuple(sidx.shape)}, expected "
                         f"([S,] k*{CHUNK})")
    K = hist.shape[-1] if hist.dim() == sidx.dim() + 1 else -1
    lead = (S,) if batched else ()
    _check("sidx", sidx, torch.int32, lead + (n,), dev)
    _check("hist", hist, torch.int32, lead + (3, K), dev)
    if _on_cpu(dev):
        return act_rows_plain(sidx, hist)
    out = torch.empty(lead + (n // CHUNK, 1, CHUNK), dtype=torch.float32,
                      device=dev)
    if S == 0:
        return out
    _check_aligned("sidx", sidx)
    from better_flow_tpu_torch.ops._build import library

    rc = library().bf_act_rows(_ptr(sidx), _ptr(hist), K, S, n, _ptr(out),
                               _stream(dev))
    _launch("act_rows", rc)
    return out


# --------------------------------------------------- B1 warp + splat


def _warp_args(st):
    """Warp scalars from the state, sign pattern of optimizer_rolling.h:340."""
    return (-st[0, ST_TDX], -st[0, ST_TDY], st[0, ST_CX], st[0, ST_CY],
            st[0, ST_TDIV], -st[0, ST_TROT])


def to_fixed(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v.to(torch.float64) * FIXED_PER_SEC).to(torch.int64)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def time_image_f32(acc_t: torch.Tensor) -> torch.Tensor:
    """The f32 time image (seconds) of an int64 fixed-point one."""
    return (acc_t.to(torch.float64) / FIXED_PER_SEC).to(torch.float32)


def _splat_plain(t_sec, act, prx, pry, geo, *, scale: int, H: int, W: int,
                 time_lo: bool):
    """Splat the warped positions (prx, pry) (nch, CHUNK) of events with
    times ``t_sec`` (nch, CHUNK) in seconds and activity ``act`` (nch,
    CHUNK) inside the dynamic window of ``geo[0, 0:4]``: the int64
    fixed-point time image and the int32 count image."""
    HP, WP = padded_image_shape(H, W)
    nch = t_sec.shape[0]
    half = scale // 2
    x_sh, y_sh, wd, hd = geo[0, 0], geo[0, 1], geo[0, 2], geo[0, 3]
    fscale = torch.full((), float(scale), device=t_sec.device)
    ix = fma(prx, fscale, x_sh).to(torch.int32)   # toward zero
    iy = fma(pry, fscale, y_sh).to(torch.int32)
    ok = ((act > 0)
          & (ix >= half) & (ix.to(torch.float32) < wd + half)
          & (iy >= half) & (iy.to(torch.float32) < hd + half))
    t0 = t_sec[:, :1]
    tr = t_sec - t0
    w_hi = _bf16(tr)
    fixed = to_fixed(t0).expand(nch, CHUNK) + to_fixed(w_hi)
    if time_lo:
        fixed = fixed + to_fixed(_bf16(tr - w_hi))
    # Rejected events add into a dump slot past the image.
    lin = torch.where(ok, ix.to(torch.int64) * WP + iy, HP * WP).reshape(-1)
    acc_t = torch.zeros(HP * WP + 1, dtype=torch.int64, device=t_sec.device)
    acc_c = torch.zeros(HP * WP + 1, dtype=torch.int32, device=t_sec.device)
    acc_t.index_add_(0, lin, fixed.reshape(-1))
    acc_c.index_add_(0, lin, torch.ones_like(lin, dtype=torch.int32))
    return (acc_t[:-1].reshape(HP, WP).contiguous(),
            acc_c[:-1].reshape(HP, WP).contiguous())


def _passes_through(st, predicated: int) -> bool:
    """The predicated mode's test: a state whose CONT is not set."""
    return bool(predicated) and not bool(st[0, ST_CONT] > 0)


def warp_images_st_plain(stat, act, pr, st, geo, acc_t, acc_c, *,
                         scale: int, H: int, W: int, time_lo: bool = True,
                         predicated: int = 0):
    """The twin of B1: the warp from the state, then the splat added into
    the pair (acc_t, acc_c) in place; with ``predicated``, a state whose
    CONT is not set passes ``pr`` through and adds nothing."""
    if _passes_through(st, predicated):
        return pr.clone(), acc_t, acc_c
    prx, pry, _, _ = project_4param_reinit(
        stat[:, 0], stat[:, 1], stat[:, 2], pr[:, 0], pr[:, 1],
        *_warp_args(st))
    t, c = _splat_plain(mul_recip(stat[:, 2], 1e9), act[:, 0], prx, pry, geo,
                        scale=scale, H=H, W=W, time_lo=time_lo)
    acc_t += t
    acc_c += c
    return torch.stack([prx, pry], dim=1), acc_t, acc_c


def warp_images_st_call(stat, act, pr, st, geo, acc_t, acc_c, *, scale: int,
                        H: int, W: int, time_lo: bool = True,
                        predicated: int = 0):
    """Warp every event from the state ``st`` and add its splat into the
    caller's pair ``acc_t`` (HP, WP) int64 fixed point, ``acc_c`` (HP, WP)
    int32 (``image_pair``), which is zero at an iteration's first launch;
    one launch may cover all of a process's shards.  Returns (new_pr (nch,
    2, CHUNK) f32, acc_t, acc_c), the pair being the caller's own
    tensors.  On the card one ordinary launch, one slot a thread, the warp
    scalars computed once a block (B5's splat phase).  With
    ``predicated`` (the unrolled drive of ``megastep_unroll``), a state
    whose CONT is not set passes ``pr`` through into ``new_pr`` and adds
    nothing to the pair; the card reads the flag itself, the host never
    does."""
    dev = stat.device
    nch = stat.shape[0]
    _check("stat", stat, torch.float32, (nch, 3, CHUNK), dev)
    _check("act", act, torch.float32, (nch, 1, CHUNK), dev)
    _check("pr", pr, torch.float32, (nch, 2, CHUNK), dev)
    _check("st", st, torch.float32, (1, ST_SIZE), dev)
    _check("geo", geo, torch.float32, (1, 8), dev)
    _check_pair(acc_t, acc_c, H, W, dev)
    if _on_cpu(dev):
        return warp_images_st_plain(stat, act, pr, st, geo, acc_t, acc_c,
                                    scale=scale, H=H, W=W, time_lo=time_lo,
                                    predicated=predicated)
    from better_flow_tpu_torch.ops._build import library

    _, WP = padded_image_shape(H, W)
    npr = torch.empty_like(pr)
    rc = library().bf_warp_images_st(
        _ptr(geo), _ptr(st), _ptr(stat), _ptr(act), _ptr(pr), _ptr(npr),
        _ptr(acc_t), _ptr(acc_c), nch, WP, scale, int(time_lo),
        int(bool(predicated)), _stream(dev))
    _launch("warp_images_st", rc)
    return npr, acc_t, acc_c


# ------------------------------------------- B2 finish + model update


def _shift(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """``out[i] = a[i - d]`` along ``axis``, zero where i - d is outside."""
    out = torch.zeros_like(a)
    n = a.shape[axis]
    src = a.narrow(axis, max(0, -d), n - abs(d))
    out.narrow(axis, max(0, d), n - abs(d)).copy_(src)
    return out


def finish_values_plain(acc_t, acc_c, *, scale: int, H: int, W: int,
                        shift=_shift, own=None):
    """Box filter, normalise, mask to H x W, all-nine mask, Scharr and the
    seven sums (cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg) as a (7,) f32
    tensor.  The sums are taken in f64 and rounded to f32 once, as the
    kernel takes them; ``shift(a, d, axis)`` moves ``a`` by ``d`` (the
    kernel's zero padding by default; a circular roll gives the TPU
    kernel's arithmetic).  ``own`` = (r0, r1, c0, c1) restricts the sums to
    that window of the image; the stencils still read all of it."""
    HP, WP = acc_t.shape
    half = scale // 2
    a_t = time_image_f32(acc_t)
    a_c = acc_c.to(torch.float32)

    def box(a):
        r = a
        for d in range(1, half + 1):
            r = r + shift(a, -d, 0) + shift(a, d, 0)
        out = r
        for d in range(1, half + 1):
            out = out + shift(r, -d, 1) + shift(r, d, 1)
        return out

    t_box, c_box = (box(a_t), box(a_c)) if scale > 1 else (a_t, a_c)
    img = torch.where(c_box >= 1, t_box / torch.clamp(c_box, min=1.0),
                      torch.zeros_like(t_box))
    rr = torch.arange(HP, device=img.device)[:, None]
    cc = torch.arange(WP, device=img.device)[None, :]
    img = torch.where((rr < H) & (cc < W), img, torch.zeros_like(img))

    nz = img > NONZERO_EPS
    col_and = nz & shift(nz, -1, 1) & shift(nz, 1, 1)
    allnine = col_and & shift(col_and, -1, 0) & shift(col_and, 1, 0)
    # 3*img[-1] + 10*img + 3*img[+1], fused as XLA compiles it:
    # fma(3, img[+1], fma(3, img[-1], 10*img)).
    three = torch.full((), 3.0, device=img.device)
    ten_img = 10.0 * img
    col_smooth = fma(three, shift(img, -1, 1),
                     fma(three, shift(img, 1, 1), ten_img))
    gx = shift(col_smooth, 1, 0) - shift(col_smooth, -1, 0)
    row_smooth = fma(three, shift(img, -1, 0),
                     fma(three, shift(img, 1, 0), ten_img))
    gy = shift(row_smooth, 1, 1) - shift(row_smooth, -1, 1)
    zero = torch.zeros_like(img)
    if own is not None:
        r0, r1, c0, c1 = own
        owned = (rr >= r0) & (rr < r1) & (cc >= c0) & (cc < c1)
        img = torch.where(owned, img, zero)
        allnine = allnine & owned
    # The all-nine mask implies the centre mask, so the masked gradients
    # are the sums' integrands.
    return model_compute_partial(img, torch.where(allnine, gx, zero),
                                 torch.where(allnine, gy, zero))


def _rdxy(st, base):
    """Slots (base+2, base+3, base, base+1): the (rot, div, dx, dy) order of
    the totals, compensations, dividers and gradients."""
    return torch.cat([st[0, base + 2:base + 4], st[0, base:base + 2]])


def _put_rdxy(out, base, v):
    out[0, base:base + 2] = v[2:4]
    out[0, base + 2:base + 4] = v[0:2]


def _update_params(schedule, rot_tol, div_tol, dx_tol, dy_tol, xy_cap,
                   rotdiv_cap, max_iter, hard_cap, exit_grad, exit_pred):
    """The scalar update's parameters, each product taken in f64 and
    rounded to f32 once (as the JAX kernel's constants are)."""
    if schedule not in ("fast", "reference"):
        raise NotImplementedError(f"schedule={schedule!r}")
    tol = (rot_tol, div_tol, dx_tol, dy_tol)
    return dict(
        fast=schedule == "fast", use_grad=exit_grad > 0,
        use_pred=exit_pred > 0, max_iter=int(max_iter),
        hard_cap=int(hard_cap), tol=tol, tol4=tuple(4.0 * t for t in tol),
        grad_tol=tuple(exit_grad * t for t in tol),
        pred_tol=tuple(exit_pred * t for t in tol),
        xy_cap=xy_cap, rotdiv_cap=rotdiv_cap,
    )


def _c_params(statics: dict):
    """The ``bf::UpdateParams`` struct of ``statics``."""
    from better_flow_tpu_torch.ops._build import UpdateParams

    p = _update_params(**statics)
    f4 = ctypes.c_float * 4
    return UpdateParams(
        int(p["fast"]), int(p["use_grad"]), int(p["use_pred"]),
        p["max_iter"], p["hard_cap"], f4(*p["tol"]), f4(*p["tol4"]),
        f4(*p["grad_tol"]), f4(*p["pred_tol"]), p["xy_cap"],
        p["rotdiv_cap"])


_WORKSPACE: dict = {}


def _workspace(dev: torch.device, H: int, W: int) -> dict:
    """Scratch of the finish passes, one set per device and image shape,
    allocated at first use: the (H, 9) f64 row sums and the image pair of
    B10 and B11, made zero (their launch leaves it zero, and a launch the
    card refuses runs nothing).  The kernels run in stream order and no
    scratch is returned to a caller, so one set serves every call (B5 and
    B6 splat into their own pair, ``_images``; B1, B2, B7a, B7b and B12
    work on the pair their caller owns)."""
    key = (dev, H, W)
    if key not in _WORKSPACE:
        acc_t, acc_c = image_pair(dev, H, W)
        _WORKSPACE[key] = dict(
            partials=torch.empty((H, 9), dtype=torch.float64, device=dev),
            acc_t=acc_t, acc_c=acc_c)
    return _WORKSPACE[key]


# Band geometry of the cooperative kernels (csrc/iteration.cuh's
# BandLayout; a CPU test parses the header's constants).
BAND_THREADS = 256
BAND_SMEM_BUDGET = 231_424          # 227 KB less 1 KB of static shared
_BAND_LEAF_BYTES = 9 * BAND_THREADS * 8
# At most three rows a band: against 1, 2, 4, 5 and 6 rows at 543x723
# (scale 3) and 721x1281 (scale 1), three were the fastest on the H100
# at both (chip_smoke.py's sweep_band_rows; PERF.md).
BAND_MAX_ROWS = 3
H100_SMS = 132


def _round4(v: int) -> int:
    return (v + 3) & ~3


def band_smem_bytes(R: int, W: int, scale: int) -> int:
    """Dynamic shared bytes of a band of ``R`` rows of a width-``W`` image
    at ``scale``: the staged time and count rows (R + 2 + 2 * half,
    ``scale // 2`` columns of margin) or the R rows' leaves of the nine
    sums, whichever is larger (they share the space), and the R + 2
    normalised f32 rows (one column of margin)."""
    half = scale // 2
    sw = _round4(_round4(W + half) + 2 * half)
    iw = _round4(W + 2)
    ns = R + 2 + 2 * half
    return max(8 * ns * sw, R * _BAND_LEAF_BYTES) + 4 * (R + 2) * iw


def band_rows(H: int, W: int, scale: int, sms: int = H100_SMS,
              n_tiles: int = 1):
    """(R, dynamic shared bytes) of the band pass of B2, B5, B6, B7b, B9
    and B12 over ``n_tiles`` images of ``H`` rows (B9's batch; the bands
    of one tile never hold another's rows): the largest R up to
    ``BAND_MAX_ROWS`` that still gives at least one band per SM and fits the
    shared-memory budget, else 1.  Raises when one row does not fit."""
    if band_smem_bytes(1, W, scale) > BAND_SMEM_BUDGET:
        raise ValueError(f"a band of one row of width {W} at scale {scale} "
                         f"needs {band_smem_bytes(1, W, scale)} bytes of "
                         f"shared memory, over {BAND_SMEM_BUDGET}")
    R = 1
    while (R < BAND_MAX_ROWS and n_tiles * -(-H // (R + 1)) >= sms
           and band_smem_bytes(R + 1, W, scale) <= BAND_SMEM_BUDGET):
        R += 1
    return R, band_smem_bytes(R, W, scale)


_SMS: dict = {}


def _device_bands(dev: torch.device, H: int, W: int, scale: int,
                  n_tiles: int = 1):
    """``band_rows`` with the device's SM count."""
    if dev not in _SMS:
        props = torch.cuda.get_device_properties(dev)
        _SMS[dev] = props.multi_processor_count
    return band_rows(H, W, scale, _SMS[dev], n_tiles)


_IMAGES: dict = {}


def _images(dev: torch.device, H: int, W: int):
    """The image pair of B5 and B6, one per device and image shape: the
    (HP, WP) int64 fixed-point time and int32 count images, made zero.  A
    call splats into them and leaves them zero (the blocks that do not run
    its tail zero them), so they are zero at every call's start; a launch
    the card refuses runs nothing.  No other kernel touches them."""
    key = (dev, H, W)
    if key not in _IMAGES:
        _IMAGES[key] = image_pair(dev, H, W)
    return _IMAGES[key]


def iteration_grid(kernel: str, dev: torch.device, H: int, W: int,
                   scale: int, n_tiles: int = 1):
    """(R, resident grid) of B2 (``"megastep_finish"``), B5
    (``"megastep"``), B6 (``"fused_warp_splat"``), B7b
    (``"finish_partials"``), B9 (``"finish_local"``, over ``n_tiles``),
    B10/B11 (``"fused_model_partials"``) or B12 (``"megastep2"``) at this
    image shape on ``dev``."""
    from better_flow_tpu_torch.ops._build import library

    R, smem = _device_bands(dev, H, W, scale, n_tiles)
    with torch.cuda.device(dev):
        return R, getattr(library(), f"bf_{kernel}_grid")(smem)


def model_update_plain(vals, st, geo, *, scale: int, params: dict):
    """_model_update_phase on the seven sums ``vals``: the next (1, 32)
    state.  Components run as (rot, div, dx, dy) 4-vectors."""
    p = params
    dev = st.device
    vec = lambda xs: torch.tensor(xs, dtype=torch.float32, device=dev)
    cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg = vals.unbind()
    denom = torch.clamp(cnt, min=1.0)
    cx_img = s_row / denom
    cy_img = s_col / denom
    # The centroid corrections are fused multiply-adds, as XLA compiles them.
    g_rot = fma(cy_img, s_gx, fma(-cx_img, s_gy, s_rg)) / denom
    g_div = fma(-cy_img, s_gy, fma(-cx_img, s_gx, s_dg)) / denom
    g = torch.stack([g_rot, g_div, s_gx / denom, s_gy / denom])

    divs = _rdxy(st, 10)
    pg = _rdxy(st, 24)
    pd = st[0, ST_PD:ST_PD + 4]
    psl = st[0, ST_SL:ST_SL + 4]
    ref = g / divs
    if p["fast"]:
        slope2 = (g - pg) / pd
        valid2 = (pd.abs() > 0) & torch.isfinite(slope2) & (slope2 < 0)
        sl = torch.where(valid2, slope2, psl)
        newton = (-0.9 * g) / sl
        lim = torch.where(valid2, vec([4.0] * 4), vec([1.0] * 4)) * ref.abs()
        okp = (sl < 0) & torch.isfinite(newton)
        d = torch.where(okp, torch.minimum(torch.maximum(newton, -lim), lim),
                        ref)
    else:
        d = ref
        sl = torch.zeros_like(ref)

    total = _rdxy(st, 0)
    y = d - _rdxy(st, 4)
    t = total + y
    comp = (t - total) - y
    divs = torch.where((pd.abs() > 0) & (g * pg < 0), divs * 2.0, divs)

    new_iters = st[0, ST_ITERS] + 1.0
    over_max = (p["max_iter"] > 0) & (new_iters > float(p["max_iter"]))
    under_cap = new_iters < float(p["hard_cap"])
    tol = vec(p["tol"])
    gref = (g / divs).abs()
    if p["fast"]:
        ref_small = (gref < vec(p["tol4"])).all()
        sm = d.abs() < tol
        if p["use_grad"]:
            sm = sm & (gref < vec(p["grad_tol"]))
        if p["use_pred"]:
            g_pred = fma(psl, pd, pg)
            relerr = (g - g_pred).abs() / torch.clamp(pg.abs(), min=1e-30)
            png = fma(sl, d, g)
            pnd = (0.9 * png / torch.where(sl < 0, sl, vec([-1e-30] * 4))).abs()
            pngr = png.abs() / divs
            sm = sm | ((pd.abs() > 0) & (relerr < 0.75) & (sl < 0)
                       & (pnd < tol) & (pngr < tol)
                       & (d.abs() < vec(p["pred_tol"])))
        small = sm.all() & ((new_iters >= 2.0) | ref_small)
        cont = ~small & ~over_max & under_cap
    else:
        caps = vec([p["rotdiv_cap"]] * 2 + [p["xy_cap"]] * 2)
        small = (gref < tol).all()
        cont = (divs < caps).any() & ~small & ~over_max & under_cap

    out = st.clone()
    _put_rdxy(out, 0, t)
    _put_rdxy(out, 4, comp)
    _put_rdxy(out, 10, divs)
    _put_rdxy(out, 24, g)
    out[0, ST_CX] = (cx_img - geo[0, 0]) * recip(scale)
    out[0, ST_CY] = (cy_img - geo[0, 1]) * recip(scale)
    out[0, ST_SL:ST_SL + 4] = sl
    out[0, ST_PD:ST_PD + 4] = d
    out[0, ST_ITERS] = new_iters
    out[0, ST_CONT] = cont.to(torch.float32)
    out[0, ST_CNT] = cnt
    out[0, ST_FB] = st[0, ST_FB]
    out[0, ST_HAS] = st[0, ST_HAS]
    out[0, 31] = 0.0
    return out


def megastep_finish_plain(acc_t, acc_c, st, geo, *, scale: int, H: int,
                          W: int, predicated: int = 0, **statics):
    """The twin of B2: the finish and the scalar update; then the pair is
    cleared, as the kernel leaves it.  With ``predicated``, a state whose
    CONT is not set is returned as a copy and the pair is left as it
    is."""
    if _passes_through(st, predicated):
        return st.clone()
    vals = finish_values_plain(acc_t, acc_c, scale=scale, H=H, W=W)
    acc_t.zero_()
    acc_c.zero_()
    return model_update_plain(vals, st, geo, scale=scale,
                              params=_update_params(**statics))


def megastep_finish_call(acc_t, acc_c, st, geo, *, scale: int, H: int,
                         W: int, schedule: str, rot_tol: float,
                         div_tol: float, dx_tol: float, dy_tol: float,
                         xy_cap: float, rotdiv_cap: float, max_iter: int,
                         hard_cap: int, exit_grad: float = 0.0,
                         exit_pred: float = 0.0, predicated: int = 0):
    """Finish + model update on the pair that ``warp_images_st_call``
    filled (and, under an event group, the seam summed), in one cooperative
    launch that leaves the pair zero for the next iteration.  Returns the
    next (1, 32) state, bitwise ``megastep_call``'s on the same events.  A
    launch the card refuses raises and leaves the pair as it was.  With
    ``predicated``, a state whose CONT is not set comes back unchanged (a
    copy) and the pair is left as it is, which the predicated B1 before it
    left zero; the card reads the flag itself."""
    statics = dict(schedule=schedule, rot_tol=rot_tol, div_tol=div_tol,
                   dx_tol=dx_tol, dy_tol=dy_tol, xy_cap=xy_cap,
                   rotdiv_cap=rotdiv_cap, max_iter=max_iter,
                   hard_cap=hard_cap, exit_grad=exit_grad,
                   exit_pred=exit_pred)
    dev = acc_t.device
    _check_pair(acc_t, acc_c, H, W, dev)
    _check("st", st, torch.float32, (1, ST_SIZE), dev)
    _check("geo", geo, torch.float32, (1, 8), dev)
    if _on_cpu(dev):
        return megastep_finish_plain(acc_t, acc_c, st, geo, scale=scale,
                                     H=H, W=W, predicated=predicated,
                                     **statics)
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    R, smem = _device_bands(dev, H, W, scale)
    cp = _c_params(statics)
    st_out = torch.empty_like(st)
    rc = library().bf_megastep_finish(
        _ptr(acc_t), _ptr(acc_c), _ptr(st), _ptr(geo), _ptr(st_out),
        _ptr(_workspace(dev, H, W)["partials"]), HP, WP, H, W, scale, R,
        smem, int(bool(predicated)), ctypes.byref(cp), _stream(dev))
    _launch("megastep_finish", rc)
    return st_out


# ----------------------------------------- the split drive's planned trips


def plans_trips(device: torch.device) -> bool:
    """The single-device split drive's trips on ``device`` run from a
    launch plan (``TripPlan``): on the card; the CPU's twins run through
    the wrappers."""
    return device.type == "cuda"


_TRIP_SYNC: dict = {}


def _trip_sync(dev: torch.device):
    """The pinned (2,) f32 host slot that a planned trip copies the state's
    [ITERS, CONT] into, and the event recorded after the copy: one pair
    per device and thread, made at first use (a pinned allocation takes
    milliseconds) and shared by the thread's plans on the device, whose
    trips run one at a time (each waits for its slot before the next is
    enqueued)."""
    key = (dev, threading.get_ident())
    if key not in _TRIP_SYNC:
        from better_flow_tpu_torch.ops._build import library

        slot = torch.zeros(2, dtype=torch.float32, pin_memory=True)
        event = ctypes.c_void_p()
        with torch.cuda.device(dev):
            rc = library().bf_trip_event(ctypes.byref(event))
        if rc != 0:
            raise RuntimeError(f"trip event: CUDA error {rc}")
        _TRIP_SYNC[key] = (slot, event.value)
    return _TRIP_SYNC[key]


class TripPlan:
    """The launch plan of the single-device split drive on the card: a
    trip (``megastep_unroll`` B1 + B2 pairs, predicated past one, then the
    copy of the last state's [ITERS, CONT] into a pinned slot) is one call
    of ``bf_trip`` (csrc/trip.cu), and its exit read one wait on an event.
    Made once per drive call, or once per slice range of the scan's loop,
    on the device of the image pair, it holds what the trips share: B1's
    and B2's arguments but the slice's, the pair, B2's row sums
    (``_workspace``), the scalar update's parameters, the stream current
    when it is made, two position buffers and two state rows that the
    pairs write in turn (the wrappers' per-pair allocations), the slot and
    event of the device and thread (``_trip_sync``).
    ``start`` checks and sets a drive call's slice and start; ``trip``
    launches; ``wait`` blocks and returns (ITERS, CONT); ``final`` gives
    the last pair's positions and state.  The launches, their arguments
    and their order are the wrappers', so the outputs are bitwise theirs;
    ``LAUNCHES`` counts each kernel launched."""

    def __init__(self, nch: int, acc_t, acc_c, *, scale: int, H: int,
                 W: int, time_lo: bool, unroll: int, statics: dict):
        from better_flow_tpu_torch.ops._build import TripArgs, library

        dev = acc_t.device
        _check_pair(acc_t, acc_c, H, W, dev)
        HP, WP = padded_image_shape(H, W)
        R, smem = _device_bands(dev, H, W, scale)
        slot, event = _trip_sync(dev)
        self.dev, self.nch, self.unroll = dev, nch, unroll
        self.pr = [torch.empty((nch, 2, CHUNK), dtype=torch.float32,
                               device=dev) for _ in range(2)]
        self.st = [torch.empty((1, ST_SIZE), dtype=torch.float32,
                               device=dev) for _ in range(2)]
        partials = _workspace(dev, H, W)["partials"]
        self._keep = (acc_t, acc_c, partials, slot)
        self._args = TripArgs(
            acc_t=acc_t.data_ptr(), acc_c=acc_c.data_ptr(),
            pr=(ctypes.c_void_p * 2)(*(t.data_ptr() for t in self.pr)),
            st=(ctypes.c_void_p * 2)(*(t.data_ptr() for t in self.st)),
            partials=partials.data_ptr(), slot=slot.data_ptr(), event=event,
            stream=_stream(dev), nch=nch, HP=HP, WP=WP, H=H, W=W,
            scale=scale, rows=R, smem=smem, time_lo=int(time_lo),
            unroll=unroll, predicated=int(unroll > 1),
            params=_c_params(statics))
        self._ref = ctypes.byref(self._args)
        self._slot = (ctypes.c_float * 2).from_address(slot.data_ptr())
        self._lib = library()
        self._slice = ()
        self.done = 0          # pairs launched in this drive call

    def start(self, stat, act, geo, pr0, st0) -> None:
        """A drive call on ``stat``, ``act``, ``geo`` from the positions
        ``pr0`` and the state ``st0``, which the trips read and never
        write."""
        dev, nch = self.dev, self.nch
        _check("stat", stat, torch.float32, (nch, 3, CHUNK), dev)
        _check("act", act, torch.float32, (nch, 1, CHUNK), dev)
        _check("pr", pr0, torch.float32, (nch, 2, CHUNK), dev)
        _check("st", st0, torch.float32, (1, ST_SIZE), dev)
        _check("geo", geo, torch.float32, (1, 8), dev)
        a = self._args
        a.geo, a.stat, a.act, a.pr0, a.st0 = (
            t.data_ptr() for t in (geo, stat, act, pr0, st0))
        self._slice = (geo, stat, act, pr0, st0)
        self.done = 0

    def trip(self) -> None:
        rc = self._lib.bf_trip(self._ref, self.done)
        if rc != 0:
            raise RuntimeError(f"trip: CUDA launch failed with error {rc}")
        self.done += self.unroll
        LAUNCHES["warp_images_st"] += self.unroll
        LAUNCHES["megastep_finish"] += self.unroll

    def wait(self):
        """(ITERS, CONT) of the last trip's state, once it is written."""
        rc = self._lib.bf_trip_wait(self._ref)
        if rc != 0:
            raise RuntimeError(f"trip wait: CUDA error {rc}")
        return self._slot[0], self._slot[1]

    def final(self):
        """The last pair's (positions, state): the plan's buffers, which
        the next drive call on this plan overwrites."""
        k = (self.done - 1) & 1
        return self.pr[k], self.st[k]


# ------------------------------------------------------ B4 final warp


class Handoff(NamedTuple):
    """B4's optional hand-off from one slice to the next
    (``warp_uv_call``'s ``handoff``): the tensors it writes, the slice's
    start state it reads, and the constants of the next start state."""

    st_next: torch.Tensor    # (1, 32) f32, written: the next start state
    seed_next: torch.Tensor  # (12,) f32, written: the next seed row
    st_in: torch.Tensor      # (1, 32) f32, read: this slice's start state
    xy_div: float            # OptimizerConfig.init_xy_divider
    rotdiv_div: float        # OptimizerConfig.init_rotdiv_divider
    slope: bool              # carry the slope memory (the fast schedule)


# The start-state slots copied from the final state: the totals, the
# compensations, the centroid and the count.
_HANDOFF_COPY = list(range(ST_CY + 1)) + [ST_CNT]


def handoff_plain(st, h: Handoff) -> None:
    """The twin of B4's hand-off: ``h.st_next`` becomes
    ``global_flow.initial_state`` of the model in ``st`` (and of its slope
    memory under ``h.slope``), ``h.seed_next`` the seed row [st's slope
    memory, st's last deltas, ``h.st_in``'s totals in (rot, div, dx, dy)
    order]."""
    keep = _HANDOFF_COPY + (list(range(ST_SL, ST_SL + 4)) if h.slope
                            else [])
    nxt = h.st_next
    nxt.zero_()
    nxt[0, keep] = st[0, keep]
    nxt[0, ST_XDIV:ST_YDIV + 1].fill_(h.xy_div)
    nxt[0, ST_RDIV:ST_DDIV + 1].fill_(h.rotdiv_div)
    nxt[0, ST_CONT].fill_(1.0)
    h.seed_next[0:4] = st[0, ST_SL:ST_SL + 4]
    h.seed_next[4:8] = st[0, ST_PD:ST_PD + 4]
    h.seed_next[8:12] = h.st_in[0, [ST_TROT, ST_TDIV, ST_TDX, ST_TDY]]


def warp_uv_plain(stat, pr, act, st, window_small: float = 0.0,
                  uvn_out=None, handoff: Optional[Handoff] = None,
                  out=None):
    prx, pry, nx, ny = project_4param_reinit(
        stat[:, 0], stat[:, 1], stat[:, 2], pr[:, 0], pr[:, 1],
        *_warp_args(st))
    out = torch.stack([prx, pry, nx, ny], dim=1, out=out)
    noise = torch.clamp(1.0 - act[:, 0], min=float(window_small))
    uvn = torch.stack([nx * UV_K, ny * UV_K, noise], dim=1, out=uvn_out)
    if handoff is not None:
        handoff_plain(st, handoff)
    return out, uvn


def warp_uv_call(stat, pr, act, st, window_small: float = 0.0,
                 uvn_out=None, handoff: Optional[Handoff] = None, out=None):
    """Final warp with the state's model.  Returns (out (nch, 4, CHUNK):
    [pr_x, pr_y, nx, ny], uvn (nch, 3, CHUNK): [u, v, noise]).  With
    ``uvn_out``, a contiguous (nch, 3, CHUNK) f32 tensor on the same
    device, the [u, v, noise] rows are written there and ``uvn`` is that
    very tensor (the scan passes its run's output at the slice); ``out``,
    a contiguous (nch, 4, CHUNK) f32 tensor, likewise takes [pr_x, pr_y,
    nx, ny] (a loop that reads none of it passes one for all its
    slices).  Under an
    event group ``stat``, ``pr`` and ``act`` may hold all the local shards'
    chunks in order: the warp is slot-wise, so one call gives the bits of
    one a shard.  With ``handoff`` (``Handoff``) the same launch also
    writes the next slice's start state and seed row from ``st``
    (``handoff_plain``), bitwise the copies and constants of
    ``global_flow.initial_state``; without it the launch is the plain
    final warp."""
    dev = stat.device
    nch = stat.shape[0]
    _check("stat", stat, torch.float32, (nch, 3, CHUNK), dev)
    _check("pr", pr, torch.float32, (nch, 2, CHUNK), dev)
    _check("act", act, torch.float32, (nch, 1, CHUNK), dev)
    _check("st", st, torch.float32, (1, ST_SIZE), dev)
    if uvn_out is not None:
        _check("uvn_out", uvn_out, torch.float32, (nch, 3, CHUNK), dev)
    if out is not None:
        _check("out", out, torch.float32, (nch, 4, CHUNK), dev)
    if handoff is not None:
        _check("st_next", handoff.st_next, torch.float32, (1, ST_SIZE), dev)
        _check("seed_next", handoff.seed_next, torch.float32, (12,), dev)
        _check("st_in", handoff.st_in, torch.float32, (1, ST_SIZE), dev)
    if _on_cpu(dev):
        return warp_uv_plain(stat, pr, act, st, window_small, uvn_out,
                             handoff, out)
    if out is None:
        out = torch.empty((nch, 4, CHUNK), dtype=torch.float32, device=dev)
    uvn = uvn_out if uvn_out is not None else torch.empty(
        (nch, 3, CHUNK), dtype=torch.float32, device=dev)
    from better_flow_tpu_torch.ops._build import library

    h = (None, None, None, 0.0, 0.0, 0) if handoff is None else (
        _ptr(handoff.st_in), _ptr(handoff.st_next), _ptr(handoff.seed_next),
        float(handoff.xy_div), float(handoff.rotdiv_div),
        int(bool(handoff.slope)))
    rc = library().bf_warp_uv(_ptr(stat), _ptr(pr), _ptr(act), _ptr(st),
                              float(window_small), _ptr(out), _ptr(uvn), nch,
                              *h, _stream(dev))
    _launch("warp_uv", rc)
    return out, uvn


# ------------------------------------------- B5 one whole iteration


def megastep_plain(stat, act, pr, st, geo, *, scale: int, H: int, W: int,
                   time_lo: bool = True, **statics):
    """The twin of B5: ``warp_images_st_plain`` into a zero pair, then
    ``megastep_finish_plain``.  Returns (new_pr, next state)."""
    npr, acc_t, acc_c = warp_images_st_plain(stat, act, pr, st, geo,
                                             *image_pair(stat.device, H, W),
                                             scale=scale, H=H, W=W,
                                             time_lo=time_lo)
    return npr, megastep_finish_plain(acc_t, acc_c, st, geo, scale=scale,
                                      H=H, W=W, **statics)


def megastep_call(stat, act, pr, st, geo, *, scale: int, H: int, W: int,
                  schedule: str, rot_tol: float, div_tol: float,
                  dx_tol: float, dy_tol: float, xy_cap: float,
                  rotdiv_cap: float, max_iter: int, hard_cap: int,
                  time_lo: bool = True, exit_grad: float = 0.0,
                  exit_pred: float = 0.0, grid_blocks: int = 0):
    """One whole optimizer iteration (warp + splat, finish, model update,
    exit test) in one cooperative launch.  Returns (new_pr (nch, 2, CHUNK)
    f32, next state (1, 32) f32), bitwise those of
    ``warp_images_st_call`` into a zero pair then ``megastep_finish_call``.
    ``grid_blocks`` > 0 asks for that many blocks instead of as many as can
    be resident; a launch the card refuses raises.  The band height and shared bytes
    come from ``band_rows``; it splats into the pair of ``_images``."""
    statics = dict(schedule=schedule, rot_tol=rot_tol, div_tol=div_tol,
                   dx_tol=dx_tol, dy_tol=dy_tol, xy_cap=xy_cap,
                   rotdiv_cap=rotdiv_cap, max_iter=max_iter,
                   hard_cap=hard_cap, exit_grad=exit_grad,
                   exit_pred=exit_pred)
    dev = stat.device
    nch = stat.shape[0]
    _check("stat", stat, torch.float32, (nch, 3, CHUNK), dev)
    _check("act", act, torch.float32, (nch, 1, CHUNK), dev)
    _check("pr", pr, torch.float32, (nch, 2, CHUNK), dev)
    _check("st", st, torch.float32, (1, ST_SIZE), dev)
    _check("geo", geo, torch.float32, (1, 8), dev)
    if _on_cpu(dev):
        return megastep_plain(stat, act, pr, st, geo, scale=scale, H=H, W=W,
                              time_lo=time_lo, **statics)
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    R, smem = _device_bands(dev, H, W, scale)
    cp = _c_params(statics)
    npr = torch.empty_like(pr)
    st_out = torch.empty_like(st)
    acc_t, acc_c = _images(dev, H, W)
    rc = library().bf_megastep(
        _ptr(geo), _ptr(st), _ptr(stat), _ptr(act), _ptr(pr), _ptr(npr),
        _ptr(st_out), _ptr(acc_t), _ptr(acc_c),
        _ptr(_workspace(dev, H, W)["partials"]), nch, HP, WP, H, W, scale,
        int(time_lo), R, smem, ctypes.byref(cp), int(grid_blocks),
        _stream(dev))
    _launch("megastep", rc)
    return npr, st_out


# ------------------------------------- B6 composed warp + splat + finish


def warp_scal_row(geo: torch.Tensor, model) -> torch.Tensor:
    """B6's (1, 16) f32 row [x_sh, y_sh, w_dyn, h_dyn, -total_dx,
    -total_dy, cx, cy, total_div, cos, sin, 0 x 5] for the (1, 8) geometry
    row ``geo`` and a ``core.model.MotionModel``, built on the device as the
    JAX wrapper builds it: each value rounded to f32 once, and cos and sin
    taken on ``crl = -total_rot`` in the carry's dtype (the f64 angle under
    f64 totals), each rounded to f32 once."""
    c, s = cos_sin_f32(-model.total_rot)
    vals = [-model.total_dx, -model.total_dy, model.cx, model.cy,
            model.total_div]
    return torch.cat([geo[0, 0:4],
                      torch.stack([v.to(torch.float32) for v in vals]
                                  + [c, s]),
                      torch.zeros(5, dtype=torch.float32, device=geo.device)]
                     ).reshape(1, 16)


def fused_warp_splat_images_plain(stat, act, pr, scal, acc_t, acc_c, *,
                                  scale: int, H: int, W: int):
    """The twin of B7a: the warp of ``warp_images_st_plain`` with the row's
    explicit scalars, then the hi+lo splat added into the pair (acc_t,
    acc_c) in place.  Returns (new_pr, acc_t, acc_c, 0)."""
    s = scal[0]
    prx, pry, _, _ = project_4param_reinit_cs(
        stat[:, 0], stat[:, 1], stat[:, 2], pr[:, 0], pr[:, 1], *s[4:11])
    t, c = _splat_plain(mul_recip(stat[:, 2], 1e9), act[:, 0], prx, pry,
                        scal, scale=scale, H=H, W=W, time_lo=True)
    acc_t += t
    acc_c += c
    return torch.stack([prx, pry], dim=1), acc_t, acc_c, 0


def finish_partials_plain(acc_t, acc_c, *, scale: int, H: int, W: int):
    """The twin of B7b: ``finish_values_plain`` with a zero eighth slot;
    then the pair is cleared, as the kernel leaves it."""
    vals = finish_values_plain(acc_t, acc_c, scale=scale, H=H, W=W)
    acc_t.zero_()
    acc_c.zero_()
    return torch.cat([vals, vals.new_zeros(1)])


def fused_warp_splat_plain(stat, act, pr, scal, *, scale: int, H: int,
                           W: int):
    """The twin of B6: B7a's twin into a zero pair, then B7b's.  Returns
    (new_pr, (8,) f32 [seven sums, 0])."""
    acc_t, acc_c = image_pair(stat.device, H, W)
    npr, *_ = fused_warp_splat_images_plain(stat, act, pr, scal, acc_t, acc_c,
                                            scale=scale, H=H, W=W)
    return npr, finish_partials_plain(acc_t, acc_c, scale=scale, H=H, W=W)


def fused_warp_splat_call(stat, act, pr, scal, *, scale: int, H: int,
                          W: int):
    """One iteration's event phase of the composed loop: warp every event
    with the (1, 16) row ``scal`` (``warp_scal_row``), splat the hi+lo time
    pair (always, as the TPU kernel does, whatever
    ``OptimizerConfig.splat_time_lo`` says), box filter, normalise, mask,
    Scharr and the seven partial sums.  Returns (new_pr (nch, 2, CHUNK)
    f32, (8,) f32 [cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg,
    fallback_chunks]).  ``fallback_chunks`` is always 0: it counts the TPU
    kernel's splat-window fallbacks, and the port's splat has no window
    (as ``ST_FB`` of the megastep state)."""
    dev = stat.device
    nch = stat.shape[0]
    _check("stat", stat, torch.float32, (nch, 3, CHUNK), dev)
    _check("act", act, torch.float32, (nch, 1, CHUNK), dev)
    _check("pr", pr, torch.float32, (nch, 2, CHUNK), dev)
    _check("scal", scal, torch.float32, (1, 16), dev)
    if _on_cpu(dev):
        return fused_warp_splat_plain(stat, act, pr, scal, scale=scale, H=H,
                                      W=W)
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    R, smem = _device_bands(dev, H, W, scale)
    npr = torch.empty_like(pr)
    out = torch.empty(8, dtype=torch.float32, device=dev)
    acc_t, acc_c = _images(dev, H, W)
    rc = library().bf_fused_warp_splat(
        _ptr(scal), _ptr(stat), _ptr(act), _ptr(pr), _ptr(npr), _ptr(out),
        _ptr(acc_t), _ptr(acc_c), _ptr(_workspace(dev, H, W)["partials"]),
        nch, HP, WP, H, W, scale, R, smem, _stream(dev))
    _launch("fused_warp_splat", rc)
    return npr, out


# --------------------- B7a / B7b the composed iteration, cut at the images


def fused_warp_splat_images_call(stat, act, pr, scal, acc_t, acc_c, *,
                                 scale: int, H: int, W: int):
    """The event phase of an event-parallel composed iteration: warp every
    event slot with the (1, 16) row ``scal`` (``warp_scal_row``) and add the
    hi+lo splat into the caller's pair ``acc_t`` (HP, WP) int64 fixed point,
    ``acc_c`` (HP, WP) int32 (``image_pair``), which is zero at an
    iteration's first launch; later launches of the same iteration add to
    it.  One launch serves all of a process's shards: pass their chunks as
    one range.  Returns (new_pr (nch, 2, CHUNK) f32, acc_t, acc_c,
    fallback_chunks), the pair being the caller's own tensors;
    ``fallback_chunks`` is always 0 (see ``fused_warp_splat_call``)."""
    dev = stat.device
    nch = stat.shape[0]
    _check("stat", stat, torch.float32, (nch, 3, CHUNK), dev)
    _check("act", act, torch.float32, (nch, 1, CHUNK), dev)
    _check("pr", pr, torch.float32, (nch, 2, CHUNK), dev)
    _check("scal", scal, torch.float32, (1, 16), dev)
    _check_pair(acc_t, acc_c, H, W, dev)
    if _on_cpu(dev):
        return fused_warp_splat_images_plain(stat, act, pr, scal, acc_t,
                                             acc_c, scale=scale, H=H, W=W)
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    npr = torch.empty_like(pr)
    rc = library().bf_warp_splat_images(
        _ptr(scal), _ptr(stat), _ptr(act), _ptr(pr), _ptr(npr), _ptr(acc_t),
        _ptr(acc_c), nch, HP, WP, scale, _stream(dev))
    _launch("fused_warp_splat_images", rc)
    return npr, acc_t, acc_c, 0


def finish_partials_call(acc_t, acc_c, *, scale: int, H: int, W: int):
    """The replicated half of an event-parallel composed iteration, on the
    pair that B7a filled and the seam summed: box filter, normalise, mask,
    Scharr and the seven partial sums, in one cooperative launch that
    leaves the pair zero for the next iteration.  Returns (8,) f32 [cnt,
    s_row, s_col, s_gx, s_gy, s_rg, s_dg, 0], bitwise
    ``fused_warp_splat_call``'s on the same events.  A launch the card
    refuses raises and leaves the pair as it was."""
    dev = acc_t.device
    _check_pair(acc_t, acc_c, H, W, dev)
    if _on_cpu(dev):
        return finish_partials_plain(acc_t, acc_c, scale=scale, H=H, W=W)
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    R, smem = _device_bands(dev, H, W, scale)
    out = torch.empty(8, dtype=torch.float32, device=dev)
    rc = library().bf_finish_partials(
        _ptr(acc_t), _ptr(acc_c), _ptr(out),
        _ptr(_workspace(dev, H, W)["partials"]), HP, WP, H, W, scale, R, smem,
        _stream(dev))
    _launch("finish_partials", rc)
    return out


# ------------------------------ B8 / B9 the tiled pipeline's splat and finish


def _chunk_padded(a: torch.Tensor, fill: float) -> torch.Tensor:
    """(n_tiles, n) -> (n_tiles, n_pad) with n_pad the next CHUNK multiple
    (at least one chunk), new slots holding ``fill``; ``a`` itself when it
    already is."""
    n = a.shape[1]
    n_pad = -(-max(n, CHUNK) // CHUNK) * CHUNK
    if n_pad == n:
        return a
    return torch.nn.functional.pad(a, (0, n_pad - n), value=fill)


def splat_local_plain(lx, ly, t_sec, acc_t, acc_c, *, H: int, W: int,
                      time_lo: bool = True):
    """The twin of B8 on chunk-padded (n_tiles, n_pad) slots: the events'
    fixed-point time weights and counts added into the pair (acc_t, acc_c)
    (n_tiles, HP, WP) in place.  Returns the pair."""
    n_tiles, n_pad = lx.shape
    HP, WP = acc_t.shape[1:]
    ix = lx.to(torch.int32).to(torch.int64)   # toward zero
    iy = ly.to(torch.int32).to(torch.int64)
    ok = (lx >= 0) & (ly >= 0) & (ix < H) & (iy < W)
    t0 = t_sec.reshape(n_tiles, -1, CHUNK)[:, :, :1]
    tr = t_sec.reshape(n_tiles, -1, CHUNK) - t0
    w_hi = _bf16(tr)
    fixed = to_fixed(t0) + to_fixed(w_hi)
    if time_lo:
        fixed = fixed + to_fixed(_bf16(tr - w_hi))
    tile = torch.arange(n_tiles, device=lx.device)[:, None]
    # A rejected slot adds zero to pixel 0.
    lin = torch.where(ok, (tile * HP + ix) * WP + iy, 0).reshape(-1)
    acc_t.view(-1).index_add_(0, lin, torch.where(
        ok, fixed.reshape(n_tiles, n_pad), 0).reshape(-1))
    acc_c.view(-1).index_add_(0, lin, ok.to(torch.int32).reshape(-1))
    return acc_t, acc_c


def splat_local_call(lx, ly, t_sec, acc_t, acc_c, *, H: int, W: int,
                     time_lo: bool = True):
    """The splat of a batch of tiles from precomputed local positions:
    ``lx``, ``ly`` (n_tiles, n) f32 integer positions in each tile's H x W
    frame, negative in a rejected or padding slot, ``t_sec`` (n_tiles, n)
    f32 timestamps in seconds, added into the caller's pair ``acc_t``
    (n_tiles, HP, WP) int64 fixed point, ``acc_c`` (n_tiles, HP, WP) int32
    (``image_pair(..., n_tiles=)``: the logical H x W image in each tile's
    top-left corner), which is zero at an iteration's start.  Each tile's
    slots are padded to whole chunks of CHUNK (position -1, time 0) unless
    they already are; an event's time weight is relative to its chunk's
    slot 0, in bf16 hi and (``time_lo``) lo parts.  Returns (acc_t, acc_c),
    the caller's own tensors.  One launch whatever the number of tiles; no
    memset and no allocation on the card."""
    dev = lx.device
    if lx.dim() != 2:
        raise ValueError(f"lx: shape {tuple(lx.shape)}, expected "
                         "(n_tiles, n)")
    shape = tuple(lx.shape)
    _check("lx", lx, torch.float32, shape, dev)
    _check("ly", ly, torch.float32, shape, dev)
    _check("t_sec", t_sec, torch.float32, shape, dev)
    _check_pair(acc_t, acc_c, H, W, dev, n_tiles=shape[0])
    lx, ly = _chunk_padded(lx, -1.0), _chunk_padded(ly, -1.0)
    t_sec = _chunk_padded(t_sec, 0.0)
    if _on_cpu(dev):
        return splat_local_plain(lx, ly, t_sec, acc_t, acc_c, H=H, W=W,
                                 time_lo=time_lo)
    from better_flow_tpu_torch.ops._build import library

    n_tiles, n_pad = lx.shape
    HP, WP = padded_image_shape(H, W)
    rc = library().bf_splat_local(_ptr(lx), _ptr(ly), _ptr(t_sec),
                                  _ptr(acc_t), _ptr(acc_c), n_tiles, n_pad,
                                  HP, WP, H, W, int(time_lo), _stream(dev))
    _launch("splat_local", rc)
    return acc_t, acc_c


def splat_local_grid(n_tiles: int, n: int) -> int:
    """The blocks B8 launches over ``n_tiles`` x ``n`` slots (``n`` padded
    to whole chunks, as ``splat_local_call`` does)."""
    from better_flow_tpu_torch.ops._build import library

    n_pad = -(-max(n, CHUNK) // CHUNK) * CHUNK
    return library().bf_splat_local_grid(n_tiles, n_pad)


def finish_local_plain(acc_t, acc_c, *, scale: int, H: int, W: int, own):
    """The twin of B9: ``finish_values_plain`` with the ownership window,
    tile by tile, with a zero eighth slot; then the pair is cleared, as the
    kernel leaves it."""
    rows = [finish_values_plain(t, c, scale=scale, H=H, W=W, own=own)
            for t, c in zip(acc_t, acc_c)]
    acc_t.zero_()
    acc_c.zero_()
    return torch.cat([torch.stack(rows),
                      acc_t.new_zeros((len(rows), 1), dtype=torch.float32)],
                     dim=1)


def finish_local_call(acc_t, acc_c, *, scale: int, H: int, W: int, own):
    """The finish of a batch of tiles' local images, the pair (n_tiles, HP,
    WP) that B8 filled (``image_pair(..., n_tiles=)``): box filter,
    normalise, mask, Scharr over the whole local image, and the seven sums
    over the window ``own`` = (r0, r1, c0, c1), the same for every tile,
    with local row and column weights, in one cooperative launch that
    leaves the pair zero for the next iteration.  Returns (n_tiles, 8) f32
    [cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg, 0]; with the whole image as
    the window, bitwise ``finish_partials_call``'s tile by tile.  One call
    whatever the number of tiles.  A launch the card refuses raises and
    leaves the pair as it was."""
    dev = acc_t.device
    if acc_t.dim() != 3:
        raise ValueError(f"acc_t: shape {tuple(acc_t.shape)}, expected "
                         "(n_tiles, HP, WP)")
    n_tiles = acc_t.shape[0]
    _check_pair(acc_t, acc_c, H, W, dev, n_tiles=n_tiles)
    r0, r1, c0, c1 = (int(v) for v in own)
    if not (0 <= r0 <= r1 <= H and 0 <= c0 <= c1 <= W):
        raise ValueError(f"own = {tuple(own)} outside the {H} x {W} image")
    if _on_cpu(dev):
        return finish_local_plain(acc_t, acc_c, scale=scale, H=H, W=W,
                                  own=(r0, r1, c0, c1))
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    R, smem = _device_bands(dev, H, W, scale, n_tiles)
    out = torch.empty((n_tiles, 8), dtype=torch.float32, device=dev)
    key = (dev, n_tiles, H, W)
    if key not in _WORKSPACE:     # B9's (n_tiles, H, 9) f64 row sums
        _WORKSPACE[key] = dict(partials=torch.empty(
            (n_tiles, H, 9), dtype=torch.float64, device=dev))
    rc = library().bf_finish_local(
        _ptr(acc_t), _ptr(acc_c), _ptr(out),
        _ptr(_WORKSPACE[key]["partials"]), n_tiles, HP, WP, H, W, scale, r0,
        r1, c0, c1, R, smem, _stream(dev))
    _launch("finish_local", rc)
    return out


# --------------- B10 / B11 the seven sums of already-warped positions


def partials_rows(pr_x, pr_y, t_ns, active):
    """The flat (n,) inputs of B10 and B11 as (nch, CHUNK) f32 rows, padded
    to whole chunks (at least one) with inactive slots: positions, times in
    seconds (``t_ns / 1e9`` as a multiplication by the f32 reciprocal, as
    XLA compiles the JAX wrapper) and activity: the twins' layout, which
    is the TPU kernel's.  The card's kernel reads the flat tensors as they
    are."""
    rows = lambda a: _chunk_padded(a.to(torch.float32)[None], 0.0).reshape(
        -1, CHUNK)
    return (rows(pr_x), rows(pr_y), rows(mul_recip(t_ns.to(torch.float32),
                                                   1e9)), rows(active))


def fused_model_partials_plain(prx, pry, t_sec, act, geo, *, scale: int,
                               H: int, W: int):
    """The twin of B10 on (nch, CHUNK) rows: the hi+lo splat of the
    positions inside the window of ``geo``, then ``finish_partials_plain``
    (B7b's twin; the kernel runs B7b on its own pair).  Returns (8,) f32
    [seven sums, 0]."""
    acc_t, acc_c = _splat_plain(t_sec, act, prx, pry, geo, scale=scale, H=H,
                                W=W, time_lo=True)
    return finish_partials_plain(acc_t, acc_c, scale=scale, H=H, W=W)


def fused_model_partials_windowed_plain(prx, pry, t_sec, act, geo, *,
                                        scale: int, H: int, W: int):
    """The twin of B11: B10's function.  The TPU kernel's splat windows
    and fallbacks are a way to scatter, and the integer sums do not depend
    on it."""
    return fused_model_partials_plain(prx, pry, t_sec, act, geo, scale=scale,
                                      H=H, W=W)


def _partials_call(name, plain, pr_x, pr_y, t_ns, active, geo, scale, H, W):
    dev = pr_x.device
    n = pr_x.shape[0] if pr_x.dim() == 1 else -1
    _check("pr_x", pr_x, torch.float32, (n,), dev)
    _check("pr_y", pr_y, torch.float32, (n,), dev)
    _check("t_ns", t_ns, torch.float32, (n,), dev)
    _check("active", active, torch.bool, (n,), dev)
    _check("geo", geo, torch.float32, (1, 8), dev)
    if _on_cpu(dev):
        return plain(*partials_rows(pr_x, pr_y, t_ns, active), geo,
                     scale=scale, H=H, W=W)
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    R, smem = _device_bands(dev, H, W, scale)
    out = torch.empty(8, dtype=torch.float32, device=dev)
    ws = _workspace(dev, H, W)
    rc = getattr(library(), "bf_" + name)(
        _ptr(geo), _ptr(pr_x), _ptr(pr_y), _ptr(t_ns), _ptr(active),
        _ptr(out), _ptr(ws["acc_t"]), _ptr(ws["acc_c"]),
        _ptr(ws["partials"]), n, HP, WP, H, W, scale, R, smem, _stream(dev))
    _launch(name, rc)
    return out


def fused_model_partials_call(pr_x, pr_y, t_ns, active, geo, *, scale: int,
                              H: int, W: int):
    """The seven sums of the time image of already-warped events: flat (n,)
    contiguous f32 ``pr_x``, ``pr_y``, ``t_ns`` and ``torch.bool``
    ``active``, accepted inside the dynamic window of the (1, 8) geometry
    row ``geo``, each CHUNK slots' time base their first slot.  Returns
    (8,) f32 [cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg, 0].  On the card
    the call is one cooperative launch and no other device operation."""
    return _partials_call("fused_model_partials", fused_model_partials_plain,
                          pr_x, pr_y, t_ns, active, geo, scale, H, W)


def fused_model_partials_windowed_call(pr_x, pr_y, t_ns, active, geo, *,
                                       scale: int, H: int, W: int):
    """``fused_model_partials_call`` for events sorted by
    ``ops.layout.sort_key_blocks`` (spatially local chunks): B10's splat,
    exact for any order and any warp, so bitwise
    ``fused_model_partials_call``."""
    return _partials_call("fused_model_partials_windowed",
                          fused_model_partials_windowed_plain, pr_x, pr_y,
                          t_ns, active, geo, scale, H, W)


# ------------------------------------------------ B12 merged megastep


def megastep2_plain(stat, act, pr, st, acc_t, acc_c, geo, *, scale: int,
                    H: int, W: int, time_lo: bool = True, **statics):
    """The twin of B12: the head (``megastep_finish_plain`` of the pair,
    which it leaves zero, when ``st[ST_HAS]`` is set, else the state with
    CONT forced to 1; then HAS = 1), the warp of every event with the head's
    state with B4's direction vectors, and, while CONT > 0, the splat of
    ``warp_images_st_plain`` added into the same pair.  Returns (npr (nch,
    4, CHUNK) [pr_x, pr_y, nx, ny], st_out, acc_t, acc_c)."""
    if st[0, ST_HAS].item() > 0.5:
        st_out = megastep_finish_plain(acc_t, acc_c, st, geo, scale=scale,
                                       H=H, W=W, **statics)
    else:
        st_out = st.clone()
        st_out[0, ST_CONT] = 1.0
    st_out[0, ST_HAS] = 1.0
    prx, pry, nx, ny = project_4param_reinit(
        stat[:, 0], stat[:, 1], stat[:, 2], pr[:, 0], pr[:, 1],
        *_warp_args(st_out))
    npr = torch.stack([prx, pry, nx, ny], dim=1)
    if st_out[0, ST_CONT].item() > 0:
        t, c = _splat_plain(mul_recip(stat[:, 2], 1e9), act[:, 0], prx, pry,
                            geo, scale=scale, H=H, W=W, time_lo=time_lo)
        acc_t += t
        acc_c += c
    return npr, st_out, acc_t, acc_c


def megastep2_call(stat, act, pr, st, acc_t, acc_c, geo, *, scale: int,
                   H: int, W: int, schedule: str, rot_tol: float,
                   div_tol: float, dx_tol: float, dy_tol: float,
                   xy_cap: float, rotdiv_cap: float, max_iter: int,
                   hard_cap: int, time_lo: bool = True,
                   exit_grad: float = 0.0, exit_pred: float = 0.0,
                   grid_blocks: int = 0):
    """One merged iteration in one cooperative launch on the caller's pair
    ``acc_t`` (HP, WP) int64, ``acc_c`` (HP, WP) int32 (``image_pair``):
    when ``st[ST_HAS]`` is set, the finish and model update of the previous
    call's splat in the pair, which the launch then leaves zero (on a
    slice's first call, HAS unset, the pair must be zero); the warp of every
    event from ``pr`` (nch, 4, CHUNK) (rows 0-1 read) with the updated
    state; and, while the updated CONT is set, the splat added into the same
    pair.  Returns (npr (nch, 4, CHUNK) [pr_x, pr_y, nx, ny], st_out (1,
    32), acc_t, acc_c), the pair being the caller's own tensors, zero when
    CONT is 0.  The call whose head clears CONT is the final warp.
    ``grid_blocks`` as in ``megastep_call``; a launch the card refuses
    raises and leaves the pair as it was."""
    statics = dict(schedule=schedule, rot_tol=rot_tol, div_tol=div_tol,
                   dx_tol=dx_tol, dy_tol=dy_tol, xy_cap=xy_cap,
                   rotdiv_cap=rotdiv_cap, max_iter=max_iter,
                   hard_cap=hard_cap, exit_grad=exit_grad,
                   exit_pred=exit_pred)
    dev = stat.device
    nch = stat.shape[0]
    _check("stat", stat, torch.float32, (nch, 3, CHUNK), dev)
    _check("act", act, torch.float32, (nch, 1, CHUNK), dev)
    _check("pr", pr, torch.float32, (nch, 4, CHUNK), dev)
    _check("st", st, torch.float32, (1, ST_SIZE), dev)
    _check_pair(acc_t, acc_c, H, W, dev)
    _check("geo", geo, torch.float32, (1, 8), dev)
    if _on_cpu(dev):
        return megastep2_plain(stat, act, pr, st, acc_t, acc_c, geo,
                               scale=scale, H=H, W=W, time_lo=time_lo,
                               **statics)
    from better_flow_tpu_torch.ops._build import library

    HP, WP = padded_image_shape(H, W)
    R, smem = _device_bands(dev, H, W, scale)
    cp = _c_params(statics)
    npr = torch.empty_like(pr)
    st_out = torch.empty_like(st)
    rc = library().bf_megastep2(
        _ptr(geo), _ptr(st), _ptr(stat), _ptr(act), _ptr(pr), _ptr(npr),
        _ptr(st_out), _ptr(acc_t), _ptr(acc_c),
        _ptr(_workspace(dev, H, W)["partials"]), nch, HP, WP, H, W, scale,
        int(time_lo), R, smem, ctypes.byref(cp), int(grid_blocks),
        _stream(dev))
    _launch("megastep2", rc)
    return npr, st_out, acc_t, acc_c


def sum_images(acc_t, acc_c, comm=None):
    """The seam of the event-parallel paths, in place: the local image
    pair, which one splat launch over all local shards filled, summed
    across the ranks of ``comm`` (``all_reduce_sum_`` of a ``parallel.comm``
    communicator; None or size 1: no collective).  Returns the pair, the
    very tensors that the finish then reads and clears for the drive's next
    iteration.  Integer sums: exact and independent of the order."""
    if comm is not None and comm.size > 1:
        comm.all_reduce_sum_([acc_t, acc_c])
    return acc_t, acc_c
