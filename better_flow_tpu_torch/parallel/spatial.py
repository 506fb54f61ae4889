"""Spatially tiled slice processing: image tiles, halo exchange, escape lane.

Counterpart of ``better_flow_tpu/parallel/spatial.py``.  For megapixel
sensors the scaled image plane is cut into n_tx x n_ty tiles (a
``parallel.mesh.TileGroup``).  Each tile holds its part of the image plus a
halo ring, and the events whose *original* pixels fall in it.  One optimizer
iteration:

1. every tile's events are scaled, truncated and accepted (plain tensor
   operations; the model is the same everywhere, so the warp that produced
   the positions needed no communication) and splatted into the tile's
   (tile + 2 halo)^2 time and count images (B8, ``splat_local_call``),
   which are zero at the iteration's start; a warped event may land in the
   halo, in a neighbour's territory;
2. fold-in: halo strips are added into the neighbours that own those pixels,
   x then y, so that corners ride through;
3. the escape lane: events accepted but beyond the halo ring are compacted
   by prefix-sum rank into a fixed-capacity buffer per tile, gathered from
   every tile and added by the tile that owns their pixel, so any
   displacement is exact, not only <= halo; a tile that overflows its
   ``esc_cap`` reports the dropped count (``escaped_dropped``, 0 = exact);
4. broadcast-back: completed edge strips of width 1 + scale // 2 are copied
   into the neighbours' halos, so the box filter and the Scharr ring read
   true values across the seams;
5. the finish per tile with the sums restricted to the owned window (B9,
   ``finish_local_call``, which leaves the images zero for the next
   iteration), the shift of the row- and column-weighted sums to global
   coordinates, the sum over tiles, the model update and the re-warp of
   every tile's events.

All tiles a process holds go through every step together: events are
(n_local, slots) tensors, and B8 and B9 take the batch in one call, so the
number of launches does not grow with the tiles.  The images are one pair
for the run (``_Tiling``), (n_local, HP, WP) with HP x WP the padded shape
of the H x W local image (``ops.layout.padded_image_shape``; the padding
stays zero): B8 adds into it, the seams work on its H x W view, B9 reads
it and leaves it zero.
A strip exchange between two tiles of one process is a tensor copy; between
ranks it is ``comm.permute``; the escape lane and the tile sum use
``all_gather``, the final union ``all_reduce_sum``.  The images are the
port's integer ones (int64 fixed-point time, int32 count), so fold-in, lane
and seams are exact in any order, and the tile sum is taken in tile order in
f64: a run repeats bit for bit, and tiles over ranks are bitwise tiles in one
process.

The XLA branch's modes (``OptimizerConfig.scatter_mode`` "xla", "rep" or
"mxu"; the JAX package's tiled run off the TPU) take the same seams in plain
tensor code and launch no kernel: step 1 is one exact integer scatter of
the accepted positions' f32 times into the run's pair (``index_add_``,
the arithmetic of ``ops.time_image``'s scatter and of the escape lane), and
step 5 the JAX package's chain in place of B9: the f32 images and their box
filter, the normalised time image, ``masked_scharr`` in XLA's contracted
form, the owned window, and the seven sums of
``ops.reductions.model_compute_partial``, tile by tile; the pair is then
zeroed, so the image-pair contract holds on either branch.

The schedules are those of the untiled composed loop
(``models.global_flow.drive_loop``): every rank computes the same sums, so
the data-dependent iteration count is the same everywhere.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from better_flow_tpu_torch.config import OptimizerConfig, SensorConfig
from better_flow_tpu_torch.core.model import FIELDS, MotionModel
from better_flow_tpu_torch.models.global_flow import (
    adaptive_loop, check_supported, drive_loop, geometry_from_bbox,
    xla_branch,
)
from better_flow_tpu_torch.ops.fused_model import (
    LAUNCHES, finish_local_call, image_pair, splat_local_call,
    time_image_f32, to_fixed,
)
from better_flow_tpu_torch.ops.gradient import masked_scharr
from better_flow_tpu_torch.ops.layout import CHUNK, padded_image_shape
from better_flow_tpu_torch.ops.reductions import (
    model_compute_partial, model_from_partials,
)
from better_flow_tpu_torch.ops.time_image import box_filter
from better_flow_tpu_torch.ops.warp import (
    compute_uv, mul_recip, project_4param_reinit, recip,
)
from better_flow_tpu_torch.parallel.mesh import TileGroup
from better_flow_tpu_torch.runtime.scan_pipeline import (
    history_depth, host_bbox, plan_slices, to_device,
)

class TiledSliceResult(NamedTuple):
    model: MotionModel
    pr_x: torch.Tensor
    pr_y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    iters: int
    # Worst iteration's count of events dropped from the escape lane, over
    # all tiles (0 = the tiled result is exact).  Resize esc_cap if nonzero.
    escaped_dropped: int


class TiledFlowState(NamedTuple):
    """The tiled optimizer's loop state.  Field names match
    ``models.global_flow.FusedFlowState`` so that ``adaptive_loop`` and
    ``fast_loop`` drive it unchanged; the per-event tensors are
    (n_local, slots), ``esc`` the worst iteration's escape-lane overflow so
    far (a 0-d int64 device tensor)."""

    pr_x: torch.Tensor
    pr_y: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    model: MotionModel
    x_div: torch.Tensor
    y_div: torch.Tensor
    rot_div: torch.Tensor
    div_div: torch.Tensor
    iters: int
    esc: torch.Tensor
    reads: int = 0

    def divs4(self) -> torch.Tensor:
        """The dividers in (rot, div, dx, dy) order."""
        return torch.stack([self.rot_div, self.div_div, self.x_div,
                            self.y_div])


class _Tiling:
    """The constants of one run: the tile geometry of a sensor over a tile
    group, this process's tiles' offsets and edge masks on the device, and
    the run's image pair (``acc_t``, ``acc_c``: (n_local, HP, WP), zero
    between iterations)."""

    def __init__(self, sensor: SensorConfig, scale: int, mesh: TileGroup,
                 halo: int):
        self.mesh = mesh
        self.scale, self.halo = scale, halo
        self.n_tx, self.n_ty = mesh.shape
        self.img_h = sensor.res_x * scale + scale
        self.img_w = sensor.res_y * scale + scale
        self.tile_h = -(-self.img_h // self.n_tx)
        self.tile_w = -(-self.img_w // self.n_ty)
        # The halo exchange is neighbour-only, and the staging assigns home
        # tiles by the natural tile size: refuse rather than grow the tiles.
        if self.tile_h < halo or self.tile_w < halo:
            raise ValueError(
                f"halo {halo} exceeds the natural tile size "
                f"({self.tile_h}x{self.tile_w} for a {self.img_h}x"
                f"{self.img_w} image over a {self.n_tx}x{self.n_ty} mesh); "
                "use fewer tiles or a smaller halo")
        self.H = self.tile_h + 2 * halo
        self.W = self.tile_w + 2 * halo
        self.own = (halo, halo + self.tile_h, halo, halo + self.tile_w)
        self.HP, self.WP = padded_image_shape(self.H, self.W)
        dev = mesh.device
        self.acc_t, self.acc_c = image_pair(dev, self.H, self.W,
                                            n_tiles=mesh.n_local)
        ids = np.arange(mesh.first_tile, mesh.first_tile + mesh.n_local)
        tx, ty = ids // self.n_ty, ids % self.n_ty
        i32 = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(dev)
        # Local frame origin (owned region's corner less the halo), in
        # global scaled-image pixels.
        self.org_r = i32(tx * self.tile_h - halo)[:, None]
        self.org_c = i32(ty * self.tile_w - halo)[:, None]
        # The shift of the row- and column-weighted sums to global
        # coordinates, as f64 factors: of [cnt, cnt, s_gy, s_gx] into
        # [s_row, s_col, s_rg, s_dg], then of [s_gx, s_gy] into [s_rg, s_dg].
        off_r, off_c = self.org_r.to(torch.float64), self.org_c.to(
            torch.float64)
        self.shift1 = torch.cat([off_r, off_c, off_r, off_r], dim=1)
        self.shift2 = torch.cat([-off_c, off_c], dim=1)
        cols = lambda *k: torch.tensor(k, device=dev)
        self.shift_cols = (cols(0, 0, 4, 3), cols(1, 2, 5, 6))
        edge = lambda a: torch.from_numpy(a).to(dev)[:, None, None]
        # (axis, side): which local tiles have that neighbour.
        self.has = {(0, -1): edge(tx > 0), (0, 1): edge(tx < self.n_tx - 1),
                    (1, -1): edge(ty > 0), (1, 1): edge(ty < self.n_ty - 1)}

    def from_neighbour(self, strips: torch.Tensor, axis: int, side: int
                       ) -> torch.Tensor:
        """For every local tile the strip ``strips[...]`` of its neighbour
        on ``side`` (-1 lower, +1 higher) along ``axis`` (0 x, 1 y), zeros
        where the sensor ends.  Tiles are numbered tx-major and held rank by
        rank, so the neighbour of local tile k is local tile
        (k + delta) mod n_local of the rank floor((k + delta) / n_local)
        further on, the same for every rank: runs of tiles with one rank
        offset move with one copy, or one ``permute`` around the ring of
        ranks (what wraps around is masked away)."""
        mesh = self.mesh
        n_local, size = mesh.n_local, mesh.comm.size
        delta = side * (self.n_ty if axis == 0 else 1)
        out = torch.empty_like(strips, memory_format=torch.contiguous_format)
        k = 0
        while k < n_local:
            d, j = divmod(k + delta, n_local)
            run = min(n_local - k, n_local - j)
            src = strips[j:j + run]
            if d % size != 0:
                pairs = [(i, (i - d) % size) for i in range(size)]
                src, = mesh.comm.permute([src.contiguous()], pairs)
            out[k:k + run] = src
            k += run
        return out.mul_(self.has[axis, side])

    def fold_in(self, img: torch.Tensor, axis: int) -> None:
        """Add every tile's halo strips along ``axis`` into the neighbours
        that own those pixels, in place; ``img`` is (n_local, H, W)."""
        if self.mesh.shape[axis] == 1:
            return
        h, dim = self.halo, axis + 1
        T = img.shape[dim] - 2 * h
        from_lower = self.from_neighbour(img.narrow(dim, T + h, h), axis, -1)
        from_higher = self.from_neighbour(img.narrow(dim, 0, h), axis, 1)
        img.narrow(dim, h, h).add_(from_lower)
        img.narrow(dim, T, h).add_(from_higher)

    def broadcast_back(self, img: torch.Tensor, axis: int) -> None:
        """Copy every tile's completed edge strips of width 1 + scale // 2
        along ``axis`` into the neighbours' halos, in place; a halo beyond
        the sensor is zeroed.  ``img`` is (n_local, H, W)."""
        if self.mesh.shape[axis] == 1:
            return
        h, dim, g = self.halo, axis + 1, 1 + self.scale // 2
        T = img.shape[dim] - 2 * h
        from_lower = self.from_neighbour(img.narrow(dim, T + h - g, g), axis,
                                         -1)
        from_higher = self.from_neighbour(img.narrow(dim, h, g), axis, 1)
        img.narrow(dim, h - g, g).copy_(from_lower)
        img.narrow(dim, T + h, g).copy_(from_higher)


class _TileEvents(NamedTuple):
    """One slice's events on this process's tiles, (n_local, slots) each,
    and the slice's window as device scalars."""

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor         # slice-local ns
    t_sec: torch.Tensor     # t / 1e9 as XLA compiles it
    active: torch.Tensor    # bool
    x_sh: float             # exact f32 values
    y_sh: float
    x_hi: int               # accepted pixels are half <= g < hi
    y_hi: int


def _tile_events(x, y, t, active, tl: _Tiling, geom) -> _TileEvents:
    half = tl.scale // 2
    if geom is None:
        # The whole-sensor window of the single-slice entry point.
        x_sh, y_sh = float(half), float(half)
        x_hi, y_hi = tl.img_h - half, tl.img_w - half
    else:
        x_sh, y_sh = geom.x_shift, geom.y_shift
        x_hi, y_hi = geom.w_dyn + half, geom.h_dyn + half
    return _TileEvents(x, y, t, mul_recip(t, 1e9), active, x_sh, y_sh, x_hi,
                       y_hi)


def _escape_lane(gx, gy, t_sec, escaped, esc_cap: int, tl: _Tiling,
                 acc_t, acc_c):
    """Compact every local tile's escaped events into its (esc_cap,) buffer
    by prefix-sum rank (no sort), gather every tile's buffer, and add the
    gathered events whose pixel a local tile owns into that tile's images
    (the run's (n_local, HP, WP) pair), in place.  Returns the number of
    events dropped for want of capacity, over all tiles (a 0-d int64
    tensor)."""
    mesh = tl.mesh
    n_local = gx.shape[0]
    rank = torch.cumsum(escaped, dim=1) - 1
    pos = torch.where(escaped, rank.clamp(max=esc_cap),
                      torch.full_like(rank, esc_cap))
    # One int32 buffer [x, y, time bits] per tile, -1 / 0 / 0 when empty;
    # overflow and the rest land in a dump slot past the capacity.
    buf = torch.zeros((3, n_local, esc_cap + 1), dtype=torch.int32,
                      device=gx.device)
    buf[0].fill_(-1)
    buf[0].scatter_(1, pos, torch.where(escaped, gx, torch.full_like(gx, -1)))
    buf[1].scatter_(1, pos, gy)
    buf[2].scatter_(1, pos, t_sec.view(torch.int32))
    dropped = (escaped.sum(dim=1) - esc_cap).clamp(min=0).sum()
    buf = buf[:, :, :esc_cap]
    if mesh.comm.size > 1:
        buf = mesh.comm.all_gather(buf.contiguous()).transpose(0, 1)
        dropped, = mesh.comm.all_reduce_sum([dropped])
    eg_x, eg_y, eg_t = buf.reshape(3, -1).unbind()
    eg_x, eg_y = eg_x.to(torch.int64), eg_y.to(torch.int64)
    tx = torch.div(eg_x, tl.tile_h, rounding_mode="floor")
    ty = torch.div(eg_y, tl.tile_w, rounding_mode="floor")
    local = tx * tl.n_ty + ty - mesh.first_tile
    own = ((eg_x >= 0) & (eg_y >= 0) & (tx < tl.n_tx) & (ty < tl.n_ty)
           & (local >= 0) & (local < n_local))
    lin = ((local * tl.HP + (eg_x - tx * tl.tile_h + tl.halo)) * tl.WP
           + (eg_y - ty * tl.tile_w + tl.halo))
    # A slot that is empty or another process's adds zero, each to a pixel
    # of its own (one shared dump pixel would serialise the card's atomics).
    lin = torch.where(own, lin, torch.arange(
        lin.shape[0], device=lin.device) % acc_t.numel())
    fixed = to_fixed(eg_t.contiguous().view(torch.float32))
    acc_t.view(-1).index_add_(0, lin, torch.where(own, fixed,
                                                  torch.zeros_like(fixed)))
    acc_c.view(-1).index_add_(0, lin, own.to(torch.int32))
    return dropped


def _local_positions(pr_x, pr_y, ev: _TileEvents, tl: _Tiling):
    """The positions (n_local, slots) scaled, truncated (toward zero, like
    the C++ cast) and accepted inside the slice's window.  Returns B8's
    inputs (lx, ly: f32 pixel positions in each tile's local frame, -1
    where rejected or outside the tile's halo ring), the global pixels
    (gx, gy: int32) and the mask of the events accepted but beyond the
    ring."""
    half = tl.scale // 2
    # pr * scale + shift, fused as XLA compiles it: the f64 product and sum
    # rounded to f32 once (``ops.warp.fma`` with host scalars).
    scaled = lambda pr, sh: (pr.to(torch.float64) * float(tl.scale) + sh).to(
        torch.float32).to(torch.int32)
    gx, gy = scaled(pr_x, ev.x_sh), scaled(pr_y, ev.y_sh)
    inb = (ev.active & (gx >= half) & (gx < ev.x_hi)
           & (gy >= half) & (gy < ev.y_hi))
    lx = gx - tl.org_r
    ly = gy - tl.org_c
    in_halo = (lx >= 0) & (lx < tl.H) & (ly >= 0) & (ly < tl.W)
    ok = inb & in_halo
    minus = torch.full_like(lx, -1)
    return (torch.where(ok, lx, minus).to(torch.float32),
            torch.where(ok, ly, minus).to(torch.float32), gx, gy,
            inb & ~in_halo)


def _global_sums(p: torch.Tensor, tl: _Tiling) -> torch.Tensor:
    """B9's (n_local, 8) sums with the row- and column-weighted ones shifted
    from each tile's local frame to global coordinates, (n_local, 7):
    s_row += off_r cnt, s_col += off_c cnt, s_rg += off_r s_gy - off_c s_gx,
    s_dg += off_r s_gx + off_c s_gy, each multiply-add fused as XLA compiles
    it (an f64 product and sum rounded to f32 once, see ``ops.warp.fma``)."""
    f32, f64 = torch.float32, torch.float64
    p64 = p.to(f64)
    # [s_row, s_col, s_rg + off_r s_gy, s_dg + off_r s_gx]
    a = (p64.index_select(1, tl.shift_cols[0]) * tl.shift1
         + p64.index_select(1, tl.shift_cols[1])).to(f32)
    b = (p64[:, 3:5] * tl.shift2 + a[:, 2:4].to(f64)).to(f32)
    return torch.cat([p[:, 0:1], a[:, 0:2], p[:, 3:5], b], dim=1)


def _splat_exact(lx, ly, t_sec, tl: _Tiling):
    """The XLA branch's splat: every accepted slot's exact fixed-point time
    and a count of one added into the run's pair (n_local, HP, WP) at its
    local pixel, in place (``lx`` and ``ly`` from ``_local_positions``, -1
    where rejected).  A rejected slot adds zero, each to a pixel of its own
    (one shared dump pixel would serialise the card's atomics).  Returns
    the pair."""
    acc_t, acc_c = tl.acc_t, tl.acc_c
    ok = lx >= 0
    tile = torch.arange(lx.shape[0], device=lx.device)[:, None]
    lin = (tile * tl.HP + lx.to(torch.int64)) * tl.WP + ly.to(torch.int64)
    spread = torch.arange(lin.numel(), device=lin.device).reshape(
        lin.shape) % acc_t.numel()
    lin = torch.where(ok, lin, spread).reshape(-1)
    fixed = to_fixed(t_sec)
    acc_t.view(-1).index_add_(0, lin, torch.where(
        ok, fixed, torch.zeros_like(fixed)).reshape(-1))
    acc_c.view(-1).index_add_(0, lin, ok.to(torch.int32).reshape(-1))
    return acc_t, acc_c


def _finish_exact(acc_t, acc_c, tl: _Tiling) -> torch.Tensor:
    """The XLA branch's finish (``better_flow_tpu/parallel/spatial.py:
    314-327``): the f32 images box filtered, the normalised time image,
    the contracted masked Scharr over the whole local image, and the seven
    sums over the owned window with local row and column weights, tile by
    tile; then the pair is zeroed for the next iteration.  Returns
    (n_local, 7) f32 [cnt, s_row, s_col, s_gx, s_gy, s_rg, s_dg]."""
    H, W = tl.H, tl.W
    t_sum = box_filter(time_image_f32(acc_t[:, :H, :W]), tl.scale)
    cnt = box_filter(acc_c[:, :H, :W].to(torch.float32), tl.scale)
    img = torch.where(cnt >= 1, t_sum / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(t_sum))
    r0, r1, c0, c1 = tl.own
    own = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    own[r0:r1, c0:c1] = True
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    rows = []
    for im in img:
        gxg, gyg = masked_scharr(im)
        rows.append(model_compute_partial(torch.where(own, im, zero),
                                          torch.where(own, gxg, zero),
                                          torch.where(own, gyg, zero)))
    acc_t.zero_()
    acc_c.zero_()
    return torch.stack(rows)


def _tiled_iteration(s: TiledFlowState, ev: _TileEvents, tl: _Tiling,
                     esc_cap: int, update_fn=None,
                     xla: bool = False) -> TiledFlowState:
    """One optimizer iteration on the tiled image (see the module
    docstring): splat the state's positions, reconcile the tiles, finish,
    update the model (``update_fn(model, state)`` in place of the reference
    step under the fast schedule) and re-warp every event.  ``xla``: the
    XLA branch's splat and finish in place of B8 and B9."""
    mesh, scale = tl.mesh, tl.scale
    lx, ly, gx, gy, escaped = _local_positions(s.pr_x, s.pr_y, ev, tl)
    if xla:
        acc_t, acc_c = _splat_exact(lx, ly, ev.t_sec, tl)
    else:
        acc_t, acc_c = splat_local_call(lx, ly, ev.t_sec, tl.acc_t,
                                        tl.acc_c, H=tl.H, W=tl.W)
    # The seams work on the logical images, the (n_local, H, W) views.
    images = [a[:, :tl.H, :tl.W] for a in (acc_t, acc_c)]

    for img in images:
        tl.fold_in(img, 0)
        tl.fold_in(img, 1)

    # Beyond-halo drifts, before the broadcast-back so that the completed
    # edge strips include them.  The lane runs only when some tile of some
    # rank has an escaped event: one blocking read an iteration.
    any_esc = escaped.any()
    if mesh.comm.size > 1:
        any_esc, = mesh.comm.all_reduce_max([any_esc.to(torch.int32)])
    esc = s.esc
    if bool(any_esc.item()):
        esc = torch.maximum(esc, _escape_lane(gx, gy, ev.t_sec, escaped,
                                              esc_cap, tl, acc_t, acc_c))

    for img in images:
        tl.broadcast_back(img, 0)
        tl.broadcast_back(img, 1)

    if xla:
        p = _finish_exact(acc_t, acc_c, tl)
    else:
        p = finish_local_call(acc_t, acc_c, scale=scale, H=tl.H, W=tl.W,
                              own=tl.own)
    p = _global_sums(p, tl)
    if mesh.comm.size > 1:
        p = mesh.comm.all_gather(p).reshape(-1, 7)
    # The sum over all tiles, in tile order.
    p = p.to(torch.float64).sum(dim=0).to(torch.float32)
    cx_img, cy_img, terms = model_from_partials(p)

    m = s.model.replace(cx=cx_img, cy=cy_img, dx=terms.dx, dy=terms.dy,
                        rot=terms.rot, div=terms.div, cnt=terms.cnt)
    if update_fn is None:
        m = m.update_accumulators(s.rot_div, s.div_div, s.x_div, s.y_div)
    else:
        m = update_fn(m, s)
    # The centroid back in event coordinates (a division by the constant
    # scale is a multiplication by its f32 reciprocal, as XLA compiles it).
    m = m.replace(cx=(m.cx - ev.x_sh) * recip(scale),
                  cy=(m.cy - ev.y_sh) * recip(scale))
    pr_x, pr_y, nx, ny = project_4param_reinit(
        ev.x, ev.y, ev.t, s.pr_x, s.pr_y, -m.total_dx, -m.total_dy, m.cx,
        m.cy, m.total_div, -m.total_rot)
    return s._replace(pr_x=pr_x, pr_y=pr_y, nx=nx, ny=ny, model=m,
                      iters=s.iters + 1, esc=esc)


def _initial_state(pr_x, pr_y, nx, ny, model: MotionModel,
                   cfg: OptimizerConfig) -> TiledFlowState:
    dev = pr_x.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return TiledFlowState(
        pr_x=pr_x, pr_y=pr_y, nx=nx, ny=ny, model=model,
        x_div=f32(cfg.init_xy_divider), y_div=f32(cfg.init_xy_divider),
        rot_div=f32(cfg.init_rotdiv_divider),
        div_div=f32(cfg.init_rotdiv_divider), iters=0,
        esc=torch.zeros((), dtype=torch.int64, device=dev))


def _check_tiled(cfg: OptimizerConfig, f64_totals: bool) -> None:
    """Raise for what the tiled path does not run: f64 totals (and what
    ``check_supported`` refuses everywhere)."""
    check_supported(cfg)
    if f64_totals:
        raise NotImplementedError(
            "f64 totals on the tiled path: the JAX package's tiled pipeline "
            "carries an f32 model only")


def _whole_chunks(cap: int) -> int:
    """Slots of a tile's bucket of ``cap`` events, padded to whole chunks (so
    that B8 finds every chunk's time base where the JAX kernel does)."""
    return -(-max(cap, CHUNK) // CHUNK) * CHUNK


def _local_tiles(a, mesh: TileGroup, dtype) -> torch.Tensor:
    """This process's tiles of a tile-major flat [n_tiles * cap] array, as
    a chunk-padded (n_local, capp) tensor on the group's device."""
    a = torch.as_tensor(a)
    if a.dim() != 1 or a.shape[0] % mesh.n_tiles != 0:
        raise ValueError(f"events of shape {tuple(a.shape)} do not divide "
                         f"over {mesh.n_tiles} tiles")
    cap = a.shape[0] // mesh.n_tiles
    a = a.reshape(mesh.n_tiles, cap)[
        mesh.first_tile:mesh.first_tile + mesh.n_local]
    return torch.nn.functional.pad(a.to(device=mesh.device, dtype=dtype),
                                   (0, _whole_chunks(cap) - cap))


def process_slice_tiled(x, y, t, active, init_model: MotionModel,
                        cfg: OptimizerConfig, sensor: SensorConfig,
                        mesh: TileGroup, halo: int = 32,
                        n_iters: Optional[int] = None, esc_cap: int = 4096
                        ) -> TiledSliceResult:
    """Run the 4-parameter optimizer on one slice with a tiled image.  The
    events are the tile-major flat [n_tiles * cap] arrays of
    ``bucket_events`` / ``bucket_events_2d`` (every rank passes the whole
    ones and keeps its tiles'); the window is the whole sensor.

    By default the reference's adaptive divider schedule runs
    (optimizer_rolling.h:60-111); ``n_iters`` forces a fixed count instead
    (the low-latency megapixel regime, bf_visualizer.cpp:102-104), with
    the reference's divider doubling on sign flips.  ``cfg.scatter_mode``
    selects B8 and B9 or the XLA branch, as in
    ``compensate_recording_tiled``.  ``esc_cap`` sizes each tile's escape
    lane; ``escaped_dropped`` reports overflow (0 = exact).
    The per-event results hold this process's tiles' slots in order (all of
    them for a group of one rank)."""
    _check_tiled(cfg, init_model.totals_dtype == torch.float64)
    tl = _Tiling(sensor, cfg.scale, mesh, halo)
    f32 = torch.float32
    xs, ys, ts = (_local_tiles(a, mesh, f32) for a in (x, y, t))
    cap = torch.as_tensor(x).shape[0] // mesh.n_tiles
    ev = _tile_events(xs, ys, ts, _local_tiles(active, mesh, torch.bool), tl,
                      None)
    model = MotionModel(*(getattr(init_model, f).to(mesh.device)
                          for f in FIELDS))
    init = _initial_state(xs, ys, torch.zeros_like(xs), torch.zeros_like(xs),
                          model, cfg)
    step = lambda s: _tiled_iteration(s, ev, tl, esc_cap,
                                      xla=xla_branch(cfg))
    if n_iters is None:
        final = adaptive_loop(init, step, cfg)
    else:
        # Zero the warm model's per-iteration deltas so that the first fixed
        # step never doubles a divider against stale values.
        z = torch.zeros((), dtype=f32, device=mesh.device)
        final = init._replace(model=model.replace(dx=z, dy=z, rot=z, div=z))
        dbl = lambda new, prev, div: torch.where(new * prev < 0, div * 2, div)
        for _ in range(n_iters):
            old = final.model
            final = step(final)
            m = final.model
            final = final._replace(
                x_div=dbl(m.dx, old.dx, final.x_div),
                y_div=dbl(m.dy, old.dy, final.y_div),
                rot_div=dbl(m.rot, old.rot, final.rot_div),
                div_div=dbl(m.div, old.div, final.div_div))
    u, v = compute_uv(final.nx, final.ny)
    own = lambda a: a[:, :cap].reshape(-1)
    return TiledSliceResult(
        model=final.model, pr_x=own(final.pr_x), pr_y=own(final.pr_y),
        u=own(u), v=own(v), iters=final.iters,
        escaped_dropped=int(final.esc.item()))


def bucket_events(x, y, t, res_x: int, scale: int, n_tiles_x: int,
                  cap_per_tile: int):
    """Host-side bucketing of events by home tile row (1-D row meshes):
    [n_tiles_x * cap] arrays ordered tile-major, with validity."""
    return bucket_events_2d(x, y, t, res_x, 0, scale, n_tiles_x, 1,
                            cap_per_tile)


def _home_tiles(x, y, res_x: int, res_y: int, scale: int, n_tx: int,
                n_ty: int) -> np.ndarray:
    """The tile (tx * n_ty + ty) that owns each event's original pixel."""
    tile_h = -(-(res_x * scale + scale) // n_tx)
    home = np.minimum((x * scale).astype(np.int64) // tile_h, n_tx - 1) * n_ty
    if n_ty > 1:
        tile_w = -(-(res_y * scale + scale) // n_ty)
        home += np.minimum((y * scale).astype(np.int64) // tile_w, n_ty - 1)
    return home


def bucket_events_2d(x, y, t, res_x: int, res_y: int, scale: int, n_tx: int,
                     n_ty: int, cap_per_tile: Optional[int],
                     on_overflow: str = "raise", idx=None):
    """Host-side bucketing by home tile (tx, ty): (xs, ys, ts, ok[, idx_out])
    as [n_tx * n_ty * cap] arrays in tile order (tx-major, ty-minor), so
    that each tile holds the events whose ORIGINAL pixel falls in it, in
    (x, y) order within the bucket (order never leaks: every per-event
    consumer maps through ``idx``).

    Tile overflow is never silent: with ``on_overflow="raise"`` (default) a
    too-small ``cap_per_tile`` raises with the capacity needed;
    ``cap_per_tile=None`` sizes to the fullest tile.  ``idx`` (optional
    per-event original indices) is bucketed alongside and returned as a
    fifth array (-1 in padding slots)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    t = np.asarray(t, np.float32)
    home = _home_tiles(x, y, res_x, res_y, scale, n_tx, n_ty)
    n_tiles = n_tx * n_ty
    counts = np.bincount(home, minlength=n_tiles)
    need = int(counts.max()) if len(x) else 0
    if cap_per_tile is None:
        cap_per_tile = max(need, 1)
    elif need > cap_per_tile and on_overflow == "raise":
        raise ValueError(
            f"tile overflow: fullest tile holds {need} events > "
            f"cap_per_tile {cap_per_tile}; pass cap_per_tile=None to "
            "auto-size")
    xs = np.zeros(n_tiles * cap_per_tile, np.float32)
    ys = np.zeros_like(xs)
    ts = np.zeros_like(xs)
    ok = np.zeros(n_tiles * cap_per_tile, bool)
    idx_out = np.full(n_tiles * cap_per_tile, -1, np.int32)
    for tile in range(n_tiles):
        sel = np.nonzero(home == tile)[0][:cap_per_tile]
        if len(sel):
            sel = sel[np.lexsort((y[sel], x[sel]))]
        dst = slice(tile * cap_per_tile, tile * cap_per_tile + len(sel))
        xs[dst], ys[dst], ts[dst], ok[dst] = x[sel], y[sel], t[sel], True
        if idx is not None:
            idx_out[dst] = np.asarray(idx)[sel]
    if idx is not None:
        return xs, ys, ts, ok, idx_out
    return xs, ys, ts, ok


def prepare_recording_tiled(x, y, t_ns, cfg, n_tx: int, n_ty: int,
                            cap_per_tile: Optional[int] = None) -> dict:
    """Host staging of the tiled pipeline: the trigger plan, the per-slice
    bbox and count, and per-slice per-tile bucketed slabs ``xb``, ``yb``,
    ``tb`` (slice-local ns) and ``idx`` (original index, -1 on padding) as
    [S, n_tiles * cap] numpy arrays.  ``cap_per_tile`` None sizes to the
    fullest (slice, tile) bucket, rounded up to 8: bucketing never drops an
    event.  Reusable across runs; ``compensate_recording_tiled`` copies a
    process's tiles to its device."""
    t0 = time.perf_counter()
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    plan = plan_slices(t_ns, cfg)
    S = len(plan.ends)
    scale = cfg.optimizer.scale
    res_x, res_y = cfg.sensor.res_x, cfg.sensor.res_y
    bbox, nval = host_bbox(x, y, plan)
    windows = [(int(plan.starts[s]), int(plan.ends[s]) + 1) for s in range(S)]
    if cap_per_tile is None:
        need = 1
        for a, b in windows:
            home = _home_tiles(x[a:b], y[a:b], res_x, res_y, scale, n_tx,
                               n_ty)
            need = max(need, int(np.bincount(home).max()))
        cap_per_tile = -(-need // 8) * 8
    slabs = [bucket_events_2d(
        x[a:b], y[a:b], (t_ns[a:b] - plan.slice_start_ns[s]).astype(
            np.float32), res_x, res_y, scale, n_tx, n_ty, cap_per_tile,
        idx=np.arange(a, b, dtype=np.int32))
        for s, (a, b) in enumerate(windows)]
    stack = lambda k, dtype: np.stack([sl[k] for sl in slabs]) if S else \
        np.zeros((0, n_tx * n_ty * cap_per_tile), dtype)
    return {
        "plan": plan, "n": len(x), "hist_k": history_depth(plan),
        "cap_per_tile": cap_per_tile, "n_tiles": (n_tx, n_ty),
        "xb": stack(0, np.float32), "yb": stack(1, np.float32),
        "tb": stack(2, np.float32), "idx": stack(4, np.int32),
        "bbox": bbox, "nval": nval,
        "plan_s": time.perf_counter() - t0,
    }


def _stage_tiles(prepared: dict, mesh: TileGroup) -> dict:
    """This process's tiles of the staged slabs on the group's device, as
    (S, n_local, capp) tensors (chunk-padded; idx -1 on padding)."""
    cap = prepared["cap_per_tile"]
    capp = _whole_chunks(cap)
    S = prepared["xb"].shape[0]
    a, b = mesh.first_tile, mesh.first_tile + mesh.n_local

    def put(key, fill):
        host = np.full((S, mesh.n_local, capp), fill, prepared[key].dtype)
        host[:, :, :cap] = prepared[key].reshape(S, mesh.n_tiles, cap)[:, a:b]
        return to_device(host, mesh.device)

    return {"x": put("xb", 0), "y": put("yb", 0), "t": put("tb", 0),
            "idx": put("idx", -1)}


def compensate_recording_tiled(
        x, y, t_ns, cfg, mesh: TileGroup, halo: int = 32,
        esc_cap: int = 4096, prepared: Optional[dict] = None,
        init_model: Optional[MotionModel] = None) -> dict:
    """Process a whole recording with tiled images: the tiled counterpart
    of ``runtime.scan_pipeline.compensate_recording_scan``.

    Per slice: the noise flags from the window-gate history, the bbox-window
    geometry and the window and event-count gates (host values), the
    warm-start warp, the tiled optimizer loop under the configured schedule
    with the secant seed carried from slice to slice, and the model carried
    on.  A skipped slice keeps the warm-start warp.  Then first-slice-wins
    accumulation by original index on the device, in reverse slice order,
    and the union over ranks.  Every rank returns the whole recording's
    ``u``, ``v``, ``noise`` (numpy, original event order), the final
    ``model``, per-slice ``iters`` and ``stats`` (``escaped_dropped``: 0 =
    exact for any drift; ``host_syncs``: the blocking reads of the schedule's
    exit test and of the escape lane's gate, two an iteration).
    ``cfg.optimizer.scatter_mode`` "auto" or "pallas" runs B8 and B9, "xla",
    "rep" or "mxu" the XLA branch (no launch; the module docstring), under
    either schedule."""
    _check_tiled(cfg.optimizer, cfg.f64_totals or (
        init_model is not None
        and init_model.totals_dtype == torch.float64))
    n_tx, n_ty = mesh.shape
    opt, sensor = cfg.optimizer, cfg.sensor
    tl = _Tiling(sensor, opt.scale, mesh, halo)
    if prepared is None:
        prepared = prepare_recording_tiled(x, y, t_ns, cfg, n_tx, n_ty)
    if tuple(prepared["n_tiles"]) != (n_tx, n_ty):
        raise ValueError(f"staged for {prepared['n_tiles']} tiles, the "
                         f"group has {(n_tx, n_ty)}")
    plan, n = prepared["plan"], prepared["n"]
    S = len(plan.ends)
    dev = mesh.device
    xla = xla_branch(opt)
    staged = _stage_tiles(prepared, mesh)
    model = init_model if init_model is not None else MotionModel.zero(dev)
    seed = torch.zeros(8, dtype=torch.float32, device=dev)
    hist = []            # (start, end) of the last hist_k slices, if gated
    hist_k = prepared["hist_k"]
    geoms = [geometry_from_bbox(*prepared["bbox"][s], opt.scale, sensor,
                                opt.min_window_fraction) for s in range(S)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches0 = dict(LAUNCHES)
    t_run0 = time.perf_counter()

    us, vs, noises, escs = [], [], [], []
    iters = np.zeros(S, np.int32)
    for s in range(S):
        sx, sy, st, si = (staged[k][s] for k in ("x", "y", "t", "idx"))
        geom = geoms[s]
        valid = si >= 0
        noise = torch.zeros_like(valid)
        for gate in hist:
            if gate is not None:
                noise |= (si >= gate[0]) & (si <= gate[1])
        mdl = model if not cfg.stm_disable else MotionModel.zero(dev)
        # Warm-start warp (set_model).
        pr_x, pr_y, nx, ny = project_4param_reinit(
            sx, sy, st, sx, sy, -mdl.total_dx, -mdl.total_dy, mdl.cx, mdl.cy,
            mdl.total_div, -mdl.total_rot)
        if not geom.window_small and \
                int(prepared["nval"][s]) >= opt.min_events:
            ev = _tile_events(sx, sy, st, valid & ~noise, tl, geom)
            final, seed = drive_loop(
                _initial_state(pr_x, pr_y, nx, ny, mdl, opt),
                lambda state, update_fn=None: _tiled_iteration(
                    state, ev, tl, esc_cap, update_fn, xla=xla), opt,
                seed=seed)
            model, nx, ny = final.model, final.nx, final.ny
            iters[s] = final.iters
            escs.append(final.esc)
        else:
            model = mdl
            seed = torch.zeros(8, dtype=torch.float32, device=dev)
        u, v = compute_uv(nx, ny)
        us.append(u)
        vs.append(v)
        noises.append((noise | valid) if geom.window_small else noise)
        hist = (hist + [(int(plan.starts[s]), int(plan.ends[s]))
                        if geom.window_small else None])[-hist_k:]

    # First-slice-wins accumulation by ORIGINAL index: this process's tiles
    # claim their events (an original pixel belongs to exactly one tile, so
    # claims are disjoint) in REVERSE slice order, the first containing
    # slice's write landing last; padding goes to a dump slot.
    acc = torch.zeros((3, n + 1), dtype=torch.float32, device=dev)
    for s in reversed(range(S)):
        si = staged["idx"][s].reshape(-1)
        tgt = torch.where(si >= 0, si, torch.full_like(si, n)).to(torch.int64)
        acc.index_copy_(1, tgt, torch.stack([
            us[s].reshape(-1), vs[s].reshape(-1),
            (noises[s] & (staged["idx"][s] >= 0)).reshape(-1).to(
                torch.float32)]))
    acc = acc[:, :n]
    esc = torch.stack(escs).max() if escs else torch.zeros(
        (), dtype=torch.int64, device=dev)
    if mesh.comm.size > 1:
        acc, = mesh.comm.all_reduce_sum([acc.contiguous()])
    escaped_dropped = int(esc.item())      # also waits for the device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t_run0
    acc = acc.cpu().numpy()
    return {
        "u": acc[0], "v": acc[1], "noise": acc[2] > 0, "model": model,
        "iters": iters,
        "stats": {
            "n_events": n, "n_slices": S, "n_tiles": (n_tx, n_ty),
            "cap_per_tile": prepared["cap_per_tile"],
            "escaped_dropped": escaped_dropped,
            "plan_s": prepared["plan_s"], "run_s": run_s,
            "events_per_s": n / run_s if run_s > 0 else 0.0,
            "mean_iters": float(np.mean(iters)) if S else 0.0,
            # The exit test's read and the lane gate's, every iteration.
            "host_syncs": 2 * int(iters.sum()),
            "launches": {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES},
        },
    }
