"""The 4-parameter global motion model as 0-d tensors.

Counterpart of ``better_flow_tpu/core/model.py``: centroid (cx, cy), the
last iteration's gradient (dx, dy, rot, div), the nonzero-pixel count and
the accumulated totals that define the warp, with Kahan compensation of the
totals.  Every field is f32, except that under f64 totals
(``PipelineConfig.f64_totals``, the reference's double accumulators,
object_model.h:10-13) the totals and their compensations are f64.  The
update promotes as the JAX package's does: an f32 step plus an f64 total is
taken in f64.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

FIELDS: Tuple[str, ...] = (
    "cx", "cy", "dx", "dy", "rot", "div", "cnt",
    "total_dx", "total_dy", "total_rot", "total_div",
    "comp_dx", "comp_dy", "comp_rot", "comp_div",
)
# The fields held in the totals' dtype.
TOTAL_FIELDS: Tuple[str, ...] = FIELDS[7:]


def _kadd(total, comp, delta):
    y = delta - comp
    t = total + y
    return t, (t - total) - y


@dataclasses.dataclass(frozen=True)
class MotionModel:
    cx: torch.Tensor
    cy: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    rot: torch.Tensor
    div: torch.Tensor
    cnt: torch.Tensor
    total_dx: torch.Tensor
    total_dy: torch.Tensor
    total_rot: torch.Tensor
    total_div: torch.Tensor
    comp_dx: torch.Tensor
    comp_dy: torch.Tensor
    comp_rot: torch.Tensor
    comp_div: torch.Tensor

    @staticmethod
    def zero(device="cpu", f64_totals: bool = False) -> "MotionModel":
        """A fresh model; with ``f64_totals`` the totals and compensations
        are f64 zeros."""
        z = torch.zeros(7, dtype=torch.float32, device=device)
        zt = torch.zeros(8, dtype=torch.float64 if f64_totals
                         else torch.float32, device=device)
        return MotionModel(*z.unbind(), *zt.unbind())

    def replace(self, **kw) -> "MotionModel":
        return dataclasses.replace(self, **kw)

    @property
    def totals_dtype(self) -> torch.dtype:
        return self.total_dx.dtype

    def totals4(self) -> torch.Tensor:
        """(rot, div, dx, dy) totals as one (4,) tensor in their dtype."""
        return torch.stack([self.total_rot, self.total_div,
                            self.total_dx, self.total_dy])

    def update_accumulators(self, d_rot, d_div, d_x, d_y) -> "MotionModel":
        """``total_p += p / divider``, the reference schedule's step
        (object_model.h:48-53): the f32 gradient over the f32 divider,
        added to the totals in their dtype."""
        return self.add_totals(self.rot / d_rot, self.div / d_div,
                               self.dx / d_x, self.dy / d_y)

    def pretty(self) -> str:
        """Host-side print (ObjectModel::operator<<, object_model.h:
        55-63), the same string as the JAX package's ``pretty``."""
        return (
            f"C: ({float(self.cx)}, {float(self.cy)}); \n"
            f"\t Shift: ({float(self.dx)}, {float(self.dy)}); "
            f" total: ({float(self.total_dx)}, {float(self.total_dy)});\n"
            f"\t Rot: {float(self.rot)} total: {float(self.total_rot)}\n"
            f"\t Div: {float(self.div)} total: {float(self.total_div)}\n"
            f"\t cnt: {int(self.cnt)}"
        )

    def add_totals(self, d_rot, d_div, d_x, d_y) -> "MotionModel":
        """Kahan-compensated ``total_p += d_p``."""
        total_rot, comp_rot = _kadd(self.total_rot, self.comp_rot, d_rot)
        total_div, comp_div = _kadd(self.total_div, self.comp_div, d_div)
        total_dx, comp_dx = _kadd(self.total_dx, self.comp_dx, d_x)
        total_dy, comp_dy = _kadd(self.total_dy, self.comp_dy, d_y)
        return self.replace(
            total_rot=total_rot, comp_rot=comp_rot,
            total_div=total_div, comp_div=comp_div,
            total_dx=total_dx, comp_dx=comp_dx,
            total_dy=total_dy, comp_dy=comp_dy,
        )
