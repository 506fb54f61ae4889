"""The scan carry across the two packages.

This system has no weights: the state a run carries from slice to slice
(the motion model, the secant seed and the window-gate history) is what a
run can start from.  ``carry_from_numpy`` turns the JAX package's
``make_carry`` tuple, given as numpy, into this package's carry, and
``carry_to_numpy`` does the reverse, so both packages can start mid-chain
from the same state.  An f64-totals carry (``PipelineConfig.f64_totals``)
keeps its totals and compensations f64 both ways.  The gate history travels
with the carry, so a range run of one package (``prepare_recording(
slice_range=...)``, ``parallel.multihost``) can start from the carry the
other package's previous range ended with: ``carry_from_jax`` and
``carry_to_jax`` take and give the JAX package's own tuple layout.

The local flow field's state is its gathered windows: ``windows_from_numpy``
turns the JAX package's ``LocalWindow`` fields, fetched to numpy, into this
package's, so that a descent can start from the other package's gather.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from better_flow_tpu_torch.core.model import FIELDS, TOTAL_FIELDS, MotionModel


def carry_from_numpy(model_fields: Union[Mapping, Sequence], seed12, ws_h,
                     st_h, en_h, device="cpu"):
    """``model_fields``: the 15 model values, by name or in
    ``core.model.FIELDS`` order (the JAX ``MotionModel._fields`` order);
    ``seed12``: the (12,) seed; ``ws_h``/``st_h``/``en_h``: the (K,) gate
    history.  Returns (model, seed12, ws_h, st_h, en_h) with the model and
    the seed as tensors on ``device`` and the history on the host.  The
    model is f32, except that totals given as float64 numpy values (an
    f64-totals carry) stay f64 with their compensations."""
    if isinstance(model_fields, Mapping):
        vals = [model_fields[f] for f in FIELDS]
    else:
        vals = list(model_fields)
        if len(vals) != len(FIELDS):
            raise ValueError(f"expected {len(FIELDS)} model fields, got "
                             f"{len(vals)}")
    tdx = vals[FIELDS.index("total_dx")]
    f64 = isinstance(tdx, (np.ndarray, np.generic)) and \
        tdx.dtype == np.float64
    model = MotionModel(*(
        torch.tensor(np.float64(v) if f64 and f in TOTAL_FIELDS
                     else np.float32(v), device=device)
        for f, v in zip(FIELDS, vals)))
    seed = torch.tensor(np.asarray(seed12, np.float32).reshape(-1))
    if seed.shape[0] == 8:
        # An (8,) seed is padded as the JAX package's make_carry pads it:
        # with the model's own totals (rot, div, dx, dy).
        seed = torch.cat([seed, model.totals4().to(torch.float32).cpu()])
    if seed.shape[0] != 12:
        raise ValueError(f"seed12: {seed.shape[0]} values, expected 8 or 12")
    if not len(ws_h) == len(st_h) == len(en_h):
        raise ValueError("gate history: ws_h, st_h and en_h differ in length")
    return (model, seed.to(device),
            np.asarray(ws_h, bool).copy(), np.asarray(st_h, np.int32).copy(),
            np.asarray(en_h, np.int32).copy())


def carry_to_numpy(carry):
    """The reverse of ``carry_from_numpy``: (model values in field order as
    an array in the totals' dtype -- f32, or f64 for an f64-totals carry,
    whose other fields are f32 values held exactly -- seed12, ws_h, st_h,
    en_h), all numpy."""
    model, seed, ws_h, st_h, en_h = carry
    dt = model.totals_dtype
    vals = torch.stack([getattr(model, f).to(dt) for f in FIELDS])
    return (vals.cpu().numpy(),
            seed.cpu().numpy().astype(np.float32),
            np.asarray(ws_h, bool).copy(), np.asarray(st_h, np.int32).copy(),
            np.asarray(en_h, np.int32).copy())


def carry_from_jax(carry_np, device="cpu"):
    """The JAX package's carry tuple ``(model, seed, ws_h, st_h, en_h)``,
    fetched to numpy (``jax.tree_util.tree_map(np.asarray, carry)``; the
    model a 15-tuple in field order), as this package's hand-off carry."""
    model, seed, ws_h, st_h, en_h = carry_np
    return carry_from_numpy(tuple(model), seed, ws_h, st_h, en_h,
                            device=device)


def carry_to_jax(carry):
    """This package's carry in the JAX package's tuple layout, all numpy:
    ``(15 model values each in its own dtype, seed12, ws_h, st_h, en_h)``,
    ready for ``MotionModel(*map(jnp.asarray, model))`` and ``make_carry``
    over there."""
    model, seed, ws_h, st_h, en_h = carry
    vals = tuple(getattr(model, f).cpu().numpy() for f in FIELDS)
    return (vals, seed.cpu().numpy().astype(np.float32),
            np.asarray(ws_h, bool).copy(), np.asarray(st_h, np.int32).copy(),
            np.asarray(en_h, np.int32).copy())


def windows_from_numpy(fields: Union[Mapping, Sequence], device="cpu"):
    """The JAX package's ``LocalWindow`` fields as numpy, by name or in
    field order (x, y, t, valid, cx, cy: (G, K) f32 and bool, (G,) f32),
    as this package's ``LocalWindow`` on ``device``."""
    # Imported here: the scan pipeline, which the model imports, imports
    # this module.
    from better_flow_tpu_torch.models.local_flow import LocalWindow

    names = LocalWindow._fields
    if isinstance(fields, Mapping):
        vals = [fields[f] for f in names]
    else:
        vals = list(fields)
        if len(vals) != len(names):
            raise ValueError(f"expected {len(names)} window fields, got "
                             f"{len(vals)}")
    return LocalWindow(*(
        torch.tensor(np.asarray(v, bool if f == "valid" else np.float32),
                     device=device) for f, v in zip(names, vals)))
