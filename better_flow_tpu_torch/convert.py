"""The scan carry across the two packages.

This system has no weights: the state a run carries from slice to slice
(the motion model, the secant seed and the window-gate history) is what a
run can start from.  ``carry_from_numpy`` turns the JAX package's
``make_carry`` tuple, given as numpy, into this package's carry, and
``carry_to_numpy`` does the reverse, so both packages can start mid-chain
from the same state.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from better_flow_tpu_torch.core.model import FIELDS, MotionModel


def carry_from_numpy(model_fields: Union[Mapping, Sequence], seed12, ws_h,
                     st_h, en_h, device="cpu"):
    """``model_fields``: the 15 model values, by name or in
    ``core.model.FIELDS`` order (the JAX ``MotionModel._fields`` order);
    ``seed12``: the (12,) seed; ``ws_h``/``st_h``/``en_h``: the (K,) gate
    history.  Returns (model, seed12, ws_h, st_h, en_h) with the model and
    the seed as f32 tensors on ``device`` and the history on the host."""
    if isinstance(model_fields, Mapping):
        vals = [model_fields[f] for f in FIELDS]
    else:
        vals = list(model_fields)
        if len(vals) != len(FIELDS):
            raise ValueError(f"expected {len(FIELDS)} model fields, got "
                             f"{len(vals)}")
    v = torch.tensor(np.asarray(vals, np.float32), device=device)
    seed = torch.tensor(np.asarray(seed12, np.float32).reshape(-1))
    if seed.shape[0] != 12:
        raise ValueError(f"seed12: {seed.shape[0]} values, expected 12")
    return (MotionModel(*v.unbind()), seed.to(device),
            np.asarray(ws_h, bool).copy(), np.asarray(st_h, np.int32).copy(),
            np.asarray(en_h, np.int32).copy())


def carry_to_numpy(carry):
    """The reverse of ``carry_from_numpy``: (model values in field order as
    an f32 array, seed12, ws_h, st_h, en_h), all numpy."""
    model, seed, ws_h, st_h, en_h = carry
    vals = torch.stack([getattr(model, f) for f in FIELDS])
    return (vals.cpu().numpy().astype(np.float32),
            seed.cpu().numpy().astype(np.float32),
            np.asarray(ws_h, bool).copy(), np.asarray(st_h, np.int32).copy(),
            np.asarray(en_h, np.int32).copy())
