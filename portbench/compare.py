"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, as numbers each held to a limit of its own.

A cell's limits are in ``portbench/limits/<cell>.json``: for every number
compared, its limit and the readings it was set from.  Every number is
computed in every run and printed beside its limit; a number without a
limit is printed and not compared.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

import numpy as np

LIMITS_DIR = pathlib.Path(__file__).resolve().parent / "limits"
# A slice is off where its median gap passes this share of the mean speed:
# the bfloat16 control puts nearly every slice past it, sound runs few.
SLICE_OFF = 0.1


def _file(cell: str) -> dict:
    path = LIMITS_DIR / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def limits(cell: str) -> Dict[str, float]:
    """The cell's limit of each number compared."""
    return {k: float(v["limit"])
            for k, v in _file(cell).get("limits", {}).items()}


def _gap(u, v, ur, vr) -> np.ndarray:
    return np.hypot(u.astype(np.float64) - ur, v.astype(np.float64) - vr)


def flow_numbers(u, v, noise, ur, vr, noise_r, slices, speed: float,
                 iters=None, iters_r=None) -> Dict[str, float]:
    """The numbers of one comparison.  ``slices`` lists each compared
    slice's (first, end) event range within the arrays.  Gaps are in
    units of the reference's mean flow speed ``speed`` (px/s).

    - ``noise_mismatch``: events whose noise flag differs (exact);
    - ``flow_gap_p50``, ``flow_gap_p90``: quantiles over events of the
      distance between the two flows;
    - ``slice_gap_max``: the largest, over slices, of a slice's median
      gap: an altered slice shows here;
    - ``slices_off``: the number of slices whose median gap passes
      ``SLICE_OFF``;
    - ``iters_mismatch``: the share of slices whose iteration counts
      differ; ``iters_gap``: the gap of their sums over the reference's;
    - ``nonfinite``: events whose flow is not a finite number."""
    g = _gap(u, v, ur, vr)
    bad = ~np.isfinite(g)
    g = np.where(bad, np.inf, g) / speed
    per = [float(np.median(g[a:b])) for a, b in slices if b > a]
    out = {
        "noise_mismatch": float(np.count_nonzero(noise != noise_r)),
        "nonfinite": float(np.count_nonzero(bad)),
        "flow_gap_p50": float(np.quantile(g, 0.5)),
        "flow_gap_p90": float(np.quantile(g, 0.9)),
        "slice_gap_max": max(per) if per else 0.0,
        "slices_off": float(sum(p > SLICE_OFF for p in per)),
    }
    if iters is not None:
        it, itr = np.asarray(iters, np.int64), np.asarray(iters_r, np.int64)
        out["iters_mismatch"] = float(np.mean(it != itr)) if len(it) else 0.0
        out["iters_gap"] = float(abs(it.sum() - itr.sum())
                                 / max(int(itr.sum()), 1))
    return out


def claimed(starts, ends) -> List[tuple]:
    """Each slice's own events in a first-slice-wins result: from its
    window's start or the previous trigger, whichever is later, to its
    trigger."""
    return [(max(int(a), int(ends[s - 1]) + 1 if s else 0), int(b) + 1)
            for s, (a, b) in enumerate(zip(starts, ends))]


def mean_speed(ur, vr) -> float:
    """The reference's mean flow speed, never below 1 px/s."""
    return max(float(np.mean(np.hypot(ur.astype(np.float64), vr))), 1.0)


def judge(numbers: Dict[str, float], lim: Dict[str, float]
          ) -> List[dict]:
    """Each number with its limit and whether it holds; ``nonfinite`` is
    held to 0 always.  A number without a limit is listed with limit
    None."""
    lim = dict(lim)
    lim.setdefault("nonfinite", 0.0)
    rows = []
    for k, v in numbers.items():
        L: Optional[float] = lim.get(k)
        ok = True if L is None else bool(np.isfinite(v) and v <= L)
        rows.append({"name": k, "value": v, "limit": L, "ok": ok})
    return rows


def failed(reason: str) -> List[dict]:
    """A comparison that could not be made counts as failed."""
    return [{"name": reason, "value": 1.0, "limit": 0.0, "ok": False}]
