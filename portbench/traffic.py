"""The one generator of the benchmark's traffic, driven by a mix's file.

A mix (``portbench/traffic/<name>.json``) names a scene generator of
``portbench/gen`` and its parameters, the sensor's event rate, and how the
events reach the program:

- ``"arrival": "closed_loop"``: recordings of ``recording_events`` events
  each, processed one after another; ``pool_recordings`` distinct ones are
  made in set-up and taken in turn;
- ``"arrival": "open_loop"``: one live stream at ``rate_eps``, delivered in
  packets of ``packet_s`` seconds of sensor time, each due on the wall
  clock at its sensor time.

Every recording and stream is a sequence of ``segment_s``-second segments
of the scene (the scene drifts off the sensor within a second at its
speed), drawn in a seeded order from ``pool_segments`` distinct segments
made from the seed.  ``subpixel`` adds seeded uniform [0, 1) offsets to x
and y, the sub-pixel coordinates of rectified events.  The same seed gives
the same events; every seed gives the same sizes and rates.

Two keys give every seed the same work, in another order:
``"pool_seed"`` makes the pool of segments from that number in place of
the run's seed, and ``"order": "rounds"`` takes a stream's segments in
rounds that hold each of the pool's segments once, each round in a seeded
order (the default, ``"draws"``, draws each segment independently).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from portbench.gen import dvs_sim, synthetic

GENERATORS = {
    "synthetic": synthetic.synthetic_events,
    "dvs_sim": dvs_sim.dvs_events,
}


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), salt]))


def segments(mix: dict, seed: int,
             salt: int = 0) -> List[Dict[str, np.ndarray]]:
    """``pool_segments`` distinct segments of the scene: x, y (f64 pixels)
    and t_ns (int64, from 0) at ``rate_eps`` over ``segment_s``."""
    gen = GENERATORS[mix["generator"]]
    n = int(round(mix["rate_eps"] * mix["segment_s"]))
    seeds = _rng(seed, 1 + salt).integers(0, 2 ** 62, mix["pool_segments"])
    out = []
    for s in seeds:
        d = gen(n, duration_s=mix["segment_s"], seed=int(s), **mix["scene"])
        out.append({"x": d["x"], "y": d["y"], "t_ns": d["t_ns"]})
    return out


def _subpixel(rec: dict, mix: dict, rng: np.random.Generator) -> dict:
    """Seeded uniform [0, 1) offsets on x and y, clipped inside the sensor
    (``chip_smoke.subpixel_stream``'s rule)."""
    out = dict(rec)
    for k, r in (("x", mix["scene"]["res_x"]), ("y", mix["scene"]["res_y"])):
        out[k] = np.clip(rec[k] + rng.uniform(0, 1, len(rec[k])), 0,
                         np.nextafter(r, 0))
    return out


def recordings(mix: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool of closed-loop recordings: each ``recording_events`` long,
    segments in a seeded order, their times one after another."""
    segs = segments(mix, seed)
    step = int(round(mix["segment_s"] * 1e9))
    rng = _rng(seed, 2)
    pool = []
    for _ in range(mix["pool_recordings"]):
        xs, ys, ts, have, j = [], [], [], 0, 0
        while have < mix["recording_events"]:
            sg = segs[int(rng.integers(len(segs)))]
            xs.append(sg["x"])
            ys.append(sg["y"])
            ts.append(sg["t_ns"] + j * step)
            have += len(sg["t_ns"])
            j += 1
        m = mix["recording_events"]
        rec = {"x": np.concatenate(xs)[:m], "y": np.concatenate(ys)[:m],
               "t_ns": np.concatenate(ts)[:m]}
        if mix.get("subpixel"):
            rec = _subpixel(rec, mix, rng)
        pool.append(rec)
    return pool


@dataclass
class Stream:
    """A live stream: segments in a seeded order, one after another, taken
    by sensor time without ever being put together whole until
    ``events``."""

    segs: List[Dict[str, np.ndarray]]
    order: np.ndarray
    step_ns: int

    def take(self, lo_ns: int, hi_ns: int):
        """The events with lo_ns <= t < hi_ns: (x f32, y f32, t int64)."""
        parts = []
        j = lo_ns // self.step_ns
        while j * self.step_ns < hi_ns:
            sg = self.segs[self.order[j % len(self.order)]]
            base = j * self.step_ns
            a = np.searchsorted(sg["t_ns"], lo_ns - base, "left")
            b = np.searchsorted(sg["t_ns"], hi_ns - base, "left")
            if b > a:
                parts.append((sg["x"][a:b], sg["y"][a:b],
                              sg["t_ns"][a:b] + base))
            j += 1
        if not parts:
            z = np.zeros(0)
            return z.astype(np.float32), z.astype(np.float32), \
                z.astype(np.int64)
        return (np.concatenate([p[0] for p in parts]).astype(np.float32),
                np.concatenate([p[1] for p in parts]).astype(np.float32),
                np.concatenate([p[2] for p in parts]))

    def events(self, hi_ns: int):
        """Every event before ``hi_ns``, put together."""
        return self.take(0, hi_ns)


def stream(mix: dict, seed: int, seconds: float, salt: int = 0) -> Stream:
    """A live stream of ``seconds`` of sensor time (``salt`` makes another
    stream from the same seed, such as the warm-up's)."""
    segs = segments(mix, mix.get("pool_seed", seed), salt)
    step = int(round(mix["segment_s"] * 1e9))
    n_seg = int(np.ceil(seconds / mix["segment_s"])) + 1
    rng = _rng(seed, 3 + salt)
    if mix.get("order", "draws") == "rounds":
        rounds = -(-n_seg // len(segs))
        order = np.concatenate([rng.permutation(len(segs))
                                for _ in range(rounds)])[:n_seg]
    else:
        order = rng.integers(0, len(segs), n_seg)
    return Stream(segs=segs, order=order, step_ns=step)
