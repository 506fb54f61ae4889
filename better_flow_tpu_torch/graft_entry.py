"""Entry hooks of the port: one slice, and a dry run of every scale-out.

Counterpart of the JAX package's ``__graft_entry__.py``.  ``entry`` gives
the flagship step, one slice of global 4-parameter motion compensation
(``models.global_flow.process_event_slice``) on a 24x32 sensor, with its
example arguments.  ``dryrun(n_shards)`` runs the four stages of
``dryrun_multichip`` with every shard or tile resident on one device, where
the JAX package lays them over a mesh of devices:

1. the temporal batch (``parallel.temporal.process_slices_batch``): slices
   over slice lanes, each slice's events over an event group, under
   ``scatter_mode`` "auto" (the kernel branch) and "xla";
2. the event-parallel scan forced to the kernel branch ("pallas"): B1 over
   the shards, the image sum, B2;
3. the tiled recording pipeline at 180x240 with ``escaped_dropped == 0``,
   under "xla" (the JAX package's run off the TPU) and "pallas" (B8, B9);
4. two chained slice ranges of the event-parallel scan, handed off through
   ``make_carry(..., seed=...)``, with disjoint claims, together bitwise
   the whole recording's scan.

Each stage asserts what the JAX stage asserts, prints one line and raises
on a failure.  Both run on the card unless ``device="cpu"``.

    python -m better_flow_tpu_torch.graft_entry [n_shards] [--cpu]
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from better_flow_tpu_torch.config import (
    OptimizerConfig, PipelineConfig, SensorConfig, SliceConfig,
)
from better_flow_tpu_torch.core.events import EventSlice, make_slice
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.io.synthetic import synthetic_events
from better_flow_tpu_torch.models.global_flow import process_event_slice
from better_flow_tpu_torch.ops import fused_model
from better_flow_tpu_torch.parallel import event_parallel
from better_flow_tpu_torch.parallel.mesh import (
    group_device, make_event_mesh, make_pipeline_mesh, make_tiled_mesh,
)
from better_flow_tpu_torch.parallel.spatial import compensate_recording_tiled
from better_flow_tpu_torch.parallel.temporal import process_slices_batch
from better_flow_tpu_torch.runtime.scan_pipeline import (
    make_carry, plan_slices,
)

SENSOR = SensorConfig(24, 32)


def _example_slice(capacity=2048, seed=0, sensor=SENSOR,
                   device="cpu") -> EventSlice:
    """``__graft_entry__._example_slice``: 90% of ``capacity`` synthetic
    events over 0.1 s, a translating scene."""
    d = synthetic_events(int(capacity * 0.9), duration_s=0.1,
                         res_x=sensor.res_x, res_y=sensor.res_y, vx=18.0,
                         vy=-12.0, n_points=60, seed=seed)
    return make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64),
                      capacity=capacity, device=device)


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` runs one slice on a 24x32
    sensor (``OptimizerConfig(scale=3, max_iter=8)``, warm start) and
    returns its ``SliceResult``."""
    dev = group_device(device)
    cfg = OptimizerConfig(scale=3, max_iter=8)
    fn = functools.partial(process_event_slice, cfg=cfg, sensor=SENSOR,
                           warm_start=True)
    return fn, (_example_slice(device=dev), MotionModel.zero(dev))


def _finite(name: str, a) -> None:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if not np.isfinite(a).all():
        raise AssertionError(f"{name}: non-finite values")


def _stage1(n: int, dev) -> None:
    n_slice = 2 if n % 2 == 0 and n > 1 else 1
    n_ev = n // n_slice
    mesh = make_pipeline_mesh(n_slice, n_ev, device=dev)
    cap = 256 * n_ev
    n_slices = 2 * n_slice
    ev_batch = [_example_slice(capacity=cap, seed=s, device=dev)
                for s in range(n_slices)]
    for mode in ("auto", "xla"):
        cfg = OptimizerConfig(scale=3, max_iter=3, min_events=100,
                              scatter_mode=mode)
        res = process_slices_batch(
            ev_batch, [MotionModel.zero(dev) for _ in range(n_slices)], cfg,
            SENSOR, mesh, warm_start=True)
        u = torch.stack([r.u for r in res])
        if tuple(u.shape) != (n_slices, cap):
            raise AssertionError(f"temporal batch: u of shape "
                                 f"{tuple(u.shape)}")
        _finite("temporal batch u", u)
        print(f"dryrun [1/4 temporal, {mode}] OK: (slice={n_slice}, "
              f"ev={n_ev}), {n_slices} slices x {cap} events, "
              f"iters={[r.iters for r in res]}")


def _scan_cfg() -> PipelineConfig:
    return PipelineConfig(
        sensor=SENSOR,
        slice=SliceConfig(max_events=2048, span_ns=int(0.05e9),
                          refresh_events=1024, refresh_time_ns=int(0.03e9)),
        optimizer=OptimizerConfig(scale=3, max_iter=2, min_events=100,
                                  scatter_mode="pallas"))


def _scan_stream():
    return synthetic_events(6000, duration_s=0.15, res_x=SENSOR.res_x,
                            res_y=SENSOR.res_y, vx=18.0, vy=-12.0,
                            n_points=60, seed=1)


def _stage2(n: int, dev, d, pcfg) -> dict:
    mesh = make_event_mesh(n, device=dev)
    fused_model.reset_launches()
    out = event_parallel.compensate_recording_scan_sharded(
        d["x"], d["y"], d["t_ns"], pcfg, mesh)
    _finite("event-parallel scan u", out["u"])
    b1, b2 = (fused_model.LAUNCHES[k] for k in ("warp_images_st",
                                                 "megastep_finish"))
    if dev.type == "cuda" and not (b1 == b2 == int(out["iters"].sum()) > 0):
        raise AssertionError(f"event-parallel scan: B1 {b1} and B2 {b2} "
                             f"launches for {int(out['iters'].sum())} "
                             "iterations")
    print(f"dryrun [2/4 event-parallel scan, kernel branch] OK: "
          f"{out['stats']['n_slices']} slices over {n} shards, "
          f"iters={out['iters'].tolist()}, B1/B2 launches {b1}/{b2}")
    return out


def _stage3(n: int, dev) -> None:
    n_tx = 2 if n % 2 == 0 and n > 1 else 1
    n_ty = n // n_tx
    mesh = make_tiled_mesh((n_tx, n_ty), device=dev)
    d = synthetic_events(16000, duration_s=0.1, res_x=180, res_y=240,
                         vx=40.0, vy=-25.0, n_points=200, seed=2)
    for mode in ("xla", "pallas"):
        cfg = PipelineConfig(
            sensor=SensorConfig(180, 240),
            slice=SliceConfig(max_events=9000, span_ns=int(0.05e9),
                              refresh_events=6000,
                              refresh_time_ns=int(0.04e9)),
            optimizer=OptimizerConfig(scale=1, max_iter=3, min_events=100,
                                      scatter_mode=mode))
        r = compensate_recording_tiled(d["x"], d["y"], d["t_ns"], cfg, mesh,
                                       halo=32)
        _finite("tiled u", r["u"])
        if r["stats"]["escaped_dropped"] != 0:
            raise AssertionError(f"tiled {mode}: escaped_dropped "
                                 f"{r['stats']['escaped_dropped']}")
        print(f"dryrun [3/4 tiled recording, {mode}] OK: (tile_x={n_tx}, "
              f"tile_y={n_ty}), sensor 180x240, {r['stats']['n_slices']} "
              f"slices, iters={r['iters'].tolist()}")


def _stage4(n: int, dev, d, pcfg, full: dict) -> None:
    mesh = make_event_mesh(n, device=dev)
    S = len(plan_slices(np.ascontiguousarray(d["t_ns"], np.int64),
                        pcfg).ends)
    mid = max(1, S // 2)
    carry = None
    claimed = np.zeros(len(d["x"]), bool)
    u = np.zeros(len(d["x"]), np.float32)
    for lo, hi in ((0, mid), (mid, S)):
        prep = event_parallel.prepare_recording_sharded(
            d["x"], d["y"], d["t_ns"], pcfg, mesh, slice_range=(lo, hi))
        if carry is None:
            ws_h, st_h, en_h = prep["hist0"]
            carry = make_carry(MotionModel.zero(dev), prep["hist_k"],
                               ws_h=ws_h, st_h=st_h, en_h=en_h)
        out = event_parallel.compensate_recording_scan_sharded(
            None, None, None, pcfg, mesh, prepared=prep, carry_in=carry)
        # The hand-off payload: the model, the (12,) seed, the history.
        model, seed, ws_h, st_h, en_h = out["carry"]
        carry = make_carry(model, prep["hist_k"], seed=seed, ws_h=ws_h,
                           st_h=st_h, en_h=en_h)
        claim = out["u"] != 0
        if (claimed & claim).any():
            raise AssertionError("range claims overlap")
        claimed |= claim
        u += out["u"]
    _finite("range u", u)
    if not np.array_equal(u, full["u"]):
        raise AssertionError("two chained ranges differ from the whole "
                             "recording's scan")
    print(f"dryrun [4/4 chained ranges] OK: 2 ranges x {n} shards over {S} "
          f"slices, carry hand-off at slice {mid}, {int(claimed.sum())} "
          "events claimed, bitwise the whole scan")


def dryrun(n_shards: int, device=None) -> None:
    """The four stages of ``dryrun_multichip`` over ``n_shards`` shards
    (tiles) resident on one device (the card unless ``device="cpu"``)."""
    n = int(n_shards)
    if n <= 0:
        raise ValueError(f"n_shards = {n}")
    dev = group_device(device)
    _stage1(n, dev)
    d, pcfg = _scan_stream(), _scan_cfg()
    full = _stage2(n, dev, d, pcfg)
    _stage3(n, dev)
    _stage4(n, dev, d, pcfg, full)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    nums = [a for a in argv if a != "--cpu"]
    fn, args = entry(device)
    print(f"entry OK, iters = {fn(*args).iters}")
    dryrun(int(nums[0]) if nums else 2, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
