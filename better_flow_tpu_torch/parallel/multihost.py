"""Multi-process recording processing: slice ranges across processes, event
parallelism inside each.

Counterpart of ``better_flow_tpu/parallel/multihost.py``:

* the global trigger plan is cut into contiguous slice ranges; each process
  OWNS its ranges and stages ONLY those (host memory, the native sort and
  the host-to-device copies scale 1/N);
* within a process each slice's events are sharded over ``ev_per_host``
  local shards (``event_parallel``): the per-iteration image sum never
  leaves the process;
* across processes the only traffic is the scan carry at range boundaries
  (the 15 model values, the secant seed and the window-gate history), one
  broadcast per boundary, and one gather of the disjoint per-range results.

Two boundary semantics:

* ``boundary="chain"`` (default; exactly the single-process run): range k
  starts from range k-1's final carry, so the ranges run one after another:
  wall time does not scale, memory and staging do.  That is the honest shape
  of the reference's warm-start chain (dvs_flow.h:215-224), a sequential
  dependence.
* ``boundary="cold"`` (exact under ``cfg.stm_disable``, approximate
  otherwise): every range starts from the initial model, so processes run
  concurrently.

Per-range outputs are disjoint by construction (a range claims only the
events whose FIRST containing slice is local, ``scan_pipeline.
accumulate_device``), so the whole result is their elementwise sum.  The
noise flags at a boundary need no communication: the window gate is
geometric, so each process rebuilds the history before its range from the
recording (``stage_range``'s ``hist0``).  A call derives the plan and the
coordinates once (``staging_source``) and stages its ranges from them.

One process can run several ranges (``n_ranges``): without a process group
the same code runs all of them in sequence, which is how the range logic is
tested without spawning processes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from better_flow_tpu_torch.config import PipelineConfig
from better_flow_tpu_torch.core.model import FIELDS, TOTAL_FIELDS, MotionModel
from better_flow_tpu_torch.models.global_flow import check_supported
from better_flow_tpu_torch.parallel import event_parallel
from better_flow_tpu_torch.parallel.comm import LocalComm, world
from better_flow_tpu_torch.parallel.mesh import EventGroup, group_device
from better_flow_tpu_torch.runtime.scan_pipeline import (
    initial_carry, stage_range, staging_source,
)


def slice_ranges(n_slices: int, n_ranges: int):
    """``n_ranges`` contiguous ranges of ceil(n / ranges) slices (the last
    ones may be short or empty)."""
    per = (n_slices + n_ranges - 1) // n_ranges
    return [(min(k * per, n_slices), min((k + 1) * per, n_slices))
            for k in range(n_ranges)]


def _pack_carry(carry, device):
    """A carry as three tensors (the model's 15 values as f64, which holds
    f32 exactly; the (12,) seed; the (3, K) int32 gate history)."""
    model, seed, ws_h, st_h, en_h = carry
    vals = torch.stack([getattr(model, f).to(torch.float64) for f in FIELDS])
    hist = torch.from_numpy(np.stack([np.asarray(ws_h, np.int32),
                                      np.asarray(st_h, np.int32),
                                      np.asarray(en_h, np.int32)]))
    return [vals.to(device), seed.to(device), hist.to(device)]


def _unpack_carry(tensors, f64_totals: bool):
    vals, seed, hist = tensors
    tdt = torch.float64 if f64_totals else torch.float32
    model = MotionModel(*(v.to(tdt if f in TOTAL_FIELDS else torch.float32)
                          for f, v in zip(FIELDS, vals.unbind())))
    h = hist.cpu().numpy()
    return (model, seed, h[0].astype(bool), h[1].copy(), h[2].copy())


def compensate_recording_multihost(
        x, y, t_ns, cfg: Optional[PipelineConfig] = None,
        boundary: str = "chain", ev_per_host: Optional[int] = None,
        gather: bool = True, comm=None, device=None,
        n_ranges: Optional[int] = None) -> dict:
    """Process a recording across all participating processes.

    Every process calls this with the SAME recording and arguments.  The
    plan is cut into ``n_ranges`` ranges (default: one per process; a
    multiple of the number of processes), ``n_ranges / processes``
    consecutive ones per process.  Returns the whole recording's result on
    every process when ``gather=True``; otherwise ``u``/``v``/``noise``
    hold only this process's claimed events (zeros elsewhere).  ``iters``
    and ``ran`` stay range-local; ``stats['slice_range']`` spans this
    process's ranges.  ``device`` defaults to the card; pass ``"cpu"`` to
    run the plain twins."""
    cfg = cfg or PipelineConfig()
    check_supported(cfg.optimizer, cfg.f64_totals)
    if boundary not in ("chain", "cold"):
        raise ValueError(f"boundary must be 'chain' or 'cold': {boundary}")
    comm = world() if comm is None else comm
    dev = group_device(device)
    n_proc, pid = comm.size, comm.rank
    R = n_proc if n_ranges is None else int(n_ranges)
    if R <= 0 or R % n_proc != 0:
        raise ValueError(f"{R} ranges do not divide over {n_proc} processes")
    src = staging_source(x, y, t_ns, cfg)
    n, S = src.n, len(src.plan.ends)
    k = R // n_proc
    mine = slice_ranges(S, R)[pid * k:(pid + 1) * k]

    mesh = EventGroup(LocalComm(), ev_per_host or 1, dev)
    staged = [stage_range(src, cfg, mesh.device, r,
                          *event_parallel.shard_staging(cfg, mesh))
              for r in mine]

    def run_mine(carry):
        """This process's ranges in order; ``carry`` None: each from its
        own initial carry (independent ranges)."""
        outs = []
        for prep in staged:
            c0 = carry if carry is not None else initial_carry(prep, cfg)
            outs.append(event_parallel.compensate_recording_scan_sharded(
                None, None, None, cfg, mesh, prepared=prep, carry_in=c0))
            if carry is not None:
                carry = outs[-1]["carry"]
        return outs

    if boundary == "cold" or cfg.stm_disable:
        outs = run_mine(None)
    else:
        # Sequential chain: wait for the previous process's carry, run,
        # hand off.  The broadcast is a collective, so every process takes
        # part at every boundary, which is what serializes the ranges.
        carry = initial_carry(staged[0], cfg)
        outs = None
        for h in range(n_proc):
            if h == pid:
                outs = run_mine(carry)
                carry = outs[-1]["carry"]
            if h < n_proc - 1:
                carry = _unpack_carry(
                    comm.broadcast(_pack_carry(carry, dev), src=h),
                    cfg.f64_totals)

    # Per-range claims are disjoint: their sum (or) is the whole result.
    u = np.sum([o["u"] for o in outs], axis=0, dtype=np.float32)
    v = np.sum([o["v"] for o in outs], axis=0, dtype=np.float32)
    noise = np.any([o["noise"] for o in outs], axis=0)
    if gather and n_proc > 1:
        both = comm.all_gather(torch.from_numpy(np.stack([u, v])).to(dev))
        flags = comm.all_gather(torch.from_numpy(noise.astype(np.int32)
                                                 ).to(dev))
        u, v = both.sum(dim=0).cpu().numpy()
        noise = flags.sum(dim=0).cpu().numpy() > 0
    last = outs[-1]
    iters = np.concatenate([o["iters"] for o in outs])
    st = dict(last["stats"])
    run_s = sum(o["stats"]["run_s"] for o in outs)
    launches = {key: sum(o["stats"]["launches"][key] for o in outs)
                for key in last["stats"]["launches"]}
    st.update(n_events=n, n_slices=len(iters), n_processes=n_proc,
              slice_range=(mine[0][0], mine[-1][1]), n_slices_total=S,
              n_ranges=R, boundary=boundary, ev_per_host=mesh.n_local,
              run_s=run_s,
              plan_s=src.seconds + sum(p["plan_s"] for p in staged),
              events_per_s=n / run_s if run_s > 0 else 0.0,
              mean_iters=float(np.mean(iters)) if len(iters) else 0.0,
              host_syncs=sum(o["stats"]["host_syncs"] for o in outs),
              launches=launches)
    return {"u": u, "v": v, "noise": noise, "model": last["model"],
            "carry": last["carry"], "iters": iters,
            "ran": np.concatenate([o["ran"] for o in outs]), "stats": st}
