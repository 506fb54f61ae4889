"""The streaming slice manager (DVS_flow) on PyTorch.

Counterpart of ``better_flow_tpu/runtime/dvs_flow.py``; reference
DVS_flow<MAX_SZ, SPAN> (dvs_flow.h:21-389).  Event ingestion and the
triggers stay on the host (a numpy ring buffer and the vectorised feed);
each fired slice is sorted by (32-row band, column) on the host, copied to
the device as one packed (5, cap) f32 input from pinned memory, and run
through ``models.global_flow.process_slice``: under the reference schedule
one megastep launch (B5) per optimizer iteration, under the ``fast``
presets the split pair (B1 + B2), then the final warp (B4); under
``megastep_merged`` one B12 launch per iteration and none for the final
warp; with f64 totals (``PipelineConfig.f64_totals``) or
``use_megastep=False`` the composed loop, one B6 launch per iteration;
with ``scatter_mode="xla"`` the XLA branch on the flat slice, in plain
tensor operations.  The motion model (f64 totals
under ``f64_totals``) and the secant seed carried from slice to slice stay
on the device.
One packed output per slice comes back; every per-event output is mapped
back through the sort's inverse permutation to the ring's order.

``pipeline_depth`` K > 0 defers the fetch of up to K slices' outputs
(``recompute`` returns the record of the slice dispatched K calls earlier,
or None while the pipe fills; ``flush`` drains it).  Outputs are
bit-identical to depth 0: the only cross-slice state a later slice reads
is the ring's noise flags, whose one source is the window gate, which is
geometric and applied on the host at dispatch.  The optimizer loop reads
the continue flag once per iteration, so dispatch itself waits for the
optimizer; what the pipe defers is the final warp and the fetch.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from better_flow_tpu_torch.config import PipelineConfig
from better_flow_tpu_torch.core.events import EventSlice
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.models.global_flow import (
    check_supported, geo_row, geometry_from_bbox, process_slice, xla_branch,
)
from better_flow_tpu_torch.ops.layout import pack_act, prepare_chunk_layouts
from better_flow_tpu_torch.runtime.scan_pipeline import (
    default_device, to_device,
)
from better_flow_tpu_torch.runtime.slice_buffer import EventRingBuffer

SORT_BAND = 32   # row-band height of the streaming host sort


class SliceRecord:
    """Per-slice outputs kept for accumulation and inspection (the
    reference's ``accumulated`` vector and motion memory,
    dvs_flow.h:43-46, 238-252, 340-346)."""

    __slots__ = ("x", "y", "timestamp", "t_local", "u", "v", "noise",
                 "pr_x", "pr_y", "model", "iters", "wall_s", "n_events",
                 "slice_start_time", "interval_s")

    def __init__(self, **kw):
        self.interval_s = None
        for k, v in kw.items():
            setattr(self, k, v)


class DVSFlow:
    def __init__(self, cfg: PipelineConfig, pipeline_depth: int = 0,
                 compact_fetch: bool = False, device=None):
        """``pipeline_depth``: slices allowed in flight beyond the one being
        finalized (0: the reference's synchronous behaviour).
        ``compact_fetch``: fetch u, v, pr_x, pr_y as f16 and noise as u8
        (9 B an event instead of 20); u/v quantise to ~1e-3 relative.
        ``device``: where the slices run (default: the card when there is
        one, else the CPU)."""
        check_supported(cfg.optimizer, cfg.f64_totals)
        if cfg.slice.max_events < 8:
            raise ValueError("SliceConfig.max_events < 8: the upload's "
                             "last row holds the 8-value geometry row")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else default_device()
        sl = cfg.slice
        self.buffer = EventRingBuffer(sl.max_events, sl.span_ns)
        self.last_model = MotionModel.zero(self.device,
                                           f64_totals=cfg.f64_totals)
        self.last_seed = torch.zeros(8, dtype=torch.float32,
                                     device=self.device)
        # Trigger state (dvs_flow.h:30-36).
        self.event_diff = 0
        self.time_diff = 0
        self.last_slice_time = 0
        self.current_slice_time = 0
        self.slices: List[SliceRecord] = []
        self.frame_count = 0
        self.on_slice: Optional[Callable[[SliceRecord], None]] = None
        self.pipeline_depth = int(pipeline_depth)
        self.compact_fetch = bool(compact_fetch)
        # Blocking device reads: one continue-flag read per optimizer
        # iteration and one fetch per slice.
        self.host_syncs = 0
        self._pending: List[dict] = []
        self._last_final_t: Optional[float] = None

    # ------------------------------------------------------------------ feed
    def add_event(self, x: float, y: float, timestamp: int) -> bool:
        """DVS_flow::add_event (dvs_flow.h:163-181).  Returns True if a
        recompute fired."""
        self.buffer.push(x, y, timestamp)
        self.event_diff += 1
        self.current_slice_time = int(timestamp)
        self.time_diff = self.current_slice_time - self.last_slice_time
        if (self.event_diff < self.cfg.slice.refresh_events
                and self.time_diff < self.cfg.slice.refresh_time_ns):
            return False
        self.recompute()
        return True

    def add_events(self, x, y, timestamp) -> int:
        """Vectorised feed of a sorted batch, with the trigger points of an
        event-by-event feed; returns the number of recomputes."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        ts = np.asarray(timestamp, np.int64)
        n = len(ts)
        fired = 0
        start = 0
        ev_th = self.cfg.slice.refresh_events
        t_th = self.cfg.slice.refresh_time_ns
        while start < n:
            # Next count trigger: when event_diff reaches ev_th.
            i_count = start + (ev_th - self.event_diff) - 1
            # Next time trigger: first i with ts[i] - last_slice_time >= t_th.
            i_time = int(np.searchsorted(ts[start:],
                                         self.last_slice_time + t_th,
                                         "left")) + start
            i = min(i_count, i_time)
            if i >= n:
                self.buffer.push_batch(x[start:], y[start:], ts[start:])
                self.event_diff += n - start
                self.current_slice_time = int(ts[-1])
                self.time_diff = self.current_slice_time - self.last_slice_time
                break
            self.buffer.push_batch(x[start:i + 1], y[start:i + 1],
                                   ts[start:i + 1])
            self.event_diff += i + 1 - start
            self.current_slice_time = int(ts[i])
            self.time_diff = self.current_slice_time - self.last_slice_time
            self.recompute()
            fired += 1
            start = i + 1
        return fired

    # ------------------------------------------------------------- recompute
    def recompute(self) -> Optional[SliceRecord]:
        """DVS_flow::recompute (dvs_flow.h:184-347) without the HUD.  At
        depth 0 returns this slice's record; at depth K the record of the
        oldest in-flight slice once more than K are pending (None while the
        pipe fills)."""
        t_begin = time.perf_counter()
        snap = self.buffer.snapshot()
        n = len(snap["x"])
        cap = self.buffer.capacity

        # Slice start time (dvs_flow.h:186-193).
        if n == cap:
            slice_start = int(snap["timestamp"][0])
        else:
            slice_start = max(self.current_slice_time - self.buffer.span_ns,
                              0)
        t_local = (snap["timestamp"] - slice_start).astype(np.float32)

        # Host spatial sort into the kernels' chunk-local layout, stable.
        key = ((snap["x"].astype(np.int64) // SORT_BAND) * 4096
               + snap["y"].astype(np.int64))
        order = np.argsort(key, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(n)

        if n > 0:
            bbox = (int(snap["x"].min()), int(snap["x"].max()),
                    int(snap["y"].min()), int(snap["y"].max()))
        else:
            bbox = (0, 0, 0, 0)
        opt = self.cfg.optimizer
        geom = geometry_from_bbox(*bbox, opt.scale, self.cfg.sensor,
                                  opt.min_window_fraction)
        # The window gate is geometric, so the host marks the ring's noise
        # flags at dispatch: the only cross-slice state a later slice reads,
        # which keeps pipelined runs bit-identical to synchronous ones.
        if geom.window_small and n > 0:
            self.buffer.noise[snap["index"]] = True

        # One upload: rows x, y, t_local, noise (the flags before this
        # slice's gate) and the kernels' (1, 8) geometry row.
        inp = np.zeros((5, cap), np.float32)
        inp[0, :n] = snap["x"][order]
        inp[1, :n] = snap["y"][order]
        inp[2, :n] = t_local[order]
        inp[3, :n] = snap["noise"][order]
        inp[4, 0:8] = geo_row(geom)[0]
        res, packed, ready = self._process(inp, n, bbox)

        # last_model = optimizer.get_model() (dvs_flow.h:224); with stm
        # disabled the optimizer started from zero and its result is still
        # kept.  Both stay on the device.
        self.last_model = res.model
        self.last_seed = res.seed
        self.host_syncs += res.reads
        self._pending.append(dict(
            snap=snap, inv=inv, n=n, slice_start=slice_start,
            t_local=t_local, t_dispatch=t_begin, packed=packed, ready=ready,
            model=res.model, iters=res.iters))

        # Reset triggers (dvs_flow.h:337-338).
        self.event_diff = 0
        self.last_slice_time = self.current_slice_time

        if len(self._pending) > self.pipeline_depth:
            return self._finalize(self._pending.pop(0))
        return None

    def _process(self, inp: np.ndarray, n: int, bbox):
        """One slice on the device.  Returns (SliceResult, the packed output
        on its way to the host, a CUDA event that marks its arrival or
        None)."""
        dev = self.device
        cap = inp.shape[1]
        d = to_device(inp, dev)
        valid = torch.arange(cap, device=dev) < n
        ev = EventSlice(x=d[0], y=d[1], t=d[2], valid=valid,
                        noise=d[3] > 0.5)
        if xla_branch(self.cfg.optimizer):
            stat = act = None            # the XLA branch reads ``ev``
        else:
            stat = prepare_chunk_layouts(ev.x, ev.y, ev.t)
            act = pack_act(ev.active)
        geo = d[4, 0:8].reshape(1, 8)
        res, _ = process_slice(
            stat, act, self.last_model, self.cfg.optimizer, self.cfg.sensor,
            bbox, n, warm_start=not self.cfg.stm_disable,
            seed=self.last_seed, geo=geo, ev=ev)
        rows = [res.u[:cap], res.v[:cap], res.pr_x[:cap], res.pr_y[:cap]]
        if self.compact_fetch:
            f16 = torch.stack(rows).to(torch.float16)
            packed = torch.cat([f16.view(torch.uint8).reshape(-1),
                                res.noise.to(torch.uint8)])
        else:
            packed = torch.stack(rows + [res.noise.to(torch.float32)])
        if dev.type != "cuda":
            return res, packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        return res, host, ready

    def _finalize(self, ent: dict) -> SliceRecord:
        """Wait for one dispatched slice's output, decode it into the ring's
        order, write it back to the still-live ring slots and emit the
        record."""
        snap, inv, n = ent["snap"], ent["inv"], ent["n"]
        if ent["ready"] is not None:
            ent["ready"].synchronize()
        self.host_syncs += 1
        packed_h = ent["packed"].numpy()
        if self.compact_fetch:
            cap = packed_h.shape[0] // 9
            f16 = packed_h[:8 * cap].view(np.float16).reshape(4, cap)
            u, v, pr_x, pr_y = (f16[k, :n].astype(np.float32)[inv]
                                for k in range(4))
            noise = packed_h[8 * cap:8 * cap + n][inv] > 0
        else:
            u, v, pr_x, pr_y = (packed_h[k, :n][inv] for k in range(4))
            noise = packed_h[4, :n][inv] > 0.5
        # Under pipelining the ring may have recycled some slots: write back
        # only to slots that still hold this slice's events.
        idx = snap["index"]
        still = self.buffer.timestamp[idx] == snap["timestamp"]
        if still.all():
            self.buffer.writeback(idx, noise=noise, u=u, v=v, pr_x=pr_x,
                                  pr_y=pr_y)
        elif still.any():
            self.buffer.writeback(idx[still], noise=noise[still],
                                  u=u[still], v=v[still],
                                  pr_x=pr_x[still], pr_y=pr_y[still])

        t_done = time.perf_counter()
        wall = t_done - ent["t_dispatch"]
        rec = SliceRecord(
            x=snap["x"].copy(), y=snap["y"].copy(),
            timestamp=snap["timestamp"].copy(), t_local=ent["t_local"],
            u=u, v=v, noise=noise, pr_x=pr_x, pr_y=pr_y, model=ent["model"],
            iters=ent["iters"], wall_s=wall, n_events=n,
            slice_start_time=ent["slice_start"])
        rec.interval_s = (t_done - self._last_final_t
                          if self._last_final_t is not None else wall)
        self._last_final_t = t_done
        if self.cfg.accumulate:
            self.slices.append(rec)
        if self.on_slice is not None:
            self.on_slice(rec)
        return rec

    def flush(self) -> List[SliceRecord]:
        """Finalize every in-flight slice."""
        out = []
        while self._pending:
            out.append(self._finalize(self._pending.pop(0)))
        return out

    # ---------------------------------------------------------- introspection
    def get_buf_size(self) -> int:
        return len(self.buffer)

    def get_time_diff(self) -> int:
        return self.time_diff

    def get_buf_time_diff(self) -> int:
        """dvs_flow.h:150-159."""
        if len(self.buffer) == self.buffer.capacity:
            start = self.buffer.oldest_timestamp()
        else:
            start = max(self.current_slice_time - self.buffer.span_ns, 0)
        return self.current_slice_time - start

    def realtime_factor(self) -> float:
        """%realtime: the last slice's time span over its wall time
        (dvs_flow.h:275-282)."""
        if not self.slices:
            return 0.0
        r = self.slices[-1]
        span_s = ((r.timestamp[-1] - r.slice_start_time) / 1e9
                  if r.n_events else 0.0)
        return span_s / r.wall_s if r.wall_s > 0 else 0.0

    def get_accumulated(self):
        from better_flow_tpu_torch.runtime.accumulate import merge_slices

        self.flush()
        return merge_slices(self.slices)
