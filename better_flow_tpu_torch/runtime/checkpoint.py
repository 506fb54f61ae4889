"""Checkpoint and resume of the streaming pipeline (DVSFlow).

Counterpart of ``better_flow_tpu/runtime/checkpoint.py``, in its version-2
``.npz`` format: a stream checkpointed by the JAX package resumes here, and
the reverse.  The state carried across is the motion model (each field
saved and loaded with its dtype, so an f64 run's totals stay f64), the
trigger counters, the ring buffer's events and noise flags, and the
accumulated slices.

One deliberate difference: the port also writes ``DVSFlow.last_seed``, the
secant seed the ``fast`` schedules carry from slice to slice, under the key
``last_seed``, and reads it when present (zeros otherwise).  The JAX
package's checkpoint omits it, so a stream it resumes under a ``fast``
schedule restarts the slope memory from zeros and differs from an
uninterrupted run; the JAX loader ignores the extra key, so the format
stays readable both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from better_flow_tpu_torch.core.model import FIELDS, MotionModel
from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow, SliceRecord

FORMAT_VERSION = 2


def save_checkpoint(path: str, engine: DVSFlow) -> None:
    snap = engine.buffer.snapshot()
    state = {
        "version": FORMAT_VERSION,
        "event_diff": engine.event_diff,
        "time_diff": engine.time_diff,
        "last_slice_time": engine.last_slice_time,
        "current_slice_time": engine.current_slice_time,
        "frame_count": engine.frame_count,
        "buf_x": snap["x"],
        "buf_y": snap["y"],
        "buf_ts": snap["timestamp"],
        "buf_noise": snap["noise"],
        "n_slices": len(engine.slices),
        "last_seed": engine.last_seed.cpu().numpy(),
    }
    for f in FIELDS:
        state[f"model_{f}"] = getattr(engine.last_model, f).cpu().numpy()
    if engine.slices:
        for key in ("x", "y", "timestamp", "u", "v", "noise"):
            state[f"acc_{key}"] = np.concatenate(
                [getattr(r, key) for r in engine.slices])
        state["acc_len"] = np.array([r.n_events for r in engine.slices])
        state["acc_start"] = np.array([r.slice_start_time
                                       for r in engine.slices])
        state["acc_iters"] = np.array([r.iters for r in engine.slices])
    np.savez_compressed(path, **state)


def load_checkpoint(path: str, engine: DVSFlow) -> DVSFlow:
    """Restore a checkpoint into a freshly built engine of the same
    configuration."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint version {int(z['version'])}, "
                         f"expected {FORMAT_VERSION}")
    dev = engine.device
    engine.event_diff = int(z["event_diff"])
    engine.time_diff = int(z["time_diff"])
    engine.last_slice_time = int(z["last_slice_time"])
    engine.current_slice_time = int(z["current_slice_time"])
    engine.frame_count = int(z["frame_count"])
    # Each field keeps its stored dtype (f64 totals and compensations from
    # an f64 run), as the JAX loader keeps it.
    engine.last_model = MotionModel(*(
        torch.from_numpy(np.asarray(z[f"model_{f}"])).to(dev)
        for f in FIELDS))
    seed = (z["last_seed"] if "last_seed" in z.files
            else np.zeros(8, np.float32))
    engine.last_seed = torch.tensor(seed, dtype=torch.float32, device=dev)
    engine.buffer.push_batch(z["buf_x"], z["buf_y"], z["buf_ts"])
    snap = engine.buffer.snapshot()
    engine.buffer.noise[snap["index"]] = z["buf_noise"]

    engine.slices = []
    if "acc_len" in z.files:
        off = 0
        for i, n in enumerate(z["acc_len"]):
            n = int(n)
            sl = slice(off, off + n)
            start = int(z["acc_start"][i])
            engine.slices.append(SliceRecord(
                x=z["acc_x"][sl], y=z["acc_y"][sl],
                timestamp=z["acc_timestamp"][sl],
                t_local=(z["acc_timestamp"][sl] - start).astype(np.float32),
                u=z["acc_u"][sl], v=z["acc_v"][sl], noise=z["acc_noise"][sl],
                pr_x=z["acc_x"][sl], pr_y=z["acc_y"][sl],
                model=engine.last_model, iters=int(z["acc_iters"][i]),
                wall_s=0.0, n_events=n, slice_start_time=start))
            off += n
    return engine
