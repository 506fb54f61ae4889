"""Temporal (slice) parallelism over independent slices.

Counterpart of ``better_flow_tpu/parallel/temporal.py``.  With the warm
start chained, slices are sequential (``runtime.scan_pipeline``).  With each
slice given its own model (``--stm-disable``, or given models) slices share
no state: a batch of slices is split over the ranks of a ``PipelineGroup``
(``mesh.make_pipeline_mesh``) and each slice's events over the process-local
event shards.  Where the JAX package maps the batch with ``vmap``, a process
loops over its slices.
"""

from __future__ import annotations

from typing import List, Sequence

from better_flow_tpu_torch.config import OptimizerConfig, SensorConfig
from better_flow_tpu_torch.core.events import EventSlice
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.models.global_flow import SliceResult
from better_flow_tpu_torch.parallel.event_parallel import (
    process_slice_event_parallel,
)
from better_flow_tpu_torch.parallel.mesh import PipelineGroup


def process_slices_batch(ev_batch: Sequence[EventSlice],
                         models: Sequence[MotionModel], cfg: OptimizerConfig,
                         sensor: SensorConfig, mesh: PipelineGroup,
                         warm_start: bool = False) -> List[SliceResult]:
    """Process a batch of independent slices: contiguous blocks of the batch
    over the ranks of ``mesh.comm``, each slice's events over ``mesh.ev``.
    ``warm_start`` applies each slice's *given* model (no chaining across
    slices: that needs the sequential scan).  The batch size must divide by
    ``mesh.n_slices``.  Returns this process's slices' results, in order
    (all of them for one rank)."""
    S = len(ev_batch)
    if len(models) != S:
        raise ValueError(f"{S} slices but {len(models)} models")
    if S % mesh.n_slices != 0:
        raise ValueError(f"{S} slices do not divide over the "
                         f"{mesh.n_slices} slice lanes")
    per = S // mesh.comm.size
    lo = mesh.comm.rank * per
    return [process_slice_event_parallel(ev_batch[s], models[s], cfg, sensor,
                                         mesh.ev, warm_start=warm_start)
            for s in range(lo, lo + per)]
