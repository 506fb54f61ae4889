"""Event-parallel slice processing: shard the events, sum the images.

Counterpart of ``better_flow_tpu/parallel/event_parallel.py``.  The events
of one slice are cut into shards over an ``EventGroup`` (``mesh``); every
optimizer iteration runs the event phase of the local shards, sums their
pre-filter images across ranks and runs the image-space finish and the
model update once per process on the summed images.  Each drive runs one
splat launch over all the local shards' chunks into the image pair it owns
(B1 in the megastep drive, B7a in the composed drive), all-reduces that pair
in place and runs the finish (B2; B7b and the scalar chain), which leaves
the pair zero for the next iteration.  The summed
images are integers, so every rank computes the same model and the same
continue flag with no further communication, and the result does not
depend on the number of shards when they are cut on chunk boundaries (the
scan pads the capacity to ``n_shards * CHUNK`` for that).

The XLA branch's modes ("xla", "rep", "mxu", the JAX package's default off
the TPU) take the same seam in plain tensor code: the local shards' events
as one flat slice, one exact integer scatter of them an iteration, the
all-reduce of that pair, then the box filter and the image chain once per
process (``models.global_flow.process_slice_xla`` with its ``group``).  The
pair is integer too, so the branch under a group of any size is bitwise
the single-device XLA branch, whatever the cut.

Divergences by design from the JAX package's signatures: a group
(``mesh.EventGroup``) stands where JAX takes a ``Mesh`` and its axis name,
and the number of shards is the group's (``n_shards``) where JAX's
``prepare_recording_sharded`` takes ``n_dev``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from better_flow_tpu_torch.config import OptimizerConfig, SensorConfig
from better_flow_tpu_torch.core.events import EventSlice, bounding_box
from better_flow_tpu_torch.core.model import MotionModel
from better_flow_tpu_torch.models.global_flow import (
    SliceResult, check_supported, process_slice, xla_branch,
)
from better_flow_tpu_torch.ops.layout import (
    CHUNK, pack_act, prepare_chunk_layouts,
)
from better_flow_tpu_torch.parallel.mesh import EventGroup
from better_flow_tpu_torch.runtime.scan_pipeline import (
    initial_carry, prepare_recording, scan_prepared, staged_capacity,
)


def local_event_shards(ev: EventSlice, group: EventGroup) -> list:
    """This process's shards of the whole slice ``ev``: equal contiguous
    runs of slots, on the group's device."""
    n = group.n_shards
    if ev.capacity % n != 0:
        raise ValueError(f"capacity {ev.capacity} not divisible by the "
                         f"{n} event shards")
    per = ev.capacity // n
    first = group.first_shard
    return [EventSlice(*(f[k * per:(k + 1) * per].to(group.device)
                         for f in ev))
            for k in range(first, first + group.n_local)]


def process_slice_event_parallel(ev: EventSlice, last_model: MotionModel,
                                 cfg: OptimizerConfig, sensor: SensorConfig,
                                 mesh: EventGroup, warm_start: bool = True
                                 ) -> SliceResult:
    """Sharded equivalent of ``models.global_flow.process_slice`` on the
    whole slice ``ev`` (every rank passes the same one; its capacity must
    divide by the number of shards, else ``ValueError``).  The bbox and the
    event count are reduced over the group.  Returns a ``SliceResult``
    whose model and scalars are the same on every rank and whose per-event
    tensors hold this process's shards' slots in order (all of them for a
    group of one rank).  The XLA branch's modes run on the local shards'
    slots put end to end (``process_slice``'s ``ev`` under the group); the
    kernel branch lays each shard out in whole chunks."""
    shards = local_event_shards(ev, mesh)
    per = shards[0].capacity
    bbox = bounding_box(shards, mesh.comm)
    n_valid = torch.stack([e.valid.sum() for e in shards]).sum()
    if mesh.comm.size > 1:
        n_valid, = mesh.comm.all_reduce_sum([n_valid])
    if xla_branch(cfg):
        local = EventSlice(*(torch.cat(f) for f in zip(*shards)))
        res, _uvn = process_slice(None, None, last_model, cfg, sensor, bbox,
                                  int(n_valid), warm_start=warm_start,
                                  ev=local, group=mesh)
        return res
    stats = [prepare_chunk_layouts(e.x, e.y, e.t) for e in shards]
    acts = [pack_act(e.active) for e in shards]
    # The local shards as one range of chunks, joined once a slice.
    res, _uvn = process_slice(torch.cat(stats), torch.cat(acts), last_model,
                              cfg, sensor, bbox, int(n_valid),
                              warm_start=warm_start, group=mesh)
    # Each shard was padded to whole chunks: keep its own slots.
    slots = stats[0].shape[0] * CHUNK

    def own(a):
        return a.reshape(len(shards), slots)[:, :per].reshape(-1)

    noise = torch.cat([e.noise | (e.valid & res.window_small)
                       for e in shards])
    return res._replace(pr_x=own(res.pr_x), pr_y=own(res.pr_y),
                        nx=own(res.nx), ny=own(res.ny), u=own(res.u),
                        v=own(res.v), noise=noise)


def jit_event_parallel(cfg: OptimizerConfig, sensor: SensorConfig,
                       mesh: EventGroup, warm_start: bool = True):
    """``process_slice_event_parallel`` with ``cfg``, ``sensor``, ``mesh``
    and ``warm_start`` bound: call it as ``fn(ev, last_model)``.  The
    counterpart of the JAX package's ``jit_event_parallel``; it compiles
    nothing (the port has no tracing step: the kernels are built on their
    first launch, ``ops._build``)."""
    return functools.partial(process_slice_event_parallel, cfg=cfg,
                             sensor=sensor, mesh=mesh, warm_start=warm_start)


def shard_staging(cfg, mesh: EventGroup):
    """(pad_quantum, chunk_range) of staging for ``mesh``: the padded
    capacity rounded to a multiple of ``n_shards * CHUNK``, so that every
    shard is a whole number of the unsharded run's chunks, and only this
    process's chunks copied to the group's device."""
    n = mesh.n_shards
    per = staged_capacity(cfg, n * CHUNK) // CHUNK // n
    chunk_range = None if mesh.comm.size == 1 else \
        (mesh.first_shard * per, (mesh.first_shard + mesh.n_local) * per)
    return n * CHUNK, chunk_range


def prepare_recording_sharded(x, y, t_ns, cfg, mesh: EventGroup,
                              slice_range=None) -> dict:
    """Host staging for the sharded scan: ``prepare_recording`` as
    ``shard_staging`` sets it for ``mesh``, on the group's device."""
    return prepare_recording(x, y, t_ns, cfg, mesh.device, slice_range,
                             *shard_staging(cfg, mesh))


def check_staged_for(prepared: dict, mesh: EventGroup) -> None:
    """Raise unless ``prepared`` holds this process's chunks of ``mesh``."""
    total, n = prepared["chunks_total"], mesh.n_shards
    if total % n != 0:
        raise ValueError(f"staged with {total} chunks a slice, which do not "
                         f"divide into {n} event shards: stage with "
                         "prepare_recording_sharded")
    per = total // n
    want = (mesh.first_shard * per, (mesh.first_shard + mesh.n_local) * per)
    if mesh.comm.size == 1:
        want = (0, total)
    if tuple(prepared["chunks"]) != want:
        raise ValueError(f"staged chunks {prepared['chunks']}, this "
                         f"process's shards are chunks {want}")
    if prepared["device"] != mesh.device:
        raise ValueError(f"staged on {prepared['device']}, the group is on "
                         f"{mesh.device}")


def compensate_recording_scan_sharded(
        x, y, t_ns, cfg, mesh: EventGroup,
        init_model: Optional[MotionModel] = None,
        prepared: Optional[dict] = None, carry_in=None) -> dict:
    """The offline slice loop with each slice's events sharded over
    ``mesh``: per iteration one event kernel over the local shards, the
    image sum, then the finish and the model update once per process.
    Cross-slice noise needs no communication: its only source is the
    per-slice window gate, decided on the host from the whole slice's bbox,
    and each shard rebuilds its events' flags from the gate history (B3).  Every rank returns the
    whole recording's result (the shards' outputs are gathered before the
    first-slice-wins accumulation); ``stats['n_devices']`` is the number of
    shards.  Pass ``prepared`` from ``prepare_recording_sharded`` to reuse
    the staging, ``carry_in`` to continue a chain."""
    check_supported(cfg.optimizer, cfg.f64_totals)
    if prepared is None:
        prepared = prepare_recording_sharded(x, y, t_ns, cfg, mesh)
    check_staged_for(prepared, mesh)
    carry0 = carry_in if carry_in is not None \
        else initial_carry(prepared, cfg, init_model)
    out = scan_prepared(prepared, cfg, carry0, group=mesh)
    out["stats"]["n_devices"] = mesh.n_shards
    return out
