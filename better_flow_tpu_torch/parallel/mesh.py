"""Shard groups: what a device mesh of the JAX package becomes.

Counterpart of ``better_flow_tpu/parallel/mesh.py``.  A ``Mesh(('ev',))``
becomes an ``EventGroup``: a communicator, the number of event shards this
process holds and their device.  The shards of a group are numbered rank by
rank: rank r holds shards [r * n_local, (r + 1) * n_local).  One rank per
card holding one shard is the deployment; several shards resident in one
process are the analogue of the JAX tests' virtual CPU devices, and what
the tests on the CPU and a single card run.  The megastep drive loops over
the local shards and sums their images, the composed drive splats all of
them in one launch; either then all-reduces the image pair across the
ranks.

A ``Mesh(('slice', 'ev'))`` becomes a ``PipelineGroup``: independent slices
over the ranks of its communicator, each slice's events over a process-local
``EventGroup``.

A ``Mesh(('tile_x', 'tile_y'))`` becomes a ``TileGroup``: the image plane cut
into n_tx x n_ty tiles, numbered tx-major (tile k is (k // n_ty, k % n_ty),
the flattened order of the JAX mesh) and held rank by rank as an event
group's shards are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from better_flow_tpu_torch.parallel.comm import LocalComm, world


class EventGroup(NamedTuple):
    comm: object            # parallel.comm communicator
    n_local: int            # event shards held by this process
    device: torch.device    # where this process's shards live

    @property
    def n_shards(self) -> int:
        return self.comm.size * self.n_local

    @property
    def first_shard(self) -> int:
        return self.comm.rank * self.n_local


class PipelineGroup(NamedTuple):
    comm: object            # slices are split over its ranks
    n_slices: int           # slice lanes in all (a multiple of comm.size)
    ev: EventGroup          # process-local event shards of each slice


class TileGroup(NamedTuple):
    comm: object            # parallel.comm communicator
    shape: tuple            # (n_tx, n_ty)
    n_local: int            # tiles held by this process
    device: torch.device    # where this process's tiles live

    @property
    def n_tiles(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def first_tile(self) -> int:
        return self.comm.rank * self.n_local


def group_device(device) -> torch.device:
    """``device``, or the card when it is None (raises without one)."""
    from better_flow_tpu_torch.runtime.scan_pipeline import default_device

    return torch.device(device) if device is not None else default_device()


def make_event_mesh(n_shards: Optional[int] = None, comm=None,
                    device=None) -> EventGroup:
    """An event group of ``n_shards`` shards in all (default: one per
    rank) over the ranks of ``comm`` (default: this process's world).
    ``device`` defaults to the card and must be given as ``"cpu"`` to run
    the plain twins."""
    comm = world() if comm is None else comm
    n = comm.size if n_shards is None else int(n_shards)
    if n <= 0 or n % comm.size != 0:
        raise ValueError(f"{n} event shards do not divide over "
                         f"{comm.size} ranks")
    return EventGroup(comm, n // comm.size, group_device(device))


def make_pipeline_mesh(n_slices: int, n_ev: int, comm=None,
                       device=None) -> PipelineGroup:
    """``n_slices`` slice lanes over the ranks of ``comm``, each with
    ``n_ev`` process-local event shards."""
    comm = world() if comm is None else comm
    if n_slices <= 0 or n_slices % comm.size != 0:
        raise ValueError(f"{n_slices} slice lanes do not divide over "
                         f"{comm.size} ranks")
    if n_ev <= 0:
        raise ValueError(f"n_ev = {n_ev}")
    return PipelineGroup(comm, int(n_slices),
                         EventGroup(LocalComm(), int(n_ev),
                                    group_device(device)))


def make_tiled_mesh(tiles, comm=None, device=None) -> TileGroup:
    """A tile group of ``tiles`` = (n_tx, n_ty) tiles over the ranks of
    ``comm`` (default: this process's world), equally many on each.
    ``device`` defaults to the card and must be given as ``"cpu"`` to run
    the plain twins."""
    comm = world() if comm is None else comm
    n_tx, n_ty = (int(v) for v in tiles)
    if n_tx <= 0 or n_ty <= 0 or (n_tx * n_ty) % comm.size != 0:
        raise ValueError(f"{n_tx} x {n_ty} tiles do not divide over "
                         f"{comm.size} ranks")
    return TileGroup(comm, (n_tx, n_ty), n_tx * n_ty // comm.size,
                     group_device(device))
