"""Multi-process execution over ``torch.distributed``.

Counterpart of ``better_flow_tpu/parallel/distributed.py``: every process
runs the same program; the event axis (one sum of the pre-filter images per
optimizer iteration, the hot collective) stays inside a process or a host,
the slice axis (independent or chained slice ranges, one small carry per
boundary) spans the processes.  The same code runs multi-process on the CPU
over gloo, which is how the tests exercise real collectives without cards.

A two-process run on one host::

    BF_COORDINATOR=localhost:29511 BF_NUM_PROCESSES=2 BF_PROCESS_ID=0 python run.py &
    BF_COORDINATOR=localhost:29511 BF_NUM_PROCESSES=2 BF_PROCESS_ID=1 python run.py

where ``run.py`` calls ``initialize()`` and then, say,
``multihost.compensate_recording_multihost``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from better_flow_tpu_torch.parallel.comm import LocalComm, world
from better_flow_tpu_torch.parallel.mesh import (
    EventGroup, PipelineGroup, group_device,
)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Initialize ``torch.distributed`` from arguments or the environment
    (``BF_COORDINATOR``, ``BF_NUM_PROCESSES``, ``BF_PROCESS_ID``).  The
    coordinator is ``host:port`` (a TCP store) or any ``init_method`` URL
    (``file:///path`` for a file store).  ``backend`` defaults to gloo for
    CPU tensors plus NCCL for CUDA tensors where a card is present.  Returns
    True if a process group was created, False for a single-process run
    (nothing configured; every path then works unchanged)."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or \
        os.environ.get("BF_COORDINATOR")
    if num_processes is None and "BF_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["BF_NUM_PROCESSES"])
    if process_id is None and "BF_PROCESS_ID" in os.environ:
        process_id = int(os.environ["BF_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, "
                         "the number of processes and this process's id")
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() \
            else "gloo"
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def shutdown() -> None:
    """Destroy the process group, if one was created."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_host_mesh(ev_per_host: Optional[int] = None,
                   device=None) -> PipelineGroup:
    """The (process, local shard) layout: the slice axis over the ranks of
    this process's world, the event axis over ``ev_per_host`` shards inside
    each process (default 1), so that the per-iteration image sum never
    leaves the process."""
    comm = world()
    n_ev = 1 if ev_per_host is None else int(ev_per_host)
    if n_ev <= 0:
        raise ValueError(f"ev_per_host = {ev_per_host}")
    return PipelineGroup(comm, comm.size,
                         EventGroup(LocalComm(), n_ev,
                                    group_device(device)))


def process_local_slice_range(n_slices: int, comm=None) -> Tuple[int, int]:
    """The contiguous slice range this process owns under slice-range
    processing: ceil(n / ranks) slices a rank, in rank order."""
    comm = world() if comm is None else comm
    per = (n_slices + comm.size - 1) // comm.size
    lo = min(comm.rank * per, n_slices)
    return lo, min(lo + per, n_slices)
