"""Scale-out of the port over ``torch.distributed``: events of a slice over
shards (``event_parallel``), slice ranges over processes (``multihost``),
independent slices over processes (``temporal``) and the image plane over
tiles (``spatial``), on the collective layer of ``comm`` and the shard
groups of ``mesh``.  Counterpart of ``better_flow_tpu/parallel/``: a group
(``mesh.EventGroup``, ``TileGroup``, ``PipelineGroup``) stands where the
JAX package takes a ``Mesh`` and its axis names."""

from better_flow_tpu_torch.parallel.distributed import (
    initialize as initialize_distributed,
    make_host_mesh,
    process_local_slice_range,
)
from better_flow_tpu_torch.parallel.event_parallel import (
    process_slice_event_parallel,
)
from better_flow_tpu_torch.parallel.mesh import make_event_mesh
from better_flow_tpu_torch.parallel.multihost import (
    compensate_recording_multihost,
)

__all__ = [
    "make_event_mesh",
    "process_slice_event_parallel",
    "initialize_distributed",
    "make_host_mesh",
    "process_local_slice_range",
    "compensate_recording_multihost",
]
