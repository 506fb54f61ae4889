"""Scale-out of the port over ``torch.distributed``: events of a slice over
shards (``event_parallel``), slice ranges over processes (``multihost``),
independent slices over processes (``temporal``), on the collective layer
of ``comm`` and the shard groups of ``mesh``.  Counterpart of
``better_flow_tpu/parallel/`` without the tiled pipeline (``spatial``)."""
