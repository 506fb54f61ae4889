"""The optimizers (counterpart of ``better_flow_tpu.models``).

``process_slice`` is the port's staged form (the kernels' chunk layout);
the JAX package's flat-slice call is ``global_flow.process_event_slice``.
"""

from better_flow_tpu_torch.models.global_flow import (
    GlobalFlowState,
    SliceResult,
    process_slice,
    slice_geometry,
)

__all__ = [
    "GlobalFlowState",
    "SliceResult",
    "process_slice",
    "slice_geometry",
]
