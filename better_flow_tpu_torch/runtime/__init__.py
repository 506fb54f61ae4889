"""The slice managers (counterpart of ``better_flow_tpu.runtime``)."""

from better_flow_tpu_torch.runtime.slice_buffer import EventRingBuffer
from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow

__all__ = ["EventRingBuffer", "DVSFlow"]
