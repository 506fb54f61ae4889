"""Events and the motion model (counterpart of ``better_flow_tpu.core``)."""

from better_flow_tpu_torch.core.events import EventSlice
from better_flow_tpu_torch.core.model import MotionModel

__all__ = ["EventSlice", "MotionModel"]
