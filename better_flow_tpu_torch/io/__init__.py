from better_flow_tpu_torch.io.event_file import (
    read_events,
    read_events_uv,
    write_events,
    write_events_uv,
)
from better_flow_tpu_torch.io.synthetic import synthetic_events

__all__ = [
    "read_events",
    "read_events_uv",
    "write_events",
    "write_events_uv",
    "synthetic_events",
]
