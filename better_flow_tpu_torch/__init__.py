"""better_flow_tpu_torch — motion compensation in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``better_flow_tpu``'s scanned path (``compensate_recording_scan``),
its streaming entry point (``DVSFlow``, ``offline.compensate_recording``,
the streaming checkpoint, the live frontend and the CLI), its scale-out
by events and by slice ranges (``parallel``), and its other optimizers and
views (the dense local flow field, the score search, clustering, the debug
views).  It imports PyTorch, never
JAX, and nothing of the JAX package: ``config``, ``io``, ``viz``,
``eval``, ``core.pixel_map``, ``profiling`` and the CLI's argument parser
are its own numpy-only copies.  Module names mirror
the JAX package:

* ``config``   — constants, the frozen config dataclasses, the presets;
* ``ops``      — ``layout`` (chunk layout, state slots), ``warp`` (the
                 per-event warp), ``fused_model`` (the eight kernel
                 wrappers with their plain twins), ``_build`` (nvcc build
                 of ``csrc/``);
* ``core``     — ``model`` (the 4-parameter motion model), ``events``
                 (``EventSlice``, ``bounding_box``), ``pixel_map`` (the
                 per-pixel event store, numpy);
* ``models``   — ``global_flow`` (one slice through the optimizer, with
                 the event-parallel image-sum seam), ``local_flow`` (the
                 dense per-pixel flow field, BASELINE configuration 3),
                 ``score_search`` (the candidate sweep), ``clustering``;
* ``runtime``  — ``scan_pipeline`` (staging of recordings, ranges and
                 shards, the slice loop, accumulation,
                 ``compensate_recording_scan``), ``dvs_flow`` (the
                 streaming slice manager), ``slice_buffer``,
                 ``accumulate``, ``offline``, ``checkpoint``, ``live``;
* ``parallel`` — ``comm`` (collectives over ``torch.distributed``),
                 ``mesh`` (shard groups), ``event_parallel``,
                 ``distributed``, ``multihost``, ``temporal``;
* ``io``       — event files, the synthetic stream, the sensor-realistic
                 simulator (``dvs_sim``), the native staging library's
                 loader, the socket transport;
* ``viz``      — the image products of the live frontend, and
                 ``debug_images`` (the optimizer's debug views);
* ``eval``     — ``metrics`` (flow errors, AEE, PSNR, sharpness; numpy);
* ``profiling`` — span timers, the realtime factor, a ``torch.profiler``
                 trace context;
* ``cli``      — ``motion_compensator``;
* ``convert``  — the scan carry to and from the JAX package's numpy form,
                 and its gathered local-flow windows.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the plain PyTorch twins, which is how the CPU tests run the port.  An entry
point runs on the card unless its caller passes ``device="cpu"``.  The
subpackages re-export the names that the JAX package's ``__init__`` files
export; ``graft_entry`` holds the entry hooks (``entry``, ``dryrun``).

Divergences by design from the JAX package's call forms: an event, tile or
pipeline group (``parallel.mesh``) where JAX takes a ``Mesh`` and an
``axis_name``, and the group's own sizes where JAX takes ``n_dev`` or
``n_devices``; a ``torch.Generator`` where ``model_compute_sampled`` takes a
PRNG ``key``; ``prepare_recording``'s ``device`` at the position of JAX's
``slice_range`` (pass that one by keyword); the staged ``models.global_flow.
process_slice`` beside the flat ``process_event_slice``.
"""

from better_flow_tpu_torch.config import (
    NZ,
    T_DIVIDER,
    UV_FACTOR,
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)

__version__ = "0.1.0"

from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow  # noqa: E402
from better_flow_tpu_torch.runtime.offline import (  # noqa: E402
    compensate_recording,
)
from better_flow_tpu_torch.runtime.scan_pipeline import (  # noqa: E402
    compensate_recording_scan,
    prepare_recording,
)

# The JAX package's names, then the port's entry points.
__all__ = [
    "NZ",
    "T_DIVIDER",
    "UV_FACTOR",
    "SensorConfig",
    "SliceConfig",
    "OptimizerConfig",
    "PipelineConfig",
    "__version__",
    "DVSFlow",
    "compensate_recording",
    "compensate_recording_scan",
    "prepare_recording",
]
