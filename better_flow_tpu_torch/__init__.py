"""better_flow_tpu_torch — motion compensation in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``better_flow_tpu``'s scanned path (``compensate_recording_scan``)
and streaming entry point (``DVSFlow``, ``offline.compensate_recording``,
the streaming checkpoint, the live frontend and the CLI).  It imports
PyTorch and never JAX; it reuses the JAX package's numpy-only modules
(``better_flow_tpu.config``, ``better_flow_tpu.io``, ``better_flow_tpu.viz``,
the CLI's argument parser).  Module names mirror the JAX package:

* ``ops``      — ``layout`` (chunk layout, state slots), ``warp`` (the
                 per-event warp), ``fused_model`` (the five kernel wrappers
                 with their plain twins), ``_build`` (nvcc build of
                 ``csrc/``);
* ``core``     — ``model`` (the 4-parameter motion model), ``events``
                 (``EventSlice``);
* ``models``   — ``global_flow`` (one slice through the optimizer);
* ``runtime``  — ``scan_pipeline`` (staging, the slice loop,
                 accumulation, ``compensate_recording_scan``), ``dvs_flow``
                 (the streaming slice manager), ``slice_buffer``,
                 ``accumulate``, ``offline``, ``checkpoint``, ``live``;
* ``cli``      — ``motion_compensator``;
* ``convert``  — the scan carry to and from the JAX package's numpy form.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the plain PyTorch twins, which is how the CPU tests run the port.
"""

from better_flow_tpu_torch.runtime.dvs_flow import DVSFlow
from better_flow_tpu_torch.runtime.offline import compensate_recording
from better_flow_tpu_torch.runtime.scan_pipeline import (
    compensate_recording_scan,
    prepare_recording,
)

__all__ = ["DVSFlow", "compensate_recording", "compensate_recording_scan",
           "prepare_recording"]
