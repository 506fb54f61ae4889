"""better_flow_tpu_torch — the scanned motion-compensation path in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``better_flow_tpu``'s main path (``compensate_recording_scan``
under ``OptimizerConfig.fast()``).  It imports PyTorch and never JAX; it
reuses the JAX package's numpy-only modules (``better_flow_tpu.config``,
``better_flow_tpu.io``).  Module names mirror the JAX package:

* ``ops``      — ``layout`` (chunk layout, state slots), ``warp`` (the
                 per-event warp), ``fused_model`` (the four kernel wrappers
                 with their plain twins), ``_build`` (nvcc build of
                 ``csrc/``);
* ``core``     — ``model`` (the 4-parameter motion model);
* ``models``   — ``global_flow`` (one slice through the optimizer);
* ``runtime``  — ``scan_pipeline`` (staging, the slice loop,
                 accumulation, ``compensate_recording_scan``);
* ``convert``  — the scan carry to and from the JAX package's numpy form.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the plain PyTorch twins, which is how the CPU tests run the port.
"""

from better_flow_tpu_torch.runtime.scan_pipeline import (
    compensate_recording_scan,
    prepare_recording,
)

__all__ = ["compensate_recording_scan", "prepare_recording"]
