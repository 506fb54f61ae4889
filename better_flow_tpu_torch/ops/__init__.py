"""The per-event and per-image operations (counterpart of
``better_flow_tpu.ops``).  Importing them builds no kernel: the CUDA
library is built on the first launch (``ops._build``)."""

from better_flow_tpu_torch.ops.warp import (
    apply_project,
    compute_uv,
    n_from_u,
    project_4param,
    project_4param_reinit,
    project_divcrl,
)
from better_flow_tpu_torch.ops.time_image import (
    time_image,
    count_image,
    scatter_images,
)
from better_flow_tpu_torch.ops.gradient import (
    masked_scharr,
    lr_sobel,
    gradient_img_fuse,
)
from better_flow_tpu_torch.ops.reductions import (
    center_of_mass,
    model_compute,
    nonzero_average,
)

__all__ = [
    "apply_project",
    "compute_uv",
    "n_from_u",
    "project_4param",
    "project_4param_reinit",
    "project_divcrl",
    "time_image",
    "count_image",
    "scatter_images",
    "masked_scharr",
    "lr_sobel",
    "gradient_img_fuse",
    "center_of_mass",
    "model_compute",
    "nonzero_average",
]
