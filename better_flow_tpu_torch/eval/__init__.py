from better_flow_tpu_torch.eval.metrics import (
    FlowErrors,
    evaluate_flow,
    psnr,
    read_dense_gt,
    sharpness,
)

__all__ = ["FlowErrors", "evaluate_flow", "psnr", "read_dense_gt", "sharpness"]
