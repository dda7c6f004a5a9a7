"""Hand-written CUDA kernels of the port, with their plain PyTorch versions."""

from torchmetrics_tpu_torch.ops.kernels import (
    LAUNCHES,
    binned_curve_counts,
    binned_curve_counts_plain,
    bincount,
    bincount_plain,
    confusion_matrix,
    confusion_matrix_plain,
    reset_launch_counts,
    ssim_moments,
    ssim_moments_plain,
    weighted_bincount,
    weighted_bincount_plain,
)

__all__ = [
    "LAUNCHES",
    "binned_curve_counts",
    "binned_curve_counts_plain",
    "bincount",
    "bincount_plain",
    "confusion_matrix",
    "confusion_matrix_plain",
    "reset_launch_counts",
    "ssim_moments",
    "ssim_moments_plain",
    "weighted_bincount",
    "weighted_bincount_plain",
]
