"""Functional image metrics of the port: SSIM, MS-SSIM, PSNR, PSNR-B, UQI, RMSE-SW, TV."""

from torchmetrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from torchmetrics_tpu_torch.functional.image.psnrb import peak_signal_noise_ratio_with_blocked_effect
from torchmetrics_tpu_torch.functional.image.rmse_sw import root_mean_squared_error_using_sliding_window
from torchmetrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.functional.image.tv import total_variation
from torchmetrics_tpu_torch.functional.image.uqi import universal_image_quality_index

__all__ = [
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "root_mean_squared_error_using_sliding_window",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
]
