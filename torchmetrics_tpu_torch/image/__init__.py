"""Image metric classes of the port: SSIM, MS-SSIM, PSNR, PSNR-B, UQI, TV, RMSE-SW."""

from torchmetrics_tpu_torch.image.psnr import PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect
from torchmetrics_tpu_torch.image.quality import (
    RootMeanSquaredErrorUsingSlidingWindow,
    TotalVariation,
    UniversalImageQualityIndex,
)
from torchmetrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)

__all__ = [
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
]
