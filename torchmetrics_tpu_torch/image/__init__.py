"""Image metric classes of the port.

Counterpart of ``torchmetrics_tpu/image/__init__.py``, with the same ``__all__``: the
model-based LPIPS, FID, IS, KID, MiFID and perceptual path length run their networks
on the metric's device from locally provided weights (the Inception family also with
seeded random weights, with a warning).
"""

from torchmetrics_tpu_torch.image.pansharpening import (
    QualityWithNoReference,
    SpatialDistortionIndex,
    SpectralDistortionIndex,
)
from torchmetrics_tpu_torch.image.fid import FrechetInceptionDistance
from torchmetrics_tpu_torch.image.inception import InceptionScore
from torchmetrics_tpu_torch.image.kid import KernelInceptionDistance
from torchmetrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.image.mifid import MemorizationInformedFrechetInceptionDistance
from torchmetrics_tpu_torch.image.perceptual_path_length import PerceptualPathLength
from torchmetrics_tpu_torch.image.psnr import PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect
from torchmetrics_tpu_torch.image.quality import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpatialCorrelationCoefficient,
    SpectralAngleMapper,
    TotalVariation,
    UniversalImageQualityIndex,
    VisualInformationFidelity,
)
from torchmetrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)


__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "PerceptualPathLength",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
