"""Image metric classes of the port.

Counterpart of ``torchmetrics_tpu/image/__init__.py``, less the model-based classes
(LPIPS, FID, IS, KID, MiFID, perceptual path length), which come with the model-based
item of ROADMAP Queue 1; asking for one raises.
"""

from torchmetrics_tpu_torch.functional.image import _MODEL_BASED, _model_based_missing
from torchmetrics_tpu_torch.image.pansharpening import (
    QualityWithNoReference,
    SpatialDistortionIndex,
    SpectralDistortionIndex,
)
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


def __getattr__(name: str):
    if name in _MODEL_BASED:
        raise _model_based_missing(__name__, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
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
