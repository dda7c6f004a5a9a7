"""Functional image metrics.

Counterpart of ``torchmetrics_tpu/functional/image/__init__.py``, less the two
model-based functions: ``learned_perceptual_image_patch_similarity`` and
``perceptual_path_length`` run a network and come with the model-based item of ROADMAP
Queue 1; asking for either raises.
"""

from torchmetrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index
from torchmetrics_tpu_torch.functional.image.d_s import spatial_distortion_index
from torchmetrics_tpu_torch.functional.image.ergas import error_relative_global_dimensionless_synthesis
from torchmetrics_tpu_torch.functional.image.gradients import image_gradients
from torchmetrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from torchmetrics_tpu_torch.functional.image.psnrb import peak_signal_noise_ratio_with_blocked_effect
from torchmetrics_tpu_torch.functional.image.qnr import quality_with_no_reference
from torchmetrics_tpu_torch.functional.image.rase import relative_average_spectral_error
from torchmetrics_tpu_torch.functional.image.rmse_sw import root_mean_squared_error_using_sliding_window
from torchmetrics_tpu_torch.functional.image.sam import spectral_angle_mapper
from torchmetrics_tpu_torch.functional.image.scc import spatial_correlation_coefficient
from torchmetrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.functional.image.tv import total_variation
from torchmetrics_tpu_torch.functional.image.uqi import universal_image_quality_index
from torchmetrics_tpu_torch.functional.image.vif import visual_information_fidelity

# the JAX package's model-based image names, which the port does not have yet
_MODEL_BASED = (
    "learned_perceptual_image_patch_similarity",
    "perceptual_path_length",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "PerceptualPathLength",
)


def _model_based_missing(module: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"`{module}.{name}` is a model-based image metric (it runs a network) and is not ported yet;"
        " it comes with the model-based item of ROADMAP Queue 1 (LPIPS, the Inception family and"
        " perceptual path length)."
    )


def __getattr__(name: str):
    if name in _MODEL_BASED:
        raise _model_based_missing(__name__, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "quality_with_no_reference",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spatial_correlation_coefficient",
    "spatial_distortion_index",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
