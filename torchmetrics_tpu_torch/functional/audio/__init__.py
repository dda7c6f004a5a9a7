"""Functional audio metrics.

Counterpart of ``torchmetrics_tpu/functional/audio/__init__.py``, less DNSMOS:
``deep_noise_suppression_mean_opinion_score`` runs converted ONNX graphs and comes with
the ``convert/``-and-DNSMOS item of ROADMAP Queue 1; asking for it raises.
"""

from torchmetrics_tpu_torch.functional.audio.external import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility

# the JAX package's DNSMOS names, which the port does not have yet
_DNSMOS = ("deep_noise_suppression_mean_opinion_score", "DeepNoiseSuppressionMeanOpinionScore")


def _dnsmos_missing(module: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"`{module}.{name}` runs the DNS challenge's ONNX graphs and is not ported yet;"
        " it comes with the `convert/`-and-DNSMOS item of ROADMAP Queue 1 (the ONNX reader and executor)."
    )


def __getattr__(name: str):
    if name in _DNSMOS:
        raise _dnsmos_missing(__name__, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "complex_scale_invariant_signal_noise_ratio",
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "source_aggregated_signal_distortion_ratio",
    "speech_reverberation_modulation_energy_ratio",
]
