"""Audio metrics (stateful modules).

Counterpart of ``torchmetrics_tpu/audio/__init__.py``, less DNSMOS:
``DeepNoiseSuppressionMeanOpinionScore`` comes with the ``convert/``-and-DNSMOS item of
ROADMAP Queue 1; asking for it raises.
"""

from torchmetrics_tpu_torch.audio.modules import (
    ComplexScaleInvariantSignalNoiseRatio,
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
    SourceAggregatedSignalDistortionRatio,
    SpeechReverberationModulationEnergyRatio,
)
from torchmetrics_tpu_torch.functional.audio import _DNSMOS, _dnsmos_missing


def __getattr__(name: str):
    if name in _DNSMOS:
        raise _dnsmos_missing(__name__, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ComplexScaleInvariantSignalNoiseRatio",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SourceAggregatedSignalDistortionRatio",
    "SpeechReverberationModulationEnergyRatio",
]
