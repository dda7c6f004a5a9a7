"""Text metrics (stateful modules).

Counterpart of ``torchmetrics_tpu/text/__init__.py``, less the two model-based
metrics: ``BERTScore`` and ``InfoLM`` load a language model and are not ported yet
(ROADMAP Queue 1, the model-based item); asking for either raises.
"""

from torchmetrics_tpu_torch.functional.text import _MODEL_BASED, _model_based_missing
from torchmetrics_tpu_torch.text.bleu import BLEUScore, SacreBLEUScore
from torchmetrics_tpu_torch.text.chrf import CHRFScore
from torchmetrics_tpu_torch.text.eed import ExtendedEditDistance
from torchmetrics_tpu_torch.text.error_rates import (
    CharErrorRate,
    EditDistance,
    MatchErrorRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from torchmetrics_tpu_torch.text.perplexity import Perplexity
from torchmetrics_tpu_torch.text.rouge import ROUGEScore
from torchmetrics_tpu_torch.text.squad import SQuAD
from torchmetrics_tpu_torch.text.ter import TranslationEditRate


def __getattr__(name: str):
    if name in _MODEL_BASED:
        raise _model_based_missing(__name__, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "EditDistance",
    "ExtendedEditDistance",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
