"""Text metrics (stateful modules).

Counterpart of ``torchmetrics_tpu/text/__init__.py``. The model-based ``BERTScore``
and ``InfoLM`` run the port's encoders (``utils/hf``) on a local snapshot.
"""

from torchmetrics_tpu_torch.text.bert import BERTScore
from torchmetrics_tpu_torch.text.bleu import BLEUScore, SacreBLEUScore
from torchmetrics_tpu_torch.text.chrf import CHRFScore
from torchmetrics_tpu_torch.text.eed import ExtendedEditDistance
from torchmetrics_tpu_torch.text.infolm import InfoLM
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


__all__ = [
    "BERTScore",
    "BLEUScore",
    "InfoLM",
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
