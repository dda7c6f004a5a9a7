"""Functional text metrics.

Counterpart of ``torchmetrics_tpu/functional/text/__init__.py``, less the two
model-based metrics: ``bert_score`` and ``infolm`` load a language model and are not
ported yet (ROADMAP Queue 1, the model-based item); asking for either raises.
"""

from torchmetrics_tpu_torch.functional.text.bleu import bleu_score
from torchmetrics_tpu_torch.functional.text.cer import char_error_rate
from torchmetrics_tpu_torch.functional.text.chrf import chrf_score
from torchmetrics_tpu_torch.functional.text.edit import edit_distance
from torchmetrics_tpu_torch.functional.text.eed import extended_edit_distance
from torchmetrics_tpu_torch.functional.text.mer import match_error_rate
from torchmetrics_tpu_torch.functional.text.perplexity import perplexity
from torchmetrics_tpu_torch.functional.text.rouge import rouge_score
from torchmetrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score
from torchmetrics_tpu_torch.functional.text.squad import squad
from torchmetrics_tpu_torch.functional.text.ter import translation_edit_rate
from torchmetrics_tpu_torch.functional.text.wer import word_error_rate
from torchmetrics_tpu_torch.functional.text.wil import word_information_lost
from torchmetrics_tpu_torch.functional.text.wip import word_information_preserved

# the JAX package's model-based text metrics, which the port does not have yet
_MODEL_BASED = ("bert_score", "infolm", "BERTScore", "InfoLM")


def _model_based_missing(module: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"`{module}.{name}` is a model-based text metric (it loads a language model) and is not ported yet;"
        " it comes with the model-based slice of ROADMAP Queue 1 (BERTScore and InfoLM beside multimodal's"
        " CLIP score and CLIP-IQA)."
    )


def __getattr__(name: str):
    if name in _MODEL_BASED:
        raise _model_based_missing(__name__, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "edit_distance",
    "extended_edit_distance",
    "match_error_rate",
    "perplexity",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
