"""ROUGEScore module.

Counterpart of ``torchmetrics_tpu/text/rouge.py``: one ``cat`` list state per key and
statistic (``rouge1_fmeasure`` ...). JAX appends one float32 scalar a sample; the port
appends one float32 vector a batch (one host-to-device copy a batch, not one a sample),
and ``compute`` concatenates either, so a JAX state dict loads and goes on.

ROUGE-Lsum needs nltk only where it splits sentences with punkt: with a splitter
installed (``set_rouge_sentence_splitter``) or the ``TM_TPU_ROUGE_REGEX_SPLIT=1``
opt-in the class builds without it; JAX asks for nltk either way.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

import torchmetrics_tpu_torch.functional.text.rouge as _rouge
from torchmetrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _rouge_score_update,
)
from torchmetrics_tpu_torch.text._base import _TextMetric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

Tensor = torch.Tensor

_STATS = ("fmeasure", "precision", "recall")


def _punkt_needed() -> bool:
    """Whether ROUGE-Lsum would split with nltk's punkt (no splitter, no opt-in)."""
    return _rouge._SENTENCE_SPLITTER is None and os.environ.get("TM_TPU_ROUGE_REGEX_SPLIT", "0") != "1"


class ROUGEScore(_TextMetric):
    r"""ROUGE score for automatic summarization.

    Example:
        >>> from torchmetrics_tpu_torch.text import ROUGEScore
        >>> rouge = ROUGEScore(rouge_keys=("rouge1", "rougeL"), device="cpu")
        >>> result = rouge("My name is John", "Is your name John")
        >>> float(result["rouge1_fmeasure"])
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if (use_stemmer or ("rougeLsum" in rouge_keys and _punkt_needed())) and not _NLTK_AVAILABLE:
            raise ModuleNotFoundError(
                "Stemmer and/or `rougeLsum` requires that `nltk` is installed. Use `pip install nltk`."
            )

        if not isinstance(rouge_keys, tuple):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )

        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        if use_stemmer:
            import nltk

            self.stemmer = nltk.stem.porter.PorterStemmer()
        else:
            self.stemmer = None
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate

        for rouge_key in self.rouge_keys:
            for score in _STATS:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx="cat")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        """Accumulate per-sample ROUGE statistics, one vector a key and statistic."""
        if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
            target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]

        output = _rouge_score_update(
            preds,
            target,
            self.rouge_keys_values,
            stemmer=self.stemmer,
            normalizer=self.normalizer,
            tokenizer=self.tokenizer,
            accumulate=self.accumulate,
        )
        names, rows = [], []
        for rouge_key, metrics in output.items():
            for tp in _STATS:
                names.append(f"rouge{rouge_key}_{tp}")
                rows.append([metric[tp] for metric in metrics])
        batch = torch.tensor(rows, dtype=torch.float32, device=self.device)
        for name, values in zip(names, batch):
            getattr(self, name).append(values)

    def compute(self) -> Dict[str, Tensor]:
        """Mean ROUGE scores over all accumulated samples."""
        out = {}
        for rouge_key in self.rouge_keys_values:
            for tp in _STATS:
                values = getattr(self, f"rouge{rouge_key}_{tp}")
                scores = dim_zero_cat(values) if values else torch.zeros(0, device=self.device)
                out[f"rouge{rouge_key}_{tp}"] = scores.to(torch.float32).mean()
        return out
