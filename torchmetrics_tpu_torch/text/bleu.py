"""BLEU / SacreBLEU metric modules.

Counterpart of ``torchmetrics_tpu/text/bleu.py``: the same float32 states
(``preds_len``, ``target_len`` and the ``(n_gram,)`` numerator and denominator). An
update counts the batch's n-grams into fresh host vectors and adds them on the
metric's device, where JAX reads its states back to the host to count into them: the
sums are the same while a count stays below 2^24, where float32 holds every integer.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from torchmetrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from torchmetrics_tpu_torch.text._base import _TextMetric

Tensor = torch.Tensor


class BLEUScore(_TextMetric):
    r"""BLEU score of machine-translated text against references.

    Example:
        >>> from torchmetrics_tpu_torch.text import BLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu = BLEUScore(device="cpu")
        >>> bleu(preds, target).round(decimals=4)
        tensor(0.7598)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    preds_len: Tensor
    target_len: Tensor
    numerator: Tensor
    denominator: Tensor

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram

        self.add_state("preds_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(self.n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(self.n_gram), dist_reduce_fx="sum")

    _tokenizer = staticmethod(_tokenize_fn)

    def _add_counts(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        """Count the batch's clipped n-grams on the host and add them to the states."""
        numerator = np.zeros(self.n_gram)
        denominator = np.zeros(self.n_gram)
        preds_len, target_len = _bleu_score_update(
            preds, target, numerator, denominator, 0.0, 0.0, self.n_gram, self._tokenizer
        )
        counts = torch.tensor(np.concatenate([numerator, denominator]), dtype=torch.float32, device=self.device)
        self.preds_len = self.preds_len + preds_len
        self.target_len = self.target_len + target_len
        self.numerator = self.numerator + counts[: self.n_gram]
        self.denominator = self.denominator + counts[self.n_gram :]

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        """Accumulate clipped n-gram counts for the batch."""
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        self._add_counts(preds_, target_)

    def compute(self) -> Tensor:
        """BLEU over accumulated corpus statistics."""
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )


class SacreBLEUScore(BLEUScore):
    r"""SacreBLEU score with the sacrebleu tokenizer family.

    Example:
        >>> from torchmetrics_tpu_torch.text import SacreBLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu = SacreBLEUScore(device="cpu")
        >>> sacre_bleu(preds, target).round(decimals=4)
        tensor(0.7598)
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self._tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        """Accumulate clipped n-gram counts with sacrebleu tokenization."""
        self._add_counts(preds, target)
