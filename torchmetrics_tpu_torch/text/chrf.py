"""CHRFScore module.

Counterpart of ``torchmetrics_tpu/text/chrf.py``: six fixed-shape per-order float32
vectors (``total_{preds,target,matching}_{char,word}_n_grams``) that sum across ranks,
and with ``return_sentence_level_score`` a ``cat`` list of the sentences' scores. An
update counts the batch on the host from zero and adds it on the metric's device (JAX
reads its states back to count into them; the sums agree while they stay below 2^24).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.chrf import _chrf_score_compute, _chrf_score_update
from torchmetrics_tpu_torch.text._base import _TextMetric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class CHRFScore(_TextMetric):
    r"""chrF/chrF++ score of machine-translated text against references.

    Example:
        >>> from torchmetrics_tpu_torch.text import CHRFScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> chrf = CHRFScore(device="cpu")
        >>> chrf(preds, target).round(decimals=4)
        tensor(0.8640)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        self.n_char_order = n_char_order
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        self.n_word_order = n_word_order
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)

        for prefix in ("total_preds", "total_target", "total_matching"):
            self.add_state(f"{prefix}_char_n_grams", torch.zeros(n_char_order), dist_reduce_fx="sum")
            self.add_state(f"{prefix}_word_n_grams", torch.zeros(n_word_order), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_chrf_score", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Accumulate the six per-order n-gram total vectors."""
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        chars, words = np.zeros(self.n_char_order), np.zeros(self.n_word_order)
        *totals, sentence_scores = _chrf_score_update(
            preds,
            target,
            chars, words, chars, words, chars, words,
            self.n_char_order,
            self.n_word_order,
            self.n_order,
            self.beta,
            self.lowercase,
            self.whitespace,
            sentence_scores,
        )
        batch = torch.tensor(np.concatenate(totals), dtype=torch.float32, device=self.device)
        start = 0
        for prefix in ("total_preds", "total_target", "total_matching"):
            for kind, width in (("char", self.n_char_order), ("word", self.n_word_order)):
                name = f"{prefix}_{kind}_n_grams"
                setattr(self, name, getattr(self, name) + batch[start : start + width])
                start += width
        if sentence_scores is not None:
            self.sentence_chrf_score.append(torch.tensor(sentence_scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """Corpus chrF over accumulated state."""
        chrf = _chrf_score_compute(
            self.total_preds_char_n_grams,
            self.total_preds_word_n_grams,
            self.total_target_char_n_grams,
            self.total_target_word_n_grams,
            self.total_matching_char_n_grams,
            self.total_matching_word_n_grams,
            self.n_order,
            self.beta,
        )
        if self.return_sentence_level_score:
            return chrf, dim_zero_cat(self.sentence_chrf_score)
        return chrf
