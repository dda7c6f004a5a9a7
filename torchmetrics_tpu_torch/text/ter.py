"""TranslationEditRate module.

Counterpart of ``torchmetrics_tpu/text/ter.py``: float32 ``total_num_edits`` and
``total_tgt_len``, and with ``return_sentence_level_score`` a ``cat`` list of the
sentences' scores.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from torchmetrics_tpu_torch.text._base import _TextMetric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class TranslationEditRate(_TextMetric):
    r"""Translation edit rate of machine-translated text against references.

    Example:
        >>> from torchmetrics_tpu_torch.text import TranslationEditRate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> ter = TranslationEditRate(device="cpu")
        >>> ter(preds, target).round(decimals=4)
        tensor(0.1538)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    total_num_edits: Tensor
    total_tgt_len: Tensor

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(normalize, bool):
            raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
        if not isinstance(no_punctuation, bool):
            raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
        if not isinstance(lowercase, bool):
            raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
        if not isinstance(asian_support, bool):
            raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")

        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total_tgt_len", torch.zeros(()), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(
        self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]
    ) -> None:
        """Accumulate edit counts and reference lengths."""
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        total_num_edits, total_tgt_length, sentence_scores = _ter_update(
            preds, target, self.tokenizer, 0.0, 0.0, sentence_scores
        )
        self.total_num_edits = self.total_num_edits + total_num_edits
        self.total_tgt_len = self.total_tgt_len + total_tgt_length
        if sentence_scores is not None:
            self.sentence_ter.append(torch.tensor(sentence_scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """Corpus TER over accumulated state."""
        ter = _ter_compute(self.total_num_edits, self.total_tgt_len)
        if self.return_sentence_level_score:
            return ter, dim_zero_cat(self.sentence_ter)
        return ter
