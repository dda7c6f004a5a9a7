"""ExtendedEditDistance module.

Counterpart of ``torchmetrics_tpu/text/eed.py``: a ``cat`` list of the sentences'
float32 scores.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.eed import _eed_update
from torchmetrics_tpu_torch.text._base import _TextMetric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class ExtendedEditDistance(_TextMetric):
    r"""Extended edit distance of machine-translated text against references.

    Example:
        >>> from torchmetrics_tpu_torch.text import ExtendedEditDistance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> eed(preds=preds, target=target).round(decimals=4)
        tensor(0.3078)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        for param_name, param in zip(["alpha", "rho", "deletion", "insertion"], [alpha, rho, deletion, insertion]):
            if not isinstance(param, float) or param < 0:
                raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Sequence[Union[str, Sequence[str]]],
    ) -> None:
        """Accumulate per-sentence EED scores."""
        scores = _eed_update(
            preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion
        )
        self.sentence_eed.append(torch.tensor(scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """Mean EED over accumulated sentences."""
        all_scores = dim_zero_cat(self.sentence_eed)
        average = all_scores.mean() if all_scores.numel() else torch.tensor(0.0, device=self.device)
        if self.return_sentence_level_score:
            return average, all_scores
        return average
