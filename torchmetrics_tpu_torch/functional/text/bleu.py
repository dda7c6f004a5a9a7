"""BLEU score.

Counterpart of ``torchmetrics_tpu/functional/text/bleu.py``. The n-gram Counters are
host work on strings; the numerator and denominator are ``(n_gram,)`` float32 tensors,
so the corpus statistics sum across ranks.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """Count all 1..n grams of a token list."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j : i + j])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    """Whitespace tokenizer."""
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: np.ndarray,
    denominator: np.ndarray,
    preds_len: float,
    target_len: float,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[float, float]:
    """Accumulate clipped n-gram hits into numerator/denominator (numpy, mutated in place)."""
    target_ = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_ = [tokenizer(line) if line else [] for line in preds]

    for pred, targets in zip(preds_, target_):
        preds_len += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        target_len += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)

        ngram_counter_clip = preds_counter & target_counter
        for counter_clip in ngram_counter_clip:
            numerator[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in preds_counter:
            denominator[len(counter) - 1] += preds_counter[counter]

    return preds_len, target_len


def _bleu_score_compute(
    preds_len: Union[Tensor, float],
    target_len: Union[Tensor, float],
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """Geometric-mean precision with brevity penalty, on the numerator's device."""
    device = numerator.device
    preds_len = torch.as_tensor(preds_len, dtype=torch.float32, device=device)
    target_len = torch.as_tensor(target_len, dtype=torch.float32, device=device)
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(device=device, dtype=torch.float32)

    if smooth:
        precision_scores = (numerator + 1.0) / (denominator + 1.0)
        precision_scores = torch.cat([(numerator[:1] / denominator[:1]), precision_scores[1:]])
    else:
        precision_scores = numerator / denominator

    log_precision_scores = torch.tensor(weights, dtype=torch.float32, device=device) * torch.log(precision_scores)
    geometric_mean = torch.exp(torch.sum(log_precision_scores))
    brevity_penalty = torch.where(preds_len > target_len, 1.0, torch.exp(1 - (target_len / preds_len)))
    score = brevity_penalty * geometric_mean
    return torch.where(torch.min(numerator) == 0.0, 0.0, score)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tensor:
    """Compute the BLEU score of machine-translated text against references, on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu_score(preds, target, device="cpu").round(decimals=4)
        tensor(0.7598)
    """
    device = _resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]

    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len, target_len = _bleu_score_update(
        preds_, target_, numerator, denominator, 0.0, 0.0, n_gram, _tokenize_fn
    )
    return _bleu_score_compute(
        preds_len, target_len, torch.tensor(numerator, dtype=torch.float32, device=device),
        torch.tensor(denominator, dtype=torch.float32, device=device), n_gram, weights, smooth
    )
