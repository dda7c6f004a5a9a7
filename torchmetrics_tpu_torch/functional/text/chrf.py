"""chrF / chrF++ score.

Counterpart of ``torchmetrics_tpu/functional/text/chrf.py``: the same n-gram
machinery on the host, and the same six fixed-shape per-order total vectors as states
(float32 ``(n_char_order,)`` / ``(n_word_order,)`` tensors that sum across ranks). The
sentence-level f-score that picks the best reference runs in numpy float32 with JAX's
order of operations, not as a device computation per (sentence, reference) pair.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _validate_inputs
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    """Character stream of a sentence, optionally stripping whitespace."""
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Split leading/trailing punctuation off a word (chrF word tokenization)."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    """chrF word tokens for a sentence."""
    return list(chain.from_iterable(_separate_word_and_punctuation(word) for word in sentence.strip().split()))


def _ngram_counts(char_or_word_list: List[str], n_gram_order: int) -> Dict[int, Counter]:
    """Counters of 1..n grams keyed by order: the same tuples as JAX's, made by ``zip``
    over shifted copies and counted by ``Counter``'s C loop."""
    ngrams: Dict[int, Counter] = defaultdict(Counter)
    for n in range(1, n_gram_order + 1):
        ngrams[n] = Counter(zip(*(char_or_word_list[k:] for k in range(n))))
    return ngrams


def _get_n_grams_counts_and_total_ngrams(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[Dict[int, Counter], Dict[int, Counter], np.ndarray, np.ndarray]:
    """Char/word n-gram counters plus per-order total vectors for one sentence."""
    if lowercase:
        sentence = sentence.lower()
    char_n_grams_counts = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_n_grams_counts = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)

    total_char = np.asarray(
        [sum(char_n_grams_counts[n].values()) for n in range(1, n_char_order + 1)], dtype=np.float64
    )
    total_word = np.asarray(
        [sum(word_n_grams_counts[n].values()) for n in range(1, n_word_order + 1)], dtype=np.float64
    )
    return char_n_grams_counts, word_n_grams_counts, total_char, total_word


def _get_ngram_matches(
    hyp_n_grams_counts: Dict[int, Counter],
    ref_n_grams_counts: Dict[int, Counter],
    n_order: int,
) -> np.ndarray:
    """Per-order vector of clipped n-gram matches between hypothesis and reference."""
    matching = np.zeros(n_order, dtype=np.float64)
    for n in range(1, n_order + 1):
        hyp = hyp_n_grams_counts[n]
        ref = ref_n_grams_counts[n]
        matching[n - 1] = sum(min(ref[g], c) for g, c in hyp.items())
    return matching


def _sentence_fscore(
    matching_char_n_grams: np.ndarray,
    matching_word_n_grams: np.ndarray,
    hyp_char_n_grams: np.ndarray,
    hyp_word_n_grams: np.ndarray,
    ref_char_n_grams: np.ndarray,
    ref_word_n_grams: np.ndarray,
    n_order: float,
    beta: float,
) -> np.float32:
    """``_calculate_fscore`` in numpy float32 on the host, for one (sentence, reference) pair."""

    def _f_score(matching, ref_total, hyp_total):
        matching = np.asarray(matching, dtype=np.float32)
        ref_total = np.asarray(ref_total, dtype=np.float32)
        hyp_total = np.asarray(hyp_total, dtype=np.float32)
        one = np.float32(1.0)
        precision = np.where(hyp_total > 0, matching / np.where(hyp_total > 0, hyp_total, one), np.float32(0.0))
        recall = np.where(ref_total > 0, matching / np.where(ref_total > 0, ref_total, one), np.float32(0.0))
        beta_sq = np.float32(beta**2)
        denominator = np.maximum(beta_sq * precision + recall, np.float32(_EPS_SMOOTHING))
        return (np.float32(1 + beta**2) * precision * recall / denominator).astype(np.float32)

    char_f = _f_score(matching_char_n_grams, ref_char_n_grams, hyp_char_n_grams)
    word_f = _f_score(matching_word_n_grams, ref_word_n_grams, hyp_word_n_grams)
    return (np.sum(char_f, dtype=np.float32) + np.sum(word_f, dtype=np.float32)) / np.float32(n_order)


def _calculate_fscore(
    matching_char_n_grams: Tensor,
    matching_word_n_grams: Tensor,
    hyp_char_n_grams: Tensor,
    hyp_word_n_grams: Tensor,
    ref_char_n_grams: Tensor,
    ref_word_n_grams: Tensor,
    n_order: float,
    beta: float,
) -> Tensor:
    """chrF/chrF++ f-score from per-order match/total vectors (corpus level, on their device)."""

    def _f_score(matching, ref_total, hyp_total):
        matching, ref_total, hyp_total = (x.to(torch.float32) for x in (matching, ref_total, hyp_total))
        precision = torch.where(hyp_total > 0, matching / torch.where(hyp_total > 0, hyp_total, 1.0), 0.0)
        recall = torch.where(ref_total > 0, matching / torch.where(ref_total > 0, ref_total, 1.0), 0.0)
        denominator = torch.clamp(beta**2 * precision + recall, min=_EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denominator

    char_f = _f_score(matching_char_n_grams, ref_char_n_grams, hyp_char_n_grams)
    word_f = _f_score(matching_word_n_grams, ref_word_n_grams, hyp_word_n_grams)
    return (torch.sum(char_f) + torch.sum(word_f)) / n_order


def _calculate_sentence_level_chrf_score(
    targets: List[str],
    pred_char_n_grams_counts: Dict[int, Counter],
    pred_word_n_grams_counts: Dict[int, Counter],
    pred_char_n_grams: np.ndarray,
    pred_word_n_grams: np.ndarray,
    n_char_order: int,
    n_word_order: int,
    n_order: float,
    beta: float,
    lowercase: bool,
    whitespace: bool,
):
    """Best f-score (and its statistics) of a hypothesis over all references."""
    best_f_score = 0.0
    best_matching_char = np.zeros(n_char_order, dtype=np.float64)
    best_matching_word = np.zeros(n_word_order, dtype=np.float64)
    best_target_char = np.zeros(n_char_order, dtype=np.float64)
    best_target_word = np.zeros(n_word_order, dtype=np.float64)

    for target in targets:
        (
            target_char_n_grams_counts,
            target_word_n_grams_counts,
            target_char_n_grams,
            target_word_n_grams,
        ) = _get_n_grams_counts_and_total_ngrams(target, n_char_order, n_word_order, lowercase, whitespace)
        matching_char = _get_ngram_matches(pred_char_n_grams_counts, target_char_n_grams_counts, n_char_order)
        matching_word = _get_ngram_matches(pred_word_n_grams_counts, target_word_n_grams_counts, n_word_order)

        f_score = float(
            _sentence_fscore(
                matching_char,
                matching_word,
                pred_char_n_grams,
                pred_word_n_grams,
                target_char_n_grams,
                target_word_n_grams,
                n_order,
                beta,
            )
        )
        if f_score > best_f_score:
            best_f_score = f_score
            best_matching_char = matching_char
            best_matching_word = matching_word
            best_target_char = target_char_n_grams
            best_target_word = target_word_n_grams

    return best_f_score, best_matching_char, best_matching_word, best_target_char, best_target_word


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    total_preds_char_n_grams: np.ndarray,
    total_preds_word_n_grams: np.ndarray,
    total_target_char_n_grams: np.ndarray,
    total_target_word_n_grams: np.ndarray,
    total_matching_char_n_grams: np.ndarray,
    total_matching_word_n_grams: np.ndarray,
    n_char_order: int,
    n_word_order: int,
    n_order: float,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    sentence_chrf_score: Optional[List[float]] = None,
):
    """Accumulate the six per-order total vectors over the batch."""
    target_corpus, preds = _validate_inputs(target, preds)

    for pred, targets in zip(preds, target_corpus):
        (
            pred_char_n_grams_counts,
            pred_word_n_grams_counts,
            pred_char_n_grams,
            pred_word_n_grams,
        ) = _get_n_grams_counts_and_total_ngrams(pred, n_char_order, n_word_order, lowercase, whitespace)
        total_preds_char_n_grams = total_preds_char_n_grams + pred_char_n_grams
        total_preds_word_n_grams = total_preds_word_n_grams + pred_word_n_grams

        (
            sentence_level_f_score,
            matching_char,
            matching_word,
            target_char,
            target_word,
        ) = _calculate_sentence_level_chrf_score(
            targets,
            pred_char_n_grams_counts,
            pred_word_n_grams_counts,
            pred_char_n_grams,
            pred_word_n_grams,
            n_char_order,
            n_word_order,
            n_order,
            beta,
            lowercase,
            whitespace,
        )
        if sentence_chrf_score is not None:
            sentence_chrf_score.append(sentence_level_f_score)

        total_target_char_n_grams = total_target_char_n_grams + target_char
        total_target_word_n_grams = total_target_word_n_grams + target_word
        total_matching_char_n_grams = total_matching_char_n_grams + matching_char
        total_matching_word_n_grams = total_matching_word_n_grams + matching_word

    return (
        total_preds_char_n_grams,
        total_preds_word_n_grams,
        total_target_char_n_grams,
        total_target_word_n_grams,
        total_matching_char_n_grams,
        total_matching_word_n_grams,
        sentence_chrf_score,
    )


def _chrf_score_compute(
    total_preds_char_n_grams: Tensor,
    total_preds_word_n_grams: Tensor,
    total_target_char_n_grams: Tensor,
    total_target_word_n_grams: Tensor,
    total_matching_char_n_grams: Tensor,
    total_matching_word_n_grams: Tensor,
    n_order: float,
    beta: float,
) -> Tensor:
    """Corpus-level chrF from accumulated vectors."""
    return _calculate_fscore(
        total_matching_char_n_grams,
        total_matching_word_n_grams,
        total_preds_char_n_grams,
        total_preds_word_n_grams,
        total_target_char_n_grams,
        total_target_word_n_grams,
        n_order,
        beta,
    )


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device] = "cuda",
):
    """Compute the chrF (or chrF++ with word n-grams) score, on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> chrf_score(preds, target, device="cpu").round(decimals=4)
        tensor(0.8640)
    """
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")

    device = _resolve_device(device)
    n_order = float(n_char_order + n_word_order)

    total_preds_char = np.zeros(n_char_order, dtype=np.float64)
    total_preds_word = np.zeros(n_word_order, dtype=np.float64)
    total_target_char = np.zeros(n_char_order, dtype=np.float64)
    total_target_word = np.zeros(n_word_order, dtype=np.float64)
    total_matching_char = np.zeros(n_char_order, dtype=np.float64)
    total_matching_word = np.zeros(n_word_order, dtype=np.float64)

    sentence_chrf: Optional[List[float]] = [] if return_sentence_level_score else None

    (
        total_preds_char,
        total_preds_word,
        total_target_char,
        total_target_word,
        total_matching_char,
        total_matching_word,
        sentence_chrf,
    ) = _chrf_score_update(
        preds,
        target,
        total_preds_char,
        total_preds_word,
        total_target_char,
        total_target_word,
        total_matching_char,
        total_matching_word,
        n_char_order,
        n_word_order,
        n_order,
        beta,
        lowercase,
        whitespace,
        sentence_chrf,
    )

    chrf_f_score = _chrf_score_compute(
        *(torch.tensor(x, dtype=torch.float32, device=device) for x in (
            total_preds_char, total_preds_word, total_target_char, total_target_word, total_matching_char,
            total_matching_word)),
        n_order,
        beta,
    )
    if sentence_chrf is not None:
        return chrf_f_score, torch.tensor(sentence_chrf, dtype=torch.float32, device=device)
    return chrf_f_score
