"""Extended edit distance (EED).

Counterpart of ``torchmetrics_tpu/functional/text/eed.py``: the same CDER-grid scoring
(float64 rows, the deletion chain accumulated in order so that the coverage counts
match JAX's bit for bit), the same English and Japanese preprocessing. Sentence scores
are Python floats until they become a float32 tensor.
"""

from __future__ import annotations

import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _validate_inputs
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Sentence-level EED score between one hypothesis and one reference string.

    JAX's row sweep with its float64 operations in the same order: the substitution and
    insertion terms of a row in numpy (the mismatches of every reference character made
    at once), the deletion chain, the argmin and the long jump in one pass over a list
    of Python floats.
    """
    n = len(hyp)
    hyp_chars = np.frombuffer(hyp.encode("utf-32-le"), dtype=np.uint32) if n else np.empty(0, np.uint32)
    ref_chars = np.frombuffer(ref.encode("utf-32-le"), dtype=np.uint32) if ref else np.empty(0, np.uint32)
    mismatch = (ref_chars[:, None] != hyp_chars[None, :]).astype(np.float64)
    number_of_visits = [-1] * (n + 1)

    row = np.ones(n + 1)
    row[0] = 0.0

    for w in range(len(ref)):
        # base[i] (i>=1): best of substitution/identity and insertion into row i
        values = [float(row[0]) + 1.0] + np.minimum(row[:-1] + mismatch[w], row[1:] + insertion).tolist()
        # the deletion chain must accumulate sequentially: a closed-form prefix-min
        # ((base[k] - k*d) + i*d) is not float-identical, and the min_index pick
        # below turns ulp differences into different coverage counts
        last = best = values[0]
        min_index = 0
        for i in range(1, n + 1):
            step = last + deletion
            if step < values[i]:
                values[i] = step
            last = values[i]
            if last < best:  # the first minimum, as np.argmin picks it
                best, min_index = last, i
        number_of_visits[min_index] += 1

        if ref[w] == " ":  # long jump back to the best column
            jump = alpha + best
            values = [v if v <= jump else jump for v in values]

        row = np.array(values)

    coverage = rho * float(sum(v if v >= 0 else 1 for v in number_of_visits))
    return min(1.0, (float(row[-1]) + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """EED English preprocessing: spaced punctuation, rejoined numbers/abbreviations."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    rules_re = [
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ]
    for pattern, replacement in rules_re:
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return f" {sentence} "


def _preprocess_ja(sentence: str) -> str:
    """EED Japanese preprocessing: NFKC normalization."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_compute(sentence_level_scores: List[float], device: Union[str, torch.device] = "cpu") -> Tensor:
    """Mean of sentence-level scores."""
    if len(sentence_level_scores) == 0:
        return torch.tensor(0.0, device=device)
    return torch.tensor(sum(sentence_level_scores) / len(sentence_level_scores), dtype=torch.float32, device=device)


def _preprocess_sentences(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str,
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    """Validate corpora shape and apply language preprocessing."""
    target, preds = _validate_inputs(hypothesis_corpus=preds, ref_corpus=target)
    if language == "en":
        preprocess_function = _preprocess_en
    elif language == "ja":
        preprocess_function = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    preds = [preprocess_function(pred) for pred in preds]
    target = [[preprocess_function(ref) for ref in reference] for reference in target]
    return preds, target


def _compute_sentence_statistics(
    preds_word: str,
    target_words: Sequence[str],
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Best (lowest) EED over all references of one hypothesis."""
    best_score = inf
    for reference in target_words:
        score = _eed_function(preds_word, reference, alpha, rho, deletion, insertion)
        best_score = min(best_score, score)
    return best_score


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    sentence_eed: Optional[List[float]] = None,
) -> List[float]:
    """Append per-sentence EED scores for the batch."""
    preds, target = _preprocess_sentences(preds, target, language)
    if sentence_eed is None:
        sentence_eed = []
    if 0 in (len(preds), len(target[0])):
        return sentence_eed
    for hypothesis, target_words in zip(preds, target):
        sentence_eed.append(
            _compute_sentence_statistics(hypothesis, target_words, alpha, rho, deletion, insertion)
        )
    return sentence_eed


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Union[str, torch.device] = "cuda",
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Compute the extended edit distance of hypotheses against references, on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import extended_edit_distance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> extended_edit_distance(preds=preds, target=target, device="cpu").round(decimals=4)
        tensor(0.3078)
    """
    device = _resolve_device(device)
    for param_name, param in zip(["alpha", "rho", "deletion", "insertion"], [alpha, rho, deletion, insertion]):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")

    sentence_level_scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    average = _eed_compute(sentence_level_scores, device)
    if return_sentence_level_score:
        return average, torch.tensor(sentence_level_scores, dtype=torch.float32, device=device)
    return average
