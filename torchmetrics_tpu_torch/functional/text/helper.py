"""Shared helpers of the text metrics.

Counterpart of ``torchmetrics_tpu/functional/text/helper.py``: ``_validate_inputs``
and the row-vectorised Levenshtein distance, the same numpy code
(``_edit_distance_dp``), which the port keeps for a substitution cost other than 1. At
unit cost it counts with Hyyrö's bit-vector form of Myers' algorithm instead: the same
integer, one Python big-int step per prediction token (``chip_smoke.py``'s
``text_eval`` times both over the ASR corpus). Tokenising and the edit distances are
host work on Python strings; only the counters they give become tensors, on the device
the caller names.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np


def _validate_inputs(
    ref_corpus: Union[Sequence[str], Sequence[Sequence[str]]],
    hypothesis_corpus: Union[str, Sequence[str]],
) -> Tuple[Sequence[Sequence[str]], Sequence[str]]:
    """Normalize reference/hypothesis corpora to List[List[str]] / List[str]."""
    if isinstance(hypothesis_corpus, str):
        hypothesis_corpus = [hypothesis_corpus]

    if all(isinstance(ref, str) for ref in ref_corpus):
        ref_corpus = [ref_corpus] if len(hypothesis_corpus) == 1 else [[ref] for ref in ref_corpus]

    if hypothesis_corpus and all(ref for ref in ref_corpus) and len(ref_corpus) != len(hypothesis_corpus):
        raise ValueError(f"Corpus has different size {len(ref_corpus)} != {len(hypothesis_corpus)}")

    return ref_corpus, hypothesis_corpus


def _edit_distance(prediction_tokens: List[str], reference_tokens: List[str]) -> int:
    """Levenshtein distance between token sequences (unit costs)."""
    return _edit_distance_cost(prediction_tokens, reference_tokens, substitution_cost=1)


def _edit_distance_cost(
    prediction_tokens: Sequence[str],
    reference_tokens: Sequence[str],
    substitution_cost: int = 1,
) -> int:
    """Levenshtein distance with configurable substitution cost: by bit vectors at unit
    cost, else by the row-vectorised DP."""
    if len(prediction_tokens) == 0:
        return len(reference_tokens)
    if len(reference_tokens) == 0:
        return len(prediction_tokens)
    if substitution_cost == 1:
        return _levenshtein_bit_vector(prediction_tokens, reference_tokens)
    return _edit_distance_dp(prediction_tokens, reference_tokens, substitution_cost)


def _edit_distance_dp(
    prediction_tokens: Sequence[str],
    reference_tokens: Sequence[str],
    substitution_cost: int = 1,
) -> int:
    """Levenshtein distance of two non-empty sequences, the JAX package's numpy code.

    Row-vectorised numpy DP: each row update is O(m) numpy ops plus one cumulative
    min scan (the insert dependency), instead of an O(m) Python loop.
    """
    m = len(reference_tokens)
    # map tokens to int ids for fast equality
    vocab: dict = {}
    for tok in prediction_tokens:
        vocab.setdefault(tok, len(vocab))
    for tok in reference_tokens:
        vocab.setdefault(tok, len(vocab))
    pred = np.asarray([vocab[t] for t in prediction_tokens])
    ref = np.asarray([vocab[t] for t in reference_tokens])

    offsets = np.arange(m + 1)
    prev = offsets.copy()
    for i, p in enumerate(pred):
        sub = prev[:-1] + np.where(ref == p, 0, substitution_cost)
        delete = prev[1:] + 1
        best = np.minimum(sub, delete)
        # cur[j] = min(best[j-1], cur[j-1] + 1) unrolls to a prefix-min of (value - j) + j
        vals = np.concatenate(([i + 1], best - offsets[1:]))
        prev = np.minimum.accumulate(vals) + offsets
    return int(prev[-1])


def _levenshtein_bit_vector(prediction_tokens: Sequence[str], reference_tokens: Sequence[str]) -> int:
    """Unit-cost Levenshtein distance by Hyyrö's bit-vector algorithm (Myers 1999).

    Bit ``i`` of the vertical delta vectors ``pv``/``mv`` says whether ``D[i+1][j]`` is
    one more/less than ``D[i][j]`` down column ``j`` (the reference along the rows);
    each prediction token updates every row at once with a handful of big-int
    operations, and the last row's cell moves by the top bit of the horizontal deltas.
    Row 0 grows by one a column, hence the 1 shifted into ``ph``.
    """
    m = len(reference_tokens)
    mask = (1 << m) - 1
    top = 1 << (m - 1)
    peq: dict = {}
    for i, tok in enumerate(reference_tokens):
        peq[tok] = peq.get(tok, 0) | (1 << i)
    pv, mv, score = mask, 0, m
    for tok in prediction_tokens:
        eq = peq.get(tok, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score
