"""Translation edit rate (TER).

Counterpart of ``torchmetrics_tpu/functional/text/ter.py``: the same Tercom tokenizer,
the beam-pruned trace edit distance with its prefix cache, and the greedy shift search
with Tercom's candidate ranking and limits, all host work on token lists. The edit
counts and reference lengths become float32 tensors; a sentence's score is taken in
numpy float32 with JAX's arithmetic, without a device round trip per sentence.
"""

from __future__ import annotations

import math
import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _validate_inputs
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000
_BEAM_WIDTH = 25
_INT_INFINITY = int(1e16)

# edit-op codes in the trace: preference order no-op/sub, delete, insert (Tercom order
# after trace flipping)
_OP_NOTHING = 0
_OP_SUBSTITUTE = 1
_OP_DELETE = 2
_OP_INSERT = 3
_OP_UNDEFINED = 4


class _TercomTokenizer:
    """Tercom normalizer (general/western + optional asian support, lowercase, punct)."""

    _ASIAN_PUNCTUATION = r"([\u3001\u3002\u3008-\u3011\u3014-\u301f\uff61-\uff65\u30fb])"
    _FULL_WIDTH_PUNCTUATION = r"([\uff0e\uff0c\uff1f\uff1a\uff1b\uff01\uff02\uff08\uff09])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)  # noqa: B019
    def __call__(self, sentence: str) -> str:
        """Normalize one sentence according to the configured Tercom options."""
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([\u4e00-\u9fff\u3400-\u4dbf])", r" \1 ", sentence)
        sentence = re.sub(r"([\u31c0-\u31ef\u2e80-\u2eff])", r" \1 ", sentence)
        sentence = re.sub(r"([\u3300-\u33ff\uf900-\ufaff\ufe30-\ufe4f])", r" \1 ", sentence)
        sentence = re.sub(r"([\u3200-\u3f22])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[\u3040-\u309f])([\u3040-\u309f]+)(?=$|^[\u3040-\u309f])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[\u30a0-\u30ff])([\u30a0-\u30ff]+)(?=$|^[\u30a0-\u30ff])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[\u31f0-\u31ff])([\u31f0-\u31ff]+)(?=$|^[\u31f0-\u31ff])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _preprocess_sentence(sentence: str, tokenizer: _TercomTokenizer) -> str:
    """Tokenize one stripped sentence."""
    return tokenizer(sentence.rstrip())


class _TraceEditDistance:
    """Beam-pruned Levenshtein against a fixed reference, returning operation traces.

    Rows are ``(cost, op)`` pairs; computed rows are cached per hypothesis prefix so the
    shift loop's many overlapping hypotheses reuse shared-prefix work (the same idea as
    sacrebleu's trie cache).
    """

    def __init__(self, reference_tokens: List[str]) -> None:
        self.ref = reference_tokens
        self.ref_len = len(reference_tokens)
        self._row_cache: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}

    def __call__(self, hyp: List[str]) -> Tuple[int, Tuple[int, ...]]:
        """Edit distance and the operation trace for a hypothesis."""
        rows = [self._initial_row()]
        start = 0
        for k in range(len(hyp)):
            cached = self._row_cache.get(tuple(hyp[: k + 1]))
            if cached is None:
                break
            rows.append(cached)
            start = k + 1

        rows = self._fill_rows(hyp, start, rows)
        trace = self._trace(len(hyp), rows)
        return rows[-1][-1][0], trace

    def _initial_row(self) -> List[Tuple[int, int]]:
        return [(j, _OP_INSERT) for j in range(self.ref_len + 1)]

    def _fill_rows(
        self, hyp: List[str], start: int, rows: List[List[Tuple[int, int]]]
    ) -> List[List[Tuple[int, int]]]:
        hyp_len = len(hyp)
        length_ratio = self.ref_len / hyp_len if hyp else 1.0
        beam = math.ceil(length_ratio / 2 + _BEAM_WIDTH) if length_ratio / 2 > _BEAM_WIDTH else _BEAM_WIDTH

        for i in range(start + 1, hyp_len + 1):
            row: List[Tuple[int, int]] = [(_INT_INFINITY, _OP_UNDEFINED)] * (self.ref_len + 1)
            pseudo_diag = math.floor(i * length_ratio)
            min_j = max(0, pseudo_diag - beam)
            max_j = self.ref_len + 1 if i == hyp_len else min(self.ref_len + 1, pseudo_diag + beam)

            prev = rows[i - 1]
            for j in range(min_j, max_j):
                if j == 0:
                    row[0] = (prev[0][0] + 1, _OP_DELETE)
                    continue
                if hyp[i - 1] == self.ref[j - 1]:
                    sub_cost, sub_op = prev[j - 1][0], _OP_NOTHING
                else:
                    sub_cost, sub_op = prev[j - 1][0] + 1, _OP_SUBSTITUTE
                best_cost, best_op = sub_cost, sub_op
                del_cost = prev[j][0] + 1
                if del_cost < best_cost:
                    best_cost, best_op = del_cost, _OP_DELETE
                ins_cost = row[j - 1][0] + 1
                if ins_cost < best_cost:
                    best_cost, best_op = ins_cost, _OP_INSERT
                row[j] = (best_cost, best_op)

            rows.append(row)
            self._row_cache[tuple(hyp[:i])] = row
        return rows

    def _trace(self, hyp_len: int, rows: List[List[Tuple[int, int]]]) -> Tuple[int, ...]:
        trace: List[int] = []
        i, j = hyp_len, self.ref_len
        while i > 0 or j > 0:
            op = rows[i][j][1]
            trace.append(op)
            if op in (_OP_NOTHING, _OP_SUBSTITUTE):
                i -= 1
                j -= 1
            elif op == _OP_INSERT:
                j -= 1
            elif op == _OP_DELETE:
                i -= 1
            else:
                raise ValueError(f"Unknown operation {op!r}")
        return tuple(reversed(trace))


def _flip_trace(trace: Tuple[int, ...]) -> Tuple[int, ...]:
    """Swap insert/delete so the trace rewrites reference→hypothesis."""
    swap = {_OP_INSERT: _OP_DELETE, _OP_DELETE: _OP_INSERT}
    return tuple(swap.get(op, op) for op in trace)


class _Alignment:
    """Array view of a reference→hypothesis trace.

    ``hyp_of_ref[r]`` is the hypothesis position aligned to reference position ``r``
    (Tercom's alignment map); ``ref_err``/``hyp_err`` flag edited positions; prefix
    sums make the span-error filters O(1) per span.
    """

    def __init__(self, trace: Tuple[int, ...]) -> None:
        hyp_of_ref: List[int] = []
        ref_err: List[int] = []
        hyp_err: List[int] = []
        hyp_pos = -1
        for op in trace:
            if op in (_OP_NOTHING, _OP_SUBSTITUTE):
                hyp_pos += 1
                hyp_of_ref.append(hyp_pos)
                edited = 1 if op == _OP_SUBSTITUTE else 0
                ref_err.append(edited)
                hyp_err.append(edited)
            elif op == _OP_INSERT:
                hyp_pos += 1
                hyp_err.append(1)
            elif op == _OP_DELETE:
                hyp_of_ref.append(hyp_pos)
                ref_err.append(1)
            else:
                raise ValueError(f"Unknown operation {op!r}.")
        self.hyp_of_ref = np.asarray(hyp_of_ref, dtype=np.int64)
        self._ref_err_prefix = np.concatenate([[0], np.cumsum(ref_err)])
        self._hyp_err_prefix = np.concatenate([[0], np.cumsum(hyp_err)])

    def ref_span_clean(self, start: int, length: int) -> bool:
        return self._ref_err_prefix[start + length] == self._ref_err_prefix[start]

    def hyp_span_clean(self, start: int, length: int) -> bool:
        return self._hyp_err_prefix[start + length] == self._hyp_err_prefix[start]


def _matching_span_table(pred_words: List[str], target_words: List[str]):
    """``spans[i, j]`` = shared-prefix length of ``pred[i:]`` vs ``target[j:]``.

    One reverse dynamic-programming sweep replaces Tercom's per-pair rescan; the
    shift enumeration then just reads span lengths (capped by the shift-size limit).
    """
    n, m = len(pred_words), len(target_words)
    spans = np.zeros((n + 1, m + 1), dtype=np.int32)
    for i in range(n - 1, -1, -1):
        w = pred_words[i]
        for j in range(m - 1, -1, -1):
            if w == target_words[j]:
                spans[i, j] = spans[i + 1, j + 1] + 1
    return np.minimum(spans[:n, :m], _MAX_SHIFT_SIZE - 1)


def _move_span(words: List[str], start: int, length: int, dest: int) -> List[str]:
    """Move ``words[start:start+length]`` so it lands at original position ``dest``.

    Implemented as remove-then-insert; for dests past the removed span the insertion
    point shifts left by the span length.
    """
    span = words[start : start + length]
    rest = words[:start] + words[start + length :]
    pos = dest if dest <= start + length else dest - length
    return rest[:pos] + span + rest[pos:]


def _best_shift(
    pred_words: List[str],
    target_words: List[str],
    cached_edit_distance: _TraceEditDistance,
    budget_used: int,
) -> Tuple[int, List[str], int]:
    """One round of Tercom's greedy shift search; returns the best gain found.

    Enumeration order (pred_start asc, target_start asc, length asc) and the
    candidate budget are semantics: they decide ties and where the search truncates.
    """
    edit_distance, inverted_trace = cached_edit_distance(pred_words)
    align = _Alignment(_flip_trace(inverted_trace))
    spans = _matching_span_table(pred_words, target_words)

    best_key: Optional[Tuple[int, int, int, int]] = None
    best_words = pred_words

    def iter_spans() -> Iterator[Tuple[int, int, int]]:
        # the (i, j) cells with a span, in row-major order as the nested loops visit
        # them; a cell without one yields nothing
        rows, cols = np.nonzero(spans)
        near = np.abs(cols - rows) <= _MAX_SHIFT_DIST
        for i, j, longest in zip(rows[near].tolist(), cols[near].tolist(), spans[rows[near], cols[near]].tolist()):
            for span_len in range(1, longest + 1):
                yield i, j, span_len

    for pred_start, target_start, length in iter_spans():
        # filters: a shift can only help if both spans contain errors and the span is
        # not already aligned onto itself
        if (
            align.hyp_span_clean(pred_start, length)
            or align.ref_span_clean(target_start, length)
            or pred_start <= int(align.hyp_of_ref[target_start]) < pred_start + length
        ):
            continue

        last_dest = -1
        for ref_probe in range(target_start - 1, target_start + length):
            if ref_probe == -1:
                dest = 0
            elif ref_probe < len(align.hyp_of_ref):
                dest = int(align.hyp_of_ref[ref_probe]) + 1
            else:
                break
            if dest == last_dest:
                continue
            last_dest = dest

            shifted = _move_span(pred_words, pred_start, length, dest)
            gain = edit_distance - cached_edit_distance(shifted)[0]
            key = (gain, length, -pred_start, -dest)
            budget_used += 1
            if best_key is None or key > best_key:
                best_key, best_words = key, shifted

        if budget_used >= _MAX_SHIFT_CANDIDATES:
            break

    if best_key is None:
        return 0, pred_words, budget_used
    return best_key[0], best_words, budget_used


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> float:
    """Edit count (shifts + Levenshtein) to turn the hypothesis into the reference."""
    if not target_words:
        return 0.0

    engine = _TraceEditDistance(target_words)
    hypothesis = pred_words
    shifts_taken, budget = 0, 0
    # greedily take the best gain-positive shift until none helps or the candidate
    # budget runs dry, then charge the residual edit distance. A round that exhausts
    # the budget or ends non-positive is DISCARDED (its best candidate is not taken)
    while True:
        gain, shifted, budget = _best_shift(hypothesis, target_words, engine, budget)
        if budget >= _MAX_SHIFT_CANDIDATES or gain <= 0:
            break
        hypothesis = shifted
        shifts_taken += 1
    return float(shifts_taken + engine(hypothesis)[0])


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best edit count over references and the average reference length."""
    per_reference = [_translation_edit_rate(tgt_words, pred_words) for tgt_words in target_words]
    mean_ref_len = sum(len(t) for t in target_words) / len(target_words)
    return min(per_reference, default=2e16), mean_ref_len


def _sentence_ter_score(num_edits: float, tgt_length: float) -> float:
    """``_compute_ter_score_from_statistics`` of one sentence, in numpy float32."""
    num_edits, tgt_length = np.float32(num_edits), np.float32(tgt_length)
    if tgt_length > 0:
        return float(num_edits / tgt_length)
    return 0.0 if num_edits == 0 else 1.0


def _compute_ter_score_from_statistics(num_edits: Tensor, tgt_length: Tensor) -> Tensor:
    """Sentence/corpus TER from edit count and reference length (edge-cased)."""
    num_edits = num_edits.to(torch.float32)
    tgt_length = tgt_length.to(device=num_edits.device, dtype=torch.float32)
    return torch.where(
        tgt_length > 0,
        num_edits / torch.where(tgt_length > 0, tgt_length, 1.0),
        torch.where(num_edits == 0, 0.0, 1.0),
    )


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    tokenizer: _TercomTokenizer,
    total_num_edits: float,
    total_tgt_length: float,
    sentence_ter: Optional[List[float]] = None,
) -> Tuple[float, float, Optional[List[float]]]:
    """Accumulate edit counts and reference lengths over the batch."""
    target, preds = _validate_inputs(target, preds)

    for hypothesis, references in zip(preds, target):
        hyp_tokens = _preprocess_sentence(hypothesis, tokenizer).split()
        ref_token_lists = [_preprocess_sentence(ref, tokenizer).split() for ref in references]
        edits, ref_len = _compute_sentence_statistics(hyp_tokens, ref_token_lists)
        total_num_edits += edits
        total_tgt_length += ref_len
        if sentence_ter is not None:
            sentence_ter.append(_sentence_ter_score(edits, ref_len))
    return total_num_edits, total_tgt_length, sentence_ter


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    """Corpus TER from accumulated statistics."""
    return _compute_ter_score_from_statistics(total_num_edits, total_tgt_length)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Compute the translation edit rate of hypotheses against references, on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> translation_edit_rate(preds, target, device="cpu").round(decimals=4)
        tensor(0.1538)
    """
    device = _resolve_device(device)
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")

    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    sentence_ter: Optional[List[float]] = [] if return_sentence_level_score else None
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(
        preds, target, tokenizer, 0.0, 0.0, sentence_ter
    )
    total_ter = _ter_compute(
        torch.tensor(total_num_edits, dtype=torch.float32, device=device),
        torch.tensor(total_tgt_length, dtype=torch.float32, device=device),
    )
    if sentence_ter is not None:
        return total_ter, torch.tensor(sentence_ter, dtype=torch.float32, device=device)
    return total_ter
