"""InfoLM.

Counterpart of ``torchmetrics_tpu/text/infolm.py``: every token position is masked in
turn, the masked LM's temperature-scaled distributions at the masked position are
summed (idf-weighted where ``idf``) in float64 into one vocabulary distribution per
sentence, and the two corpora's distributions are compared by one of nine information
measures (on float32 distributions, as JAX's arrays hold them).

The masked LM is the port's (``utils/hf``), from a local snapshot, on the metric's
device. A position no row has a token in is skipped, as in JAX, and at each position
only the rows holding a token there run, each batch trimmed to its longest row (the
other rows' distributions are multiplied by zero in JAX). The hidden state at the
masked position is gathered before the head, so only ``[rows, vocab]`` logits are
formed, never ``[rows, seq, vocab]``; JAX slices after the decoder. Both compute the
same numbers.
"""

from __future__ import annotations

import functools
import math
import os
from collections import Counter, defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.bert import _get_progress_bar, _row_widths
from torchmetrics_tpu_torch.text._base import _TextMetric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.imports import _TQDM_AVAILABLE, snapshot_weight_stamp

Tensor = torch.Tensor

_ALLOWED_INFORMATION_MEASURES = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)


class _InformationMeasure:
    """The InfoLM divergence/distance family over vocabulary distributions."""

    def __init__(self, information_measure: str, alpha: Optional[float] = None, beta: Optional[float] = None) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURES:
            raise ValueError(
                f"Argument `information_measure` expected to be one of {_ALLOWED_INFORMATION_MEASURES}"
                f" but got {information_measure}"
            )
        self.information_measure = information_measure
        needs_alpha = ("alpha_divergence", "ab_divergence", "renyi_divergence")
        needs_beta = ("beta_divergence", "ab_divergence")
        if information_measure in needs_alpha and not isinstance(alpha, float):
            raise ValueError(f"Parameter `alpha` is expected to be defined for {information_measure}.")
        if information_measure in needs_beta and not isinstance(beta, float):
            raise ValueError(f"Parameter `beta` is expected to be defined for {information_measure}.")
        if information_measure == "alpha_divergence" and alpha in (0, 1):
            raise ValueError(f"Parameter `alpha` is expected to be float differened from 0 and 1 for {information_measure}.")
        if information_measure == "beta_divergence" and beta in (0, -1):
            raise ValueError(f"Parameter `beta` is expected to be float differened from 0 and -1 for {information_measure}.")
        if information_measure == "ab_divergence" and (alpha is None or beta is None or 0 in (alpha, beta, alpha + beta)):
            raise ValueError(
                f"Parameters `alpha`, `beta` and their sum are expected to be differened from 0 for {information_measure}."
            )
        if information_measure == "renyi_divergence" and alpha == 1:
            raise ValueError(f"Parameter `alpha` is expected to be float differened from 1 for {information_measure}.")
        self.alpha = alpha or 0.0
        self.beta = beta or 0.0

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        fn = getattr(self, f"_calculate_{self.information_measure}")
        return torch.nan_to_num(fn(preds_distribution, target_distribution))

    @staticmethod
    def _calculate_kl_divergence(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(t * torch.log(p / t), dim=-1)

    def _calculate_alpha_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        denom = self.alpha * (self.alpha - 1)
        return (1 - torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / denom

    def _calculate_ab_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        a = torch.log(torch.sum(t ** (self.beta + self.alpha), dim=-1)) / (self.beta * (self.beta + self.alpha))
        b = torch.log(torch.sum(p ** (self.beta + self.alpha), dim=-1)) / (self.alpha * (self.beta + self.alpha))
        c = torch.log(torch.sum(t**self.alpha * p**self.beta, dim=-1)) / (self.alpha * self.beta)
        return a + b - c

    def _calculate_beta_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        self.alpha = 1.0
        return self._calculate_ab_divergence(p, t)

    def _calculate_renyi_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        return torch.log(torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / (self.alpha - 1)

    @staticmethod
    def _calculate_l1_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.linalg.vector_norm(t - p, ord=1, dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.linalg.vector_norm(t - p, ord=2, dim=-1)

    @staticmethod
    def _calculate_l_infinity_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.linalg.vector_norm(t - p, ord=float("inf"), dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: Tensor, t: Tensor) -> Tensor:
        return 2 * torch.arccos(torch.clip(torch.sqrt(p * t).sum(dim=-1), 0, 1))


def _load_masked_lm(model_name_or_path: str, device: torch.device):
    return _load_masked_lm_uncached(model_name_or_path, str(device), snapshot_weight_stamp(model_name_or_path))


@functools.lru_cache(maxsize=2)
def _load_masked_lm_uncached(model_name_or_path: str, device: str, _stamp=()):
    """The port's masked LM and tokenizer of a local snapshot."""
    from torchmetrics_tpu_torch.utils.hf.encoders import load_encoder
    from torchmetrics_tpu_torch.utils.hf.tokenizer import load_tokenizer

    try:
        if not (isinstance(model_name_or_path, str) and os.path.isdir(model_name_or_path)):
            raise FileNotFoundError(model_name_or_path)
        tokenizer = load_tokenizer(model_name_or_path)
        model = load_encoder(model_name_or_path, masked_lm=True)
    except NotImplementedError:
        raise
    except Exception as err:
        raise OSError(
            f"Could not load `{model_name_or_path}` from the local transformers cache and this"
            " environment has no network access. Provide a locally cached model path."
        ) from err
    return model.to(device), tokenizer


class InfoLM(_TextMetric):
    r"""InfoLM: information measures over masked-LM predictive distributions.

    ``model_name_or_path`` is a local snapshot directory of a BERT or RoBERTa masked LM
    (``google/bert_uncased_L-2_H-128_A-2`` by default); construction raises an
    ``OSError`` when it is not there (nothing is downloaded). The model runs on the
    metric's device (``"cuda"`` unless ``device="cpu"``). With ``verbose`` and ``tqdm``
    installed, the position loop shows a progress bar.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        model_name_or_path: str = "google/bert_uncased_L-2_H-128_A-2",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        device: Optional[Any] = None,
        max_length: Optional[int] = None,
        batch_size: int = 64,
        num_threads: int = 0,
        verbose: bool = True,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        del num_threads
        if not (isinstance(batch_size, int) and batch_size > 0):
            raise ValueError(f"Argument `batch_size` is expected to be a positive integer but got {batch_size}")
        self.batch_size = batch_size
        self.verbose = verbose
        self.information_measure_fn = _InformationMeasure(information_measure, alpha, beta)
        self.model, self.tokenizer = _load_masked_lm(model_name_or_path, self.device)
        if not (isinstance(temperature, float) and temperature > 0):
            raise ValueError(f"Argument `temperature` is expected to be a positive float but got {temperature}")
        self.temperature = temperature
        self.idf = idf
        model_max = self.model.config["max_position_embeddings"]
        self.max_length = min(max_length, model_max) if max_length else model_max
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("preds_input_ids", [], dist_reduce_fx="cat")
        self.add_state("preds_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("target_input_ids", [], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", [], dist_reduce_fx="cat")

    def update(self, preds, target) -> None:
        """Tokenize and store fixed-width id/mask rows."""
        for texts, ids_state, mask_state in (
            (preds, self.preds_input_ids, self.preds_attention_mask),
            (target, self.target_input_ids, self.target_attention_mask),
        ):
            texts = [texts] if isinstance(texts, str) else list(texts)
            enc = self.tokenizer(texts, padding="max_length", truncation=True, max_length=self.max_length)
            ids_state.append(torch.as_tensor(enc["input_ids"], device=self.device))
            mask_state.append(torch.as_tensor(enc["attention_mask"], device=self.device))

    def _token_mask(self, input_ids: np.ndarray) -> np.ndarray:
        """True for real content tokens (not PAD/SEP/CLS)."""
        special = {self.tokenizer.pad_token_id, self.tokenizer.sep_token_id, self.tokenizer.cls_token_id}
        mask = np.ones_like(input_ids, dtype=bool)
        for tok in special:
            if tok is not None:
                mask &= input_ids != tok
        return mask

    @staticmethod
    def _ids_idf(input_ids: np.ndarray) -> np.ndarray:
        """Per-token inverse document frequencies over this corpus."""
        num_sentences = input_ids.shape[0]
        counter: Counter = Counter()
        for row in input_ids:
            counter.update(set(row.tolist()))
        idf: Dict[int, float] = defaultdict(lambda: math.log(num_sentences + 1))
        idf.update({idx: math.log((num_sentences + 1) / (occ + 1)) for idx, occ in counter.items()})
        return np.vectorize(lambda t: idf[int(t)])(input_ids)

    def _sentence_distribution(self, input_ids: np.ndarray, attention_mask: np.ndarray) -> Tensor:
        """One float64 vocabulary distribution per sentence, ``[rows, vocab]``."""
        token_mask = self._token_mask(input_ids)
        ids_idf = self._ids_idf(input_ids) if self.idf else None
        widths = _row_widths(attention_mask)
        mask_token_id = self.tokenizer.mask_token_id
        device = self.device
        ids_all = torch.as_tensor(input_ids, device=device).long()
        mask_all = torch.as_tensor(attention_mask, device=device).long()
        weights = token_mask * ids_idf if self.idf else token_mask.astype(np.float64)
        total: Optional[Tensor] = None
        for mask_idx in _get_progress_bar(range(input_ids.shape[1]), self.verbose and _TQDM_AVAILABLE):
            rows = np.nonzero(token_mask[:, mask_idx])[0]
            if rows.size == 0:
                continue
            rows = rows[np.argsort(-widths[rows], kind="stable")]
            for start in range(0, rows.size, self.batch_size):
                part = rows[start : start + self.batch_size]
                width = max(int(widths[part].max()), mask_idx + 1)
                index = torch.as_tensor(part, device=device)
                ids_b = ids_all[index, :width].clone()
                ids_b[:, mask_idx] = mask_token_id
                hidden = self.model.encode(ids_b, mask_all[index, :width])[:, mask_idx]
                probs = torch.softmax(self.model.logits(hidden) / self.temperature, dim=-1).to(torch.float64)
                probs = probs * torch.as_tensor(weights[part, mask_idx], device=device)[:, None]
                if total is None:
                    total = torch.zeros(input_ids.shape[0], probs.shape[1], dtype=torch.float64, device=device)
                total.index_add_(0, index, probs)
        if total is None:
            total = torch.zeros(input_ids.shape[0], 1, dtype=torch.float64, device=device)
        denom = weights.sum(axis=1, keepdims=True)
        return total / torch.as_tensor(denom, device=device)

    def compute(self):
        """InfoLM score over all accumulated sentence pairs."""
        distributions = []
        for ids, mask in ((self.preds_input_ids, self.preds_attention_mask),
                          (self.target_input_ids, self.target_attention_mask)):
            ids_np = dim_zero_cat(ids).cpu().numpy()
            mask_np = dim_zero_cat(mask).cpu().numpy()
            # JAX holds the float64 sums in a float32 array (x64 off) before the measure
            distributions.append(self._sentence_distribution(ids_np, mask_np).to(torch.float32))
        info_lm_score = self.information_measure_fn(*distributions)
        if self.return_sentence_level_score:
            return info_lm_score.mean(), info_lm_score
        return info_lm_score.mean()
