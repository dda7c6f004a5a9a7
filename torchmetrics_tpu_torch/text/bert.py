"""BERTScore module.

Counterpart of ``torchmetrics_tpu/text/bert.py``: tokenized id/mask ``cat`` states
padded to ``max_length`` (capped to the encoder's position budget), and every option
of the functional passed through at ``compute``. The encoder, when loaded from
``model_name_or_path``, lives on the metric's device; JAX's ``mesh`` is refused.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.bert import (
    _DEFAULT_MODEL,
    _load_model,
    _simple_whitespace_tokenizer,
    bert_score,
)
from torchmetrics_tpu_torch.text._base import _TextMetric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class BERTScore(_TextMetric):
    r"""BERTScore: greedy cosine matching of contextual embeddings.

    ``model`` may be any callable ``(input_ids, attention_mask) -> (B, S, D)``
    (``(B, num_layers, S, D)`` when ``all_layers=True``); without it,
    ``model_name_or_path`` (a local snapshot directory) is loaded by the port's encoder
    and tokenizer on the metric's device. All options of the functional pass through
    at ``compute``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import BERTScore
        >>> table = torch.randn(1000, 8, generator=torch.Generator().manual_seed(0))
        >>> def toy_model(input_ids, attention_mask):
        ...     return table[input_ids % 1000]
        >>> bertscore = BERTScore(model=toy_model, device="cpu")
        >>> bertscore.update(["hello there"], ["hello there"])
        >>> float(bertscore.compute()["f1"]) > 0.99
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    preds_input_ids: List[Tensor]
    preds_attention_mask: List[Tensor]
    target_input_ids: List[Tensor]
    target_attention_mask: List[Tensor]

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Callable] = None,
        user_tokenizer: Any = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        device: Optional[Any] = None,
        max_length: int = 512,
        batch_size: int = 64,
        num_threads: int = 0,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        mesh: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        del num_threads
        if mesh is not None:
            raise ValueError("`mesh` is a JAX option; the port runs the encoder on the metric's device, one card.")
        self.model_name_or_path = model_name_or_path or _DEFAULT_MODEL
        if model is None:
            model, user_tokenizer = _load_model(self.model_name_or_path, num_layers, all_layers, self.device)
            model_max = model.hf_model.config.get("max_position_embeddings")
            if model_max is not None and max_length > model_max:
                max_length = model_max
            if user_forward_fn is not None:
                model = model.hf_model  # user_forward_fn receives the encoder itself
        self.model = model
        self.user_tokenizer = user_tokenizer
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.user_forward_fn = user_forward_fn
        self.verbose = verbose
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.baseline_url = baseline_url

        self.add_state("preds_input_ids", [], dist_reduce_fx="cat")
        self.add_state("preds_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("target_input_ids", [], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", [], dist_reduce_fx="cat")

    def _tokenize(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        if self.user_tokenizer is not None:
            enc = self.user_tokenizer(
                list(texts), padding="max_length", truncation=True, max_length=self.max_length, return_tensors="np"
            )
            return {k: np.asarray(enc[k]) for k in ("input_ids", "attention_mask")}
        return _simple_whitespace_tokenizer(list(texts), self.max_length, pad_to_max_length=True)

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        """Tokenize and store fixed-width id/mask rows."""
        preds_list = [preds] if isinstance(preds, str) else list(preds)
        target_list = [target] if isinstance(target, str) else list(target)
        if len(preds_list) != len(target_list):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        enc_p = self._tokenize(preds_list)
        enc_t = self._tokenize(target_list)
        for name, enc, key in (("preds_input_ids", enc_p, "input_ids"), ("preds_attention_mask", enc_p, "attention_mask"),
                               ("target_input_ids", enc_t, "input_ids"),
                               ("target_attention_mask", enc_t, "attention_mask")):
            getattr(self, name).append(torch.as_tensor(enc[key], device=self.device))

    def compute(self) -> Dict[str, Union[Tensor, List[float], str]]:
        """BERTScore P/R/F1 over all accumulated sentences (the functional's
        pre-tokenized dict path)."""
        enc_preds = {"input_ids": dim_zero_cat(self.preds_input_ids),
                     "attention_mask": dim_zero_cat(self.preds_attention_mask)}
        enc_target = {"input_ids": dim_zero_cat(self.target_input_ids),
                      "attention_mask": dim_zero_cat(self.target_attention_mask)}
        return bert_score(
            enc_preds,
            enc_target,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_forward_fn=self.user_forward_fn,
            verbose=self.verbose,
            idf=self.idf,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_hash=self.return_hash,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            baseline_url=self.baseline_url,
        )
