"""InfoLM (functional).

Counterpart of ``torchmetrics_tpu/functional/text/infolm.py``: a thin wrapper over the
module, which scores one corpus pair.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
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
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Compute InfoLM between a predicted and a reference corpus, on ``device``
    (``"cuda"`` unless the caller asks for ``"cpu"``); ``num_threads`` is accepted and
    ignored, as in JAX."""
    from torchmetrics_tpu_torch.text.infolm import InfoLM

    metric = InfoLM(
        model_name_or_path=model_name_or_path,
        temperature=temperature,
        information_measure=information_measure,
        idf=idf,
        alpha=alpha,
        beta=beta,
        device=device,
        max_length=max_length,
        batch_size=batch_size,
        num_threads=num_threads,
        verbose=verbose,
        return_sentence_level_score=return_sentence_level_score,
    )
    metric.update(preds, target)
    return metric.compute()
