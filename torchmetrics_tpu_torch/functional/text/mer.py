"""Match error rate.

Counterpart of ``torchmetrics_tpu/functional/text/mer.py``.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor


def _mer_update(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    device: Union[str, torch.device] = "cpu",
) -> Tuple[Tensor, Tensor]:
    """Edit operations and max(len(ref), len(pred)) word totals for the batch."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += max(len(tgt_tokens), len(pred_tokens))
    return (
        torch.tensor(errors, dtype=torch.float32, device=device),
        torch.tensor(total, dtype=torch.float32, device=device),
    )


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    """MER = errors / total."""
    return errors / total


def match_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device] = "cuda"
) -> Tensor:
    """Compute the match error rate of transcriptions, as a tensor on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import match_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> match_error_rate(preds=preds, target=target, device="cpu").round(decimals=4)
        tensor(0.4444)
    """
    errors, total = _mer_update(preds, target, _resolve_device(device))
    return _mer_compute(errors, total)
