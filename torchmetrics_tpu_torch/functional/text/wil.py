"""Word information lost.

Counterpart of ``torchmetrics_tpu/functional/text/wil.py``.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor


def _word_info_lost_update(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    device: Union[str, torch.device] = "cpu",
) -> Tuple[Tensor, Tensor, Tensor]:
    """(errors - total), reference word count, prediction word count for the batch."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    total = 0
    errors = 0
    target_total = 0
    preds_total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        target_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, target_tokens)
        target_total += len(target_tokens)
        preds_total += len(pred_tokens)
        total += max(len(target_tokens), len(pred_tokens))
    return (
        torch.tensor(errors - total, dtype=torch.float32, device=device),
        torch.tensor(target_total, dtype=torch.float32, device=device),
        torch.tensor(preds_total, dtype=torch.float32, device=device),
    )


def _word_info_lost_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    """WIL = 1 - hit-rate product."""
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device] = "cuda"
) -> Tensor:
    """Compute the word information lost of transcriptions, as a tensor on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import word_information_lost
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_information_lost(preds, target, device="cpu").round(decimals=4)
        tensor(0.6528)
    """
    errors, target_total, preds_total = _word_info_lost_update(preds, target, _resolve_device(device))
    return _word_info_lost_compute(errors, target_total, preds_total)
