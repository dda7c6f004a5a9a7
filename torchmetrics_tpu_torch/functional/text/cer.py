"""Character error rate.

Counterpart of ``torchmetrics_tpu/functional/text/cer.py``.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor


def _cer_update(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    device: Union[str, torch.device] = "cpu",
) -> Tuple[Tensor, Tensor]:
    """Character-level edit operations and reference char count for the batch."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        errors += _edit_distance(list(pred), list(tgt))
        total += len(tgt)
    return (
        torch.tensor(errors, dtype=torch.float32, device=device),
        torch.tensor(total, dtype=torch.float32, device=device),
    )


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    """CER = errors / reference chars."""
    return errors / total


def char_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device] = "cuda"
) -> Tensor:
    """Compute the character error rate of transcriptions, as a tensor on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import char_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> char_error_rate(preds=preds, target=target, device="cpu").round(decimals=4)
        tensor(0.3415)
    """
    errors, total = _cer_update(preds, target, _resolve_device(device))
    return _cer_compute(errors, total)
