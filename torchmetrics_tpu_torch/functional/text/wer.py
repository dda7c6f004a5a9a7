"""Word error rate.

Counterpart of ``torchmetrics_tpu/functional/text/wer.py``.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor


def _wer_update(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    device: Union[str, torch.device] = "cpu",
) -> Tuple[Tensor, Tensor]:
    """Word-level edit operations and reference word count for the batch."""
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
        total += len(tgt_tokens)
    return (
        torch.tensor(errors, dtype=torch.float32, device=device),
        torch.tensor(total, dtype=torch.float32, device=device),
    )


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    """WER = errors / reference words."""
    return errors / total


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Union[str, torch.device] = "cuda"
) -> Tensor:
    """Compute the word error rate of transcriptions, as a tensor on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import word_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_error_rate(preds=preds, target=target, device="cpu")
        tensor(0.5000)
    """
    errors, total = _wer_update(preds, target, _resolve_device(device))
    return _wer_compute(errors, total)
