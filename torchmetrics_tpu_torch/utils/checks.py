"""Input and placement checks used by the classification and image slices.

Counterpart of ``torchmetrics_tpu/utils/checks.py``, cut to what the port calls.
The port adds the device check: every entry point runs on the card unless the
caller asks for the CPU, and asking for the card where there is none raises
instead of falling back.
"""

from __future__ import annotations

from typing import Union

import torch


def _resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The ``torch.device`` a metric lives on; ``cuda`` without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass `device='cpu'` to run the metric on the CPU."
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Expected `device` to be a CUDA device or 'cpu', but got {device}.")
    return device


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise if ``preds`` and ``target`` have different shapes (the JAX package's message)."""
    if preds.shape != target.shape:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape, but got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}."
        )
