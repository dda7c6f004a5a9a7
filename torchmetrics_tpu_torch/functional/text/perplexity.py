"""Perplexity.

Counterpart of ``torchmetrics_tpu/functional/text/perplexity.py``: tensor math, no
kernel of the port's own. The token negative log-likelihood is ``logsumexp(logits) -
logits[target]``, which never makes the ``[N, V]`` log-probabilities; ``ignore_index``
is a mask, so an update has no data-dependent shape and captures into a CUDA graph.
JAX's ``_logsumexp_last_axis`` sums 128-lane partials where ``V % 128 == 0`` and ``V >=
256``, a layout for XLA:CPU; ``torch.logsumexp`` over the whole row agrees with it
within float32 rounding, not bitwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _dtype_name(dtype: torch.dtype) -> str:
    """``float32`` for ``torch.float32``: the name JAX prints in its messages."""
    return str(dtype).replace("torch.", "")


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> None:
    """Validate [B, T, V] float logits against [B, T] integer targets."""
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            "Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len],"
            f" but got {target.ndim}."
        )
    if tuple(preds.shape[:2]) != tuple(target.shape):
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise TypeError(
            f"Input tensor `preds` is expected to be of floating point type but got {_dtype_name(preds.dtype)}."
        )
    if target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(
            f"Input tensor `target` is expected to be of integer type but got {_dtype_name(target.dtype)}."
        )


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Summed token negative log-likelihood and valid-token count for the batch."""
    _check_shape_and_type_consistency(preds, target)

    logits = preds.reshape(-1, preds.shape[-1])
    target = target.reshape(-1)

    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.where(mask, target, torch.zeros_like(target))
    else:
        mask = torch.ones_like(target, dtype=torch.bool)

    lse = torch.logsumexp(logits, dim=-1)
    target_logits = torch.gather(logits, 1, target[:, None].long()).squeeze(1)
    total_log_probs = torch.sum((lse - target_logits) * mask)
    count = mask.sum(dtype=torch.int32)
    return total_log_probs, count


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    """exp of the mean NLL."""
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Compute perplexity of a language model's logits against target token ids, on the
    logits' device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text import perplexity
        >>> g = torch.Generator().manual_seed(22)
        >>> preds = torch.rand(2, 8, 5, generator=g)
        >>> target = torch.randint(0, 5, (2, 8), generator=g)
        >>> float(perplexity(preds, target)) > 1
        True
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
