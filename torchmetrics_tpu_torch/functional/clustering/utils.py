"""Shared helpers for clustering metrics.

Counterpart of ``torchmetrics_tpu/functional/clustering/utils.py``. The JAX package
builds the contingency table on the host (``np.unique`` and a float64 ``np.add.at``).
Here it stays where the labels are: each side is densified by ``torch.unique``, and
the (target, pred) pairs are counted by one launch of the bincount kernel over
``target_index * P + pred_index``, ``R * P`` bins, cast to float64. The counts are
exact, as JAX's float64 sums are. A table of ``R * P >= 2^31`` cells is refused with
a ``ValueError``: the kernel's bins are an int, and JAX's dense float64 table would
take 16 GB or more.

The pair confusion matrix is float64, as in JAX; the entropy of a labelling is summed
in float64 and rounded to float32 once, as JAX returns it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

# the contingency table's bins are the bincount kernel's int bins
_MAX_CELLS = 1 << 31


def _scalar(value: float, like: Tensor) -> Tensor:
    """A float32 0-d tensor on ``like``'s device (JAX's ``jnp.asarray(value)``)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _validate_average_method_arg(average_method: str = "arithmetic") -> None:
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError(
            "Expected argument `average_method` to be one of  `min`, `geometric`, `arithmetic`, `max`,"
            f"but got {average_method}"
        )


def calculate_entropy(x: Tensor) -> Tensor:
    """Entropy of a label assignment (natural log, computed in log-space)."""
    x = torch.as_tensor(x)
    if x.numel() == 0:
        return _scalar(1.0, x)
    p = torch.unique(x, return_counts=True)[1]
    if p.numel() == 1:
        return _scalar(0.0, x)
    p = p.to(torch.float64)
    n = p.sum()
    return (-torch.sum((p / n) * (torch.log(p) - torch.log(n)))).to(torch.float32)


def calculate_generalized_mean(x: Tensor, p: Union[int, str]) -> Tensor:
    """Generalized (power) mean: min / geometric / arithmetic / max or an exponent."""
    x = torch.as_tensor(x)
    if isinstance(p, str):
        if p == "min":
            return x.min()
        if p == "geometric":
            return torch.exp(torch.mean(torch.log(x)))
        if p == "arithmetic":
            return x.mean()
        if p == "max":
            return x.max()
        raise ValueError("'method' must be 'min', 'geometric', 'arirthmetic', or 'max'")
    return torch.mean(torch.pow(x, p)) ** (1.0 / p)


def calculate_contingency_matrix(preds: Tensor, target: Tensor, eps: Optional[float] = None) -> Tensor:
    """Dense float64 contingency matrix of shape (n_classes_target, n_classes_preds)."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    if preds.ndim != 1 or target.ndim != 1:
        raise ValueError(f"Expected 1d `preds` and `target` but got {preds.ndim} and {target.ndim}.")

    preds_classes, preds_idx = torch.unique(preds, return_inverse=True)
    target_classes, target_idx = torch.unique(target, return_inverse=True)
    num_preds, num_target = preds_classes.numel(), target_classes.numel()
    if num_target * num_preds >= _MAX_CELLS:
        raise ValueError(
            f"The contingency table of {num_target} target and {num_preds} predicted clusters has"
            f" {num_target * num_preds} cells, more than the bincount kernel's 2^31 - 1 bins"
            " (as a dense float64 table it would take 16 GB or more)."
        )
    counts = kernels.bincount(target_idx * num_preds + preds_idx, None, num_target * num_preds)
    contingency = counts.reshape(num_target, num_preds).to(torch.float64)
    if eps is not None:
        contingency = contingency + eps
    return contingency


def check_cluster_labels(preds: Tensor, target: Tensor) -> None:
    """Require same-shape 1D integer label tensors (shape/dtype only)."""
    _check_same_shape(preds, target)
    if preds.ndim != 1:
        raise ValueError("Expected arguments to be 1-d tensors.")
    if any(torch.as_tensor(x).is_floating_point() for x in (preds, target)):
        raise ValueError(
            "Expected real, discrete values for x but received"
            f" {_dtype_name(preds)} and {_dtype_name(target)}."
        )


def _dtype_name(x) -> str:
    """A tensor's dtype as the JAX package names it (``float32``)."""
    return str(torch.as_tensor(x).dtype).removeprefix("torch.")


def _validate_intrinsic_cluster_data(data: Tensor, labels: Tensor) -> None:
    """Require 2D float data and 1D labels."""
    if data.ndim != 2:
        raise ValueError(f"Expected 2D data, got {data.ndim}D data instead")
    if not data.is_floating_point():
        raise ValueError(f"Expected floating point data, got {_dtype_name(data)} data instead")
    if labels.ndim != 1:
        raise ValueError(f"Expected 1D labels, got {labels.ndim}D labels instead")


def _validate_intrinsic_labels_to_samples(num_labels: int, num_samples: int) -> None:
    """Require 1 < clusters < samples."""
    if not 1 < num_labels < num_samples:
        raise ValueError(
            "Number of detected clusters must be greater than one and less than the number of samples."
            f"Got {num_labels} clusters and {num_samples} samples."
        )


def calculate_pair_cluster_confusion_matrix(
    preds: Optional[Tensor] = None,
    target: Optional[Tensor] = None,
    contingency: Optional[Tensor] = None,
) -> Tensor:
    """2x2 pair-counting confusion matrix of two clusterings (in pair units)."""
    if preds is None and target is None and contingency is None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`.")
    if preds is not None and target is not None and contingency is not None:
        raise ValueError("Must provide either `preds` and `target` or `contingency`, not both.")
    if preds is not None and target is not None:
        contingency = calculate_contingency_matrix(preds, target)
    if contingency is None:
        raise ValueError("Must provide `contingency` if `preds` and `target` are not provided.")
    contingency = torch.as_tensor(contingency)

    num_samples = contingency.sum()
    sum_c = contingency.sum(dim=1)
    sum_k = contingency.sum(dim=0)
    sum_squared = (contingency**2).sum()

    pair_11 = sum_squared - num_samples
    pair_10 = (contingency * sum_k).sum() - sum_squared
    pair_01 = (contingency.T * sum_c).sum() - sum_squared
    pair_00 = num_samples**2 - pair_01 - pair_10 - sum_squared
    return torch.stack([torch.stack([pair_00, pair_01]), torch.stack([pair_10, pair_11])])
