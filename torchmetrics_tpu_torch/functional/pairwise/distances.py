"""Pairwise distance and similarity functions.

Counterpart of ``torchmetrics_tpu/functional/pairwise/distances.py``. Cosine, linear
and Euclidean run one ``[N, d] x [d, M]`` product in full float32 (no TF32), as the
JAX package's ``Precision.HIGHEST``; Euclidean keeps its Gram-matrix expansion and its
order of operations. Manhattan and Minkowski are ``torch.cdist``, the same sum of
``|x_ik - y_jk| ** p`` and its p-th root per entry (p = 2 included) as JAX's ``[N, M, d]`` broadcast,
without holding that broadcast (51 GB at N = M = 4096, d = 768).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

Tensor = torch.Tensor


def _check_input(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[Tensor, Tensor, bool]:
    """Validate [N,d]/[M,d] inputs and default ``zero_diagonal`` (True iff y is x)."""
    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        y = torch.as_tensor(y, device=x.device)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    """Reduce the [N,M] matrix along its last dimension (mean/sum/none)."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    """Zero the first ``min(N, M)`` diagonal entries, out of place (``torch.cdist``'s
    backward reads its own output)."""
    if zero_diagonal:
        return distance.diagonal_scatter(distance.new_zeros(min(distance.shape)))
    return distance


def pairwise_cosine_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    r"""Calculate pairwise cosine similarity between rows of ``x`` (and ``y``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.pairwise import pairwise_cosine_similarity
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_cosine_similarity(x, y).round(decimals=4)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    distance = _zero_diagonal(_matmul_full_float32(x, y.T), zero_diag)
    return _reduce_distance_matrix(distance, reduction)


def pairwise_euclidean_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    r"""Calculate pairwise euclidean distances between rows of ``x`` (and ``y``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.pairwise import pairwise_euclidean_distance
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_euclidean_distance(x, y).round(decimals=4)
        tensor([[3.1623, 2.0000],
                [5.3852, 4.1231],
                [8.9443, 7.6158]])
    """
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    x_norm = (x * x).sum(dim=1, keepdim=True)
    y_norm = (y * y).sum(dim=1)
    # (x_norm + y_norm) - 2 * xy, JAX's order, with one [N, M] temporary besides the product
    distance = (x_norm + y_norm).sub_(_matmul_full_float32(x, y.T).mul_(2))
    distance = _zero_diagonal(distance.clamp_(min=0.0), zero_diag)
    return _reduce_distance_matrix(distance.sqrt_(), reduction)


def pairwise_linear_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    r"""Calculate pairwise linear similarity (inner products) between rows.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.pairwise import pairwise_linear_similarity
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 2.,  7.],
                [ 3., 11.],
                [ 5., 18.]])
    """
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    distance = _zero_diagonal(_matmul_full_float32(x, y.T), zero_diag)
    return _reduce_distance_matrix(distance, reduction)


def pairwise_manhattan_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    r"""Calculate pairwise manhattan (L1) distances between rows.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.pairwise import pairwise_manhattan_distance
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[ 4.,  2.],
                [ 7.,  5.],
                [12., 10.]])
    """
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    distance = _zero_diagonal(torch.cdist(x, y, p=1), zero_diag)
    return _reduce_distance_matrix(distance, reduction)


def pairwise_minkowski_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    exponent: float = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    r"""Calculate pairwise minkowski (L_p) distances between rows.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.pairwise import pairwise_minkowski_distance
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_minkowski_distance(x, y, exponent=4).round(decimals=4)
        tensor([[3.0092, 2.0000],
                [5.0317, 4.0039],
                [8.1222, 7.0583]])
    """
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {exponent}")
    # p = 2 by differences too, not cdist's Gram expansion
    distance = torch.cdist(x, y, p=exponent, compute_mode="donot_use_mm_for_euclid_dist")
    distance = _zero_diagonal(distance, zero_diag)
    return _reduce_distance_matrix(distance, reduction)
