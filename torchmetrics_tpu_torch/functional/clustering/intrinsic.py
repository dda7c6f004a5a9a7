"""Intrinsic (data + labels) clustering metrics.

Counterpart of ``torchmetrics_tpu/functional/clustering/intrinsic.py``. A cluster's
count comes from the bincount kernel and its sum from the one-hot product, in full
float32 (JAX: ``Precision.HIGHEST``). JAX's two broadcasts over cluster pairs, the
``[K, K, d]`` centroid differences of Davies-Bouldin and the Dunn index's Python loop
over ``combinations(range(K), 2)``, are ``torch.cdist`` over the centroids, which never
holds the ``[K, K, d]`` differences (Euclidean by direct differences, not the Gram
expansion) and whose gradient is 0 at a zero distance, as JAX's guarded norms give;
the Dunn index reads its pairs in ``combinations`` order (``torch.triu_indices``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _scalar,
    _validate_intrinsic_cluster_data,
    _validate_intrinsic_labels_to_samples,
)
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor


def _relabel(labels: Tensor) -> Tuple[Tensor, int]:
    """Zero-index the labels (``torch.unique``)."""
    unique, inverse = torch.unique(labels, return_inverse=True)
    return inverse, unique.numel()


def _one_hot(labels: Tensor, num_labels: int, dtype: torch.dtype) -> Tensor:
    """(N, K) one-hot rows of zero-indexed labels in ``dtype``."""
    onehot = torch.zeros((labels.numel(), num_labels), dtype=dtype, device=labels.device)
    return onehot.scatter_(1, labels[:, None], 1)


def _cluster_stats(data: Tensor, labels: Tensor, num_labels: int) -> Tuple[Tensor, Tensor]:
    """Per-cluster counts (bincount kernel) and centroids (one-hot product, full float32)."""
    counts = kernels.bincount(labels, None, num_labels).to(data.dtype)  # (K,)
    sums = _matmul_full_float32(_one_hot(labels, num_labels, data.dtype).T, data)  # (K, d)
    return counts, sums / counts[:, None]


def calinski_harabasz_score(data: Tensor, labels: Tensor) -> Tensor:
    """Compute the Calinski-Harabasz score for intrinsic cluster evaluation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import calinski_harabasz_score
        >>> data = torch.tensor([[0., 0.], [0., 1.], [5., 5.], [5., 6.]])
        >>> calinski_harabasz_score(data, torch.tensor([0, 0, 1, 1]))
        tensor(100.)
    """
    data = torch.as_tensor(data)
    labels = torch.as_tensor(labels, device=data.device)
    _validate_intrinsic_cluster_data(data, labels)
    labels, num_labels = _relabel(labels)
    num_samples = data.shape[0]
    _validate_intrinsic_labels_to_samples(num_labels, num_samples)

    mean = data.mean(dim=0)
    counts, centroids = _cluster_stats(data, labels, num_labels)
    between = (torch.square(centroids - mean).sum(dim=1) * counts).sum()
    within = torch.square(data - centroids[labels]).sum()

    one = torch.ones_like(within)
    return torch.where(
        within == 0,
        one,
        between * (num_samples - num_labels) / (torch.where(within == 0, one, within) * (num_labels - 1.0)),
    )


def _grad_safe_norm(diff: Tensor) -> Tensor:
    """L2 norm along the last axis with a finite gradient at exactly zero (never let
    ``sqrt`` see the zero: JAX's double-where guard)."""
    sq = torch.square(diff).sum(dim=-1)
    zero = sq == 0
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


def _grad_safe_pnorm(v: Tensor, p: float, dim: int = -1) -> Tensor:
    """p-norm with finite gradients at exact zeros (the same double-where guard)."""
    a = torch.abs(v)
    zero = a == 0
    powed = torch.where(zero, torch.zeros_like(a), torch.where(zero, torch.ones_like(a), a) ** p)
    s = torch.sum(powed, dim=dim)
    zero = s == 0
    return torch.where(zero, torch.zeros_like(s), torch.where(zero, torch.ones_like(s), s) ** (1.0 / p))


def _centroid_distances(centroids: Tensor, p: float = 2) -> Tensor:
    """[K, K] p-norm distances between centroids (``torch.cdist``, direct differences)."""
    return torch.cdist(centroids, centroids, p=p, compute_mode="donot_use_mm_for_euclid_dist")


def davies_bouldin_score(data: Tensor, labels: Tensor) -> Tensor:
    """Compute the Davies-Bouldin score for intrinsic cluster evaluation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import davies_bouldin_score
        >>> data = torch.tensor([[0., 0.], [0., 1.], [5., 5.], [5., 6.]])
        >>> davies_bouldin_score(data, torch.tensor([0, 0, 1, 1])).round(decimals=4)
        tensor(0.1414)
    """
    data = torch.as_tensor(data)
    labels = torch.as_tensor(labels, device=data.device)
    _validate_intrinsic_cluster_data(data, labels)
    labels, num_labels = _relabel(labels)
    num_samples = data.shape[0]
    _validate_intrinsic_labels_to_samples(num_labels, num_samples)

    counts, centroids = _cluster_stats(data, labels, num_labels)
    dists = _grad_safe_norm(data - centroids[labels])
    intra_dists = _matmul_full_float32(_one_hot(labels, num_labels, data.dtype).T, dists) / counts

    centroid_distances = _centroid_distances(centroids)

    if bool(torch.allclose(intra_dists, torch.zeros_like(intra_dists))) or bool(
        torch.allclose(centroid_distances, torch.zeros_like(centroid_distances))
    ):
        return _scalar(0.0, data)

    centroid_distances = torch.where(
        centroid_distances == 0, torch.full_like(centroid_distances, float("inf")), centroid_distances
    )
    combined_intra = intra_dists[None, :] + intra_dists[:, None]
    scores = (combined_intra / centroid_distances).amax(dim=1)  # ties share the gradient, as in JAX
    return scores.mean()


def _dunn_index_update(data: Tensor, labels: Tensor, p: float) -> Tuple[Tensor, Tensor]:
    """Intercluster centroid distances (every pair a < b, in ``combinations`` order) and
    max intracluster radii."""
    labels, num_labels = _relabel(labels)
    data = data.to(torch.float32)
    _, centroids = _cluster_stats(data, labels, num_labels)

    first, second = torch.triu_indices(num_labels, num_labels, offset=1, device=data.device)
    inter = _centroid_distances(centroids, p)[first, second]
    radii = _grad_safe_pnorm(data - centroids[labels], p, dim=1)
    max_intra = torch.full((num_labels,), float("-inf"), dtype=radii.dtype, device=radii.device)
    max_intra = max_intra.scatter_reduce(0, labels, radii, reduce="amax")
    return inter, max_intra


def _dunn_index_compute(intercluster_distance: Tensor, max_intracluster_distance: Tensor) -> Tensor:
    """Dunn index: min separation over max diameter."""
    return intercluster_distance.min() / max_intracluster_distance.max()


def dunn_index(data: Tensor, labels: Tensor, p: float = 2) -> Tensor:
    """Compute the Dunn index for intrinsic cluster evaluation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import dunn_index
        >>> data = torch.tensor([[0., 0.], [0.5, 0.], [1., 0.], [0.5, 1.]])
        >>> labels = torch.tensor([0, 0, 0, 1])
        >>> dunn_index(data, labels)
        tensor(2.)
    """
    data = torch.as_tensor(data)
    pairwise, diameters = _dunn_index_update(data, torch.as_tensor(labels, device=data.device), p)
    return _dunn_index_compute(pairwise, diameters)
