"""Pairwise metrics (functional only).

Counterpart of ``torchmetrics_tpu/functional/pairwise/__init__.py``.
"""

from torchmetrics_tpu_torch.functional.pairwise.distances import (
    pairwise_cosine_similarity,
    pairwise_euclidean_distance,
    pairwise_linear_similarity,
    pairwise_manhattan_distance,
    pairwise_minkowski_distance,
)

__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
]
