"""Clustering metric modules.

Counterpart of ``torchmetrics_tpu/clustering/modules.py``: the same classes, the same
"cat" list states (``preds``/``target``, ``data``/``labels``), arguments and plot
bounds. Each class evaluates its functional on the whole epoch at ``compute``.
"""

from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.clustering import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    calinski_harabasz_score,
    completeness_score,
    davies_bouldin_score,
    dunn_index,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.utils import _validate_average_method_arg, check_cluster_labels
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class _LabelPairClusteringMetric(Metric):
    """Base for metrics over (predicted labels, target labels) pairs."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Store the batch's cluster labels."""
        check_cluster_labels(preds, target)
        self.preds.append(preds)
        self.target.append(target)


class _IntrinsicClusteringMetric(Metric):
    """Base for metrics over (embedded data, cluster labels) pairs."""

    is_differentiable = True
    full_state_update = True
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", [], dist_reduce_fx="cat")
        self.add_state("labels", [], dist_reduce_fx="cat")

    def update(self, data: Tensor, labels: Tensor) -> None:
        """Store the batch's embeddings and labels."""
        self.data.append(data)
        self.labels.append(labels)


class MutualInfoScore(_LabelPairClusteringMetric):
    r"""Mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import MutualInfoScore
        >>> mi = MutualInfoScore(device="cpu")
        >>> mi(torch.tensor([1, 3, 2, 0, 1]), torch.tensor([0, 3, 2, 2, 1])).round(decimals=4)
        tensor(1.0549)
    """

    def compute(self) -> Tensor:
        """MI over all accumulated labels."""
        return mutual_info_score(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class AdjustedMutualInfoScore(_LabelPairClusteringMetric):
    r"""Adjusted mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import AdjustedMutualInfoScore
        >>> ami = AdjustedMutualInfoScore(average_method="arithmetic", device="cpu")
        >>> ami(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0])).round(decimals=4)
        tensor(-0.2500)
    """

    plot_lower_bound: float = -1.0

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def compute(self) -> Tensor:
        """AMI over all accumulated labels."""
        return adjusted_mutual_info_score(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.average_method
        )


class NormalizedMutualInfoScore(_LabelPairClusteringMetric):
    r"""Normalized mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import NormalizedMutualInfoScore
        >>> nmi = NormalizedMutualInfoScore("arithmetic", device="cpu")
        >>> nmi(torch.tensor([1, 3, 2, 0, 1]), torch.tensor([0, 3, 2, 2, 1])).round(decimals=4)
        tensor(0.7919)
    """

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def compute(self) -> Tensor:
        """NMI over all accumulated labels."""
        return normalized_mutual_info_score(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.average_method
        )


class RandScore(_LabelPairClusteringMetric):
    r"""Rand score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import RandScore
        >>> metric = RandScore(device="cpu")
        >>> metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1])).round(decimals=4)
        tensor(0.8333)
    """

    def compute(self) -> Tensor:
        """Rand score over all accumulated labels."""
        return rand_score(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class AdjustedRandScore(_LabelPairClusteringMetric):
    r"""Adjusted Rand score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import AdjustedRandScore
        >>> metric = AdjustedRandScore(device="cpu")
        >>> metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1])).round(decimals=4)
        tensor(0.5714)
    """

    plot_lower_bound: float = -1.0

    def compute(self) -> Tensor:
        """ARI over all accumulated labels."""
        return adjusted_rand_score(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class FowlkesMallowsIndex(_LabelPairClusteringMetric):
    r"""Fowlkes-Mallows index between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import FowlkesMallowsIndex
        >>> fmi = FowlkesMallowsIndex(device="cpu")
        >>> fmi(torch.tensor([2, 2, 0, 1, 0]), torch.tensor([2, 2, 1, 1, 0])).round(decimals=4)
        tensor(0.5000)
    """

    def compute(self) -> Tensor:
        """FMI over all accumulated labels."""
        return fowlkes_mallows_index(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class HomogeneityScore(_LabelPairClusteringMetric):
    r"""Homogeneity score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import HomogeneityScore
        >>> metric = HomogeneityScore(device="cpu")
        >>> metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))
        tensor(1.)
    """

    def compute(self) -> Tensor:
        """Homogeneity over all accumulated labels."""
        return homogeneity_score(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class CompletenessScore(_LabelPairClusteringMetric):
    r"""Completeness score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import CompletenessScore
        >>> metric = CompletenessScore(device="cpu")
        >>> metric(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0]))
        tensor(1.)
    """

    def compute(self) -> Tensor:
        """Completeness over all accumulated labels."""
        return completeness_score(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class VMeasureScore(_LabelPairClusteringMetric):
    r"""V-measure score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import VMeasureScore
        >>> metric = VMeasureScore(beta=1.0, device="cpu")
        >>> metric(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1])).round(decimals=4)
        tensor(0.8000)
    """

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, float) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = beta

    def compute(self) -> Tensor:
        """V-measure over all accumulated labels."""
        return v_measure_score(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.beta)


class CalinskiHarabaszScore(_IntrinsicClusteringMetric):
    r"""Calinski-Harabasz score for intrinsic cluster evaluation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import CalinskiHarabaszScore
        >>> data = torch.randn(10, 3, generator=torch.Generator().manual_seed(42))
        >>> labels = torch.tensor([0, 1, 0, 1, 1, 0, 0, 1, 0, 1])
        >>> chs = CalinskiHarabaszScore(device="cpu")
        >>> float(chs(data, labels)) > 0
        True
    """

    higher_is_better = True

    def compute(self) -> Tensor:
        """CH score over all accumulated data."""
        return calinski_harabasz_score(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class DaviesBouldinScore(_IntrinsicClusteringMetric):
    r"""Davies-Bouldin score for intrinsic cluster evaluation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import DaviesBouldinScore
        >>> data = torch.randn(10, 3, generator=torch.Generator().manual_seed(42))
        >>> labels = torch.tensor([0, 1, 0, 1, 1, 0, 0, 1, 0, 1])
        >>> dbs = DaviesBouldinScore(device="cpu")
        >>> float(dbs(data, labels)) > 0
        True
    """

    higher_is_better = False

    def compute(self) -> Tensor:
        """DB score over all accumulated data."""
        return davies_bouldin_score(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class DunnIndex(_IntrinsicClusteringMetric):
    r"""Dunn index for intrinsic cluster evaluation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import DunnIndex
        >>> data = torch.tensor([[0., 0.], [0.5, 0.], [1., 0.], [0.5, 1.]])
        >>> labels = torch.tensor([0, 0, 0, 1])
        >>> dunn = DunnIndex(p=2, device="cpu")
        >>> dunn(data, labels)
        tensor(2.)
    """

    higher_is_better = True

    def __init__(self, p: float = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def compute(self) -> Tensor:
        """Dunn index over all accumulated data."""
        return dunn_index(dim_zero_cat(self.data), dim_zero_cat(self.labels), self.p)
