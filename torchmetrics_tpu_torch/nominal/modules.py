"""Nominal metric modules.

Counterpart of ``torchmetrics_tpu/nominal/modules.py``: each statistic accumulates
JAX's float32 ``(num_classes, num_classes)`` ``confmat`` state (summed across
processes; one confusion-matrix-kernel launch an update) under JAX's compute-group
key, except Fleiss' kappa, which keeps its "cat" ``counts`` of per-sample rows.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.nominal.association import (
    _cramers_v_compute,
    _fleiss_kappa_compute,
    _fleiss_kappa_update,
    _nominal_confmat_update,
    _pearsons_contingency_coefficient_compute,
    _theils_u_compute,
    _tschuprows_t_compute,
)
from torchmetrics_tpu_torch.functional.nominal.utils import _nominal_input_validation
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class _ConfmatNominalMetric(Metric):
    """Base for nominal statistics over an accumulated contingency table."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    confmat: Tensor

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 2:
            raise ValueError(f"Argument `num_classes` is expected to be an integer larger than 1, but got {num_classes}")
        self.num_classes = num_classes
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes)), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the contingency table."""
        confmat = _nominal_confmat_update(
            preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value
        )
        self.confmat = self.confmat + confmat

    def _compute_group_params(self):
        return (self.num_classes, self.nan_strategy, self.nan_replace_value)


class CramersV(_ConfmatNominalMetric):
    r"""Cramer's V statistic of association between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import CramersV
        >>> preds = torch.randint(0, 4, (100,), generator=torch.Generator().manual_seed(42))
        >>> target = (preds + torch.randint(0, 2, (100,), generator=torch.Generator().manual_seed(43))) % 4
        >>> cramers_v = CramersV(num_classes=4, device="cpu")
        >>> float(cramers_v(preds, target)) > 0
        True
    """

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        """Cramer's V over the accumulated table."""
        return _cramers_v_compute(self.confmat, self.bias_correction)


class PearsonsContingencyCoefficient(_ConfmatNominalMetric):
    r"""Pearson's contingency coefficient between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import PearsonsContingencyCoefficient
        >>> preds = torch.randint(0, 4, (100,), generator=torch.Generator().manual_seed(42))
        >>> target = (preds + torch.randint(0, 2, (100,), generator=torch.Generator().manual_seed(43))) % 4
        >>> pcc = PearsonsContingencyCoefficient(num_classes=4, device="cpu")
        >>> float(pcc(preds, target)) > 0
        True
    """

    def compute(self) -> Tensor:
        """Pearson's C over the accumulated table."""
        return _pearsons_contingency_coefficient_compute(self.confmat)


class TschuprowsT(_ConfmatNominalMetric):
    r"""Tschuprow's T statistic between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TschuprowsT
        >>> preds = torch.randint(0, 4, (100,), generator=torch.Generator().manual_seed(42))
        >>> target = (preds + torch.randint(0, 2, (100,), generator=torch.Generator().manual_seed(43))) % 4
        >>> tschuprows_t = TschuprowsT(num_classes=4, device="cpu")
        >>> float(tschuprows_t(preds, target)) > 0
        True
    """

    def __init__(self, num_classes: int, bias_correction: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, **kwargs)
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        """Tschuprow's T over the accumulated table."""
        return _tschuprows_t_compute(self.confmat, self.bias_correction)


class TheilsU(_ConfmatNominalMetric):
    r"""Theil's U (uncertainty coefficient) between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TheilsU
        >>> preds = torch.randint(0, 4, (100,), generator=torch.Generator().manual_seed(42))
        >>> target = (preds + torch.randint(0, 2, (100,), generator=torch.Generator().manual_seed(43))) % 4
        >>> theils_u = TheilsU(num_classes=4, device="cpu")
        >>> float(theils_u(preds, target)) > 0
        True
    """

    def compute(self) -> Tensor:
        """Theil's U over the accumulated table."""
        return _theils_u_compute(self.confmat)


class FleissKappa(Metric):
    r"""Fleiss' kappa inter-rater agreement.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import FleissKappa
        >>> ratings = torch.randint(0, 10, (10, 5), generator=torch.Generator().manual_seed(42))
        >>> kappa = FleissKappa(mode='counts', device="cpu")
        >>> float(kappa(ratings)) < 1
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ["counts", "probs"]:
            raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
        self.mode = mode
        self.add_state("counts", [], dist_reduce_fx="cat")

    def update(self, ratings: Tensor) -> None:
        """Store per-sample category counts for the batch."""
        counts = _fleiss_kappa_update(ratings, self.mode)
        self.counts.append(counts)

    def compute(self) -> Tensor:
        """Fleiss' kappa over all accumulated samples."""
        return _fleiss_kappa_compute(dim_zero_cat(self.counts))
