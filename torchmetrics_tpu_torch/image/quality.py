"""Analytic image-quality metric modules: UQI, SAM, ERGAS, SCC, VIF, TV, RMSE-SW, RASE.

Counterpart of ``torchmetrics_tpu/image/quality.py``, with the same states (names,
dtypes and reductions) in every class.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.image.ergas import _ergas_compute, _ergas_update
from torchmetrics_tpu_torch.functional.image.rase import relative_average_spectral_error
from torchmetrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update
from torchmetrics_tpu_torch.functional.image.sam import _sam_compute, _sam_update
from torchmetrics_tpu_torch.functional.image.scc import _LAPLACIAN, _scc_map, _scc_update
from torchmetrics_tpu_torch.functional.image.tv import _total_variation_compute, _total_variation_update
from torchmetrics_tpu_torch.functional.image.uqi import _uqi_compute, _uqi_update
from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype
from torchmetrics_tpu_torch.functional.image.vif import _vif_per_image_channel
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class UniversalImageQualityIndex(Metric):
    r"""Universal image quality index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import UniversalImageQualityIndex
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> uqi = UniversalImageQualityIndex(device="cpu")
        >>> float(uqi(preds, target)) > 0.9
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction is None or reduction == "none":
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            self.add_state("sum_uqi", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("numel", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the UQI sum (or the raw inputs for reduction='none')."""
        preds, target = _uqi_update(preds, target)
        if self.reduction is None or self.reduction == "none":
            self.preds.append(preds)
            self.target.append(target)
        else:
            uqi_score = _uqi_compute(preds, target, self.kernel_size, self.sigma, reduction="sum")
            self.sum_uqi = self.sum_uqi + uqi_score
            ps = preds.shape
            self.numel = self.numel + ps[0] * ps[1] * (ps[2] - self.kernel_size[0] + 1) * (
                ps[3] - self.kernel_size[1] + 1
            )

    def compute(self) -> Tensor:
        """UQI over accumulated state."""
        if self.reduction == "none" or self.reduction is None:
            preds = dim_zero_cat(self.preds)
            target = dim_zero_cat(self.target)
            return _uqi_compute(preds, target, self.kernel_size, self.sigma, self.reduction)
        return self.sum_uqi / self.numel if self.reduction == "elementwise_mean" else self.sum_uqi


class SpectralAngleMapper(Metric):
    r"""Spectral angle mapper.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralAngleMapper
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(16, 3, 16, 16, generator=g), torch.rand(16, 3, 16, 16, generator=g)
        >>> sam = SpectralAngleMapper(device="cpu")
        >>> float(sam(preds, target)) > 0
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction == "none" or reduction is None:
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            self.add_state("sum_sam", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("numel", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the spectral-angle sum (or the raw inputs for reduction='none')."""
        preds, target = _sam_update(preds, target)
        if self.reduction == "none" or self.reduction is None:
            self.preds.append(preds)
            self.target.append(target)
        else:
            sam_score = _sam_compute(preds, target, reduction="sum")
            self.sum_sam = self.sum_sam + sam_score
            p_shape = preds.shape
            self.numel = self.numel + p_shape[0] * p_shape[2] * p_shape[3]

    def compute(self) -> Tensor:
        """SAM over accumulated state."""
        if self.reduction == "none" or self.reduction is None:
            preds = dim_zero_cat(self.preds)
            target = dim_zero_cat(self.target)
            return _sam_compute(preds, target, self.reduction)
        return self.sum_sam / self.numel if self.reduction == "elementwise_mean" else self.sum_sam


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    r"""ERGAS pan-sharpening quality.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> ergas = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> float(ergas(preds, target)) > 9
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")
        self.ratio = ratio
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Store the batch (ERGAS needs whole-epoch band statistics)."""
        preds, target = _ergas_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """ERGAS over all accumulated images."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _ergas_compute(preds, target, self.ratio, self.reduction)


class SpatialCorrelationCoefficient(Metric):
    r"""Spatial correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialCorrelationCoefficient
        >>> x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> scc = SpatialCorrelationCoefficient(device="cpu")
        >>> round(float(scc(x, x)), 3)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    scc_score: Tensor
    total: Tensor

    def __init__(self, high_pass_filter: Optional[Tensor] = None, window_size: int = 8, **kwargs: Any) -> None:
        # the module's keyword is `high_pass_filter`, the functional's `hp_filter`, as in JAX
        super().__init__(**kwargs)
        self.hp_filter = _LAPLACIAN if high_pass_filter is None else high_pass_filter
        self.ws = window_size
        self.add_state("scc_score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-image mean SCC."""
        preds, target, hp_filter = _scc_update(preds, target, self.hp_filter, self.ws)
        scc_map = _scc_map(preds, target, hp_filter, self.ws)
        self.scc_score = self.scc_score + torch.sum(torch.mean(scc_map, dim=(1, 2, 3)))
        self.total = self.total + preds.shape[0]

    def compute(self) -> Tensor:
        """Mean SCC over all images."""
        return self.scc_score / self.total


class VisualInformationFidelity(Metric):
    r"""Pixel-based visual information fidelity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import VisualInformationFidelity
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(2, 1, 41, 41, generator=g), torch.rand(2, 1, 41, 41, generator=g)
        >>> vif = VisualInformationFidelity(device="cpu")
        >>> float(vif(preds, target)) > 0
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    vif_score: Tensor
    total: Tensor

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.add_state("vif_score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.sigma_n_sq = sigma_n_sq

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-image channel-mean VIF."""
        preds = _as_jax_dtype(preds)
        target = _as_jax_dtype(target).to(preds.dtype)
        vif_val = torch.mean(_vif_per_image_channel(preds, target, self.sigma_n_sq), dim=1)
        self.vif_score = self.vif_score + torch.sum(vif_val)
        self.total = self.total + preds.shape[0]

    def compute(self) -> Tensor:
        """Mean VIF over all images."""
        return self.vif_score / self.total


class TotalVariation(Metric):
    r"""Total variation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import TotalVariation
        >>> tv = TotalVariation(device="cpu")
        >>> img = torch.rand(5, 3, 28, 28, generator=torch.Generator().manual_seed(42))
        >>> float(tv(img)) > 0
        True
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        self.add_state("score_list", [], dist_reduce_fx="cat")
        self.add_state("score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("num_elements", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        """Accumulate per-image TV (or its sum)."""
        score, num_elements = _total_variation_update(img)
        if self.reduction is None or self.reduction == "none":
            self.score_list.append(score)
        else:
            self.score = self.score + score.sum()
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> Tensor:
        """TV over accumulated state."""
        score = dim_zero_cat(self.score_list) if self.reduction is None or self.reduction == "none" else self.score
        return _total_variation_compute(score, self.num_elements, self.reduction)


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    r"""RMSE over a sliding window.

    The RMSE map state is a "cat" list of per-batch summed maps, summed in ``compute``,
    as in the JAX package.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RootMeanSquaredErrorUsingSlidingWindow
        >>> g = torch.Generator().manual_seed(22)
        >>> preds, target = torch.rand(4, 3, 16, 16, generator=g), torch.rand(4, 3, 16, 16, generator=g)
        >>> rmse_sw = RootMeanSquaredErrorUsingSlidingWindow(device="cpu")
        >>> float(rmse_sw(preds, target)) > 0
        True
    """

    higher_is_better = False
    is_differentiable = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("rmse_map_chunks", [], dist_reduce_fx="cat")
        self.add_state("total_images", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the windowed-RMSE sum and the per-batch RMSE maps."""
        rmse_val_sum, rmse_map, total_images = _rmse_sw_update(
            preds, target, self.window_size, rmse_val_sum=None, rmse_map=None, total_images=None
        )
        self.rmse_val_sum = self.rmse_val_sum + rmse_val_sum
        self.rmse_map_chunks.append(rmse_map[None])
        self.total_images = self.total_images + total_images

    def compute(self) -> Optional[Tensor]:
        """Windowed RMSE over accumulated state."""
        rmse_map = torch.sum(dim_zero_cat(self.rmse_map_chunks), dim=0)
        rmse, _ = _rmse_sw_compute(self.rmse_val_sum, rmse_map, self.total_images)
        return rmse


class RelativeAverageSpectralError(Metric):
    r"""Relative average spectral error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RelativeAverageSpectralError
        >>> g = torch.Generator().manual_seed(22)
        >>> preds, target = torch.rand(4, 3, 16, 16, generator=g), torch.rand(4, 3, 16, 16, generator=g)
        >>> rase = RelativeAverageSpectralError(device="cpu")
        >>> float(rase(preds, target)) > 0
        True
    """

    higher_is_better = False
    is_differentiable = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Store the batch (RASE needs whole-epoch target means)."""
        self.preds.append(_as_jax_dtype(preds))
        self.target.append(_as_jax_dtype(target))

    def compute(self) -> Tensor:
        """RASE over all accumulated images."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return relative_average_spectral_error(preds, target, self.window_size)
