"""Pan-sharpening quality modules: D_lambda, D_s and QNR.

Counterpart of ``torchmetrics_tpu/image/pansharpening.py``, with the same list states
(``preds``, ``ms``, ``pan``, ``pan_lr``, or ``preds`` and ``target``); the scores need the
whole epoch, so ``compute`` evaluates them over every stored image.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.image.d_lambda import (
    _spectral_distortion_index_compute,
    _spectral_distortion_index_update,
)
from torchmetrics_tpu_torch.functional.image.d_s import (
    _spatial_distortion_index_compute,
    _spatial_distortion_index_update,
)
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor

_REDUCTIONS = ("elementwise_mean", "sum", "none")


def _check_reduction(reduction: str) -> str:
    if reduction not in _REDUCTIONS:
        raise ValueError(f"Expected argument `reduction` be one of {_REDUCTIONS} but got {reduction}")
    return reduction


def _positive_int(name: str, value: Any) -> int:
    if not isinstance(value, int) or value <= 0:
        raise ValueError(f"Expected `{name}` to be a positive integer. Got {name}: {value}.")
    return value


def _target_parts(target: Dict[str, Tensor]) -> tuple:
    """``ms``, ``pan`` and the optional ``pan_lr`` of a pan-sharpening target dict."""
    if "ms" not in target:
        raise ValueError(f"Expected `target` to have key `ms`. Got target: {target.keys()}.")
    if "pan" not in target:
        raise ValueError(f"Expected `target` to have key `pan`. Got target: {target.keys()}.")
    return target["ms"], target["pan"], target.get("pan_lr")


class _PanSharpeningQuadruple(Metric):
    """The stored (fused, ms, pan, optional pan_lr) quadruples of D_s and QNR."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("ms", [], dist_reduce_fx="cat")
        self.add_state("pan", [], dist_reduce_fx="cat")
        self.add_state("pan_lr", [], dist_reduce_fx="cat")

    def _store(self, preds: Tensor, ms: Tensor, pan: Tensor, pan_lr) -> None:
        self.preds.append(preds)
        self.ms.append(ms)
        self.pan.append(pan)
        if pan_lr is not None:
            self.pan_lr.append(pan_lr)

    def _stored(self) -> tuple:
        pan_lr = dim_zero_cat(self.pan_lr) if len(self.pan_lr) > 0 else None
        return dim_zero_cat(self.preds), dim_zero_cat(self.ms), dim_zero_cat(self.pan), pan_lr


class SpectralDistortionIndex(Metric):
    r"""Spectral distortion index (D_lambda).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralDistortionIndex
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(16, 3, 16, 16, generator=g), torch.rand(16, 3, 16, 16, generator=g)
        >>> sdi = SpectralDistortionIndex(device="cpu")
        >>> float(sdi(preds, target)) < 0.2
        True
    """

    higher_is_better = True  # as the reference's metadata says
    is_differentiable = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = _positive_int("p", p)
        self.reduction = _check_reduction(reduction)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Store the batch (the UQI matrices need the whole epoch)."""
        preds, target = _spectral_distortion_index_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """D_lambda over all accumulated images."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _spectral_distortion_index_compute(preds, target, self.p, self.reduction)


class SpatialDistortionIndex(_PanSharpeningQuadruple):
    r"""Spatial distortion index (D_s).

    ``target`` is a dict with keys ``ms``, ``pan`` and optionally ``pan_lr``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialDistortionIndex
        >>> g = torch.Generator().manual_seed(42)
        >>> preds = torch.rand(16, 3, 32, 32, generator=g)
        >>> target = {"ms": torch.rand(16, 3, 16, 16, generator=g), "pan": torch.rand(16, 3, 32, 32, generator=g)}
        >>> sdi = SpatialDistortionIndex(device="cpu")
        >>> float(sdi(preds, target)) < 0.2
        True
    """

    higher_is_better = False
    is_differentiable = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        norm_order: int = 1,
        window_size: int = 7,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.norm_order = _positive_int("norm_order", norm_order)
        self.window_size = _positive_int("window_size", window_size)
        self.reduction = _check_reduction(reduction)

    def update(self, preds: Tensor, target: Dict[str, Tensor]) -> None:
        """Store the pan-sharpening quadruple for epoch-end evaluation."""
        ms, pan, pan_lr = _target_parts(target)
        self._store(*_spatial_distortion_index_update(preds, ms, pan, pan_lr))

    def compute(self) -> Tensor:
        """D_s over all accumulated images."""
        return _spatial_distortion_index_compute(*self._stored(), self.norm_order, self.window_size, self.reduction)


class QualityWithNoReference(_PanSharpeningQuadruple):
    r"""Quality with no reference (QNR).

    ``target`` is a dict with keys ``ms``, ``pan`` and optionally ``pan_lr``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import QualityWithNoReference
        >>> g = torch.Generator().manual_seed(42)
        >>> preds = torch.rand(16, 3, 32, 32, generator=g)
        >>> target = {"ms": torch.rand(16, 3, 16, 16, generator=g), "pan": torch.rand(16, 3, 32, 32, generator=g)}
        >>> qnr = QualityWithNoReference(device="cpu")
        >>> float(qnr(preds, target)) > 0.8
        True
    """

    higher_is_better = True
    is_differentiable = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        alpha: float = 1,
        beta: float = 1,
        norm_order: int = 1,
        window_size: int = 7,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(alpha, (int, float)) or alpha < 0:
            raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
        self.alpha = alpha
        if not isinstance(beta, (int, float)) or beta < 0:
            raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
        self.beta = beta
        self.norm_order = _positive_int("norm_order", norm_order)
        self.window_size = _positive_int("window_size", window_size)
        self.reduction = _check_reduction(reduction)

    def update(self, preds: Tensor, target: Dict[str, Tensor]) -> None:
        """Store the pan-sharpening quadruple for epoch-end evaluation."""
        ms, pan, pan_lr = _target_parts(target)
        preds, ms = _spectral_distortion_index_update(preds, ms)
        self._store(*_spatial_distortion_index_update(preds, ms, pan, pan_lr))

    def compute(self) -> Tensor:
        """QNR over all accumulated images."""
        preds, ms, pan, pan_lr = self._stored()
        d_lambda = _spectral_distortion_index_compute(preds, ms, self.norm_order, self.reduction)
        d_s = _spatial_distortion_index_compute(preds, ms, pan, pan_lr, self.norm_order, self.window_size,
                                                self.reduction)
        return (1 - d_lambda) ** self.alpha * (1 - d_s) ** self.beta
