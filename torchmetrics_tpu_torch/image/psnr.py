"""PSNR metric modules.

Counterpart of ``torchmetrics_tpu/image/psnr.py``: the same states, with the same
names, dtypes (an int32 ``total``) and reductions.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.image.psnr import _as_float32, _psnr_compute, _psnr_update
from torchmetrics_tpu_torch.functional.image.psnrb import _psnrb_compute, _psnrb_update
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class PeakSignalNoiseRatio(Metric):
    r"""Peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
        >>> psnr = PeakSignalNoiseRatio(device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> psnr(preds, target).round(decimals=4)
        tensor(2.5527)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")

        self.clamping_fn = None
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", torch.zeros(()), dist_reduce_fx="min")
            self.add_state("max_target", torch.zeros(()), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            self.add_state("data_range", torch.tensor(float(data_range[1] - data_range[0])), dist_reduce_fx="mean")
            self.clamping_fn = partial(torch.clamp, min=data_range[0], max=data_range[1])
        else:
            self.add_state("data_range", torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, (list, tuple)) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate squared error (per dim-group when ``dim`` is set)."""
        # float64 arrays arrive as float64 here, where JAX takes them as float32
        preds, target = _as_float32(preds), _as_float32(target)
        if self.clamping_fn is not None:
            preds = self.clamping_fn(preds)
            target = self.clamping_fn(target)

        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + num_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(num_obs)

    def compute(self) -> Tensor:
        """PSNR over accumulated state."""
        data_range = (
            self.data_range if getattr(self, "data_range", None) is not None else self.max_target - self.min_target
        )
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = torch.cat([torch.ravel(v) for v in self.sum_squared_error])
            total = torch.cat([torch.ravel(v) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    r"""PSNR with blocked effect for grayscale images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatioWithBlockedEffect
        >>> metric = PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(2, 1, 16, 16, generator=g), torch.rand(2, 1, 16, 16, generator=g)
        >>> float(metric(preds, target)) > 0
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("bef", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("data_range", torch.zeros(()), dist_reduce_fx="max")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate squared error, blocking effect, and the running data range."""
        preds, target = _as_float32(preds), _as_float32(target)
        sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=self.block_size)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.bef = self.bef + bef
        self.total = self.total + num_obs
        self.data_range = torch.maximum(self.data_range, torch.max(target) - torch.min(target))

    def compute(self) -> Tensor:
        """PSNR-B over accumulated state."""
        return _psnrb_compute(self.sum_squared_error, self.bef, self.total, self.data_range)
