"""Kernel inception distance.

Counterpart of ``torchmetrics_tpu/image/kid.py``. The polynomial kernels are full-float32
products on the metric's device; the MMD sums run on the host in float64, as in JAX.
``compute`` draws its subsets from numpy's global RNG, as JAX's does, so
``np.random.seed`` gives both packages the same subsets.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.image._inception_net import InceptionFeatureExtractor
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD² estimate from the three kernel blocks.

    Kernel entries reach ~1e4 and the sums ~1e7, where float32 summation order already
    shifts the 4th digit — the final reduction therefore runs in host float64.
    """
    m = k_xx.shape[0]
    k_xx, k_yy, k_xy = (torch.as_tensor(k).detach().cpu().numpy().astype(np.float64) for k in (k_xx, k_yy, k_xy))

    kt_xx_sum = (k_xx.sum(axis=-1) - np.diagonal(k_xx)).sum()
    kt_yy_sum = (k_yy.sum(axis=-1) - np.diagonal(k_yy)).sum()
    k_xy_sum = k_xy.sum()

    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    value -= 2 * k_xy_sum / (m**2)
    return torch.tensor(value, dtype=torch.float32)


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Polynomial kernel (γ x·y + c)^d: one full-float32 product and an elementwise epilogue."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    prod = _matmul_full_float32(f1, f2.T)
    return (prod * gamma + coef) ** degree


def poly_mmd(
    f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    """MMD² under the polynomial kernel."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KernelInceptionDistance(Metric):
    r"""Kernel inception distance between real and generated image distributions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import KernelInceptionDistance
        >>> feature_fn = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16]
        >>> kid = KernelInceptionDistance(feature=feature_fn, subsets=2, subset_size=8, device="cpu")
        >>> g = torch.Generator().manual_seed(42)
        >>> kid.update(torch.rand(16, 3, 8, 8, generator=g), real=True)
        >>> kid.update(torch.rand(16, 3, 8, 8, generator=g), real=False)
        >>> kid_mean, kid_std = kid.compute()
        >>> bool(torch.isfinite(kid_mean))
        True
    """

    feature_network: str = "inception"  # FeatureShare hook (reference image/kid.py:174)
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    real_features: List[Tensor]
    fake_features: List[Tensor]

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        mesh: Optional[Any] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)

        if isinstance(feature, int):
            self.inception: Callable = InceptionFeatureExtractor(
                feature=feature, normalize=normalize, mesh=mesh, weights_path=weights_path, device=self.device)
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract and store features for the requested distribution."""
        features = torch.as_tensor(self.inception(imgs), dtype=torch.float32)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Mean and std of subset MMD² scores."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)

        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        kid_scores_ = []
        for _ in range(self.subsets):
            # global numpy RNG so np.random.seed makes compute reproducible
            perm = np.random.permutation(n_samples_real)
            f_real = real_features[torch.from_numpy(perm[: self.subset_size]).to(real_features.device)]
            perm = np.random.permutation(n_samples_fake)
            f_fake = fake_features[torch.from_numpy(perm[: self.subset_size]).to(fake_features.device)]
            kid_scores_.append(poly_mmd(f_real, f_fake, self.degree, self.gamma, self.coef))
        kid_scores = torch.stack(kid_scores_).to(self.device)
        return kid_scores.mean(), kid_scores.std(unbiased=False)

    def reset(self) -> None:
        """Reset states; optionally keep the real-distribution features."""
        if not self.reset_real_features:
            value = deepcopy(self.real_features)
            super().reset()
            self.real_features = value
        else:
            super().reset()
