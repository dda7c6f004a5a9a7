"""Memorization-informed Fréchet inception distance.

Counterpart of ``torchmetrics_tpu/image/mifid.py``: the means and covariances in host
float64 and the Fréchet distance of ``image/fid.py``, the memorization distance as a
full-float32 cosine product on the metric's device.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.image._inception_net import InceptionFeatureExtractor
from torchmetrics_tpu_torch.image.fid import _compute_fid
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


def _compute_cosine_distance(features1: Tensor, features2: Tensor, cosine_distance_eps: float = 0.1) -> Tensor:
    """Mean nearest-neighbour cosine distance, thresholded at eps (memorization gate)."""
    features1 = features1[torch.sum(features1, dim=1) != 0]
    features2 = features2[torch.sum(features2, dim=1) != 0]

    norm_f1 = features1 / torch.linalg.norm(features1, dim=1, keepdim=True)
    norm_f2 = features2 / torch.linalg.norm(features2, dim=1, keepdim=True)

    d = 1.0 - torch.abs(_matmul_full_float32(norm_f1, norm_f2.T))
    mean_min_d = torch.mean(d.min(dim=1).values)
    return torch.where(mean_min_d < cosine_distance_eps, mean_min_d, torch.ones_like(mean_min_d))


def _mifid_compute(
    mu1: np.ndarray,
    sigma1: np.ndarray,
    features1: Tensor,
    mu2: np.ndarray,
    sigma2: np.ndarray,
    features2: Tensor,
    cosine_distance_eps: float = 0.1,
) -> Tensor:
    """FID divided by the memorization distance."""
    distance = _compute_cosine_distance(features1, features2, cosine_distance_eps)
    fid_value = _compute_fid(mu1, sigma1, mu2, sigma2).to(distance.device)
    return torch.where(fid_value > 1e-8, fid_value / (distance + 10e-15), torch.zeros_like(fid_value))


class MemorizationInformedFrechetInceptionDistance(Metric):
    r"""Memorization-informed FID.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MemorizationInformedFrechetInceptionDistance
        >>> feature_fn = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16]
        >>> mifid = MemorizationInformedFrechetInceptionDistance(feature=feature_fn, device="cpu")
        >>> g = torch.Generator().manual_seed(42)
        >>> mifid.update(torch.rand(8, 3, 8, 8, generator=g), real=True)
        >>> mifid.update(torch.rand(8, 3, 8, 8, generator=g), real=False)
        >>> float(mifid.compute()) >= 0
        True
    """

    feature_network: str = "inception"  # FeatureShare hook (reference image/mifid.py:154)
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    real_features: List[Tensor]
    fake_features: List[Tensor]

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        cosine_distance_eps: float = 0.1,
        mesh: Optional[Any] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)

        if isinstance(feature, int):
            valid_int_input = (64, 192, 768, 2048)
            if feature not in valid_int_input:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {valid_int_input}, but got {feature}."
                )
            self.inception: Callable = InceptionFeatureExtractor(
                feature=feature, normalize=normalize, mesh=mesh, weights_path=weights_path, device=self.device)
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        if not (isinstance(cosine_distance_eps, float) and 1 >= cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps

        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract and store features for the requested distribution."""
        features = torch.as_tensor(self.inception(imgs), dtype=torch.float32)
        if features.ndim == 1:
            features = features[None]
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tensor:
        """MIFID over all accumulated features."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)

        rf = real_features.detach().cpu().numpy().astype(np.float64)
        ff = fake_features.detach().cpu().numpy().astype(np.float64)
        mean_real, mean_fake = rf.mean(axis=0), ff.mean(axis=0)
        cov_real, cov_fake = np.cov(rf.T), np.cov(ff.T)

        return _mifid_compute(
            mean_real, cov_real, real_features,
            mean_fake, cov_fake, fake_features,
            cosine_distance_eps=self.cosine_distance_eps,
        )

    def reset(self) -> None:
        """Reset states; optionally keep the real-distribution features."""
        if not self.reset_real_features:
            value = deepcopy(self.real_features)
            super().reset()
            self.real_features = value
        else:
            super().reset()
