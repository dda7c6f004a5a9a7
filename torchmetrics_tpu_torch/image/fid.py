"""Fréchet inception distance.

Counterpart of ``torchmetrics_tpu/image/fid.py``, with the same states (names, dtypes
and reductions), so ``convert.load_jax_state`` carries a JAX FID across. The feature
statistics (the sum, the cross-product sum and the count) accumulate in float32 on the
metric's device, the cross product in full float32 (``_matmul_full_float32``); the
Fréchet distance's eigendecomposition runs on the host in float64 at compute time, as
in JAX.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.image._inception_net import InceptionFeatureExtractor
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor


def _compute_fid(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> Tensor:
    r"""Frechet distance between two Gaussians via the eigenvalue form of tr sqrt(S1 S2)."""
    a = float(np.square(mu1 - mu2).sum())
    b = float(np.trace(sigma1) + np.trace(sigma2))
    eigvals = np.linalg.eigvals(sigma1 @ sigma2)
    c = float(np.sqrt(eigvals.astype(np.complex128)).real.sum())
    return torch.tensor(a + b - 2 * c, dtype=torch.float32)


def _host64(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


class FrechetInceptionDistance(Metric):
    r"""Fréchet inception distance between real and generated image distributions.

    ``feature`` may be one of the inception tap sizes (64/192/768/2048 — the
    locally provided torch-fidelity checkpoint, see
    ``torchmetrics_tpu_torch.image._inception_net``) or any callable mapping an image
    batch to ``(N, num_features)`` features.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
        >>> feature_fn = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16]
        >>> fid = FrechetInceptionDistance(feature=feature_fn, num_features=16, device="cpu")
        >>> g = torch.Generator().manual_seed(42)
        >>> fid.update(torch.rand(8, 3, 8, 8, generator=g), real=True)
        >>> fid.update(torch.rand(8, 3, 8, 8, generator=g), real=False)
        >>> float(fid.compute()) >= 0
        True
    """

    feature_network: str = "inception"  # FeatureShare hook (reference image/fid.py:296)
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    real_features_sum: Tensor
    real_features_cov_sum: Tensor
    real_features_num_samples: Tensor
    fake_features_sum: Tensor
    fake_features_cov_sum: Tensor
    fake_features_num_samples: Tensor

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        num_features: Optional[int] = None,
        input_img_size: Tuple[int, int, int] = (3, 299, 299),
        mesh: Optional[Any] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)

        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        if isinstance(feature, int):
            valid_int_input = (64, 192, 768, 2048)
            if feature not in valid_int_input:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {valid_int_input}, but got {feature}."
                )
            self.inception = InceptionFeatureExtractor(
                feature=feature, normalize=normalize, mesh=mesh, weights_path=weights_path, device=self.device)
            num_features = feature
        elif callable(feature):
            self.inception = feature
            if num_features is None:
                num_features = getattr(feature, "num_features", None)
            if num_features is None:
                dummy = torch.zeros((1, *input_img_size), dtype=torch.float32, device=self.device)
                num_features = int(torch.as_tensor(feature(dummy)).shape[-1])
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.num_features = num_features

        mx = (num_features, num_features)
        self.add_state("real_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
        self.add_state("real_features_cov_sum", torch.zeros(mx), dist_reduce_fx="sum")
        self.add_state("real_features_num_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("fake_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
        self.add_state("fake_features_cov_sum", torch.zeros(mx), dist_reduce_fx="sum")
        self.add_state("fake_features_num_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features and fold them into the running first/second moments."""
        features = torch.as_tensor(self.inception(imgs), dtype=torch.float32)
        if features.ndim == 1:
            features = features[None]

        feat_sum = features.sum(dim=0)
        cov_sum = _matmul_full_float32(features.T, features)
        n = features.shape[0]
        if real:
            self.real_features_sum = self.real_features_sum + feat_sum
            self.real_features_cov_sum = self.real_features_cov_sum + cov_sum
            self.real_features_num_samples = self.real_features_num_samples + n
        else:
            self.fake_features_sum = self.fake_features_sum + feat_sum
            self.fake_features_cov_sum = self.fake_features_cov_sum + cov_sum
            self.fake_features_num_samples = self.fake_features_num_samples + n

    def compute(self) -> Tensor:
        """FID from the accumulated moments (host float64 eigendecomposition)."""
        n_real = int(self.real_features_num_samples)
        n_fake = int(self.fake_features_num_samples)
        if n_real < 2 or n_fake < 2:
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")

        mean_real = _host64(self.real_features_sum) / n_real
        mean_fake = _host64(self.fake_features_sum) / n_fake
        cov_real = (_host64(self.real_features_cov_sum) - n_real * np.outer(mean_real, mean_real)) / (n_real - 1)
        cov_fake = (_host64(self.fake_features_cov_sum) - n_fake * np.outer(mean_fake, mean_fake)) / (n_fake - 1)
        return _compute_fid(mean_real, cov_real, mean_fake, cov_fake).to(self.device)

    def reset(self) -> None:
        """Reset states; optionally keep the (expensive) real-distribution statistics."""
        if not self.reset_real_features:
            real_features_sum = deepcopy(self.real_features_sum)
            real_features_cov_sum = deepcopy(self.real_features_cov_sum)
            real_features_num_samples = deepcopy(self.real_features_num_samples)
            super().reset()
            self.real_features_sum = real_features_sum
            self.real_features_cov_sum = real_features_cov_sum
            self.real_features_num_samples = real_features_num_samples
        else:
            super().reset()
