"""Inception score.

Counterpart of ``torchmetrics_tpu/image/inception.py``. ``compute`` permutes the
features with numpy's global RNG, as JAX's does, so ``np.random.seed`` gives both
packages the same splits.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.image._inception_net import InceptionFeatureExtractor
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class InceptionScore(Metric):
    r"""Inception score of generated images (exp of the label-marginal KL).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import InceptionScore
        >>> feature_fn = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :10]
        >>> inception = InceptionScore(feature=feature_fn, splits=2, device="cpu")
        >>> inception.update(torch.rand(16, 3, 8, 8, generator=torch.Generator().manual_seed(42)))
        >>> score_mean, score_std = inception.compute()
        >>> bool(score_mean >= 1.0)
        True
    """

    feature_network: str = "inception"  # FeatureShare hook (reference image/inception.py:106)
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0

    features: List[Tensor]

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        mesh: Optional[Any] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)

        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        if isinstance(feature, (str, int)):
            valid_inputs = ("logits_unbiased", 64, 192, 768, 2048)
            if feature not in valid_inputs:
                raise ValueError(
                    f"Input to argument `feature` must be one of {valid_inputs}, but got {feature}."
                )
            self.inception: Callable = InceptionFeatureExtractor(
                feature=feature, normalize=normalize, mesh=mesh, weights_path=weights_path, device=self.device)
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        self.splits = splits
        self.add_state("features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor) -> None:
        """Extract and store features (logits) for the generated images."""
        features = torch.as_tensor(self.inception(imgs), dtype=torch.float32)
        self.features.append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """Mean and std of the per-split inception scores."""
        features = dim_zero_cat(self.features)
        # global numpy RNG so np.random.seed makes compute reproducible
        idx = np.random.permutation(features.shape[0])
        features = features[torch.from_numpy(idx).to(features.device)]

        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        # torch.chunk semantics: ceil-sized chunks, possibly fewer than `splits`
        n = features.shape[0]
        chunk_size = -(-n // self.splits)
        kl_ = []
        for p, log_p in zip(torch.split(prob, chunk_size), torch.split(log_prob, chunk_size)):
            m_p = p.mean(dim=0, keepdim=True)
            kl = p * (log_p - torch.log(m_p))
            kl_.append(torch.exp(kl.sum(dim=1).mean()))
        kl = torch.stack(kl_)
        return kl.mean(), kl.std(unbiased=True)
