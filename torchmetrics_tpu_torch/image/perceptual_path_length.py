"""Perceptual path length (module).

Counterpart of ``torchmetrics_tpu/image/perceptual_path_length.py``: ``update`` stores
the generator and ``compute`` samples and scores through the functional, on the
metric's device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.image.perceptual_path_length import perceptual_path_length

Tensor = torch.Tensor


class PerceptualPathLength(Metric):
    r"""PPL metric module: ``update`` stores the generator; ``compute`` samples and scores.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PerceptualPathLength
        >>> class Generator:
        ...     g = torch.Generator().manual_seed(0)
        ...     def sample(self, n):
        ...         return torch.randn(n, 8, generator=self.g)
        ...     def __call__(self, z):
        ...         return torch.tanh(z[:, :3, None, None] * torch.ones(1, 3, 16, 16))
        >>> sim = lambda a, b: (a - b).abs().mean(dim=(1, 2, 3))
        >>> ppl = PerceptualPathLength(num_samples=32, batch_size=16, resize=None,
        ...                            similarity_fn=sim, device="cpu")
        >>> ppl.update(generator=Generator())
        >>> mean, std, dists = ppl.compute()
        >>> bool(torch.isfinite(mean))
        True
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 128,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Any = "vgg",
        similarity_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        if not (isinstance(num_samples, int) and num_samples > 0):
            raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}.")
        if interpolation_method not in ("lerp", "slerp_any", "slerp_unit"):
            raise ValueError(
                f"Argument `interpolation_method` must be one of 'lerp', 'slerp_any', 'slerp_unit',"
                f" got {interpolation_method}."
            )
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net
        self.similarity_fn = similarity_fn
        self._generator = None

    def update(self, generator: Any) -> None:
        """Store the generator to be evaluated (sampling happens at compute)."""
        if not hasattr(generator, "sample"):
            raise NotImplementedError(
                "The generator must implement a `sample` method returning latents"
            )
        self._generator = generator

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Sample interpolation pairs and return (mean, std, distances)."""
        if self._generator is None:
            raise RuntimeError("No generator was provided; call `update(generator)` first.")
        return perceptual_path_length(
            self._generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            resize=self.resize,
            lower_discard=self.lower_discard,
            upper_discard=self.upper_discard,
            sim_net=self.sim_net,
            device=self.device,
            similarity_fn=self.similarity_fn,
        )
