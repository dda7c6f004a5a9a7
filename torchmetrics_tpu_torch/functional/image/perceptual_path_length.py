"""Perceptual path length (functional).

Counterpart of ``torchmetrics_tpu/functional/image/perceptual_path_length.py``:
epsilon-perturbed latent interpolations scored with a perceptual similarity, filtered
to the [lower, upper] percentile band.

The generator interface matches the reference (``generator.sample(num_samples)`` and
``generator(z)`` — or ``generator.sample`` returning ``(z, labels)`` and
``generator(z, labels)`` when ``conditional=True``). The similarity defaults to LPIPS
and therefore needs either locally provided weights or a custom ``similarity_fn``. The
images are resized as ``jax.image.resize(..., "bilinear")`` resizes them (antialiased
when shrinking, ``functional/image/utils._resize_bilinear``); the scoring runs on the
generator's device, or on ``device`` when given.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.image.utils import _resize_bilinear

Tensor = torch.Tensor


def _interpolate(latents1: Tensor, latents2: Tensor, epsilon: float, interpolation_method: str) -> Tensor:
    """Interpolate towards an epsilon-offset point (lerp, or slerp for any-d latents)."""
    eps = epsilon
    if interpolation_method == "lerp":
        return latents1 + (latents2 - latents1) * eps
    if interpolation_method in ("slerp_any", "slerp_unit"):
        a = latents1 / torch.linalg.norm(latents1, dim=-1, keepdim=True)
        b = latents2 / torch.linalg.norm(latents2, dim=-1, keepdim=True)
        d = torch.sum(a * b, dim=-1, keepdim=True)
        p = eps * torch.arccos(torch.clip(d, -1, 1))
        c = b - d * a
        c = c / torch.linalg.norm(c, dim=-1, keepdim=True)
        interpolated = a * torch.cos(p) + c * torch.sin(p)
        if interpolation_method == "slerp_any":
            interpolated = interpolated * torch.linalg.norm(latents1, dim=-1, keepdim=True)
        return interpolated
    raise ValueError(f"Interpolation method {interpolation_method} not supported.")


def _named_lpips_similarity(net_type: str) -> Callable[[Tensor, Tensor], Tensor]:
    """Per-pair LPIPS distance from a named backbone (locally provided weights), on the
    images' device (a module per device)."""
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import resolve_lpips_backbone_path
    from torchmetrics_tpu_torch.functional.image.lpips import (
        _cached_backbone_fn,
        _lpips_from_features,
        _scaling_layer,
        load_lpips_head_weights,
    )

    resolved = resolve_lpips_backbone_path(net_type, None)
    nets: Dict[torch.device, Callable] = {}

    def similarity(img1: Tensor, img2: Tensor) -> Tensor:
        # generator images are in [-1, 1] (reference PPL contract); apply the
        # LPIPS scaling layer then the backbone pyramid
        device = img1.device
        if device not in nets:
            nets[device] = _cached_backbone_fn(net_type, resolved, device)
        feats1 = nets[device](_scaling_layer(img1))
        feats2 = nets[device](_scaling_layer(img2))
        return _lpips_from_features(feats1, feats2, load_lpips_head_weights(net_type, device))

    return similarity


def perceptual_path_length(
    generator: Any,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 128,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Union[str, Callable[[Tensor, Tensor], Tensor]] = "vgg",
    device: Optional[Any] = None,
    similarity_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    r"""Compute the perceptual path length of a generator.

    With ``conditional=True``, ``generator.sample`` must return ``(latents, labels)``
    and the generator is called as ``generator(latents, labels)``.

    ``sim_net`` mirrors the reference (``perceptual_path_length.py:163``): a named
    LPIPS backbone (``"alex"``/``"vgg"``/``"squeeze"`` — locally provided torchvision
    weights, see ``_lpips_backbones.py``) or a callable ``(img1, img2) -> (B,)``.
    ``similarity_fn`` is the JAX package's alias for the callable form and takes
    precedence when given. ``device``, when given, is where the images are scored
    (JAX ignores it); the generator runs wherever it lives.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import perceptual_path_length
        >>> class Generator:
        ...     g = torch.Generator().manual_seed(0)
        ...     def sample(self, n):
        ...         return torch.randn(n, 8, generator=self.g)
        ...     def __call__(self, z):
        ...         return torch.tanh(z[:, :3, None, None] * torch.ones(1, 3, 16, 16))
        >>> sim = lambda a, b: (a - b).abs().mean(dim=(1, 2, 3))
        >>> mean, std, dists = perceptual_path_length(Generator(), num_samples=32, batch_size=16,
        ...                                           resize=None, similarity_fn=sim)
        >>> bool(torch.isfinite(mean))
        True
    """
    if not hasattr(generator, "sample"):
        raise NotImplementedError(
            "The generator must implement a `sample` method returning latents"
            + (" and labels" if conditional else "")
        )
    if similarity_fn is None:
        if callable(sim_net):
            similarity_fn = sim_net
        else:
            try:
                similarity_fn = _named_lpips_similarity(sim_net)
            except FileNotFoundError as err:
                raise ModuleNotFoundError(
                    f"The default `{sim_net}` LPIPS similarity requires pretrained torchvision"
                    " weights, which cannot be downloaded in this environment. Provide them"
                    " locally ($TORCHMETRICS_TPU_LPIPS_BACKBONES) or pass a callable"
                    " `sim_net`/`similarity_fn`."
                ) from err

    def placed(imgs: Any) -> Tensor:
        imgs = torch.as_tensor(imgs)
        return imgs.to(device) if device is not None else imgs

    distances = []
    num_batches = int(np.ceil(num_samples / batch_size))
    for _ in range(num_batches):
        if conditional:
            latents1, labels1 = generator.sample(batch_size)
            latents2, _ = generator.sample(batch_size)
        else:
            latents1 = generator.sample(batch_size)
            latents2 = generator.sample(batch_size)
        latents1, latents2 = torch.as_tensor(latents1), torch.as_tensor(latents2)
        latents_interp = _interpolate(latents1, latents2, epsilon, interpolation_method)

        if conditional:
            imgs1 = placed(generator(latents1, labels1))
            imgs2 = placed(generator(latents_interp, labels1))
        else:
            imgs1 = placed(generator(latents1))
            imgs2 = placed(generator(latents_interp))
        if resize is not None:
            imgs1 = _resize_bilinear(imgs1.to(torch.float32), resize, resize)
            imgs2 = _resize_bilinear(imgs2.to(torch.float32), resize, resize)
        distances.append(torch.as_tensor(similarity_fn(imgs1, imgs2)) / epsilon**2)

    distances_arr = torch.cat(distances)[:num_samples]

    lower = torch.quantile(distances_arr, lower_discard) if lower_discard is not None else distances_arr.min()
    upper = torch.quantile(distances_arr, upper_discard) if upper_discard is not None else distances_arr.max()
    kept = distances_arr[(distances_arr >= lower) & (distances_arr <= upper)]
    return kept.mean(), kept.std(unbiased=False), kept
