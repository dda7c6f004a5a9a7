"""Learned perceptual image patch similarity (functional).

Counterpart of ``torchmetrics_tpu/functional/image/lpips.py``. The named AlexNet /
VGG16 / SqueezeNet backbones are the port's modules (``_lpips_backbones.py``), built
from locally provided weights (``weights_path`` / ``$TORCHMETRICS_TPU_LPIPS_BACKBONES``;
nothing is downloaded) and kept per weights file and device. The linear heads are the
port's own copies of the JAX package's ``lpips_models/{alex,vgg,squeeze}.npz``. The
scoring machinery also works with any user-provided feature pyramid. The functional
runs on its inputs' device.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.image.utils import _on_device

Tensor = torch.Tensor


def _normalize_tensor(feats: Tensor, eps: float = 1e-10) -> Tensor:
    """Unit-normalize features over the channel dimension."""
    norm = torch.sqrt(torch.sum(torch.square(feats), dim=1, keepdim=True))
    return feats / (norm + eps)


def _spatial_average(x: Tensor) -> Tensor:
    """Mean over the spatial dims, keeping (B, 1)."""
    return x.mean(dim=(2, 3))


_SHIFT = np.asarray([-0.030, -0.088, -0.188], dtype=np.float32)[None, :, None, None]
_SCALE = np.asarray([0.458, 0.448, 0.450], dtype=np.float32)[None, :, None, None]


def _shift_scale() -> np.ndarray:
    return np.stack([_SHIFT, _SCALE])


def _scaling_layer(img: Tensor) -> Tensor:
    """LPIPS's shift/scale layer: ``(img - shift) / scale`` per RGB channel."""
    shift, scale = _on_device(_shift_scale, (), img.device)
    return (img - shift) / scale


def _lpips_from_features(
    feats1: Sequence[Tensor],
    feats2: Sequence[Tensor],
    head_weights: Optional[Sequence[Tensor]] = None,
) -> Tensor:
    """LPIPS distance from two feature pyramids (NCHW per level).

    ``head_weights`` are per-level (C,) linear-head weights; uniform when omitted.
    """
    total = None
    for lvl, (f1, f2) in enumerate(zip(feats1, feats2)):
        diff = torch.square(_normalize_tensor(f1) - _normalize_tensor(f2))
        if head_weights is not None:
            w = torch.as_tensor(head_weights[lvl], dtype=diff.dtype, device=diff.device).reshape(1, -1, 1, 1)
            contribution = _spatial_average((diff * w).sum(dim=1, keepdim=True)).squeeze(-1)
        else:
            contribution = _spatial_average(diff.mean(dim=1, keepdim=True)).squeeze(-1)
        total = contribution if total is None else total + contribution
    return total


def load_lpips_head_weights(net_type: str = "alex", device: Optional[torch.device] = None) -> List[Tensor]:
    """Bundled per-level LPIPS linear-head weights for ``net_type``, on ``device`` (the
    CPU when None).

    The port's byte-identical copies of the JAX package's npz heads (converted from the
    reference's ``functional/image/lpips_models/{alex,vgg,squeeze}.pth``); each entry is
    the (C,) weight vector of the level's 1x1 conv head.
    """
    allowed = ("alex", "vgg", "squeeze")
    if net_type not in allowed:
        raise ValueError(f"Argument `net_type` must be one of {allowed}, but got {net_type}")
    return list(_head_weights(net_type, torch.device(device if device is not None else "cpu")))


@functools.lru_cache(maxsize=16)
def _head_weights(net_type: str, device: torch.device) -> tuple:
    """The heads of ``net_type`` on ``device``, read and copied there once (callers
    never write to them)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "lpips_models", f"{net_type}.npz")
    with np.load(path) as data:
        levels = sorted(data.files, key=lambda name: int(name.replace("lin", "")))
        return tuple(torch.from_numpy(np.array(data[name])).to(device) for name in levels)


@functools.lru_cache(maxsize=8)
def _cached_backbone_params(net_type: str, resolved_path: str) -> dict:
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import load_lpips_backbone_params

    return load_lpips_backbone_params(net_type, resolved_path)


@functools.lru_cache(maxsize=8)
def _cached_backbone_by_file(net_type: str, resolved_path: str, device: torch.device) -> Callable:
    return _backbone_module(net_type, resolved_path, device)


def _backbone_module(net_type: str, resolved_path: str, device: torch.device) -> Callable:
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import make_lpips_feature_fn

    return make_lpips_feature_fn(net_type, params=_cached_backbone_params(net_type, resolved_path), device=device)


def _cached_backbone_fn(
    net_type: str, weights_path: Optional[str], device: Optional[torch.device] = None, shared: bool = True
) -> Callable:
    """The named backbone on ``device``: its file's parameters are loaded once per (net,
    concrete file), the module built once per device as well unless ``shared`` is off
    (a metric owns its module, which moves with it).

    Env-var resolution happens *before* the cache key, so re-pointing
    ``$TORCHMETRICS_TPU_LPIPS_BACKBONES`` at different weights is picked up by the
    next construction instead of silently reusing the old backbone.
    """
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import resolve_lpips_backbone_path

    resolved = resolve_lpips_backbone_path(net_type, weights_path)
    device = torch.device(device if device is not None else "cpu")
    return (_cached_backbone_by_file if shared else _backbone_module)(net_type, resolved, device)


def _missing_backbone(net_type: str) -> ModuleNotFoundError:
    return ModuleNotFoundError(
        f"The `{net_type}` LPIPS backbone requires pretrained torchvision weights,"
        " which cannot be downloaded in this environment. Provide them locally"
        " (`weights_path` / $TORCHMETRICS_TPU_LPIPS_BACKBONES, optionally converted"
        " with `python -m torchmetrics_tpu_torch.convert lpips-backbone`), or pass"
        " `feature_fn` (a callable producing a feature pyramid)."
    )


def learned_perceptual_image_patch_similarity(
    img1: Tensor,
    img2: Tensor,
    net_type: str = "alex",
    reduction: str = "mean",
    normalize: bool = False,
    feature_fn: Optional[Callable[[Tensor], Sequence[Tensor]]] = None,
    head_weights: Optional[Sequence[Tensor]] = None,
    weights_path: Optional[str] = None,
) -> Tensor:
    r"""Compute LPIPS between two image batches, on their device.

    Without ``feature_fn``, the named ``net_type`` backbone runs from locally provided
    torchvision weights (``weights_path`` or the ``TORCHMETRICS_TPU_LPIPS_BACKBONES``
    directory). A custom ``feature_fn`` (image batch -> feature pyramid) plugs into
    the same scoring machinery.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import learned_perceptual_image_patch_similarity
        >>> g = torch.Generator().manual_seed(42)
        >>> img1, img2 = torch.rand(4, 3, 16, 16, generator=g), torch.rand(4, 3, 16, 16, generator=g)
        >>> feature_fn = lambda img: [img, img[:, :, ::2, ::2]]
        >>> float(learned_perceptual_image_patch_similarity(img1, img2, feature_fn=feature_fn)) > 0
        True
    """
    img1 = torch.as_tensor(img1, dtype=torch.float32)
    img2 = torch.as_tensor(img2, dtype=torch.float32, device=img1.device)
    if normalize:  # [0,1] -> [-1,1]
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    img1 = _scaling_layer(img1)
    img2 = _scaling_layer(img2)

    if feature_fn is None:
        try:
            feature_fn = _cached_backbone_fn(net_type, weights_path, img1.device)
        except FileNotFoundError as err:
            raise _missing_backbone(net_type) from err
    feats1, feats2 = feature_fn(img1), feature_fn(img2)
    if head_weights is None:
        # auto-use the bundled heads only when the pyramid matches the named
        # backbone's channel layout; custom pyramids fall back to uniform weights
        try:
            bundled = load_lpips_head_weights(net_type, img1.device)
            if len(bundled) == len(feats1) and all(
                w.shape[0] == f.shape[1] for w, f in zip(bundled, feats1)
            ):
                head_weights = bundled
        except (ValueError, OSError):
            head_weights = None
    loss = _lpips_from_features(feats1, feats2, head_weights)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"Argument `reduction` must be one of 'mean' or 'sum', but got {reduction}")
