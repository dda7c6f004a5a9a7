"""Image gradients (dy, dx) by one-step finite differences.

Counterpart of ``torchmetrics_tpu/functional/image/gradients.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype

Tensor = torch.Tensor


def _image_gradients_validate(img) -> None:
    """Require a 4D NCHW tensor."""
    if not hasattr(img, "ndim"):
        raise TypeError(f"The `img` expects an array but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Forward differences along H and W, zero-padded at the far edge."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1))


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Compute (dy, dx) gradient images of an ``(N, C, H, W)`` batch.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import image_gradients
        >>> image = torch.arange(0, 1*1*5*5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :2, :2]
        tensor([[5., 5.],
                [5., 5.]])
    """
    img = _as_jax_dtype(img)
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
