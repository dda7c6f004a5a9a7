"""Shared window, convolution, pooling and padding helpers of the image metrics.

Counterpart of ``torchmetrics_tpu/functional/image/utils.py``. The JAX package asks
its convolutions for ``Precision.HIGHEST``, since reduced-precision passes shift
SSIM-class scores by about 1e-4; on the card cuDNN may run float32 convolutions in
TF32 (on by default), so ``_conv2d``/``_conv3d`` keep every convolution on PyTorch's
native depthwise kernels, which have no TF32 path, and set no flag.
Padding follows ``jnp.pad``'s ``reflect`` and ``symmetric`` modes exactly, for pads
of any size, by gathering with index maps that numpy builds. Windows and index maps
are built once per shape and device and cached; callers never write to them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _as_jax_dtype(x) -> Tensor:
    """A tensor in the dtype the JAX package computes in (it runs without x64):
    float64 becomes float32 and int64 int32; other dtypes stay."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float64:
        return x.to(torch.float32)
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    return x


def _dtype_name(dtype: torch.dtype) -> str:
    """``float32`` for ``torch.float32``: the name JAX prints in its messages."""
    return str(dtype).replace("torch.", "")


_ON_DEVICE: Dict[tuple, Tensor] = {}  # (design, args, device) -> a host design's copy there


def _on_device(design: Callable[..., np.ndarray], args: tuple, device: torch.device) -> Tensor:
    """The numpy array ``design(*args)`` on ``device``, copied there once. The first call
    for a device runs outside a CUDA graph capture (a capture's warm run comes first):
    a capture cannot copy from the host."""
    key = (design.__module__, design.__qualname__, args, torch.device(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(design(*args)).to(device)
    return _ON_DEVICE[key]


def reduce(x: Tensor, reduction: Union[str, None]) -> Tensor:
    """Reduce a tensor of scores: ``elementwise_mean``/``mean``, ``sum`` or ``none``."""
    if reduction in ("elementwise_mean", "mean"):
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


@lru_cache(maxsize=64)
def _gaussian_cached(kernel_size: int, sigma: float, device: torch.device) -> Tensor:
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, dtype=torch.float32)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return (gauss / gauss.sum())[None, :].to(device)


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32, device="cpu") -> Tensor:
    """1D gaussian window, normalised to sum 1; shape ``(1, kernel_size)``."""
    return _gaussian_cached(int(kernel_size), float(sigma), torch.device(device)).to(dtype)


def _gaussian_kernel_2d(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype = torch.float32, device="cpu"
) -> Tensor:
    """Separable 2D gaussian kernel broadcast per channel; shape ``(C, 1, kh, kw)``."""
    kx = _gaussian(kernel_size[0], sigma[0], dtype, device)
    ky = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kx.T * ky
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1])


def _gaussian_kernel_3d(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype = torch.float32, device="cpu"
) -> Tensor:
    """3D gaussian kernel per channel; shape ``(C, 1, kh, kw, kd)``."""
    kx = _gaussian(kernel_size[0], sigma[0], dtype, device)
    ky = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kz = _gaussian(kernel_size[2], sigma[2], dtype, device)
    kernel = (kx.T * ky)[:, :, None] * kz[0][None, None, :]
    return kernel.expand(channel, 1, *kernel_size)


def _depthwise_single_channel(conv, x: Tensor, kernel: Tensor, stride=1) -> Tensor:
    """``conv(x, kernel)`` of a single-channel ``x`` (``[N, 1, ...]``) as one image whose
    channels are its N planes (a plane alone doubled), each with its own copy of the
    window: a depthwise convolution with the same sums."""
    planes = x.shape[0]
    folded = x.contiguous().reshape(1, planes, *x.shape[2:])
    if planes == 1:
        folded = torch.cat((folded, folded), dim=1)
    width = folded.shape[1]
    out = conv(folded, kernel.expand(width, *kernel.shape[1:]).contiguous(), groups=width, stride=stride)
    return out[0, :planes].unsqueeze(1)


def _grouped_conv(conv, x: Tensor, kernel: Tensor, groups: int, stride=1) -> Tensor:
    """A VALID grouped convolution with one input channel a group, in full float32 on the
    card without touching a process-wide flag.

    On a CUDA tensor PyTorch runs a float32 convolution with more than one group of one
    channel on its native depthwise kernels (plain FMAs, no TF32); with a single group
    it goes to cuDNN, whose algorithms may use TF32 (``cudnn.allow_tf32`` is on by
    default), and so does a channels-last input. So a single-channel input runs as
    ``_depthwise_single_channel`` and every input is made contiguous. The CPU runs the
    convolution as it is."""
    kernel = kernel.to(x.dtype).contiguous()
    if not x.is_cuda:
        return conv(x, kernel, groups=groups, stride=stride)
    if groups == 1 and x.shape[1] == 1:
        return _depthwise_single_channel(conv, x, kernel, stride)
    return conv(x.contiguous(), kernel, groups=groups, stride=stride)


def _conv2d(x: Tensor, kernel: Tensor, groups: int = 1, stride=1) -> Tensor:
    """VALID 2D convolution, NCHW/OIHW, in full float32 (``_grouped_conv``)."""
    return _grouped_conv(F.conv2d, x, kernel, groups, stride)


def _conv3d(x: Tensor, kernel: Tensor, groups: int = 1) -> Tensor:
    """VALID 3D convolution, NCDHW/OIDHW, in full float32 (``_grouped_conv``)."""
    return _grouped_conv(F.conv3d, x, kernel, groups)


def _avg_pool2d(x: Tensor) -> Tensor:
    """2x2 average pool, stride 2, floor mode (the MS-SSIM downsampling step)."""
    return F.avg_pool2d(x, kernel_size=2, stride=2)


def _avg_pool3d(x: Tensor) -> Tensor:
    """2x2x2 average pool, stride 2, floor mode."""
    return F.avg_pool3d(x, kernel_size=2, stride=2)


@lru_cache(maxsize=256)
def _pad_index(n: int, lo: int, hi: int, mode: str, device: torch.device) -> Tensor:
    """Source index of each position of a length-``n`` axis padded by ``(lo, hi)`` in
    ``np.pad``'s ``mode``, which ``jnp.pad`` follows."""
    return torch.from_numpy(np.pad(np.arange(n), (lo, hi), mode=mode)).to(device)


def _pad(x: Tensor, pads: Sequence[Tuple[int, int]], mode: str) -> Tensor:
    """Pad the trailing ``len(pads)`` dims of ``x``, as ``jnp.pad`` does in ``mode``."""
    first = x.ndim - len(pads)
    for i, (lo, hi) in enumerate(pads):
        if lo or hi:
            dim = first + i
            x = x.index_select(dim, _pad_index(x.shape[dim], lo, hi, mode, x.device))
    return x


def _reflect_pad_2d(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """Edge-excluding reflection padding of the trailing two dims of NCHW input."""
    return _pad(x, ((pad_h, pad_h), (pad_w, pad_w)), "reflect")


def _reflect_pad_3d(x: Tensor, pad_d: int, pad_h: int, pad_w: int) -> Tensor:
    """Edge-excluding reflection padding of the trailing three dims of NCDHW input."""
    return _pad(x, ((pad_d, pad_d), (pad_h, pad_h), (pad_w, pad_w)), "reflect")


def _uniform_filter(x: Tensor, window_size: int) -> Tensor:
    """Mean filter with edge-including (symmetric) padding: pad left by ``ws//2`` and
    right by ``ws//2 + ws%2 - 1``, then a VALID mean convolution; the output has the
    input's spatial shape."""
    lo = window_size // 2
    hi = lo + window_size % 2 - 1
    x = _pad(x, ((lo, hi), (lo, hi)), "symmetric")
    channel = x.shape[1]
    kernel = torch.full((channel, 1, window_size, window_size), 1.0 / window_size**2, dtype=x.dtype, device=x.device)
    return _conv2d(x, kernel, groups=channel)
