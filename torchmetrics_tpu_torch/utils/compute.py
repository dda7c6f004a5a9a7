"""Shared numeric helpers.

Counterpart of ``torchmetrics_tpu/utils/compute.py``, cut to what the slices call, the
full-float32 matmul that stands for the JAX package's ``Precision.HIGHEST``, and the
full-float32 convolution that the networks and the ONNX executor run on.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float = 1.0, axis: int = -1) -> Tensor:
    """Area under the curve by the trapezoidal rule (inputs assumed sorted along x).

    The same arithmetic as ``jnp.trapezoid``: half the sum of ``dx * (y[1:] + y[:-1])``.
    """
    x = torch.movedim(x, axis, -1)
    y = torch.movedim(y, axis, -1)
    area = 0.5 * (torch.diff(x, dim=-1) * (y[..., 1:] + y[..., :-1])).sum(-1)
    return (area * direction).to(torch.float32)


def _cuda_matmul_precision() -> str:
    """The float32 precision cuBLAS matmuls run at: ``torch.backends.cuda.matmul``'s
    ``fp32_precision``, or the process-wide ``torch.backends.fp32_precision`` where that
    reads ``"none"`` (inherit); ``"ieee"`` where both do. Only read, never written."""
    precision = torch.backends.cuda.matmul.fp32_precision
    if precision == "none":
        precision = getattr(torch.backends, "fp32_precision", "none")
    return "ieee" if precision == "none" else precision


def _matmul_full_float32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in full float32, as the JAX package's ``Precision.HIGHEST``.

    ``torch.matmul`` takes no precision argument, and the setting is the process's, so
    this writes none: where matmuls run in IEEE float32 (PyTorch's default) it is
    ``torch.matmul``; where a caller has turned TF32 (or lower) on, it multiplies in
    float64 and rounds once to float32, which no other thread's product notices. On an
    H100, FP64 on the tensor cores peaks near FP32 without TF32."""
    if _cuda_matmul_precision() == "ieee":
        return torch.matmul(a, b)
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.result_type(a, b))


# the most bytes one im2col chunk may take: a batch whose columns pass it is unfolded a
# few images at a time (Inception's ``Conv2d_2a_3x3`` unfolds 288 x 147^2 floats, 24.9
# MB, an image; VGG16's first block 576 x 256^2, 151 MB)
IM2COL_CHUNK_BYTES = 1 << 30


def _conv2d_full_float32(
    x: Tensor,
    weight: Tensor,
    bias: Optional[Tensor] = None,
    stride: Sequence[int] = (1, 1),
    padding: Sequence[Tuple[int, int]] = ((0, 0), (0, 0)),
    dilation: Sequence[int] = (1, 1),
    groups: int = 1,
) -> Tensor:
    """An NCHW convolution with OIHW ``weight`` in full float32, never on cuDNN.

    cuDNN may run a float32 convolution in TF32 (``torch.backends.cudnn.allow_tf32`` is
    on by default), about 1e-3 relative off, and the flag is the process's. So the
    input is padded (``padding`` is ``((top, bottom), (left, right))``), unfolded
    (im2col, at most :data:`IM2COL_CHUNK_BYTES` of columns at a time) and multiplied by
    the weight through :func:`_matmul_full_float32`, one product a chunk. A 1x1
    convolution is a direct product over the pixels, with no unfold."""
    (top, bottom), (left, right) = padding
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    n, c, h, w = x.shape
    out_c, c_group, kh, kw = weight.shape
    ho = (h - (kh - 1) * dilation[0] - 1) // stride[0] + 1
    wo = (w - (kw - 1) * dilation[1] - 1) // stride[1] + 1
    depth = c_group * kh * kw
    mat = weight.reshape(groups, out_c // groups, depth).to(x.dtype)
    if groups == 1:
        mat = mat[0]
    if kh == kw == 1:
        x = x[:, :, : (ho - 1) * stride[0] + 1 : stride[0], : (wo - 1) * stride[1] + 1 : stride[1]]
        cols = x.reshape(n, groups, depth, ho * wo) if groups > 1 else x.reshape(n, depth, ho * wo)
        out = _matmul_full_float32(mat.expand(n, *mat.shape), cols)
    else:
        per_image = c * kh * kw * ho * wo * x.element_size()
        chunk = max(1, IM2COL_CHUNK_BYTES // max(per_image, 1))
        outs = []
        for start in range(0, n, chunk):
            part = x[start : start + chunk]
            cols = F.unfold(part, (kh, kw), dilation=tuple(dilation), stride=tuple(stride))  # [n, C*kh*kw, L]
            if groups > 1:
                cols = cols.reshape(part.shape[0], groups, depth, ho * wo)
            outs.append(_matmul_full_float32(mat.expand(part.shape[0], *mat.shape), cols))
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
    out = out.reshape(n, out_c, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1).to(out.dtype)
    return out


class Conv2dFullFloat32(torch.nn.Module):
    """A 2-D convolution layer (``weight`` OIHW, optional ``bias``) that runs on
    :func:`_conv2d_full_float32`: the state dict of ``torch.nn.Conv2d``, never cuDNN."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, int],
        stride: Tuple[int, int] = (1, 1),
        padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0)),
        bias: bool = True,
    ) -> None:
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(tuple(p) for p in padding)
        self.weight = torch.nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size), requires_grad=False)
        self.bias = torch.nn.Parameter(torch.empty(out_channels), requires_grad=False) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        return _conv2d_full_float32(x, self.weight, self.bias, self.stride, self.padding)
