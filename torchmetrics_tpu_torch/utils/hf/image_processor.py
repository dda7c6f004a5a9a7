"""CLIP's image processor on uint8 tensors, on the caller's device, bitwise as
``transformers``' ``CLIPImageProcessor`` gives it.

``CLIPImageProcessor`` resizes the shortest edge to ``size["shortest_edge"]`` (the long
edge to ``int(size * long / short)``) through PIL's 8-bit bicubic resampler, center-crops
(padding with zeros where the crop is larger than the image), rescales (the uint8 image
times ``rescale_factor`` in float64, then cast to float32) and normalises in float32
(``(x - mean) / std``). A float bicubic (``F.interpolate``) is up to a grey level off PIL,
so the resampler here is PIL's own algorithm (``libImaging/Resample.c``) in integer tensor
arithmetic:

- per output pixel, the bicubic filter (``a = -0.5``, support 2 scaled by the downscale
  factor) is evaluated in float64 on the host over the input pixels ``PIL`` picks, the
  weights normalised to sum 1 and rounded to fixed point with 22 fraction bits;
- a horizontal pass, whose sums (from ``2^21``) are shifted down 22 bits and clipped to
  an intermediate uint8 image, then the vertical pass on it, each a loop over the filter's
  taps of an int32 gather-multiply-add;
- a pass whose size does not change is skipped, and an image of the target size is
  copied, as PIL does.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.utils.hf.snapshot import read_json

Tensor = torch.Tensor

PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _c_int(x: float) -> int:
    """C's ``(int)`` cast: truncation toward zero."""
    return int(x)


@lru_cache(maxsize=64)
def pil_coefficients(in_size: int, out_size: int) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for a bicubic pass of
    ``in_size`` to ``out_size`` pixels: each output's first input pixel and its
    fixed-point weights."""
    scale = float(in_size) / out_size  # (in1 - in0) / outSize over the box (0, in_size)
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    starts, weights = [], []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(_c_int(center - support + 0.5), 0)
        xmax = min(_c_int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        fixed = tuple(_c_int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0 else _c_int(0.5 + w * (1 << PRECISION_BITS))
                      for w in k)
        starts.append(xmin)
        weights.append(fixed)
    return tuple(starts), tuple(weights)


def _pass(image: Tensor, out_size: int, dim: int) -> Tensor:
    """One 8-bit bicubic pass of uint8 ``image`` along ``dim`` (``-1`` columns, ``-2`` rows)."""
    in_size = image.shape[dim]
    starts, weights = pil_coefficients(in_size, out_size)
    taps = max(len(w) for w in weights)
    index = torch.tensor([[min(s + t, in_size - 1) for t in range(taps)] for s in starts], dtype=torch.long)
    coeff = torch.tensor([list(w) + [0] * (taps - len(w)) for w in weights], dtype=torch.int32)
    index, coeff = index.to(image.device), coeff.to(image.device)
    src = image.to(torch.int32)
    acc = torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int32, device=image.device)
    shape = [1] * image.dim()
    shape[dim] = out_size
    for t in range(taps):
        acc = acc + src.index_select(dim, index[:, t]) * coeff[:, t].reshape(shape)
    return torch.clamp(acc >> PRECISION_BITS, 0, 255).to(torch.uint8)


def pil_bicubic_resize(images: Tensor, height: int, width: int) -> Tensor:
    """``PIL.Image.resize((width, height), BICUBIC)`` of uint8 ``[..., H, W]`` images."""
    if images.dtype != torch.uint8:
        raise TypeError(f"The 8-bit resampler takes uint8 images, got {images.dtype}")
    h, w = images.shape[-2:]
    if (h, w) == (height, width):
        return images.clone()
    out = images
    if w != width:
        out = _pass(out, width, -1)
    if h != height:
        out = _pass(out, height, -2)
    return out


def shortest_edge_size(height: int, width: int, size: int) -> Tuple[int, int]:
    """``get_resize_output_image_size(..., default_to_square=False)``: (height, width)."""
    short, long = (width, height) if width <= height else (height, width)
    new_short, new_long = size, int(size * long / short)
    return (new_long, new_short) if width <= height else (new_short, new_long)


def center_crop(images: Tensor, height: int, width: int) -> Tensor:
    """``transformers``' ``center_crop``: the window of the given size about the centre,
    zeros where it leaves the image."""
    orig_h, orig_w = images.shape[-2:]
    top, left = (orig_h - height) // 2, (orig_w - width) // 2
    if top >= 0 and left >= 0 and top + height <= orig_h and left + width <= orig_w:
        return images[..., top : top + height, left : left + width]
    new_h, new_w = max(height, orig_h), max(width, orig_w)
    padded = images.new_zeros(images.shape[:-2] + (new_h, new_w))
    top_pad, left_pad = math.ceil((new_h - orig_h) / 2), math.ceil((new_w - orig_w) / 2)
    padded[..., top_pad : top_pad + orig_h, left_pad : left_pad + orig_w] = images
    top, left = top + top_pad, left + left_pad
    return padded[..., max(0, top) : min(new_h, top + height), max(0, left) : min(new_w, left + width)]


class CLIPImageProcessor:
    """``pixel_values`` of uint8 ``[3, H, W]`` images, on their device."""

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        config = dict(config or {})
        size = config.get("size", {"shortest_edge": 224})
        size = {"shortest_edge": size} if isinstance(size, int) else dict(size)
        crop = config.get("crop_size", {"height": 224, "width": 224})
        crop = {"height": crop, "width": crop} if isinstance(crop, int) else dict(crop)
        self.do_resize = config.get("do_resize", True)
        self.size = size
        self.resample = config.get("resample", 3)
        self.do_center_crop = config.get("do_center_crop", True)
        self.crop_size = crop
        self.do_rescale = config.get("do_rescale", True)
        self.rescale_factor = config.get("rescale_factor", 1 / 255)
        self.do_normalize = config.get("do_normalize", True)
        self.image_mean = tuple(config.get("image_mean", OPENAI_CLIP_MEAN))
        self.image_std = tuple(config.get("image_std", OPENAI_CLIP_STD))
        if self.do_resize and self.resample != 3:
            raise NotImplementedError(f"Resampling filter {self.resample} is not one the port runs (it runs bicubic,"
                                      " 3); ROADMAP Queue 1 lists what the port does not read yet.")

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "CLIPImageProcessor":
        path = os.path.join(model_dir, "preprocessor_config.json")
        return cls(read_json(path) if os.path.isfile(path) else None)

    def _resize(self, image: Tensor) -> Tensor:
        h, w = image.shape[-2:]
        if "shortest_edge" in self.size:
            height, width = shortest_edge_size(h, w, self.size["shortest_edge"])
        else:
            height, width = self.size["height"], self.size["width"]
        return pil_bicubic_resize(image, height, width)

    def __call__(self, images: Sequence[Tensor]) -> Tensor:
        """``[N, 3, crop_h, crop_w]`` float32 ``pixel_values``; images of one size are
        resized together."""
        out: List[Optional[Tensor]] = [None] * len(images)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, image in enumerate(images):
            if image.dim() != 3 or image.shape[0] != 3:
                raise ValueError(f"Expected uint8 images of shape [3, H, W], got {tuple(image.shape)}")
            groups.setdefault(tuple(image.shape), []).append(i)
        for indices in groups.values():
            batch = torch.stack([images[i] for i in indices])
            if self.do_resize:
                batch = self._resize(batch)
            if self.do_center_crop:
                batch = center_crop(batch, self.crop_size["height"], self.crop_size["width"])
            x = batch
            if self.do_rescale:
                x = (x.to(torch.float64) * self.rescale_factor).to(torch.float32)
            else:
                x = x.to(torch.float32)
            if self.do_normalize:
                mean = torch.tensor(self.image_mean, dtype=torch.float32, device=x.device).reshape(1, 3, 1, 1)
                std = torch.tensor(self.image_std, dtype=torch.float32, device=x.device).reshape(1, 3, 1, 1)
                x = (x - mean) / std
            for j, i in enumerate(indices):
                out[i] = x[j]
        return torch.stack(out) if out else torch.zeros(0, 3, self.crop_size["height"], self.crop_size["width"])
