"""CLIPScore.

Counterpart of ``torchmetrics_tpu/functional/multimodal/clip_score.py``: 100 times the
cosine similarity of CLIP's image and text embeddings, with JAX's input checks and
messages. The CLIP model is the port's (``utils/hf/clip.py``), from a local snapshot
directory, with CLIP's BPE tokenizer and image processor (``utils/hf``), on ``device``
(``"cuda"`` unless the caller asks for ``"cpu"``; no CPU fallback).
"""

from __future__ import annotations

import functools
import os
from typing import Any, List, Tuple, Union

import torch

from torchmetrics_tpu_torch.utils.checks import _resolve_device
from torchmetrics_tpu_torch.utils.imports import snapshot_weight_stamp

Tensor = torch.Tensor

_DEFAULT_MODEL = "openai/clip-vit-large-patch14"


class _CLIPProcessor:
    """CLIP's tokenizer and image processor, called as ``CLIPProcessor`` is."""

    def __init__(self, tokenizer: Any, image_processor: Any) -> None:
        self.tokenizer, self.image_processor = tokenizer, image_processor

    def __call__(self, text: List[str], images: List[Tensor], device: torch.device) -> dict:
        enc = self.tokenizer(text, padding=True)
        return {"pixel_values": self.image_processor([torch.as_tensor(i).to(device) for i in images]),
                "input_ids": torch.as_tensor(enc["input_ids"], device=device),
                "attention_mask": torch.as_tensor(enc["attention_mask"], device=device)}


def _get_clip_model_and_processor(model_name_or_path: str = _DEFAULT_MODEL, device: Any = "cuda"):
    """The port's CLIP model (on ``device``) and processor of a local snapshot, cached per
    (path, device, weight-file stamps)."""
    device = _resolve_device(device)
    return _get_clip_model_and_processor_uncached(model_name_or_path, str(device),
                                                  snapshot_weight_stamp(model_name_or_path))


@functools.lru_cache(maxsize=2)
def _get_clip_model_and_processor_uncached(model_name_or_path: str, device: str, _stamp=()):
    from torchmetrics_tpu_torch.utils.hf.clip import load_clip
    from torchmetrics_tpu_torch.utils.hf.image_processor import CLIPImageProcessor
    from torchmetrics_tpu_torch.utils.hf.tokenizer import load_tokenizer

    try:
        if not (isinstance(model_name_or_path, str) and os.path.isdir(model_name_or_path)):
            raise FileNotFoundError(model_name_or_path)
        model = load_clip(model_name_or_path)
        processor = _CLIPProcessor(load_tokenizer(model_name_or_path, "clip"),
                                   CLIPImageProcessor.from_pretrained(model_name_or_path))
    except NotImplementedError:
        raise
    except Exception as err:
        raise OSError(
            f"Could not load CLIP model `{model_name_or_path}` from the local transformers cache"
            " and this environment has no network access. Provide a locally cached model path."
        ) from err
    return model.to(device), processor


def _device_of(model: Any) -> torch.device:
    return next(model.parameters()).device


def _clip_score_update(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    model,
    processor,
) -> Tuple[Tensor, int]:
    """Per-sample 100 cos(image embedding, text embedding) for a batch, on the model's device."""
    if not isinstance(images, list):
        if images.ndim == 3:
            images = [images]
        else:
            images = list(images)
    if not all(i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )
    device = _device_of(model)
    processed = processor(text=text, images=[torch.as_tensor(i).to(torch.uint8) for i in images], device=device)
    img_features = model.get_image_features(processed["pixel_values"])
    txt_features = model.get_text_features(processed["input_ids"], processed["attention_mask"])
    img_features = img_features / torch.linalg.vector_norm(img_features, dim=-1, keepdim=True)
    txt_features = txt_features / torch.linalg.vector_norm(txt_features, dim=-1, keepdim=True)
    score = 100 * (img_features * txt_features).sum(-1)
    return score, len(text)


def clip_score(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    model_name_or_path: str = _DEFAULT_MODEL,
    device: Union[str, torch.device, None] = "cuda",
) -> Tensor:
    r"""Compute CLIPScore, the CLIP-embedding cosine agreement of images and captions.

    ``model_name_or_path`` is a local snapshot directory (nothing is downloaded); the
    model runs on ``device``.
    """
    model, processor = _get_clip_model_and_processor(model_name_or_path, device)
    score, _ = _clip_score_update(images, text, model, processor)
    score = score.mean(0)
    return torch.maximum(score, torch.zeros_like(score))
