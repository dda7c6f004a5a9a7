"""CLIP image quality assessment.

Counterpart of ``torchmetrics_tpu/functional/multimodal/clip_iqa.py``: images are scored
against antonym prompt pairs ("Good photo." against "Bad photo.") by a softmax of the
CLIP logits over each pair. ``"clip_iqa"`` names ``openai/clip-vit-base-patch32``, which
must be a local snapshot directory like any other name.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.multimodal.clip_score import _device_of, _get_clip_model_and_processor
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _clip_iqa_format_prompts(prompts: Union[Tuple[str, ...], str]) -> Tuple[List[str], List[str]]:
    """Expand prompt keywords / custom pairs into a flat list of positive/negative prompts."""
    if isinstance(prompts, str):
        prompts = (prompts,)
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a string or tuple of strings / prompt-pair tuples")

    prompts_names: List[str] = []
    prompts_list: List[str] = []
    count = 0
    for p in prompts:
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {list(_PROMPTS)} if not custom tuple prompts,"
                    f" got {p}."
                )
            prompts_names.append(p)
            prompts_list.extend(_PROMPTS[p])
        elif isinstance(p, tuple) and len(p) == 2:
            prompts_names.append(f"user_defined_{count}")
            prompts_list.extend(p)
            count += 1
        else:
            raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
    return prompts_names, prompts_list


def clip_image_quality_assessment(
    images: Tensor,
    model_name_or_path: str = "clip_iqa",
    data_range: float = 1.0,
    prompts: Union[Tuple[str, ...], str] = ("quality",),
    device: Union[str, torch.device, None] = "cuda",
) -> Union[Tensor, Dict[str, Tensor]]:
    r"""Compute CLIP-IQA: no-reference image quality from antonym prompt pairs.

    Images are cast to uint8 by truncation after ``clip(i / data_range * 255, 0, 255)``;
    the model (a local snapshot directory) runs on ``device``.
    """
    prompts_names, prompts_list = _clip_iqa_format_prompts(prompts)
    if model_name_or_path == "clip_iqa":
        model_name_or_path = "openai/clip-vit-base-patch32"
    model, processor = _get_clip_model_and_processor(model_name_or_path, device)
    images = torch.as_tensor(images).to(_device_of(model))
    if images.is_floating_point():
        images = images.to(torch.float32)  # JAX's arrays are float32
    if images.ndim == 3:
        images = images[None]
    imgs_uint8 = [torch.clip(i / data_range * 255, 0, 255).to(torch.uint8) for i in images]

    processed = processor(text=prompts_list, images=imgs_uint8, device=_device_of(model))
    img_features = model.get_image_features(processed["pixel_values"])
    img_features = img_features / torch.linalg.vector_norm(img_features, dim=-1, keepdim=True)
    txt_features = model.get_text_features(processed["input_ids"], processed["attention_mask"])
    txt_features = txt_features / torch.linalg.vector_norm(txt_features, dim=-1, keepdim=True)

    logits = 100 * _matmul_full_float32(img_features, txt_features.t())
    logits = logits.reshape(logits.shape[0], -1, 2)
    probs = torch.softmax(logits, dim=-1)[..., 0]

    if len(prompts_names) == 1:
        return probs.squeeze(-1)
    return {name: probs[:, i] for i, name in enumerate(prompts_names)}
