"""CLIP's text and vision towers and both projections, as an ``nn.Module`` with
``transformers``' PyTorch parameter names, computing what ``FlaxCLIPModel``'s
``get_text_features`` and ``get_image_features`` compute.

- Pre-LN layers: LayerNorm, self-attention, residual; LayerNorm, fc1, quick-GELU
  (``x * sigmoid(1.702 x)``), fc2, residual. Attention as in ``encoders``: written out,
  full float32, Flax's ``finfo(float32).min`` bias.
- Text: token + position embeddings, the causal mask combined with the padding mask,
  ``final_layer_norm``, then the pooled token: ``input_ids.argmax(-1)`` where the config's
  ``eos_token_id`` is 2 (the checkpoints published before ``transformers`` fixed it),
  else the first position holding ``eos_token_id`` (position 0 where none does, as
  Flax's ``argmax`` of an all-false row gives).
- Vision: the patch embedding as a patchify reshape and one full-float32 product (no
  convolution), the class embedding, position embeddings, ``pre_layrnorm``, the layers,
  ``post_layernorm`` on the class token.
- ``logit_scale`` is read and kept but, as in the JAX package, no score uses it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32
from torchmetrics_tpu_torch.utils.hf.encoders import Linear, attention_bias, multi_head_attention, unsupported_model_type

Tensor = torch.Tensor


def quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int) -> None:
        super().__init__()
        self.q_proj, self.k_proj = Linear(hidden, hidden), Linear(hidden, hidden)
        self.v_proj, self.out_proj = Linear(hidden, hidden), Linear(hidden, hidden)
        self.heads = heads

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        context = multi_head_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x), bias, self.heads)
        return self.out_proj(context)


class _MLP(nn.Module):
    def __init__(self, hidden: int, width: int, act: str) -> None:
        super().__init__()
        if act != "quick_gelu":
            raise NotImplementedError(f"CLIP's hidden_act `{act}` is not one the port runs (it runs `quick_gelu`);"
                                      " ROADMAP Queue 1 lists the model types the port does not read yet.")
        self.fc1, self.fc2 = Linear(hidden, width), Linear(width, hidden)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        hidden, eps = config["hidden_size"], config.get("layer_norm_eps", 1e-5)
        self.self_attn = _Attention(hidden, config["num_attention_heads"])
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = _MLP(hidden, config["intermediate_size"], config.get("hidden_act", "quick_gelu"))
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        self.layers = nn.ModuleList([_Layer(config) for _ in range(config["num_hidden_layers"])])

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer(x, bias)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        self.token_embedding = nn.Embedding(config["vocab_size"], config["hidden_size"])
        self.position_embedding = nn.Embedding(config["max_position_embeddings"], config["hidden_size"])


class _TextTransformer(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        self.embeddings = _TextEmbeddings(config)
        self.encoder = _Encoder(config)
        self.final_layer_norm = nn.LayerNorm(config["hidden_size"], eps=config.get("layer_norm_eps", 1e-5))
        self.eos_token_id = config.get("eos_token_id", 2)

    def forward(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        s = input_ids.shape[1]
        positions = torch.arange(s, device=input_ids.device)
        x = self.embeddings.token_embedding(input_ids) + self.embeddings.position_embedding(positions)
        causal = torch.ones(s, s, dtype=torch.bool, device=input_ids.device).tril()
        mask = (attention_mask > 0)[:, None, None, :] & causal
        x = self.final_layer_norm(self.encoder(x, attention_bias(mask)))
        if self.eos_token_id == 2:
            pooled_at = input_ids.argmax(dim=-1)
        else:
            pooled_at = (input_ids == self.eos_token_id).to(torch.int32).argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), pooled_at]


class _VisionEmbeddings(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        hidden, patch = config["hidden_size"], config["patch_size"]
        self.patch = patch
        self.class_embedding = nn.Parameter(torch.zeros(hidden), requires_grad=False)
        self.patch_embedding = nn.Module()
        self.patch_embedding.weight = nn.Parameter(torch.zeros(hidden, config.get("num_channels", 3), patch, patch),
                                                   requires_grad=False)
        patches = (config["image_size"] // patch) ** 2
        self.position_embedding = nn.Embedding(patches + 1, hidden)

    def forward(self, pixel_values: Tensor) -> Tensor:
        b, c, h, w = pixel_values.shape
        p = self.patch
        patches = pixel_values.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(b, (h // p) * (w // p), c * p * p)
        weight = self.patch_embedding.weight.reshape(self.patch_embedding.weight.shape[0], -1)
        x = _matmul_full_float32(patches, weight.t())
        x = torch.cat([self.class_embedding.expand(b, 1, -1), x], dim=1)
        return x + self.position_embedding.weight[: x.shape[1]]


class _VisionTransformer(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        hidden, eps = config["hidden_size"], config.get("layer_norm_eps", 1e-5)
        self.embeddings = _VisionEmbeddings(config)
        self.pre_layrnorm = nn.LayerNorm(hidden, eps=eps)
        self.encoder = _Encoder(config)
        self.post_layernorm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, pixel_values: Tensor) -> Tensor:
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return self.post_layernorm(self.encoder(x, zero)[:, 0])


def _tower_config(config: Dict[str, Any], key: str) -> Dict[str, Any]:
    tower = dict(config.get(key) or {})
    defaults = {
        "text_config": {"vocab_size": 49408, "hidden_size": 512, "intermediate_size": 2048, "num_hidden_layers": 12,
                        "num_attention_heads": 8, "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                        "layer_norm_eps": 1e-5, "eos_token_id": 49407},
        "vision_config": {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
                          "num_attention_heads": 12, "num_channels": 3, "image_size": 224, "patch_size": 32,
                          "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5},
    }[key]
    return {**defaults, **tower}


class CLIPModel(nn.Module):
    """``CLIPModel``'s parameters; :meth:`get_text_features` and :meth:`get_image_features`."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        if config.get("model_type") != "clip":
            raise unsupported_model_type(config.get("model_type"))
        self.config = dict(config)
        text, vision = _tower_config(config, "text_config"), _tower_config(config, "vision_config")
        projection = config.get("projection_dim", 512)
        self.text_model = _TextTransformer(text)
        self.vision_model = _VisionTransformer(vision)
        self.text_projection = Linear(text["hidden_size"], projection, bias=False)
        self.visual_projection = Linear(vision["hidden_size"], projection, bias=False)
        self.logit_scale = nn.Parameter(torch.zeros(()), requires_grad=False)
        self.image_size = vision["image_size"]
        self.max_positions = text["max_position_embeddings"]
        self.requires_grad_(False)

    def get_text_features(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        return self.text_projection(self.text_model(input_ids, attention_mask))

    def get_image_features(self, pixel_values: Tensor) -> Tensor:
        return self.visual_projection(self.vision_model(pixel_values))


def load_clip(model_dir: str) -> CLIPModel:
    """The CLIP model of a local snapshot, on the CPU."""
    from torchmetrics_tpu_torch.utils.hf.encoders import load_weights
    from torchmetrics_tpu_torch.utils.hf.snapshot import load_state_dict, read_config

    return load_weights(CLIPModel(read_config(model_dir)), load_state_dict(model_dir))
