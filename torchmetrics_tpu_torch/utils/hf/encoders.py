"""BERT and RoBERTa encoders as ``nn.Module``s with ``transformers``' PyTorch parameter
names, so a snapshot's weights load by name, computing what ``transformers``' Flax
classes compute (``FlaxBertModel``, ``FlaxRobertaModel`` and their masked-LM heads).

- Embeddings: word + position + token type (zeros), then LayerNorm. RoBERTa's
  positions come from the ids: ``padding_idx + cumsum(ids != pad) * (ids != pad)``.
- Post-LN layers: self-attention, dense, residual, LayerNorm; dense, exact-erf GELU,
  dense, residual, LayerNorm. Every hidden state is returned (``num_layers``,
  ``all_layers``).
- Attention is written out: the query scaled by ``1/sqrt(head_dim)``, one product for
  the scores, ``finfo(float32).min`` added at masked keys (Flax's bias; a row whose
  keys are all masked stays finite), a softmax, one product for the values. No
  ``scaled_dot_product_attention``, no cuDNN.
- Every product goes through ``utils/compute._matmul_full_float32``: full float32 on the
  card as on the CPU.
- The masked-LM head (dense, GELU, LayerNorm, the decoder tied to the word embeddings,
  a bias) is separate from the encoder, so a caller can gather the positions it needs
  before the ``[.., vocab]`` product.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor

SUPPORTED_ENCODERS = ("bert", "roberta")
_ROADMAP = "ROADMAP Queue 1 lists the model types the port does not read yet"


def unsupported_model_type(model_type: Any) -> NotImplementedError:
    return NotImplementedError(
        f"Model type `{model_type}` is not one the port runs (it runs {', '.join(SUPPORTED_ENCODERS)} and clip);"
        f" {_ROADMAP}."
    )


class Linear(nn.Module):
    """``nn.Linear``'s parameters (``weight`` ``[out, in]``, ``bias``) on a full-float32 product."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features), requires_grad=False) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        out = _matmul_full_float32(x, self.weight.t())
        return out if self.bias is None else out + self.bias


def gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="none")


def attention_bias(mask: Tensor) -> Tensor:
    """Flax's additive attention bias: 0 where ``mask`` is set, ``finfo(float32).min`` elsewhere."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    low = torch.full((), torch.finfo(torch.float32).min, dtype=torch.float32, device=mask.device)
    return torch.where(mask > 0, zero, low)


def multi_head_attention(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, heads: int) -> Tensor:
    """Scaled dot-product attention written out as two products and a softmax.

    ``q``, ``k``, ``v``: ``[B, S, heads * d]``; ``bias``: broadcastable to ``[B, heads, S, S]``."""
    b, s, width = q.shape
    d = width // heads
    q = q.reshape(b, s, heads, d).transpose(1, 2) / math.sqrt(d)
    k = k.reshape(b, -1, heads, d).permute(0, 2, 3, 1)
    v = v.reshape(b, -1, heads, d).transpose(1, 2)
    scores = _matmul_full_float32(q, k) + bias
    probs = torch.softmax(scores, dim=-1)
    return _matmul_full_float32(probs, v).transpose(1, 2).reshape(b, s, width)


class _Embeddings(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        hidden = config["hidden_size"]
        self.word_embeddings = nn.Embedding(config["vocab_size"], hidden)
        self.position_embeddings = nn.Embedding(config["max_position_embeddings"], hidden)
        self.token_type_embeddings = nn.Embedding(config.get("type_vocab_size", 2), hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=config.get("layer_norm_eps", 1e-12))
        self.roberta = config.get("model_type") == "roberta"
        self.pad = config.get("pad_token_id", 1)

    def forward(self, input_ids: Tensor) -> Tensor:
        if self.roberta:
            mask = (input_ids != self.pad).to(torch.int32)
            positions = torch.cumsum(mask, dim=1, dtype=torch.int32) * mask + self.pad
        else:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand_as(input_ids)
        x = self.word_embeddings(input_ids) + self.position_embeddings(positions.long())
        x = x + self.token_type_embeddings.weight[0]
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int) -> None:
        super().__init__()
        self.query, self.key, self.value = Linear(hidden, hidden), Linear(hidden, hidden), Linear(hidden, hidden)


class _Output(nn.Module):
    def __init__(self, width: int, hidden: int, eps: float) -> None:
        super().__init__()
        self.dense = Linear(width, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x: Tensor, residual: Tensor) -> Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, eps: float) -> None:
        super().__init__()
        self.self = _SelfAttention(hidden)
        self.output = _Output(hidden, hidden, eps)
        self.heads = heads

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        att = self.self
        context = multi_head_attention(att.query(x), att.key(x), att.value(x), bias, self.heads)
        return self.output(context, x)


class _Intermediate(nn.Module):
    def __init__(self, hidden: int, width: int) -> None:
        super().__init__()
        self.dense = Linear(hidden, width)

    def forward(self, x: Tensor) -> Tensor:
        return gelu(self.dense(x))


class _Layer(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        hidden, eps = config["hidden_size"], config.get("layer_norm_eps", 1e-12)
        self.attention = _Attention(hidden, config["num_attention_heads"], eps)
        self.intermediate = _Intermediate(hidden, config["intermediate_size"])
        self.output = _Output(config["intermediate_size"], hidden, eps)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class _Encoder(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        self.layer = nn.ModuleList([_Layer(config) for _ in range(config["num_hidden_layers"])])


def _check_encoder_config(config: Dict[str, Any]) -> None:
    if config.get("model_type") not in SUPPORTED_ENCODERS:
        raise unsupported_model_type(config.get("model_type"))
    act = config.get("hidden_act", "gelu")
    if act != "gelu":
        raise NotImplementedError(f"hidden_act `{act}` is not one the port runs (it runs exact-erf `gelu`); {_ROADMAP}.")
    if config.get("position_embedding_type", "absolute") != "absolute":
        raise NotImplementedError(
            f"position_embedding_type `{config['position_embedding_type']}` is not one the port runs; {_ROADMAP}."
        )


class TransformerEncoder(nn.Module):
    """``BertModel``/``RobertaModel``: the embeddings and the layers (the pooler, which no
    metric reads, is left out)."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        _check_encoder_config(config)
        self.config = dict(config)
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.requires_grad_(False)

    @property
    def num_hidden_layers(self) -> int:
        return len(self.encoder.layer)

    def hidden_states(self, input_ids: Tensor, attention_mask: Tensor, upto: Optional[int] = None) -> List[Tensor]:
        """The embeddings' output and each layer's, ``[B, S, hidden]`` each; with ``upto``
        the layers past it are not run."""
        bias = attention_bias(attention_mask)[:, None, None, :]
        states = [self.embeddings(input_ids)]
        for i, layer in enumerate(self.encoder.layer):
            if upto is not None and i >= upto:
                break
            states.append(layer(states[-1], bias))
        return states

    def forward(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        return self.hidden_states(input_ids, attention_mask)[-1]


class _Transform(nn.Module):
    def __init__(self, hidden: int, eps: float) -> None:
        super().__init__()
        self.dense = Linear(hidden, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=eps)


class _Predictions(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        self.transform = _Transform(config["hidden_size"], config.get("layer_norm_eps", 1e-12))
        self.bias = nn.Parameter(torch.zeros(config["vocab_size"]), requires_grad=False)


class _BertHead(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        self.predictions = _Predictions(config)


class _RobertaHead(nn.Module):
    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        hidden = config["hidden_size"]
        self.dense = Linear(hidden, hidden)
        self.layer_norm = nn.LayerNorm(hidden, eps=config.get("layer_norm_eps", 1e-5))
        self.bias = nn.Parameter(torch.zeros(config["vocab_size"]), requires_grad=False)


class MaskedLM(nn.Module):
    """``BertForMaskedLM``/``RobertaForMaskedLM``: the encoder under ``bert.``/``roberta.``
    and the head under ``cls.predictions.``/``lm_head.``, its decoder tied to the word
    embeddings. :meth:`encode` gives the last hidden states and :meth:`logits` maps any
    ``[.., hidden]`` rows of them to ``[.., vocab]``."""

    def __init__(self, config: Dict[str, Any]) -> None:
        super().__init__()
        _check_encoder_config(config)
        if not config.get("tie_word_embeddings", True):
            raise NotImplementedError(f"A masked-LM head with an untied decoder is not one the port runs; {_ROADMAP}.")
        self.config = dict(config)
        self.is_roberta = config["model_type"] == "roberta"
        encoder = TransformerEncoder(config)
        if self.is_roberta:
            self.roberta = encoder
            self.lm_head = _RobertaHead(config)
        else:
            self.bert = encoder
            self.cls = _BertHead(config)
        self.requires_grad_(False)

    @property
    def encoder(self) -> TransformerEncoder:
        return self.roberta if self.is_roberta else self.bert

    def encode(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        return self.encoder(input_ids, attention_mask)

    def logits(self, hidden: Tensor) -> Tensor:
        if self.is_roberta:
            head = self.lm_head
            x = head.layer_norm(gelu(head.dense(hidden)))
        else:
            head = self.cls.predictions
            x = head.transform.LayerNorm(gelu(head.transform.dense(hidden)))
        table = self.encoder.embeddings.word_embeddings.weight
        return _matmul_full_float32(x, table.t()) + head.bias

    def forward(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        return self.logits(self.encode(input_ids, attention_mask))


def load_weights(module: nn.Module, state: Dict[str, Tensor], prefix: str = "") -> nn.Module:
    """Load ``state`` (``transformers``' PyTorch names) into ``module`` by name.

    A base model's names may carry the masked-LM class's prefix (``bert.``,
    ``roberta.``, ``prefix``) and a masked-LM's may lack it; what the module does not
    have (a head, the pooler, the tied decoder, ``position_ids`` buffers) is skipped. A
    missing parameter raises."""
    own = module.state_dict()
    got: Dict[str, Tensor] = {}
    for name, tensor in state.items():
        if prefix and name.startswith(prefix) and name[len(prefix):] in own:
            name = name[len(prefix):]
        elif prefix and (prefix + name) in own:
            name = prefix + name
        if name in own:
            got[name] = tensor
    missing = sorted(set(own) - set(got))
    if missing:
        raise ValueError(f"The checkpoint lacks {len(missing)} parameters the model needs, e.g. {missing[:5]}")
    for name, tensor in got.items():
        if tuple(tensor.shape) != tuple(own[name].shape):
            raise ValueError(f"`{name}` has shape {tuple(tensor.shape)} in the checkpoint, {tuple(own[name].shape)} in the model")
    module.load_state_dict({k: v.to(torch.float32) for k, v in got.items()}, strict=True)
    return module


def load_encoder(model_dir: str, masked_lm: bool = False) -> nn.Module:
    """The BERT or RoBERTa encoder (with its masked-LM head where ``masked_lm``) of a
    local snapshot, on the CPU."""
    from torchmetrics_tpu_torch.utils.hf.snapshot import load_state_dict, read_config

    config = read_config(model_dir)
    module = MaskedLM(config) if masked_lm else TransformerEncoder(config)
    return load_weights(module, load_state_dict(model_dir), f"{config['model_type']}.")
