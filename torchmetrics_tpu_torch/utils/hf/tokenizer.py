"""What the WordPiece and BPE tokenizers share: special tokens found in the raw text,
truncation, padding and the attention mask, as ``transformers``' fast tokenizers give
them for ``tokenizer(texts, padding=..., truncation=..., max_length=...)``; and
:func:`load_tokenizer`, which picks the tokenizer a snapshot directory names.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from torchmetrics_tpu_torch.utils.hf.snapshot import read_json

# ``transformers``' stand-in for "no limit" (``VERY_LARGE_INTEGER``)
VERY_LARGE_INTEGER = int(1e30)
# Unicode whitespace as Rust's ``char::is_whitespace`` and Oniguruma's ``\s`` see it:
# the White_Space property (Python's ``str.isspace`` also takes U+001C-U+001F)
_WHITESPACE_CONTROLS = frozenset("\t\n\x0b\x0c\r\x85")


def is_whitespace(c: str) -> bool:
    return c in _WHITESPACE_CONTROLS or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _token_content(value: Any) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class AddedToken:
    """A special token matched in the raw text before any normalisation; ``lstrip`` and
    ``rstrip`` take the whitespace on its left or right with it."""

    def __init__(self, content: str, lstrip: bool = False, rstrip: bool = False) -> None:
        self.content, self.lstrip, self.rstrip = content, lstrip, rstrip


class BaseTokenizer:
    """Batch encoding around a subclass's ``_encode_text`` (the ids of one text without
    special tokens) and ``_with_specials`` (the post-processor)."""

    model_max_length: int = VERY_LARGE_INTEGER
    num_special_tokens = 2

    def __init__(self, vocab: Dict[str, int], specials: Dict[str, Optional[str]], added: Sequence[AddedToken],
                 model_max_length: Optional[int] = None) -> None:
        self.vocab = vocab
        self.specials = specials
        self.added = sorted(added, key=lambda t: -len(t.content))
        if model_max_length is not None:
            self.model_max_length = int(model_max_length)
        self._cache: Dict[str, List[int]] = {}

    def _special_id(self, role: str) -> Optional[int]:
        token = self.specials.get(role)
        return None if token is None else self.vocab.get(token)

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._special_id("pad_token")

    @property
    def cls_token_id(self) -> Optional[int]:
        return self._special_id("cls_token")

    @property
    def sep_token_id(self) -> Optional[int]:
        return self._special_id("sep_token")

    @property
    def mask_token_id(self) -> Optional[int]:
        return self._special_id("mask_token")

    @property
    def unk_token_id(self) -> Optional[int]:
        return self._special_id("unk_token")

    def _encode_text(self, text: str) -> List[int]:
        raise NotImplementedError

    def _with_specials(self, ids: List[int]) -> List[int]:
        raise NotImplementedError

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """``text`` cut into (piece, is a special token) at every special token."""
        pieces: List[Tuple[str, bool]] = []
        start = i = 0
        while i < len(text) and self.added:
            hit = next((t for t in self.added if text.startswith(t.content, i)), None)
            if hit is None:
                i += 1
                continue
            before = text[start:i]
            if hit.lstrip:
                before = before.rstrip()
            pieces.append((before, False))
            pieces.append((hit.content, True))
            i += len(hit.content)
            if hit.rstrip:
                while i < len(text) and is_whitespace(text[i]):
                    i += 1
            start = i
        pieces.append((text[start:], False))
        return [(p, special) for p, special in pieces if special or p]

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without the post-processor's special tokens."""
        cached = self._cache.get(text)
        if cached is not None:
            return cached
        ids: List[int] = []
        for piece, special in self._split_added(text):
            ids.extend([self.vocab[piece]] if special else self._encode_text(piece))
        if len(self._cache) < 1 << 16:
            self._cache[text] = ids
        return ids

    def __call__(self, texts: Union[str, Sequence[str]], padding: Union[bool, str] = True,
                 truncation: Union[bool, str] = False, max_length: Optional[int] = None,
                 **kwargs: Any) -> Dict[str, np.ndarray]:
        """``input_ids`` and ``attention_mask`` of ``texts`` as int64 arrays, padded on the
        right to ``max_length`` (``padding="max_length"``) or to the longest row;
        ``return_tensors`` and the like are accepted, as a ``transformers`` tokenizer
        takes them."""
        texts = [texts] if isinstance(texts, str) else list(texts)
        if max_length is None and (truncation or padding == "max_length"):
            max_length = self.model_max_length
        rows = []
        for text in texts:
            ids = self.encode(text)
            if truncation:
                ids = ids[: max(max_length - self.num_special_tokens, 0)]
            rows.append(self._with_specials(list(ids)))
        width = max([len(r) for r in rows] + [max_length if padding == "max_length" else 0])
        pad = self.pad_token_id if self.pad_token_id is not None else 0
        input_ids = np.full((len(rows), width), pad, dtype=np.int64)
        attention_mask = np.zeros((len(rows), width), dtype=np.int64)
        for i, row in enumerate(rows):
            input_ids[i, : len(row)] = row
            attention_mask[i, : len(row)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def special_tokens(config: Dict[str, Any], defaults: Dict[str, Optional[str]]) -> Dict[str, Optional[str]]:
    """The special token of each role: the config's (a string or an added-token dict), else the default."""
    out = dict(defaults)
    for role in out:
        if role in config:
            out[role] = _token_content(config[role])
    return out


def tokenizer_config(model_dir: str) -> Dict[str, Any]:
    """``tokenizer_config.json`` with ``special_tokens_map.json`` over it, as
    ``transformers`` merges them."""
    config: Dict[str, Any] = {}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            config.update(read_json(path))
    return config


def added_tokens(model_dir: str, config: Dict[str, Any], specials: Dict[str, Optional[str]],
                 tokenizer_json: Optional[Dict[str, Any]]) -> List[AddedToken]:
    """The snapshot's special tokens with their strip flags (from
    ``added_tokens_decoder``, else ``tokenizer.json``), the roles' tokens at least."""
    flags: Dict[str, AddedToken] = {}
    for entry in (tokenizer_json or {}).get("added_tokens", []):
        if entry.get("special", True):
            flags[entry["content"]] = AddedToken(entry["content"], entry.get("lstrip", False), entry.get("rstrip", False))
    for entry in config.get("added_tokens_decoder", {}).values():
        if entry.get("special", True):
            flags[entry["content"]] = AddedToken(entry["content"], entry.get("lstrip", False), entry.get("rstrip", False))
    for role in ("mask_token",):
        value = config.get(role)
        if isinstance(value, dict) and value.get("content") in flags:
            flags[value["content"]] = AddedToken(value["content"], value.get("lstrip", False), value.get("rstrip", False))
    for token in specials.values():
        if token is not None and token not in flags:
            flags[token] = AddedToken(token)
    return list(flags.values())


def load_tokenizer(model_dir: str, model_type: Optional[str] = None) -> BaseTokenizer:
    """The tokenizer ``transformers``' ``AutoTokenizer`` loads from ``model_dir``:
    WordPiece for BERT, byte-level BPE for RoBERTa and GPT-2, CLIP's BPE for CLIP."""
    from torchmetrics_tpu_torch.utils.hf.bpe import ByteLevelBPETokenizer, CLIPTokenizer
    from torchmetrics_tpu_torch.utils.hf.wordpiece import WordPieceTokenizer

    config = tokenizer_config(model_dir)
    name = (config.get("tokenizer_class") or "").replace("Fast", "")
    if not name and os.path.isfile(os.path.join(model_dir, "config.json")):
        model_type = model_type or read_json(os.path.join(model_dir, "config.json")).get("model_type")
        name = {"bert": "BertTokenizer", "roberta": "RobertaTokenizer", "gpt2": "GPT2Tokenizer",
                "clip": "CLIPTokenizer"}.get(model_type or "", "")
    kinds = {"BertTokenizer": WordPieceTokenizer, "DistilBertTokenizer": WordPieceTokenizer,
             "RobertaTokenizer": ByteLevelBPETokenizer, "GPT2Tokenizer": ByteLevelBPETokenizer,
             "CLIPTokenizer": CLIPTokenizer}
    if name not in kinds:
        raise NotImplementedError(
            f"The tokenizer of `{model_dir}` ({name or 'unnamed'}) is not one the port reads: it reads WordPiece"
            " (BERT), byte-level BPE (RoBERTa, GPT-2) and CLIP's BPE; the others are listed in ROADMAP Queue 1."
        )
    return kinds[name].from_pretrained(model_dir, config)
