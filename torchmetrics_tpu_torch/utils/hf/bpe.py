"""Byte-level BPE (RoBERTa, GPT-2) and CLIP's BPE, as ``transformers``' fast tokenizers
run them.

Both pre-tokenizers are regexes over Unicode classes (``\\p{L}``, ``\\p{N}``) that
Python's ``re`` cannot express, so each is written out as a scanner over
``unicodedata.category``:

- byte-level (``pre_tokenizers.ByteLevel``): GPT-2's
  ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, then
  every UTF-8 byte mapped to its printable stand-in;
- CLIP (``CLIPTokenizerFast``): NFC, runs of whitespace to one space, lower case, then
  ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` with the gaps removed, then
  the byte-level split and mapping; its BPE marks a word's last symbol with ``</w>``,
  and a symbol outside the vocabulary becomes the unknown token.

The merges are applied lowest rank first, and the result of each word is cached, as
``tokenizers`` caches it.
"""

from __future__ import annotations

import os
import unicodedata
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torchmetrics_tpu_torch.utils.hf.snapshot import read_json
from torchmetrics_tpu_torch.utils.hf.tokenizer import (
    BaseTokenizer,
    added_tokens,
    is_letter,
    is_number,
    is_whitespace,
    special_tokens,
)

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _contraction(text: str, i: int) -> Optional[str]:
    return next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)


def _run(text: str, i: int, test) -> int:
    while i < len(text) and test(text[i]):
        i += 1
    return i


def _is_other(c: str) -> bool:
    return not (is_whitespace(c) or is_letter(c) or is_number(c))


def gpt2_split(text: str) -> List[str]:
    """GPT-2's pre-tokenizer regex, alternative by alternative."""
    out, i, n = [], 0, len(text)
    while i < n:
        hit = _contraction(text, i)
        if hit:
            out.append(hit)
            i += len(hit)
            continue
        start = i + 1 if text[i] == " " and i + 1 < n and not is_whitespace(text[i + 1]) else i
        c = text[start]
        if not is_whitespace(c):
            test = is_letter if is_letter(c) else is_number if is_number(c) else _is_other
            end = _run(text, start, test)
        else:
            end = _run(text, i, is_whitespace)
            if end < n and end - i > 1:  # ``\s+(?!\S)``: leave the last space to the next word
                end -= 1
        out.append(text[i:end])
        i = end
    return out


def clip_split(text: str) -> List[str]:
    """CLIP's pre-tokenizer regex, keeping the matches and dropping the whitespace."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        hit = _contraction(text, i)
        if hit:
            end = i + len(hit)
        elif is_letter(c):
            end = _run(text, i, is_letter)
        elif is_number(c):
            end = i + 1
        elif is_whitespace(c):
            i += 1
            continue
        else:
            end = _run(text, i, _is_other)
        out.append(text[i:end])
        i = end
    return out


def clip_normalize(text: str) -> str:
    """NFC, each run of whitespace to one space, lower case (character by character,
    as ``tokenizers``' ``Lowercase``)."""
    text = unicodedata.normalize("NFC", text)
    out: List[str] = []
    for c in text:
        if not is_whitespace(c):
            out.append(c.lower())
        elif not (out and out[-1] == " "):
            out.append(" ")
    return "".join(out)


def _read_bpe(model_dir: str) -> Tuple[Dict[str, int], List[Tuple[str, str]], Optional[Dict[str, Any]]]:
    tokenizer_json = None
    if os.path.isfile(os.path.join(model_dir, "tokenizer.json")):
        tokenizer_json = read_json(os.path.join(model_dir, "tokenizer.json"))
    vocab_path, merges_path = os.path.join(model_dir, "vocab.json"), os.path.join(model_dir, "merges.txt")
    if os.path.isfile(vocab_path) and os.path.isfile(merges_path):
        vocab = read_json(vocab_path)
        with open(merges_path, encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        merges = [tuple(line.split()) for line in lines if line and not line.startswith("#version")]
    elif tokenizer_json is not None and tokenizer_json.get("model", {}).get("type") == "BPE":
        vocab = dict(tokenizer_json["model"]["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in tokenizer_json["model"]["merges"]]
    else:
        raise OSError(f"`{model_dir}` holds neither `vocab.json` and `merges.txt` nor a BPE `tokenizer.json`.")
    return vocab, [m for m in merges if len(m) == 2], tokenizer_json


class _BPE(BaseTokenizer):
    suffix = ""
    bos_role, eos_role = "cls_token", "sep_token"

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], specials: Dict[str, Optional[str]],
                 added: list, model_max_length: Optional[int] = None) -> None:
        super().__init__(vocab, specials, added, model_max_length)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        self._words: Dict[str, List[int]] = {}

    def bpe(self, token: str) -> List[str]:
        word = list(token)
        if self.suffix:
            word[-1] += self.suffix
        while len(word) > 1:
            pairs = [(self.ranks.get((a, b), None), a, b) for a, b in zip(word, word[1:])]
            ranked = [p for p in pairs if p[0] is not None]
            if not ranked:
                break
            _, first, second = min(ranked)
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def word_ids(self, word: str) -> List[int]:
        cached = self._words.get(word)
        if cached is None:
            mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
            unk = self.unk_token_id
            cached = [self.vocab[p] if p in self.vocab else unk for p in self.bpe(mapped)]
            cached = [i for i in cached if i is not None]
            self._words[word] = cached
        return cached

    def pieces(self, text: str) -> List[str]:
        raise NotImplementedError

    def _encode_text(self, text: str) -> List[int]:
        return [i for piece in self.pieces(text) for i in self.word_ids(piece)]

    def _with_specials(self, ids: List[int]) -> List[int]:
        return [self._special_id(self.bos_role)] + ids + [self._special_id(self.eos_role)]


class ByteLevelBPETokenizer(_BPE):
    """RoBERTa's (and GPT-2's) tokenizer: ``<s> ... </s>`` around the byte-level BPE."""

    def __init__(self, *args: Any, add_prefix_space: bool = False, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.add_prefix_space = add_prefix_space

    @classmethod
    def from_pretrained(cls, model_dir: str, config: Dict[str, Any]) -> "ByteLevelBPETokenizer":
        vocab, merges, tokenizer_json = _read_bpe(model_dir)
        defaults = {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>", "cls_token": "<s>",
                    "unk_token": "<unk>", "pad_token": "<pad>", "mask_token": "<mask>"}
        specials = special_tokens(config, defaults)
        added = added_tokens(model_dir, config, specials, tokenizer_json)
        if "mask_token" not in config or not isinstance(config.get("mask_token"), dict):
            # RobertaTokenizer makes its mask token take the space on its left
            added = [t if t.content != specials["mask_token"] else type(t)(t.content, True, t.rstrip) for t in added]
        return cls(vocab, merges, specials, added, config.get("model_max_length"),
                   add_prefix_space=config.get("add_prefix_space", False))

    def pieces(self, text: str) -> List[str]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        return gpt2_split(text)


class CLIPTokenizer(_BPE):
    """CLIP's tokenizer: ``<|startoftext|> ... <|endoftext|>`` around its BPE."""

    suffix = "</w>"
    bos_role, eos_role = "bos_token", "eos_token"

    @classmethod
    def from_pretrained(cls, model_dir: str, config: Dict[str, Any]) -> "CLIPTokenizer":
        vocab, merges, tokenizer_json = _read_bpe(model_dir)
        defaults = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>",
                    "pad_token": "<|endoftext|>"}
        specials = special_tokens(config, defaults)
        added = added_tokens(model_dir, config, specials, tokenizer_json)
        return cls(vocab, merges, specials, added, config.get("model_max_length"))

    def pieces(self, text: str) -> List[str]:
        return [p for piece in clip_split(clip_normalize(text)) for p in gpt2_split(piece)]
