"""BERT's WordPiece tokenizer, as ``transformers``' ``BertTokenizerFast`` runs it.

The fast tokenizer's pipeline: ``BertNormalizer`` (drop control characters and map
whitespace to a space, space out CJK ideographs, strip accents, lower-case),
``BertPreTokenizer`` (split on whitespace, isolate each punctuation mark), the
``WordPiece`` model (greedy longest match with a ``##`` continuation prefix; a word of
more than 100 characters, or one that cannot be covered, becomes ``[UNK]``), and the
``[CLS] ... [SEP]`` post-processor. The settings come from ``tokenizer_config.json``
the way ``BertTokenizerFast.__init__`` takes them (``do_lower_case`` defaults to true
and, with ``strip_accents`` unset, ties accent stripping to lower-casing), the
vocabulary from ``vocab.txt`` or, where only that exists, ``tokenizer.json``.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Any, Dict, List, Optional

from torchmetrics_tpu_torch.utils.hf.snapshot import read_json
from torchmetrics_tpu_torch.utils.hf.tokenizer import BaseTokenizer, added_tokens, is_whitespace, special_tokens

# the code points ``tokenizers``' BertNormalizer spaces out as CJK ideographs
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F), (0x2B740, 0x2B81F),
    (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)
_DEFAULT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]", "cls_token": "[CLS]",
                     "mask_token": "[MASK]"}


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c) in ("Cc", "Cf", "Cn", "Co", "Cs")


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punctuation(c: str) -> bool:
    return (c.isascii() and not c.isalnum() and 33 <= ord(c) <= 126) or unicodedata.category(c)[0] == "P"


class WordPieceTokenizer(BaseTokenizer):
    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True, strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True, clean_text: bool = True, specials: Optional[dict] = None,
                 added: Optional[list] = None, model_max_length: Optional[int] = None,
                 continuing_subword_prefix: str = "##", max_input_chars_per_word: int = 100) -> None:
        specials = dict(_DEFAULT_SPECIALS, **(specials or {}))
        super().__init__(vocab, specials, added if added is not None else [], model_max_length)
        self.do_lower_case = do_lower_case
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.clean_text = clean_text
        self.prefix = continuing_subword_prefix
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk = specials["unk_token"]

    @classmethod
    def from_pretrained(cls, model_dir: str, config: Dict[str, Any]) -> "WordPieceTokenizer":
        tokenizer_json = None
        if os.path.isfile(os.path.join(model_dir, "tokenizer.json")):
            tokenizer_json = read_json(os.path.join(model_dir, "tokenizer.json"))
        vocab_path = os.path.join(model_dir, "vocab.txt")
        model = (tokenizer_json or {}).get("model", {})
        if os.path.isfile(vocab_path):
            with open(vocab_path, encoding="utf-8") as fh:
                # a token's id is its line (a repeated token keeps its last line, as in transformers)
                vocab = {line.rstrip("\n"): i for i, line in enumerate(fh)}
        elif model.get("type") == "WordPiece":
            vocab = dict(model["vocab"])
        else:
            raise OSError(f"`{model_dir}` holds neither `vocab.txt` nor a WordPiece `tokenizer.json`.")
        normalizer = (tokenizer_json or {}).get("normalizer") or {}
        specials = special_tokens(config, _DEFAULT_SPECIALS)
        return cls(
            vocab,
            do_lower_case=config.get("do_lower_case", True),
            strip_accents=config.get("strip_accents"),
            tokenize_chinese_chars=config.get("tokenize_chinese_chars", True),
            clean_text=normalizer.get("clean_text", True),
            specials=specials,
            added=added_tokens(model_dir, config, specials, tokenizer_json),
            model_max_length=config.get("model_max_length"),
            continuing_subword_prefix=model.get("continuing_subword_prefix", "##"),
            max_input_chars_per_word=model.get("max_input_chars_per_word", 100),
        )

    def normalize(self, text: str) -> str:
        if self.clean_text:
            text = "".join(" " if is_whitespace(c) else c for c in text
                           if not (c in "\x00\ufffd" or _is_control(c)))
        if self.tokenize_chinese_chars:
            text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text) if unicodedata.category(c) != "Mn")
        if self.do_lower_case:
            text = "".join(c.lower() for c in text)
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        words: List[str] = []
        current: List[str] = []
        for c in text:
            if is_whitespace(c) or _is_punctuation(c):
                if current:
                    words.append("".join(current))
                    current = []
                if not is_whitespace(c):
                    words.append(c)
            else:
                current.append(c)
        if current:
            words.append("".join(current))
        return words

    def word_ids(self, word: str) -> List[int]:
        if len(word) > self.max_input_chars_per_word:
            return [self.vocab[self.unk]]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            found = None
            while start < end:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.vocab:
                    found = self.vocab[piece]
                    break
                end -= 1
            if found is None:
                return [self.vocab[self.unk]]
            ids.append(found)
            start = end
        return ids

    def _encode_text(self, text: str) -> List[int]:
        return [i for word in self.pre_tokenize(self.normalize(text)) for i in self.word_ids(word)]

    def _with_specials(self, ids: List[int]) -> List[int]:
        return [self.cls_token_id] + ids + [self.sep_token_id]
