"""SacreBLEU score.

Counterpart of ``torchmetrics_tpu/functional/text/sacre_bleu.py``: the same tokenizer
family, ``none``, ``13a``, ``zh``, ``intl`` and ``char`` as regular expressions, and
``ja-mecab``/``ko-mecab`` through MeCab. ``intl`` needs the ``regex`` package and the
MeCab tokenizers their dictionaries; without them those tokenizers raise, as JAX's do.
"""

from __future__ import annotations

import re
from functools import partial
from typing import ClassVar, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update
from torchmetrics_tpu_torch.utils.checks import _resolve_device
from torchmetrics_tpu_torch.utils.imports import _REGEX_AVAILABLE

Tensor = torch.Tensor

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char", "ja-mecab", "ko-mecab")

_UCODE_RANGES = (
    ("\u3400", "\u4db5"),
    ("\u4e00", "\u9fa5"),
    ("\u9fa6", "\u9fbb"),
    ("\uf900", "\ufa2d"),
    ("\ufa30", "\ufa6a"),
    ("\ufa70", "\ufad9"),
    ("\U00020000", "\U0002a6d6"),
    ("\U0002f800", "\U0002fa1d"),
    ("\uff00", "\uffef"),
    ("\u2e80", "\u2eff"),
    ("\u3000", "\u303f"),
    ("\u31c0", "\u31ef"),
    ("\u2f00", "\u2fdf"),
    ("\u2ff0", "\u2fff"),
    ("\u3100", "\u312f"),
    ("\u31a0", "\u31bf"),
    ("\ufe10", "\ufe1f"),
    ("\ufe30", "\ufe4f"),
    ("\u2600", "\u26ff"),
    ("\u2700", "\u27bf"),
    ("\u3200", "\u32ff"),
    ("\u3300", "\u33ff"),
)


class _SacreBLEUTokenizer:
    """The sacrebleu tokenizer family (mteval-v13a/v14 compatible regex pipelines)."""

    _REGEX = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )

    # compiled at the first ``intl`` call: importing the port never imports ``regex``
    _INT_REGEX: ClassVar[tuple] = ()

    _TOKENIZE_FN: ClassVar[dict] = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
        "ja-mecab": "_tokenize_ja_mecab",
        "ko-mecab": "_tokenize_ko_mecab",
    }

    # lazily constructed MeCab taggers (per-tokenizer); building one loads the
    # dictionary from disk/network mounts — a retried resource init, see
    # ``_mecab_tagger``
    _MECAB_TAGGERS: ClassVar[dict] = {}

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        self._check_tokenizers_validity(tokenize)
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized_line = self.tokenize_fn(line)
        return self._lower(tokenized_line, self.lowercase).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        """One-shot tokenization used by the functional API."""
        cls._check_tokenizers_validity(tokenize)
        tokenize_fn = getattr(cls, cls._TOKENIZE_FN[tokenize])
        tokenized_line = tokenize_fn(line)
        return cls._lower(tokenized_line, lowercase).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for _re, repl in cls._REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"')
            line = line.replace("&amp;", "&")
            line = line.replace("&lt;", "<")
            line = line.replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        line_in_chars = ""
        for char in line:
            if cls._is_chinese_char(char):
                line_in_chars += f" {char} "
            else:
                line_in_chars += char
        return cls._tokenize_regex(line_in_chars)

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        if not _REGEX_AVAILABLE:
            raise ModuleNotFoundError(
                "The `intl` tokenizer requires that the `regex` package is installed."
                " Use `pip install regex`."
            )
        if not cls._INT_REGEX:
            import regex

            cls._INT_REGEX = (
                (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
                (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
                (regex.compile(r"(\p{S})"), r" \1 "),
            )
        for _re, repl in cls._INT_REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line.strip())

    @classmethod
    def _mecab_tagger(cls, tokenize: str):
        """Build (once) the MeCab tagger behind ``ja-mecab``/``ko-mecab``.

        Tagger construction loads the dictionary resources — on pods these often
        live on network mounts, so the init is retried through the robust layer
        before giving up (reference sacrebleu downloads them outright).
        """
        if tokenize in cls._MECAB_TAGGERS:
            return cls._MECAB_TAGGERS[tokenize]
        import MeCab

        from torchmetrics_tpu_torch.robust.retry import RetrySchedule, retry_call

        def _build():
            if tokenize == "ja-mecab":
                import ipadic

                tagger = MeCab.Tagger(ipadic.MECAB_ARGS + " -Owakati")
            else:
                import mecab_ko_dic

                tagger = MeCab.Tagger(mecab_ko_dic.MECAB_ARGS + " -Owakati")
            tagger.parse("")  # force the dictionary load; raises on a torn resource
            return tagger

        # ModuleNotFoundError is deterministic — only I/O-shaped failures retry
        tagger = retry_call(
            _build,
            schedule=RetrySchedule(max_attempts=3, base_delay=1.0),
            retry_on=(RuntimeError, OSError),
            description=f"MeCab dictionary init for {tokenize!r}",
        )
        cls._MECAB_TAGGERS[tokenize] = tagger
        return tagger

    @classmethod
    def _tokenize_ja_mecab(cls, line: str) -> str:
        return cls._mecab_tagger("ja-mecab").parse(line.strip()).strip()

    @classmethod
    def _tokenize_ko_mecab(cls, line: str) -> str:
        return cls._mecab_tagger("ko-mecab").parse(line.strip()).strip()

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line

    @classmethod
    def _check_tokenizers_validity(cls, tokenize: str) -> None:
        if tokenize in ("ja-mecab", "ko-mecab"):
            from torchmetrics_tpu_torch.utils.imports import (
                _IPADIC_AVAILABLE,
                _MECAB_AVAILABLE,
                _MECAB_KO_DIC_AVAILABLE,
            )

            dic_name = "ipadic" if tokenize == "ja-mecab" else "mecab_ko_dic"
            dic_ok = _IPADIC_AVAILABLE if tokenize == "ja-mecab" else _MECAB_KO_DIC_AVAILABLE
            if not _MECAB_AVAILABLE or not dic_ok:
                raise ModuleNotFoundError(
                    f"The `{tokenize}` tokenizer requires the `mecab` and `{dic_name}`"
                    " dependencies, which are not installed in this environment."
                    " Install the matching mecab packages to use it."
                )
        if tokenize not in cls._TOKENIZE_FN:
            raise ValueError(
                f"Unsupported tokenizer selected. Please, choose one of {list(cls._TOKENIZE_FN)}"
            )


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tensor:
    """Compute the SacreBLEU score of machine-translated text against references, on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import sacre_bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu_score(preds, target, device="cpu").round(decimals=4)
        tensor(0.7598)
    """
    device = _resolve_device(device)
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    tokenize_fn = partial(_SacreBLEUTokenizer.tokenize, tokenize=tokenize, lowercase=lowercase)
    preds_len, target_len = _bleu_score_update(
        preds, target, numerator, denominator, 0.0, 0.0, n_gram, tokenize_fn
    )
    return _bleu_score_compute(
        preds_len, target_len, torch.tensor(numerator, dtype=torch.float32, device=device),
        torch.tensor(denominator, dtype=torch.float32, device=device), n_gram, weights, smooth
    )
