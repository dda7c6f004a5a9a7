"""Tiny Hugging Face snapshot directories for the parity tests of the model-based text
and multimodal metrics, built with ``transformers`` (Flax weights from a
seed, tokenizers saved by ``transformers`` over vocabularies synthesized by
``chip_smoke.py``), and seeded strings for the tokenizer tests.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

import chip_smoke

# the words every test vocabulary covers (lower case): accents, German, CJK, digits
WORDS = ["the", "cat", "sat", "on", "mat", "hello", "there", "world", "general", "kenobi", "master", "a",
         "dog", "runs", "blue", "sky", "over", "lazy", "good", "friend", "über", "café", "naïve", "straße",
         "résumé", "東京", "日本", "1234", "42", "photo", "quality", "bad", "bright", "dark", "sharp"]
SMALL = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 37}


def vocab_words(extra: int = 300, seed: int = 0) -> List[str]:
    rng = random.Random(seed)
    return WORDS + ["".join(rng.choice("abcdefghijklmnop") for _ in range(rng.randint(2, 8))) for _ in range(extra)]


def seeded_texts(n: int, seed: int = 0) -> List[str]:
    """Strings with accents, CJK, digits, punctuation, emoji, control characters, runs of
    mixed whitespace, upper case, over-long words and empty strings."""
    rng = random.Random(seed)
    out = ["", "   ", "hello [MASK] world", "a <mask> b", "x<|endoftext|>y", "don't it's we're I'll"]
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(0, 12)):
            r = rng.random()
            if r < 0.45:
                w = rng.choice(WORDS + ["Über", "CAFÉ", "Ωmega", "ΣΑΣ"])
            elif r < 0.55:
                w = rng.choice(list("!?.,;:'\"()-—…«»"))
            elif r < 0.65:
                w = str(rng.randint(0, 99999))
            elif r < 0.75:
                w = "".join(rng.choice("日本語中文字") for _ in range(rng.randint(1, 3)))
            elif r < 0.82:
                w = rng.choice(["😀", "🎉", "👍🏽", "​", "\x00", "\x07", "é", "é"])
            else:
                w = "".join(rng.choice("abcdefghij") for _ in range(rng.randint(1, 130 if rng.random() < 0.1 else 8)))
            parts.append(w.upper() if rng.random() < 0.2 else w)
            parts.append(rng.choice([" ", "  ", "\t", "\n", "   ", "　", "\xa0", "", " "]))
        out.append("".join(parts))
    return out


def wordpiece_files(d: str, cased: bool = False, json_only: bool = False) -> None:
    """``vocab.txt`` (or, ``json_only``, only ``tokenizer.json``) and the tokenizer config
    of a BERT tokenizer saved by ``transformers``."""
    from transformers import BertTokenizerFast

    os.makedirs(d, exist_ok=True)
    tokens = chip_smoke.synth_wordpiece_vocab(vocab_words() + [w.capitalize() for w in WORDS], 900)
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(tokens) + "\n")
    BertTokenizerFast(vocab_file=os.path.join(d, "vocab.txt"), do_lower_case=not cased).save_pretrained(d)
    if json_only:
        os.remove(os.path.join(d, "vocab.txt"))
    else:
        os.remove(os.path.join(d, "tokenizer.json"))


def bpe_files(d: str, clip: bool = False, size: int = 1500) -> None:
    """``vocab.json`` and ``merges.txt`` with the tokenizer config saved by ``transformers``
    (RoBERTa's or CLIP's)."""
    from transformers import CLIPTokenizer, RobertaTokenizer

    os.makedirs(d, exist_ok=True)
    vocab, merges = chip_smoke.synth_bpe_vocab(vocab_words(), size, clip=clip)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump(vocab, fh, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    cls = CLIPTokenizer if clip else RobertaTokenizer
    cls(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")).save_pretrained(d)


def encoder_snapshot(d: str, kind: str = "bert", masked_lm: bool = False, seed: int = 0,
                     max_positions: int = 64, cased: bool = False, initializer_range: float = 0.02) -> str:
    """A BERT or RoBERTa snapshot (``flax_model.msgpack``) of 2 layers at width 32."""
    from transformers import BertConfig, FlaxBertForMaskedLM, FlaxBertModel, FlaxRobertaForMaskedLM, FlaxRobertaModel
    from transformers import RobertaConfig

    if kind == "bert":
        wordpiece_files(d, cased=cased)
        vocab = sum(1 for _ in open(os.path.join(d, "vocab.txt"), encoding="utf-8"))
        config = BertConfig(vocab_size=vocab, max_position_embeddings=max_positions,
                            initializer_range=initializer_range, **SMALL)
        cls = FlaxBertForMaskedLM if masked_lm else FlaxBertModel
    else:
        bpe_files(d)
        config = RobertaConfig(vocab_size=1500, max_position_embeddings=max_positions + 2,
                               initializer_range=initializer_range, **SMALL)
        cls = FlaxRobertaForMaskedLM if masked_lm else FlaxRobertaModel
    cls(config, seed=seed).save_pretrained(d)
    return d


def clip_snapshot(d: str, seed: int = 0, eos_token_id: int = 49407, image_size: int = 30, patch_size: int = 6,
                  shortest_edge: int = 0) -> str:
    """A CLIP snapshot (``flax_model.msgpack``) of 2 + 2 layers at width 32, CLIP's BPE and
    an image processor resizing the shortest edge to ``shortest_edge`` (the image size)."""
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPProcessor, CLIPTokenizer, FlaxCLIPModel

    bpe_files(d, clip=True)
    text = dict(SMALL, vocab_size=1500, max_position_embeddings=77, eos_token_id=eos_token_id)
    vision = dict(SMALL, image_size=image_size, patch_size=patch_size)
    FlaxCLIPModel(CLIPConfig(text_config=text, vision_config=vision, projection_dim=16), seed=seed).save_pretrained(d)
    edge = shortest_edge or image_size
    processor = CLIPImageProcessor(size={"shortest_edge": edge}, crop_size={"height": image_size, "width": image_size})
    tokenizer = CLIPTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))
    CLIPProcessor(image_processor=processor, tokenizer=tokenizer).save_pretrained(d)
    return d
