"""The port's tokenizers and CLIP image processor (``utils/hf``) against what the JAX
package's ``AutoTokenizer`` / ``CLIPProcessor`` load from the same directory.

Token ids and attention masks must be equal exactly, on seeded strings with accents,
CJK, digits, punctuation, emoji, control characters, runs of mixed whitespace, special
tokens and empty strings; ``pixel_values`` must be bitwise equal for downscales,
upscales, odd sizes, non-square images and a crop larger than the image.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tests.helpers import hf_snapshots  # noqa: E402
from torchmetrics_tpu_torch.utils.hf import bpe  # noqa: E402
from torchmetrics_tpu_torch.utils.hf.image_processor import CLIPImageProcessor, pil_coefficients  # noqa: E402
from torchmetrics_tpu_torch.utils.hf.tokenizer import load_tokenizer  # noqa: E402

transformers = pytest.importorskip("transformers")

TEXTS = hf_snapshots.seeded_texts(160, seed=3)
PADDINGS = (True, "max_length")


def _assert_same(hf, port, padding, max_length=24, truncation=True):
    want = hf(TEXTS, padding=padding, truncation=truncation, max_length=max_length, return_tensors="np")
    got = port(TEXTS, padding=padding, truncation=truncation, max_length=max_length)
    for key in ("input_ids", "attention_mask"):
        assert got[key].shape == want[key].shape, key
        bad = [i for i in range(len(TEXTS)) if not np.array_equal(got[key][i], want[key][i])]
        assert not bad, (key, repr(TEXTS[bad[0]]), want[key][bad[0]], got[key][bad[0]])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    out = {}
    for name, kw in (("uncased", {}), ("cased", {"cased": True}), ("json_only", {"json_only": True})):
        hf_snapshots.wordpiece_files(str(root / name), **kw)
        out[name] = str(root / name)
    hf_snapshots.bpe_files(str(root / "roberta"))
    out["roberta"] = str(root / "roberta")
    d = str(root / "clip")
    hf_snapshots.bpe_files(d, clip=True)
    proc = transformers.CLIPProcessor(image_processor=transformers.CLIPImageProcessor(),
                                      tokenizer=transformers.CLIPTokenizer(d + "/vocab.json", d + "/merges.txt"))
    proc.save_pretrained(d)
    out["clip"] = d
    return out


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("kind", ["uncased", "cased", "json_only"])
def test_wordpiece_ids_equal_auto_tokenizer(dirs, kind, padding):
    hf = transformers.AutoTokenizer.from_pretrained(dirs[kind], local_files_only=True)
    assert type(hf).__name__ == "BertTokenizerFast"
    port = load_tokenizer(dirs[kind], "bert")
    _assert_same(hf, port, padding)
    assert (port.pad_token_id, port.cls_token_id, port.sep_token_id, port.mask_token_id) == \
        (hf.pad_token_id, hf.cls_token_id, hf.sep_token_id, hf.mask_token_id)


@pytest.mark.parametrize("padding", PADDINGS)
def test_byte_level_bpe_ids_equal_auto_tokenizer(dirs, padding):
    hf = transformers.AutoTokenizer.from_pretrained(dirs["roberta"], local_files_only=True)
    assert type(hf).__name__ == "RobertaTokenizerFast"
    port = load_tokenizer(dirs["roberta"], "roberta")
    _assert_same(hf, port, padding)
    assert (port.pad_token_id, port.cls_token_id, port.sep_token_id, port.mask_token_id) == \
        (hf.pad_token_id, hf.cls_token_id, hf.sep_token_id, hf.mask_token_id)


@pytest.mark.parametrize("padding, truncation", [(True, True), ("max_length", True), (True, False)])
def test_clip_bpe_ids_equal_the_processor_s_tokenizer(dirs, padding, truncation):
    hf = transformers.CLIPProcessor.from_pretrained(dirs["clip"], local_files_only=True).tokenizer
    assert type(hf).__name__ == "CLIPTokenizerFast"
    port = load_tokenizer(dirs["clip"], "clip")
    _assert_same(hf, port, padding, max_length=None if not truncation else 24, truncation=truncation)


def test_a_tokenizer_json_alone_gives_the_vocabulary_of_vocab_txt(dirs):
    a, b = load_tokenizer(dirs["json_only"]), load_tokenizer(dirs["uncased"])
    assert a.vocab == b.vocab and a(TEXTS, padding=True)["input_ids"].tolist() == \
        b(TEXTS, padding=True)["input_ids"].tolist()


def test_the_pre_tokenizer_scanners_equal_the_regexes():
    regex = pytest.importorskip("regex")
    gpt2 = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    clip = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
    for text in TEXTS:
        assert bpe.gpt2_split(text) == gpt2.findall(text), repr(text)
        normalized = bpe.clip_normalize(text)
        assert bpe.clip_split(normalized) == clip.findall(normalized), repr(normalized)


def test_an_unknown_tokenizer_kind_raises_naming_the_roadmap(tmp_path):
    (tmp_path / "tokenizer_config.json").write_text('{"tokenizer_class": "T5Tokenizer"}')
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        load_tokenizer(str(tmp_path))


# ------------------------------------------------------------------ the image processor

IMAGE_CASES = {
    "copy_at_equal_size": ((30, 30), 30, 30),
    "downscale_non_square": ((64, 48), 30, 28),
    "upscale_odd": ((17, 23), 30, 30),
    "coco_to_224": ((480, 640), 224, 224),
    "wide_odd": ((31, 97), 24, 40),
    "crop_larger_than_image": ((10, 12), 8, 30),
    "tall_thin": ((100, 7), 5, 5),
    "upscale_square": ((20, 20), 40, 40),
    "koniq_to_224": ((768, 1024), 224, 224),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_pixel_values_are_bitwise_clip_image_processor_s(case):
    (h, w), edge, crop = IMAGE_CASES[case]
    rng = np.random.RandomState(len(case))
    images = [rng.randint(0, 256, (3, h, w)).astype(np.uint8) for _ in range(3)]
    hf = transformers.CLIPImageProcessor(size={"shortest_edge": edge}, crop_size={"height": crop, "width": crop})
    want = hf(images, return_tensors="np")["pixel_values"]
    got = CLIPImageProcessor(hf.to_dict())([torch.from_numpy(i) for i in images]).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fixed_point_weights_sum_to_one_and_follow_pil_s_support():
    starts, weights = pil_coefficients(640, 298)
    scale = 640 / 298
    assert max(len(w) for w in weights) == int(np.ceil(2 * scale)) * 2 + 1 - 2  # taps clipped to the image
    for w in weights:
        assert abs(sum(w) - (1 << 22)) <= len(w)
    assert starts[0] == 0 and starts[-1] + len(weights[-1]) == 640
