"""The port's translation metrics (BLEU, SacreBLEU, chrF/chrF++, TER, EED), held against
the JAX package on the CPU.

The cases of ``tests/text/test_text.py`` (BLEU at two n-gram orders with and without
smoothing, SacreBLEU for each tokenizer and case, chrF with and without word n-grams and
whitespace, its sentence-level scores, TER with and without normalisation, EED with its
sentence scores) and ``tests/text/test_text_stream_sweep.py``'s multi-reference streams
run through both packages, held against JAX rather than the reference. Added: seeded
corpora with one to three references, empty strings, a one-word hypothesis and unicode;
every SacreBLEU tokenizer that runs here (``none``, ``13a``, ``zh``, ``intl``, ``char``)
token for token, and the MeCab ones raising as JAX's do; custom BLEU weights; TER's
Tercom options; EED in Japanese and with other costs, and its row sweep against JAX's
bit for bit on random pairs; each class over three batches, ``merge_states`` of
two halves, and a JAX state dict loaded and updated further; the validation messages.

Tolerances: n-gram counts, lengths and edit counts exactly; scores and per-sentence
lists within 1e-6.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.functional.text as jf  # noqa: E402
import torchmetrics_tpu.text as jt  # noqa: E402
import torchmetrics_tpu_torch.functional.text as tf  # noqa: E402
import torchmetrics_tpu_torch.text as tt  # noqa: E402
from tests.test_torch_text_error_rates import (  # noqa: E402
    assert_close,
    assert_states_equal,
    jax_state_goes_on,
    merged_value,
    np_value,
    random_sentences,
    stream_corpus,
)

CORPUS_PREDS = ["the cat is on the mat", "a dog walks in the park"]
CORPUS_TARGET = [
    ["there is a cat on the mat", "a cat is on the mat"],
    ["a dog walks in the park at night"],
]


def multi_reference_corpus(seed: int, n: int) -> tuple:
    """(hypotheses, references): one to three references a hypothesis, with empty
    strings, a one-word hypothesis, punctuation and unicode."""
    rng = random.Random(seed)
    refs = [random_sentences(seed + 100 * k, n, empty=k == 0) for k in range(3)]
    target = [[refs[k][i] for k in range(rng.randint(1, 3))] for i in range(n)]
    target[0] = ["a reference.", "another, reference!"]
    hyps = []
    for i in range(n):
        words = target[i][0].split()
        hyps.append(" ".join(w for w in words if rng.random() > 0.3) + (" über" if rng.random() < 0.3 else ""))
    hyps[0], hyps[1] = "", "reference"
    return hyps, target


def _batches(seed: int, n: int = 3, size: int = 5) -> list:
    return [multi_reference_corpus(seed + i, size) for i in range(n)]


CORPORA = {
    "corpus": (CORPUS_PREDS, CORPUS_TARGET),
    "stream": (stream_corpus(4, 0), [[t, t2] for t, t2 in zip(stream_corpus(4, 70), stream_corpus(4, 90))]),
    "unicode": multi_reference_corpus(5, 8),
    "single": (["cat"], [["the cat"]]),
}

FUNCTIONS = {
    "bleu_score": {},
    "bleu_score_smooth_2": {"n_gram": 2, "smooth": True},
    "bleu_score_weights": {"weights": [0.4, 0.3, 0.2, 0.1]},
    "sacre_bleu_score": {},
    "sacre_bleu_score_intl": {"tokenize": "intl", "lowercase": True},
    "sacre_bleu_score_zh": {"tokenize": "zh"},
    "chrf_score": {},
    "chrf_score_chrf": {"n_word_order": 0},
    "chrf_score_sentences": {"return_sentence_level_score": True, "whitespace": True, "lowercase": True},
    "translation_edit_rate": {},
    "translation_edit_rate_tercom": {"normalize": True, "no_punctuation": True, "asian_support": True,
                                     "lowercase": False, "return_sentence_level_score": True},
    "extended_edit_distance": {"return_sentence_level_score": True},
    "extended_edit_distance_ja": {"language": "ja", "alpha": 1.5, "rho": 0.4, "deletion": 0.3, "insertion": 1.5},
}
CLASSES = {
    "BLEUScore": {},
    "BLEUScore_smooth_2": {"n_gram": 2, "smooth": True},
    "SacreBLEUScore": {},
    "SacreBLEUScore_intl": {"tokenize": "intl", "lowercase": True},
    "SacreBLEUScore_char": {"tokenize": "char"},
    "CHRFScore": {},
    "CHRFScore_chrf": {"n_word_order": 0},
    "CHRFScore_sentences": {"return_sentence_level_score": True, "whitespace": True},
    "TranslationEditRate": {},
    "TranslationEditRate_tercom": {"normalize": True, "no_punctuation": True, "return_sentence_level_score": True},
    "ExtendedEditDistance": {},
    "ExtendedEditDistance_sentences": {"return_sentence_level_score": True},
}
SCORE_STATES = ("sentence_",)


def _function_name(case: str) -> str:
    for name in ("bleu_score", "sacre_bleu_score", "chrf_score", "translation_edit_rate", "extended_edit_distance"):
        if case.startswith(name):
            return name
    raise KeyError(case)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_functionals_equal_jax(case, corpus):
    name, kw = _function_name(case), FUNCTIONS[case]
    preds, target = CORPORA[corpus]
    assert_close(getattr(tf, name)(preds, target, device="cpu", **kw), getattr(jf, name)(preds, target, **kw))


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram", [1, 2, 4])
def test_bleu_equals_jax(smooth, n_gram):
    port, jax_metric = tt.BLEUScore(n_gram=n_gram, smooth=smooth, device="cpu"), jt.BLEUScore(n_gram=n_gram,
                                                                                               smooth=smooth)
    port.update(CORPUS_PREDS, CORPUS_TARGET)
    jax_metric.update(CORPUS_PREDS, CORPUS_TARGET)
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


TOKENIZERS = ["none", "13a", "zh", "intl", "char"]
TOKENIZER_LINES = ["Hello, World! It's 3.5 km -- e.g. U.S. &amp; &lt;b&gt;", "中文字符和日本語のテキスト。",
                   "Straße über Äpfel: naïve café (yes) 1,000.50", "  spaced   out\n- line  ", "emoji 🙂 ok?!",
                   ""]


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", TOKENIZERS)
def test_sacre_bleu_tokenizers_equal_jax(tokenize, lowercase):
    from torchmetrics_tpu.functional.text.sacre_bleu import _SacreBLEUTokenizer as JTok
    from torchmetrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer as TTok

    for line in TOKENIZER_LINES:
        assert TTok.tokenize(line, tokenize, lowercase) == JTok.tokenize(line, tokenize, lowercase)
        assert TTok(tokenize, lowercase)(line) == JTok(tokenize, lowercase)(line)
    port = tt.SacreBLEUScore(tokenize=tokenize, lowercase=lowercase, device="cpu")
    jax_metric = jt.SacreBLEUScore(tokenize=tokenize, lowercase=lowercase)
    for preds, target in ((CORPUS_PREDS, CORPUS_TARGET), multi_reference_corpus(8, 6)):
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("tokenize", ["ja-mecab", "ko-mecab"])
def test_the_mecab_tokenizers_raise_as_jax_does_without_mecab(tokenize):
    from torchmetrics_tpu_torch.utils.imports import _IPADIC_AVAILABLE, _MECAB_AVAILABLE, _MECAB_KO_DIC_AVAILABLE

    if _MECAB_AVAILABLE and (_IPADIC_AVAILABLE if tokenize == "ja-mecab" else _MECAB_KO_DIC_AVAILABLE):
        pytest.skip("MeCab and its dictionary are installed")
    with pytest.raises(ModuleNotFoundError) as port_err:
        tt.SacreBLEUScore(tokenize=tokenize, device="cpu")
    with pytest.raises(ModuleNotFoundError) as jax_err:
        jt.SacreBLEUScore(tokenize=tokenize)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("whitespace", [False, True])
@pytest.mark.parametrize("n_word_order", [0, 1, 2])
def test_chrf_equals_jax(n_word_order, whitespace):
    kw = {"n_word_order": n_word_order, "whitespace": whitespace, "return_sentence_level_score": True}
    port, jax_metric = tt.CHRFScore(device="cpu", **kw), jt.CHRFScore(**kw)
    for preds, target in ((CORPUS_PREDS, CORPUS_TARGET), multi_reference_corpus(9, 6)):
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric, SCORE_STATES)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("asian_support", [False, True])
def test_ter_equals_jax(normalize, asian_support):
    kw = {"normalize": normalize, "asian_support": asian_support, "return_sentence_level_score": True}
    port, jax_metric = tt.TranslationEditRate(device="cpu", **kw), jt.TranslationEditRate(**kw)
    for preds, target in ((CORPUS_PREDS, CORPUS_TARGET), multi_reference_corpus(10, 6)):
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric, SCORE_STATES)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("seed", range(3))
def test_ter_of_random_token_lists_equals_jax(seed):
    from torchmetrics_tpu.functional.text.ter import _translation_edit_rate as jter
    from torchmetrics_tpu_torch.functional.text.ter import _translation_edit_rate as tter

    rng = random.Random(seed)
    vocab = ["a", "b", "c", "d", "the", "cat", "mat", "on"]
    for _ in range(60):
        ref = [rng.choice(vocab) for _ in range(rng.randint(0, 25))]
        hyp = ref[:]
        rng.shuffle(hyp) if rng.random() < 0.5 else None
        hyp = [w for w in hyp if rng.random() > 0.2] + [rng.choice(vocab) for _ in range(rng.randint(0, 4))]
        assert tter(hyp, ref) == jter(hyp, ref)


@pytest.mark.parametrize("seed", range(3))
def test_eed_of_random_pairs_equals_jax_bit_for_bit(seed):
    from torchmetrics_tpu.functional.text.eed import _eed_function as jeed
    from torchmetrics_tpu_torch.functional.text.eed import _eed_function as teed

    rng = random.Random(seed)
    sentences = random_sentences(seed, 90, max_words=30)
    pairs = [(f" {rng.choice(sentences)} ", f" {rng.choice(sentences)} ") for _ in range(150)]
    pairs += [("", " a "), (" a ", "")]
    costs = [(2.0, 0.3, 0.2, 1.0), (1.0, 0.5, 0.35, 2.0)][seed % 2]
    assert [teed(h, r, *costs) for h, r in pairs] == [jeed(h, r, *costs) for h, r in pairs]


@pytest.mark.parametrize("language", ["en", "ja"])
def test_eed_equals_jax(language):
    port = tt.ExtendedEditDistance(language=language, return_sentence_level_score=True, device="cpu")
    jax_metric = jt.ExtendedEditDistance(language=language, return_sentence_level_score=True)
    for preds, target in (BATCH for BATCH in (("this is the prediction", "this is the reference"),
                                                multi_reference_corpus(12, 7))):
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric, SCORE_STATES)
    assert_close(port.compute(), jax_metric.compute())


def _cls(name: str):
    return getattr(tt, name.split("_")[0]), getattr(jt, name.split("_")[0])


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_classes_over_batches_equal_jax(name):
    kw = CLASSES[name]
    port_cls, jax_cls = _cls(name)
    port, jax_metric = port_cls(device="cpu", **kw), jax_cls(**kw)
    for preds, target in _batches(40):
        assert_close(port(preds, target), jax_metric(preds, target))
    assert_states_equal(port, jax_metric, SCORE_STATES)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_multi_reference_streams_equal_jax(name):
    """``test_text_stream_sweep.py``'s three-step multi-reference streams."""
    kw = CLASSES[name]
    port_cls, jax_cls = _cls(name)
    port, jax_metric = port_cls(device="cpu", **kw), jax_cls(**kw)
    for step in range(3):
        preds = stream_corpus(4, step)
        target = [[t, t2] for t, t2 in zip(stream_corpus(4, step + 70), stream_corpus(4, step + 90))]
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric, SCORE_STATES)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_merged_halves_equal_one_metric_fed_everything(name):
    kw = CLASSES[name]
    port_cls, jax_cls = _cls(name)
    batches = _batches(50, n=4)
    merged, whole, _ = merged_value(lambda: port_cls(device="cpu", **kw), batches)
    assert_close(merged, whole, atol=0.0)
    jax_metric = jax_cls(**kw)
    for b in batches:
        jax_metric.update(*b)
    assert_close(merged, jax_metric.compute())


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_a_jax_state_loaded_into_the_port_goes_on_equal(name):
    kw = CLASSES[name]
    port_cls, jax_cls = _cls(name)
    got, want = jax_state_goes_on(lambda: port_cls(device="cpu", **kw), lambda: jax_cls(**kw), _batches(60),
                                  SCORE_STATES)
    assert_close(got, want)


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_validation_messages_equal_jax():
    constructors = [
        ("BLEUScore", {"n_gram": 2, "weights": [1.0]}),
        ("SacreBLEUScore", {"tokenize": "klingon"}),
        ("CHRFScore", {"n_char_order": 0}),
        ("CHRFScore", {"n_word_order": -1}),
        ("CHRFScore", {"beta": -1.0}),
        ("TranslationEditRate", {"normalize": 1}),
        ("TranslationEditRate", {"no_punctuation": "no"}),
        ("TranslationEditRate", {"lowercase": None}),
        ("TranslationEditRate", {"asian_support": 0}),
        ("ExtendedEditDistance", {"language": "de"}),
        ("ExtendedEditDistance", {"alpha": -1.0}),
        ("ExtendedEditDistance", {"rho": 1}),
    ]
    for name, kw in constructors:
        assert _message(lambda: getattr(tt, name)(device="cpu", **kw)) == _message(lambda: getattr(jt, name)(**kw))
    functionals = [
        ("bleu_score", (["a"], [["a"], ["b"]]), {}),
        ("bleu_score", (["a"], [["a"]]), {"weights": [0.5]}),
        ("sacre_bleu_score", (["a", "b"], [["a"]]), {}),
        ("sacre_bleu_score", (["a"], [["a"]]), {"n_gram": 3, "weights": [0.5]}),
        ("chrf_score", (["a"], [["a"]]), {"n_char_order": 0}),
        ("chrf_score", (["a", "b"], [["a"], ["b"], ["c"]]), {}),
        ("translation_edit_rate", (["a"], [["a"]]), {"normalize": "yes"}),
        ("translation_edit_rate", (["a", "b", "c"], [["a"], ["b"]]), {}),
        ("extended_edit_distance", (["a"], [["a"]]), {"language": "fr"}),
        ("extended_edit_distance", (["a"], [["a"]]), {"insertion": 1}),
    ]
    for name, args, kw in functionals:
        assert _message(lambda: getattr(tf, name)(*args, device="cpu", **kw)) == _message(
            lambda: getattr(jf, name)(*args, **kw))
    assert _message(lambda: tt.BLEUScore(device="cpu").update(["a", "b"], [["a"]])) == _message(
        lambda: jt.BLEUScore().update(["a", "b"], [["a"]]))
    from torchmetrics_tpu.functional.text.eed import _preprocess_en as jpre
    from torchmetrics_tpu_torch.functional.text.eed import _preprocess_en as tpre

    assert _message(lambda: tpre(3)) == _message(lambda: jpre(3))


def test_sentence_scores_are_float32_tensors_on_the_metric_device():
    port = tt.TranslationEditRate(return_sentence_level_score=True, device="cpu")
    port.update(*multi_reference_corpus(13, 4))
    corpus, sentences = port.compute()
    assert corpus.dtype == sentences.dtype == torch.float32 and sentences.shape == (4,)
    np.testing.assert_array_equal(np_value(sentences), np_value(port.sentence_ter[0]))
