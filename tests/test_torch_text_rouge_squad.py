"""The port's ROUGE and SQuAD metrics, held against the JAX package on the CPU.

The cases of ``tests/text/test_text.py`` (ROUGE-1/2/L over a batch, multi-reference
``best`` and ``avg``; SQuAD), ``tests/text/test_text_stream_sweep.py``'s SQuAD stream
and ``tests/text/test_rouge_lsum.py`` (ROUGE-Lsum with and without the stemmer, multi
reference, the class over batches, a fuzzed corpus; the regex splitter's rules and its
opt-in) run through both packages, held against JAX rather than the reference. As in
``test_rouge_lsum.py`` the regex sentence splitter is installed on both sides: nltk's
punkt is not installed here and is never downloaded. Added: every ROUGE key (1-9, L,
Lsum) with custom normaliser and tokenizer, seeded corpora with empty strings, a
one-word summary and unicode; the splitter's order (hook, opt-in, then nltk, which
raises without nltk) and the class building without nltk where punkt is not needed;
SQuAD over seeded questions with several gold answers and an unanswered question; each
class over batches, ``merge_states`` of two halves, a JAX state dict loaded and
updated further; the validation messages.

Tolerances: SQuAD's question count exactly; scores and per-sample lists within 1e-6.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.functional.text as jf  # noqa: E402
import torchmetrics_tpu.functional.text.rouge as jrouge  # noqa: E402
import torchmetrics_tpu.text as jt  # noqa: E402
import torchmetrics_tpu_torch.functional.text as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.text.rouge as trouge  # noqa: E402
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
MULTI_SENT_PREDS = [
    "The cat sat on the mat. It was a sunny day! The dog barked loudly.",
    "Results improved significantly. We attribute this to better data.",
    "One sentence only here",
    "First point. Second point. Third point? Yes. No! Maybe.",
]
MULTI_SENT_TARGET = [
    "A cat was sitting on the mat. The day was sunny. A dog barked.",
    "The results were significantly better. This is attributed to data quality.",
    "Only one sentence here",
    "First point. The second point differs. A third point? Yes indeed. No!",
]
SCORE_STATES = ("rouge",)


@pytest.fixture(autouse=True)
def _shared_splitter():
    jrouge.set_rouge_sentence_splitter(jrouge._regex_split_sentence)
    trouge.set_rouge_sentence_splitter(trouge._regex_split_sentence)
    yield
    jrouge.set_rouge_sentence_splitter(None)
    trouge.set_rouge_sentence_splitter(None)


def documents(seed: int, n: int) -> list:
    """Seeded documents of one to four sentences, the first one empty."""
    rng = random.Random(seed)
    docs = []
    for i in range(n):
        sentences = random_sentences(seed * 31 + i, rng.randint(1, 4), max_words=9, empty=False)
        docs.append(" ".join(s + rng.choice([".", "!", "?"]) for s in sentences))
    docs[0] = ""
    return docs


def summary_batches(seed: int, n: int = 3, size: int = 5, refs: int = 1) -> list:
    out = []
    for i in range(n):
        preds = documents(seed + i, size)
        preds[1] = "word"
        target = [[d] if refs == 1 else [d, documents(seed + 50 + i, size)[j]] for j, d in
                  enumerate(documents(seed + 20 + i, size))]
        out.append((preds, target))
    return out


ROUGE_CASES = {
    "default": {},
    "all_n": {"rouge_keys": tuple(f"rouge{n}" for n in range(1, 10)) + ("rougeL", "rougeLsum")},
    "avg": {"accumulate": "avg", "rouge_keys": ("rouge1", "rougeL", "rougeLsum")},
    "stemmer": {"use_stemmer": True, "rouge_keys": ("rouge2", "rougeLsum")},
    "custom": {"normalizer": lambda s: s.upper(), "tokenizer": lambda s: s.split(" "), "rouge_keys": ("rouge1",
                                                                                                       "rougeL")},
    "one_key": {"rouge_keys": "rougeLsum"},
}
CORPORA = {
    "corpus": (CORPUS_PREDS, CORPUS_TARGET),
    "lsum": (MULTI_SENT_PREDS, MULTI_SENT_TARGET),
    "multi_reference": ([MULTI_SENT_PREDS[0], MULTI_SENT_PREDS[1]],
                        [[MULTI_SENT_TARGET[0], "The mat had a cat. Dogs bark."], [MULTI_SENT_TARGET[1]]]),
    "random": summary_batches(7, n=1, size=8, refs=2)[0],
    "strings": ("My name is John", "Is your name John"),
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("case", sorted(ROUGE_CASES))
def test_rouge_score_equals_jax(case, corpus):
    kw = ROUGE_CASES[case]
    preds, target = CORPORA[corpus]
    assert_close(tf.rouge_score(preds, target, device="cpu", **kw), jf.rouge_score(preds, target, **kw))


@pytest.mark.parametrize("accumulate", ["best", "avg"])
def test_rouge_multi_reference_equals_jax(accumulate):
    keys = ("rouge1", "rougeL")
    assert_close(tf.rouge_score(CORPUS_PREDS, CORPUS_TARGET, rouge_keys=keys, accumulate=accumulate, device="cpu"),
                 jf.rouge_score(CORPUS_PREDS, CORPUS_TARGET, rouge_keys=keys, accumulate=accumulate))


def test_rouge_lsum_fuzz_corpus_equals_jax():
    """``test_rouge_lsum.py``'s fuzzed corpus."""
    rng = np.random.RandomState(3)
    vocab = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]

    def make_doc():
        sents = []
        for _ in range(rng.randint(1, 5)):
            words = [vocab[rng.randint(len(vocab))] for _ in range(rng.randint(1, 8))]
            sents.append(" ".join(words) + rng.choice([".", "!", "?"]))
        return " ".join(sents)

    preds = [make_doc() for _ in range(12)]
    target = [make_doc() for _ in range(12)]
    assert_close(tf.rouge_score(preds, target, rouge_keys=("rougeLsum",), device="cpu"),
                 jf.rouge_score(preds, target, rouge_keys=("rougeLsum",)))


@pytest.mark.parametrize("seed", range(4))
def test_the_lcs_alignment_from_bit_rows_equals_jax_table(seed):
    """ROUGE-Lsum's alignment, read off bit-parallel rows, is the one JAX backtracks
    through its numpy table, ties included (small alphabets), up to 300 tokens a side."""
    rng = random.Random(seed)
    for _ in range(200):
        sides = []
        for _ in range(2):
            alphabet = rng.randint(1, 12)
            length = rng.choice([0, 1, rng.randint(2, 40), rng.randint(100, 300)])
            sides.append(np.array([rng.randrange(alphabet) for _ in range(length)], dtype=np.int64))
        target, pred = sides
        assert trouge._aligned_target_positions(target, pred) == jrouge._aligned_target_positions(target, pred)
        assert trouge._lcs_length(pred, target) == jrouge._lcs_length(pred, target)


def _rouge(name):
    kw = ROUGE_CASES[name]
    return (lambda: tt.ROUGEScore(device="cpu", **kw)), (lambda: jt.ROUGEScore(**kw))


@pytest.mark.parametrize("refs", [1, 2])
@pytest.mark.parametrize("case", sorted(ROUGE_CASES))
def test_rouge_class_over_batches_equals_jax(case, refs):
    make_port, make_jax = _rouge(case)
    port, jax_metric = make_port(), make_jax()
    for preds, target in summary_batches(70, refs=refs):
        assert_close(port(preds, target), jax_metric(preds, target))
    assert_states_equal(port, jax_metric, SCORE_STATES)
    assert_close(port.compute(), jax_metric.compute())


def test_rouge_class_streams_lsum_as_jax_does():
    """``test_rouge_lsum.py``'s module stream."""
    port, jax_metric = tt.ROUGEScore(rouge_keys=("rougeLsum",), device="cpu"), jt.ROUGEScore(rouge_keys=("rougeLsum",))
    for i in range(0, len(MULTI_SENT_PREDS), 2):
        port.update(MULTI_SENT_PREDS[i:i + 2], MULTI_SENT_TARGET[i:i + 2])
        jax_metric.update(MULTI_SENT_PREDS[i:i + 2], MULTI_SENT_TARGET[i:i + 2])
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("case", ["default", "avg"])
def test_rouge_merged_halves_equal_one_metric_fed_everything(case):
    make_port, make_jax = _rouge(case)
    batches = summary_batches(80, n=4)
    merged, whole, _ = merged_value(make_port, batches)
    assert_close(merged, whole, atol=0.0)
    jax_metric = make_jax()
    for b in batches:
        jax_metric.update(*b)
    assert_close(merged, jax_metric.compute())


@pytest.mark.parametrize("case", ["default", "all_n"])
def test_rouge_jax_state_loaded_into_the_port_goes_on_equal(case):
    make_port, make_jax = _rouge(case)
    got, want = jax_state_goes_on(make_port, make_jax, summary_batches(90), SCORE_STATES)
    assert_close(got, want)


def test_a_rouge_class_with_no_update_computes_nan_as_jax_does():
    got = tt.ROUGEScore(rouge_keys=("rouge1",), device="cpu").compute()
    want = jt.ROUGEScore(rouge_keys=("rouge1",)).compute()
    assert_close(got, want)
    assert np.isnan(np_value(got["rouge1_fmeasure"]))


def test_the_regex_splitter_equals_jax():
    cases = ["A b. C d! E f? G.", 'He said "stop." Then left.', 'He said ("stop.") Then left.',
             "no terminal punctuation", "  ", "Über alles. 中文。 Fine!"]
    for text in cases:
        assert trouge._regex_split_sentence(text) == jrouge._regex_split_sentence(text)
    assert trouge._regex_split_sentence("A b. C d! E f? G.") == ["A b.", "C d!", "E f?", "G."]


def test_the_splitter_hook_comes_before_the_opt_in_and_the_opt_in_before_nltk(monkeypatch):
    monkeypatch.setenv("TM_TPU_ROUGE_REGEX_SPLIT", "1")
    trouge.set_rouge_sentence_splitter(lambda x: [x])
    assert trouge._split_sentence("One. Two.") == ["One. Two."]
    trouge.set_rouge_sentence_splitter(None)
    assert trouge._split_sentence("One. Two.") == ["One.", "Two."]
    out = tf.rouge_score(["One. Two."], ["One. Two too."], rouge_keys=("rougeLsum",), device="cpu")
    assert np.isfinite(np_value(out["rougeLsum_fmeasure"]))
    monkeypatch.delenv("TM_TPU_ROUGE_REGEX_SPLIT")
    monkeypatch.setattr(trouge, "_NLTK_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="requires that `nltk` is installed"):
        trouge._split_sentence("One. Two.")


def test_the_class_needs_nltk_only_where_punkt_splits(monkeypatch):
    import torchmetrics_tpu_torch.text.rouge as rouge_class

    monkeypatch.setattr(rouge_class, "_NLTK_AVAILABLE", False)
    tt.ROUGEScore(device="cpu")  # the regex splitter is installed: no punkt
    with pytest.raises(ModuleNotFoundError, match="requires that `nltk` is installed"):
        tt.ROUGEScore(use_stemmer=True, device="cpu")
    trouge.set_rouge_sentence_splitter(None)
    monkeypatch.delenv("TM_TPU_ROUGE_REGEX_SPLIT", raising=False)
    with pytest.raises(ModuleNotFoundError, match="requires that `nltk` is installed"):
        tt.ROUGEScore(device="cpu")
    monkeypatch.setenv("TM_TPU_ROUGE_REGEX_SPLIT", "1")
    tt.ROUGEScore(device="cpu")
    tt.ROUGEScore(rouge_keys=("rouge1",), device="cpu")


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_rouge_validation_messages_equal_jax():
    for kw in ({"rouge_keys": ("rouge10",)}, {"accumulate": "max"}, {"rouge_keys": "rougeX"}):
        assert _message(lambda: tt.ROUGEScore(device="cpu", **kw)) == _message(lambda: jt.ROUGEScore(**kw))
        assert _message(lambda: tf.rouge_score("a", "a", device="cpu", **kw)) == _message(
            lambda: jf.rouge_score("a", "a", **kw))


# --------------------------------------------------------------------------- SQuAD

SQUAD_PREDS = [{"prediction_text": "1976", "id": "1"}, {"prediction_text": "a test", "id": "2"}]
SQUAD_TARGET = [
    {"answers": {"answer_start": [97], "text": ["1976"]}, "id": "1"},
    {"answers": {"answer_start": [1], "text": ["this is a test", "another answer"]}, "id": "2"},
]


def squad_batch(seed: int, n: int = 12) -> tuple:
    """Seeded questions with one to three gold answers (one empty), predictions exact up
    to case, articles and punctuation, overlapping, or unrelated; unicode answers."""
    rng = random.Random(seed)
    words = random_sentences(seed, 30, empty=False)
    preds, targets = [], []
    for i in range(n):
        golds = [rng.choice(words) for _ in range(rng.randint(1, 3))]
        if i == 3:
            golds.append("")
        kind = rng.random()
        if kind < 0.5:
            answer = rng.choice(["The ", "a ", ""]) + rng.choice(golds).upper() + rng.choice(["", ".", "!"])
        elif kind < 0.8:
            answer = " ".join(golds[0].split()[:2] + ["extra"])
        else:
            answer = rng.choice(words)
        qid = f"{seed}-{i}"
        preds.append({"prediction_text": answer if i != 2 else "", "id": qid})
        targets.append({"answers": {"answer_start": [0] * len(golds), "text": golds}, "id": qid})
    return preds, targets


SQUAD_CORPORA = {"reference": (SQUAD_PREDS, SQUAD_TARGET), "seeded": squad_batch(3),
                 "single": ({"prediction_text": "Über", "id": "x"}, {"answers": {"text": ["über"]}, "id": "x"})}


@pytest.mark.parametrize("corpus", sorted(SQUAD_CORPORA))
def test_squad_equals_jax(corpus):
    preds, target = SQUAD_CORPORA[corpus]
    assert_close(tf.squad(preds, target, device="cpu"), jf.squad(preds, target))


def test_squad_class_over_batches_equals_jax():
    port, jax_metric = tt.SQuAD(device="cpu"), jt.SQuAD()
    for seed in range(3):
        preds, target = squad_batch(seed)
        assert_close(port(preds, target), jax_metric(preds, target))
    assert port.total.dtype == torch.int32
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


def test_squad_stream_equals_jax():
    """``test_text_stream_sweep.py``'s SQuAD stream."""
    port, jax_metric = tt.SQuAD(device="cpu"), jt.SQuAD()
    for step in range(2):
        preds = [{"prediction_text": text, "id": f"q{step}_{i}"} for i, text in enumerate(stream_corpus(3, step))]
        target = [{"answers": {"answer_start": [0], "text": [text]}, "id": f"q{step}_{i}"}
                  for i, text in enumerate(stream_corpus(3, step + 7))]
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


def test_squad_merged_halves_and_a_jax_state_go_on_equal():
    batches = [squad_batch(10 + i) for i in range(4)]
    merged, whole, _ = merged_value(lambda: tt.SQuAD(device="cpu"), batches)
    assert_close(merged, whole, atol=0.0)
    got, want = jax_state_goes_on(lambda: tt.SQuAD(device="cpu"), jt.SQuAD, batches)
    assert_close(got, want)


def test_an_unanswered_question_warns_and_scores_zero():
    preds, target = [{"prediction_text": "a", "id": "1"}], [{"answers": {"text": ["a"]}, "id": "1"},
                                                            {"answers": {"text": ["b"]}, "id": "2"}]
    with pytest.warns(UserWarning, match="Unanswered question 2 will receive score 0."):
        got = tf.squad(preds, target, device="cpu")
    assert_close(got, jf.squad(preds, target))


def test_squad_input_messages_equal_jax():
    bad = [
        ({"prediction_text": "a"}, {"answers": {"text": ["a"]}, "id": "1"}),
        ({"prediction_text": "a", "id": "1"}, {"id": "1"}),
        ({"prediction_text": "a", "id": "1"}, {"answers": {"answer_start": [0]}, "id": "1"}),
    ]
    for preds, target in bad:
        assert _message(lambda: tf.squad(preds, target, device="cpu"), KeyError) == _message(
            lambda: jf.squad(preds, target), KeyError)
