"""The port's error-rate text metrics, held against the JAX package on the CPU.

The cases of ``tests/text/test_text.py`` (the five error-rate modules over two batches,
``EditDistance`` and its reductions, a stream against one batch, ``forward`` against
the functional) and ``tests/text/test_text_stream_sweep.py``'s single-reference streams
run through both packages, held against JAX rather than the reference. Added: seeded
corpora with empty strings, a one-word hypothesis and unicode (German letters, CJK,
emoji); ``substitution_cost`` other than 1, where the port keeps JAX's numpy DP, and
the unit-cost bit-vector distance against it on random token lists; each class over
three batches, ``merge_states`` of two halves against one metric fed everything, and a
JAX state dict loaded by ``convert.load_jax_state`` and updated further; the ``device``
keyword of the string functionals; the validation messages; the class attributes, the
``__all__`` lists of the whole text domain and its four model-based names, which raise.

This file also holds the helpers the other ``test_torch_text_*`` files import.

Tolerances: counters and distances exactly (the same integers, rounded once to
float32); rates and scores within 1e-6.
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
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.parallel.reductions import merge_states  # noqa: E402

SCORE_ATOL = 1e-6

BATCH_1 = (
    ["this is the prediction", "there is an other sample"],
    ["this is the reference", "there is another one"],
)
BATCH_2 = (
    ["hello world how are you", "the weather is cold"],
    ["hello there how are you", "the weather was warm"],
)


def stream_corpus(n: int, seed: int) -> list:
    """``tests/text/test_text_stream_sweep.py``'s corpus."""
    rng = np.random.RandomState(seed)
    words = ["the", "cat", "dog", "runs", "fast", "blue", "sky", "over", "jumps", "lazy"]
    return [" ".join(rng.choice(words, size=rng.randint(2, 10))) for _ in range(n)]


UNICODE_WORDS = ["straße", "über", "Äpfel", "naïve", "中文", "日本語", "🙂", "café", "x", "the", "a", "of",
                 "it's", "U.S.", "3.5", "Dr.", "e.g.", "(yes)", "end."]


def random_sentences(seed: int, n: int, max_words: int = 14, empty: bool = True) -> list:
    """Seeded sentences of 0 to ``max_words`` words over ASCII and unicode words, the
    first ones an empty string and a one-word sentence."""
    rng = random.Random(seed)
    vocab = UNICODE_WORDS + [f"w{i}" for i in range(40)]
    out = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, max_words))) for _ in range(n)]
    if empty:
        out[0] = ""
    if n > 1:
        out[1] = rng.choice(vocab)
    return out


def random_pairs(seed: int, n: int) -> tuple:
    """(hypotheses, references): references edited into hypotheses, some unrelated."""
    refs = random_sentences(seed, n)
    refs[0] = "a reference"  # an empty hypothesis against a reference
    rng = random.Random(seed + 1)
    hyps = []
    for i, ref in enumerate(refs):
        words = ref.split()
        if i % 5 == 4:
            words = random_sentences(seed + i, 2, empty=False)[0].split()
        else:
            words = [w for w in words if rng.random() > 0.2] + (["extra"] if rng.random() < 0.3 else [])
        hyps.append(" ".join(words))
    hyps[0] = ""
    return hyps, refs


def np_value(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, jax_value, atol: float = SCORE_ATOL, where: str = "value") -> None:
    """A port value (tensor, tuple or dict of them) within ``atol`` of JAX's, with the
    same shape and dtype; NaN where JAX has NaN."""
    if isinstance(jax_value, dict):
        assert sorted(port) == sorted(jax_value), where
        for k in jax_value:
            assert_close(port[k], jax_value[k], atol, f"{where}.{k}")
        return
    if isinstance(jax_value, (tuple, list)):
        assert len(port) == len(jax_value), where
        for i, (a, b) in enumerate(zip(port, jax_value)):
            assert_close(a, b, atol, f"{where}[{i}]")
        return
    got, want = np_value(port), np_value(jax_value)
    assert got.shape == want.shape and got.dtype == want.dtype, (where, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=atol, err_msg=where)


def _cat(value) -> np.ndarray:
    if isinstance(value, list):
        return np.concatenate([np.atleast_1d(np_value(v)) for v in value]) if value else np.zeros(0)
    return np_value(value)


def assert_states_equal(port, jax_metric, score_states: tuple = ()) -> None:
    """The port metric's states against the JAX metric's: the same names and dtypes,
    counters exactly, the lists named in ``score_states`` (concatenated) within
    SCORE_ATOL."""
    got = port.state_dict(persistent_only=False)
    want = jax_metric.state_dict(persistent_only=False)
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = _cat(got[key]), _cat(want[key])
        assert a.shape == b.shape, key
        if isinstance(want[key], list) and not want[key]:
            continue
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        if key.startswith(score_states) and score_states:
            np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def merged_value(make, batches: list):
    """``compute`` over ``merge_states`` of two port metrics fed the two halves of
    ``batches``, and the compute of one port metric fed everything."""
    half = len(batches) // 2
    first, second, whole = make(), make(), make()
    for b in batches[:half]:
        first.update(*b)
    for b in batches[half:]:
        second.update(*b)
    for b in batches:
        whole.update(*b)
    state = {
        key: merge_states(first.metric_state[key], second.metric_state[key], first._reductions[key], half,
                          len(batches) - half)
        for key in first.metric_state
    }
    return whole.pure_compute(state), whole.compute(), whole


def jax_state_goes_on(make_port, make_jax, batches: list, score_states: tuple = ()):
    """A JAX metric fed the first batches, its state dict loaded into the port, both fed
    the rest: the states and values after."""
    jax_metric = make_jax()
    for b in batches[:1]:
        jax_metric.update(*b)
    port = load_jax_state(make_port(), jax_metric.state_dict(persistent_only=False))
    for b in batches[1:]:
        jax_metric.update(*b)
        port.update(*b)
    assert_states_equal(port, jax_metric, score_states)
    return port.compute(), jax_metric.compute()


# ------------------------------------------------------------------------ cases

FUNCTIONS = {
    "word_error_rate": {},
    "char_error_rate": {},
    "match_error_rate": {},
    "word_information_lost": {},
    "word_information_preserved": {},
    "edit_distance": {},
}
CLASSES = {
    "WordErrorRate": {},
    "CharErrorRate": {},
    "MatchErrorRate": {},
    "WordInfoLost": {},
    "WordInfoPreserved": {},
    "EditDistance": {},
    "EditDistance_sum": {"reduction": "sum"},
    "EditDistance_none": {"reduction": "none"},
    "EditDistance_cost_2": {"substitution_cost": 2},
}
CORPORA = {
    "batch_1": BATCH_1,
    "batch_2": BATCH_2,
    "stream": (stream_corpus(5, 0), stream_corpus(5, 50)),
    "unicode": random_pairs(3, 12),
    "single_word": (["hello"], ["hello world"]),
    "long": (stream_corpus(3, 9)[0:1] * 1 + [" ".join(stream_corpus(40, 4))], [" ".join(stream_corpus(40, 5)),
                                                                               "x"]),
}


def _batches(seed: int, n: int = 3, size: int = 6) -> list:
    return [random_pairs(seed + i, size) for i in range(n)]


def _port_cls(name: str):
    return getattr(tt, name.split("_")[0])


def _jax_cls(name: str):
    return getattr(jt, name.split("_")[0])


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functionals_equal_jax(name, corpus):
    preds, target = CORPORA[corpus]
    got = getattr(tf, name)(preds, target, device="cpu")
    want = getattr(jf, name)(preds, target)
    assert_close(got, want)


@pytest.mark.parametrize("substitution_cost", [1, 2, 0])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
def test_edit_distance_reductions_equal_jax(reduction, substitution_cost):
    preds, target = ["rain", "lnaguaeg", "", "über"], ["shine", "language", "abc", "uber"]
    got = tf.edit_distance(preds, target, substitution_cost, reduction, device="cpu")
    want = jf.edit_distance(preds, target, substitution_cost, reduction)
    if reduction in ("sum", "none", None):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np_value(got), np_value(want))
    else:
        assert_close(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_the_bit_vector_distance_equals_the_dynamic_programme(seed):
    from torchmetrics_tpu.functional.text.helper import _edit_distance_cost as jcost
    from torchmetrics_tpu_torch.functional.text.helper import (
        _edit_distance_cost,
        _edit_distance_dp,
        _levenshtein_bit_vector,
    )

    rng = random.Random(seed)
    alphabet = list("abcäß中 ") + ["tok", "🙂"]
    for _ in range(300):
        a = [rng.choice(alphabet[: rng.randint(1, len(alphabet))]) for _ in range(rng.randint(1, 70))]
        b = [rng.choice(alphabet[: rng.randint(1, len(alphabet))]) for _ in range(rng.randint(1, 70))]
        want = jcost(a, b)
        assert _levenshtein_bit_vector(a, b) == want == _edit_distance_cost(a, b) == _edit_distance_dp(a, b)
        assert _edit_distance_cost(a, b, 2) == jcost(a, b, 2)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_classes_over_batches_equal_jax(name):
    kw = CLASSES[name]
    port, jax_metric = _port_cls(name)(device="cpu", **kw), _jax_cls(name)(**kw)
    for preds, target in (BATCH_1, BATCH_2, *_batches(11)):
        assert_close(port(preds, target), jax_metric(preds, target))
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_single_reference_streams_equal_jax(name):
    """``test_text_stream_sweep.py``'s three-step streams."""
    kw = CLASSES[name]
    port, jax_metric = _port_cls(name)(device="cpu", **kw), _jax_cls(name)(**kw)
    for step in range(3):
        preds, target = stream_corpus(5, step), stream_corpus(5, step + 50)
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_merged_halves_equal_one_metric_fed_everything(name):
    kw = CLASSES[name]
    batches = _batches(21, n=4)
    merged, whole, _ = merged_value(lambda: _port_cls(name)(device="cpu", **kw), batches)
    np.testing.assert_array_equal(np_value(merged), np_value(whole))
    jax_metric = _jax_cls(name)(**kw)
    for b in batches:
        jax_metric.update(*b)
    assert_close(merged, jax_metric.compute())


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_a_jax_state_loaded_into_the_port_goes_on_equal(name):
    kw = CLASSES[name]
    got, want = jax_state_goes_on(lambda: _port_cls(name)(device="cpu", **kw), lambda: _jax_cls(name)(**kw),
                                  _batches(31))
    assert_close(got, want)


def test_a_stream_equals_one_batch_of_everything():
    """``test_module_sum_states_merge_across_updates``, in both packages."""
    port, whole = tt.WordErrorRate(device="cpu"), tt.WordErrorRate(device="cpu")
    for preds, target in (BATCH_1, BATCH_2):
        port.update(preds, target)
    whole.update(BATCH_1[0] + BATCH_2[0], BATCH_1[1] + BATCH_2[1])
    np.testing.assert_array_equal(np_value(port.compute()), np_value(whole.compute()))
    jax_metric = jt.WordErrorRate()
    jax_metric.update(BATCH_1[0] + BATCH_2[0], BATCH_1[1] + BATCH_2[1])
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("name", ["word_error_rate", "char_error_rate", "match_error_rate"])
def test_forward_equals_the_functional(name):
    cls = {"word_error_rate": tt.WordErrorRate, "char_error_rate": tt.CharErrorRate,
           "match_error_rate": tt.MatchErrorRate}[name]
    np.testing.assert_array_equal(np_value(cls(device="cpu")(*BATCH_1)),
                                  np_value(getattr(tf, name)(*BATCH_1, device="cpu")))


def test_a_string_functional_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("word_error_rate", "bleu_score", "rouge_score", "chrf_score", "translation_edit_rate"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(tf, name)(["a b"], ["a b"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.squad({"prediction_text": "a", "id": "1"}, {"answers": {"text": ["a"]}, "id": "1"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.WordErrorRate()
    assert tf.word_error_rate(["a b"], ["a b"], device="cpu").device.type == "cpu"


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_validation_messages_equal_jax():
    calls = [
        lambda fn, **kw: fn([1], ["a"], **kw),
        lambda fn, **kw: fn(["a"], [2], **kw),
        lambda fn, **kw: fn(["a", "b"], ["a"], **kw),
        lambda fn, **kw: fn(["a"], ["b"], reduction="max", **kw),
    ]
    for call in calls:
        assert _message(lambda: call(tf.edit_distance, device="cpu")) == _message(lambda: call(jf.edit_distance))
    for kw in ({"substitution_cost": -1}, {"substitution_cost": 1.5}, {"reduction": "max"}):
        assert _message(lambda: tt.EditDistance(device="cpu", **kw)) == _message(lambda: jt.EditDistance(**kw))


ALL_CLASSES = sorted(tt.__all__)


@pytest.mark.parametrize("cls", ALL_CLASSES)
def test_classes_keep_jax_attributes(cls):
    for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound",
                 "plot_upper_bound"):
        assert getattr(getattr(tt, cls), attr, None) == getattr(getattr(jt, cls), attr, None), attr


def test_the_all_lists_equal_jax_less_the_model_based_metrics():
    """Since the model-based metrics are ported, the lists equal JAX's (the name is kept
    from the slice that still left BERTScore and InfoLM out)."""
    import torchmetrics_tpu as jtm
    import torchmetrics_tpu_torch as ttm
    import torchmetrics_tpu_torch.functional as tfunctional

    assert tt.__all__ == jt.__all__
    assert tf.__all__ == jf.__all__
    assert set(tt.__all__) <= set(ttm.__all__) and set(tt.__all__) <= set(jtm.__all__)
    assert set(tf.__all__) <= set(tfunctional.__all__) and "text" in tfunctional.__all__
    for name in tt.__all__:
        assert getattr(ttm, name) is getattr(tt, name)


@pytest.mark.parametrize("module, name", [(tt, "BERTScore"), (tt, "InfoLM"), (tf, "bert_score"), (tf, "infolm")])
def test_the_model_based_names_raise_naming_the_roadmap_item(module, name):
    """The model-based names resolve to the port's own class or function, by attribute
    and by import (they raised ``NotImplementedError`` until they were ported; the test
    keeps its name); an unknown name is still an ``AttributeError``."""
    import importlib

    owners = {"BERTScore": "text.bert", "InfoLM": "text.infolm", "bert_score": "functional.text.bert",
              "infolm": "functional.text.infolm"}
    got = getattr(module, name)
    assert got is getattr(importlib.import_module(f"torchmetrics_tpu_torch.{owners[name]}"), name)
    scope = {}
    exec(f"from {module.__name__} import {name}", scope)
    assert scope[name] is got
    with pytest.raises(AttributeError):
        getattr(module, "NoSuchMetric")
