"""BERTScore in the port against the JAX package, on tiny snapshots (2 layers, width 32)
that both packages load from the same directory, and on user models.

Precision, recall and F1 within 1e-5 for the functional and the class: ``idf`` on and
off, ``num_layers``, ``all_layers``, the baseline from a local CSV and from a URL (the
fetcher patched in both packages, so nothing leaves the machine), a user model with its
tokenizer, ``user_forward_fn``, ``return_hash``, and a position budget (64) below the
default ``max_length``; JAX's state carried across; JAX's messages for bad inputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from tests.helpers import hf_snapshots  # noqa: E402
from torchmetrics_tpu.functional.text import bert_score as jax_bert_score  # noqa: E402
from torchmetrics_tpu.text import BERTScore as JaxBERTScore  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.functional.text import bert_score  # noqa: E402
from torchmetrics_tpu_torch.text import BERTScore  # noqa: E402

pytest.importorskip("transformers")

PREDS = ["hello there my friend", "the cat sat on the mat", "über café naïve", "a dog runs over the lazy mat",
         "東京 日本 1234", "blue sky"]
TARGET = ["hello there good friend", "a cat sat on a mat", "café über straße", "the lazy dog runs",
          "日本 東京 42", "blue sky over the dog"]
KEYS = ("precision", "recall", "f1")
EMB = np.random.RandomState(7).randn(1000, 12).astype(np.float32)
TORCH_EMB = torch.from_numpy(EMB)


def _assert_scores(got, want, atol=1e-5):
    for key in KEYS:
        g, w = np.asarray(got[key].cpu() if isinstance(got[key], torch.Tensor) else got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("bertscore")
    return {"bert": hf_snapshots.encoder_snapshot(str(root / "bert"), "bert", seed=1),
            "roberta": hf_snapshots.encoder_snapshot(str(root / "roberta"), "roberta", seed=2)}


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("kind", ["bert", "roberta"])
def test_bert_score_equals_jax(models, kind, idf):
    got = bert_score(PREDS, TARGET, model_name_or_path=models[kind], idf=idf, device="cpu", batch_size=4)
    want = jax_bert_score(PREDS, TARGET, model_name_or_path=models[kind], idf=idf, batch_size=4)
    _assert_scores(got, want)


@pytest.mark.parametrize("options", [{"num_layers": 1}, {"all_layers": True}, {"num_layers": 0, "idf": True}],
                         ids=["num_layers", "all_layers", "embeddings_idf"])
def test_layer_options_equal_jax(models, options):
    got = bert_score(PREDS, TARGET, model_name_or_path=models["bert"], device="cpu", **options)
    want = jax_bert_score(PREDS, TARGET, model_name_or_path=models["bert"], **options)
    _assert_scores(got, want)
    if options.get("all_layers"):
        assert tuple(got["f1"].shape) == (3, len(PREDS))


def test_baseline_from_a_local_csv_and_return_hash_equal_jax(models, tmp_path):
    path = tmp_path / "baseline.csv"
    path.write_text("LAYER,P,R,F\n0,0.1,0.2,0.3\n1,0.4,0.5,0.6\n2,0.35,0.45,0.55\n")
    kw = dict(model_name_or_path=models["bert"], rescale_with_baseline=True, baseline_path=str(path),
              return_hash=True, idf=True)
    got = bert_score(PREDS, TARGET, device="cpu", **kw)
    want = jax_bert_score(PREDS, TARGET, **kw)
    _assert_scores(got, want)
    assert got["hash"] == want["hash"] == f"{models['bert']}_LNone_idf"


def test_baseline_from_a_url_goes_through_the_retry_layer_as_jax_s(models, monkeypatch):
    import torchmetrics_tpu.robust.retry as jretry
    import torchmetrics_tpu_torch.robust.retry as tretry

    seen = []

    def fetch(url, timeout=30.0):
        seen.append(url)
        return b"LAYER,P,R,F\n0,0.1,0.2,0.3\n1,0.4,0.5,0.6\n2,0.35,0.45,0.55\n"

    monkeypatch.setattr(jretry, "_default_fetcher", fetch)
    monkeypatch.setattr(tretry, "_default_fetcher", fetch)
    kw = dict(model_name_or_path=models["bert"], rescale_with_baseline=True, baseline_url="https://example.invalid/b.csv")
    _assert_scores(bert_score(PREDS, TARGET, device="cpu", **kw), jax_bert_score(PREDS, TARGET, **kw))
    assert seen == ["https://example.invalid/b.csv"] * 2


class _Tokenizer:
    """A whitespace tokenizer over crc32 ids, for both packages."""

    def __call__(self, texts, padding=True, truncation=True, max_length=512, return_tensors="np"):
        import zlib

        rows = [[1] + [3 + zlib.crc32(t.encode()) % 900 for t in text.split()[: max_length - 2]] + [2] for text in texts]
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        ids, mask = np.zeros((len(rows), width), np.int64), np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)], mask[i, : len(r)] = r, 1
        return {"input_ids": ids, "attention_mask": mask}


def test_a_user_model_and_tokenizer_equal_jax():
    got = bert_score(PREDS, TARGET, model=lambda ids, mask: TORCH_EMB[ids % 1000], user_tokenizer=_Tokenizer(),
                     device="cpu", idf=True)
    want = jax_bert_score(PREDS, TARGET, model=lambda ids, mask: jnp.asarray(EMB)[ids % 1000],
                          user_tokenizer=_Tokenizer(), idf=True)
    _assert_scores(got, want)


def test_user_forward_fn_receives_the_port_s_encoder_and_equals_jax(models):
    seen = []

    def port_fn(model, batch):
        seen.append(type(model).__name__)
        return model(batch["input_ids"], batch["attention_mask"]) * 2.0

    def jax_fn(model, batch):
        return model(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"]).last_hidden_state * 2.0

    got = bert_score(PREDS, TARGET, model_name_or_path=models["bert"], user_forward_fn=port_fn, device="cpu")
    want = jax_bert_score(PREDS, TARGET, model_name_or_path=models["bert"], user_forward_fn=jax_fn)
    _assert_scores(got, want)
    assert seen and set(seen) == {"TransformerEncoder"}


@pytest.mark.parametrize("idf", [False, True])
def test_the_class_equals_jax_and_its_state_carries_across(models, idf):
    port = BERTScore(model_name_or_path=models["roberta"], idf=idf, device="cpu", batch_size=3)
    jax = JaxBERTScore(model_name_or_path=models["roberta"], idf=idf, batch_size=3)
    assert port.max_length == jax.max_length == 66  # capped to the position budget
    for part in (slice(0, 4), slice(4, 6)):
        port.update(PREDS[part], TARGET[part])
        jax.update(PREDS[part], TARGET[part])
    _assert_scores(port.compute(), jax.compute())
    # JAX's state after the first batch carried into the port, both fed the second
    jax = JaxBERTScore(model_name_or_path=models["roberta"], idf=idf, batch_size=3)
    jax.update(PREDS[:4], TARGET[:4])
    carried = load_jax_state(BERTScore(model_name_or_path=models["roberta"], idf=idf, device="cpu", batch_size=3),
                             jax.state_dict(persistent_only=False))
    for metric in (jax, carried):
        metric.update(PREDS[4:], TARGET[4:])
    _assert_scores(carried.compute(), jax.compute())


def test_the_whitespace_fallback_class_equals_jax():
    model = lambda ids, mask: TORCH_EMB[ids % 1000]  # noqa: E731
    port, jax = BERTScore(model=model, max_length=16, device="cpu"), JaxBERTScore(
        model=lambda ids, mask: jnp.asarray(EMB)[ids % 1000], max_length=16)
    port.update(PREDS, TARGET)
    jax.update(PREDS, TARGET)
    _assert_scores(port.compute(), jax.compute())


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_bad_inputs_raise_jax_s_messages(models):
    model = lambda ids, mask: TORCH_EMB[ids % 1000]  # noqa: E731
    jmodel = lambda ids, mask: jnp.asarray(EMB)[ids % 1000]  # noqa: E731
    assert _message(lambda: bert_score(["a"], ["a", "b"], model=model, device="cpu")) == \
        _message(lambda: jax_bert_score(["a"], ["a", "b"], model=jmodel))
    assert _message(lambda: bert_score([1], [2], model=model, device="cpu")) == \
        _message(lambda: jax_bert_score([1], [2], model=jmodel))
    assert _message(lambda: bert_score(PREDS, TARGET, model_name_or_path=models["bert"], num_layers=5, device="cpu")) \
        == _message(lambda: jax_bert_score(PREDS, TARGET, model_name_or_path=models["bert"], num_layers=5))
    bad = lambda ids, mask: TORCH_EMB[ids % 1000][:, :1]  # noqa: E731
    jbad = lambda ids, mask: jnp.asarray(EMB)[ids % 1000][:, :1]  # noqa: E731
    assert _message(lambda: bert_score(PREDS, TARGET, model=bad, device="cpu")) == \
        _message(lambda: jax_bert_score(PREDS, TARGET, model=jbad))
    with pytest.raises(OSError, match="local transformers cache and this environment has no network access"):
        bert_score(PREDS, TARGET, model_name_or_path="no/such-model", device="cpu")
    empty = bert_score([], [], model=model, return_hash=True, device="cpu")
    assert empty == jax_bert_score([], [], model=jmodel, return_hash=True)


def test_the_mesh_option_is_refused():
    with pytest.raises(ValueError, match="`mesh` is a JAX option"):
        bert_score(PREDS, TARGET, model=lambda i, m: TORCH_EMB[i % 1000], device="cpu", mesh=object())
    with pytest.raises(ValueError, match="`mesh` is a JAX option"):
        BERTScore(model=lambda i, m: TORCH_EMB[i % 1000], device="cpu", mesh=object())


def test_the_encoder_runs_on_the_card_unless_asked_for_the_cpu(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bert_score(PREDS, TARGET, model_name_or_path=models["bert"])


@pytest.mark.parametrize("module_name", ["torchmetrics_tpu_torch.functional.text.bert", "torchmetrics_tpu_torch.text.bert"])
def test_docstring_examples_run(module_name):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
