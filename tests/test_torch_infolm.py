"""InfoLM in the port against the JAX package, on a tiny BERT masked LM (2 layers,
width 32, 64 positions) that both packages load from the same directory.

Each package's per-sentence distributions (idf on and off) are held within 1e-5
relative of each other, then every one of the nine information measures on its own
package's distributions; the functional, the class with sentence-level scores and a
carried-across JAX state end to end, all within 1e-5 relative; JAX's messages for bad
arguments.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tests.helpers import hf_snapshots  # noqa: E402
from torchmetrics_tpu.functional.text import infolm as jax_infolm  # noqa: E402
from torchmetrics_tpu.text import InfoLM as JaxInfoLM  # noqa: E402
from torchmetrics_tpu.text.infolm import _InformationMeasure as JaxMeasure  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.functional.text import infolm  # noqa: E402
from torchmetrics_tpu_torch.text import InfoLM  # noqa: E402
from torchmetrics_tpu_torch.text.infolm import _InformationMeasure  # noqa: E402

pytest.importorskip("transformers")

PREDS = ["hello there my friend", "the cat sat on the mat", "über café naïve", "a dog runs over the lazy mat", ""]
TARGET = ["hello there good friend", "a cat sat on a mat", "café über straße", "the lazy dog runs", "blue sky"]
MEASURES = {
    "kl_divergence": {}, "alpha_divergence": {"alpha": 0.5}, "beta_divergence": {"beta": 0.5},
    "ab_divergence": {"alpha": 0.5, "beta": 0.3}, "renyi_divergence": {"alpha": 0.5}, "l1_distance": {},
    "l2_distance": {}, "l_infinity_distance": {}, "fisher_rao_distance": {},
}


def _close(got, want, rtol=1e-5):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-3)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    # weights drawn wider than BERT's 0.02 so that the distributions differ between
    # sentences and the measures are not a cancellation near zero
    return hf_snapshots.encoder_snapshot(str(tmp_path_factory.mktemp("infolm") / "mlm"), "bert", masked_lm=True,
                                         seed=3, initializer_range=0.2)


@pytest.fixture(scope="module")
def distributions(model):
    """(port, JAX) distributions of both corpora, idf off and on."""
    out = {}
    for idf in (False, True):
        port = InfoLM(model, idf=idf, verbose=False, device="cpu")
        jax = JaxInfoLM(model, idf=idf, verbose=False)
        port.update(PREDS, TARGET)
        jax.update(PREDS, TARGET)
        pair = []
        for metric in (port, jax):
            pair.append([metric._sentence_distribution(np.asarray(ids[0]), np.asarray(mask[0]))
                         for ids, mask in ((metric.preds_input_ids, metric.preds_attention_mask),
                                           (metric.target_input_ids, metric.target_attention_mask))])
        out[idf] = pair
    return out


@pytest.mark.parametrize("idf", [False, True])
def test_sentence_distributions_equal_jax(distributions, idf):
    port, jax = distributions[idf]
    for got, want in zip(port, jax):
        want = np.asarray(want)
        ok = np.isfinite(want).all(axis=1)  # the empty sentence: 0 / 0 in both
        assert (np.isfinite(got.numpy()).all(axis=1) == ok).all()
        np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("measure", sorted(MEASURES))
def test_each_information_measure_equals_jax(distributions, measure):
    port, jax = distributions[True]
    got = _InformationMeasure(measure, **MEASURES[measure])(*(d.to(torch.float32) for d in port))
    want = JaxMeasure(measure, **MEASURES[measure])(*jax)
    _close(got, want)


@pytest.mark.parametrize("idf", [False, True])
def test_the_functional_equals_jax(model, idf):
    got = infolm(PREDS, TARGET, model, idf=idf, verbose=False, return_sentence_level_score=True, device="cpu")
    want = jax_infolm(PREDS, TARGET, model, idf=idf, verbose=False, return_sentence_level_score=True)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_the_class_over_batches_and_a_carried_jax_state_equal_jax(model):
    kw = dict(information_measure="alpha_divergence", alpha=0.3, verbose=False, return_sentence_level_score=True,
              batch_size=2, max_length=24)
    jax = JaxInfoLM(model, **kw)
    jax.update(PREDS[:3], TARGET[:3])
    port = load_jax_state(InfoLM(model, device="cpu", **kw), jax.state_dict(persistent_only=False))
    for metric in (jax, port):
        metric.update(PREDS[3:], TARGET[3:])
    got, want = port.compute(), jax.compute()
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert port.max_length == jax.max_length == 24


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("kwargs", [
    {"information_measure": "nope"}, {"information_measure": "alpha_divergence"},
    {"information_measure": "alpha_divergence", "alpha": 1.0}, {"information_measure": "beta_divergence", "beta": -1.0},
    {"information_measure": "ab_divergence", "alpha": 0.5, "beta": -0.5}, {"information_measure": "renyi_divergence",
                                                                          "alpha": 1.0},
    {"batch_size": 0}, {"temperature": 0},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_bad_arguments_raise_jax_s_messages(model, kwargs):
    assert _message(lambda: InfoLM(model, device="cpu", **kwargs)) == _message(lambda: JaxInfoLM(model, **kwargs))


def test_a_missing_model_raises_jax_s_words():
    with pytest.raises(OSError, match="local transformers cache and this environment has no network access"):
        InfoLM("no/such-model", device="cpu")
