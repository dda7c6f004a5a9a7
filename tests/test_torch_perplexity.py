"""The port's perplexity, held against the JAX package on the CPU.

The cases of ``tests/text/test_text.py``'s ``TestPerplexity`` (two updates with and
without ``ignore_index``, the shape check) and ``tests/text/test_text_stream_sweep.py``'s
perplexity stream (``ignore_index=-100``) run through both packages, held against JAX
rather than the reference. Added: both branches of JAX's ``_logsumexp_last_axis`` (V =
32,000, Llama-2's vocabulary and a multiple of 128, where JAX sums 128-lane partials,
and V = 50,257, GPT-2's, where it does not) against the port's one ``torch.logsumexp``;
a batch that ignores every token (0/0, NaN in both packages); the type and shape
messages; the class over batches, ``merge_states`` of two halves, a JAX state dict
loaded and updated further, and ``jit_update=True`` (the capture cache's CPU route)
against the eager update.

Tolerances: the token count exactly; the summed negative log-likelihood and the
perplexity within 1e-5 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.text as jf  # noqa: E402
import torchmetrics_tpu.text as jt  # noqa: E402
import torchmetrics_tpu_torch.functional.text as tf  # noqa: E402
import torchmetrics_tpu_torch.text as tt  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.parallel.reductions import merge_states  # noqa: E402

RTOL = 1e-5


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, jax_value) -> None:
    got, want = _np(port), _np(jax_value)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def logits(seed: int, shape: tuple, vocab: int, ignore=None, signal: float = 3.0):
    """Seeded float32 logits with a signal on the target, and int targets; ``ignore``
    replaces about a fifth of the targets."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, vocab, shape)
    x = rng.normal(size=(*shape, vocab)).astype(np.float32)
    np.put_along_axis(x, target[..., None], np.take_along_axis(x, target[..., None], -1) + signal, -1)
    if ignore is not None:
        target = np.where(rng.rand(*shape) < 0.2, ignore, target)
    return x, target


@pytest.mark.parametrize("ignore_index", [None, 2, -100])
@pytest.mark.parametrize("vocab", [5, 12, 256, 32_000, 50_257])
def test_functional_equals_jax(vocab, ignore_index):
    shape = (2, 8) if vocab < 1000 else (2, 6)
    x, target = logits(vocab, shape, vocab, ignore=ignore_index)
    got = tf.perplexity(torch.from_numpy(x), torch.from_numpy(target), ignore_index=ignore_index)
    _close(got, jf.perplexity(jnp.asarray(x), jnp.asarray(target), ignore_index=ignore_index))


@pytest.mark.parametrize("vocab", [32_000, 50_257])
def test_update_sums_equal_jax_on_both_logsumexp_branches(vocab):
    from torchmetrics_tpu.functional.text.perplexity import _perplexity_update as jupdate
    from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_update as tupdate

    x, target = logits(vocab + 1, (3, 5), vocab, ignore=-100, signal=8.0)
    total, count = tupdate(torch.from_numpy(x), torch.from_numpy(target), -100)
    jtotal, jcount = jupdate(jnp.asarray(x), jnp.asarray(target), -100)
    assert int(count) == int(jcount) and count.dtype == torch.int32
    _close(total, jtotal)


def test_a_batch_that_ignores_every_token_is_nan_in_both():
    x, target = logits(1, (2, 4), 7)
    target = np.full_like(target, -100)
    got = tf.perplexity(torch.from_numpy(x), torch.from_numpy(target), ignore_index=-100)
    want = jf.perplexity(jnp.asarray(x), jnp.asarray(target), ignore_index=-100)
    assert np.isnan(_np(got)) and np.isnan(_np(want))


@pytest.mark.parametrize("ignore_index", [None, 2])
def test_class_against_jax_over_two_updates(ignore_index):
    """``TestPerplexity.test_against_reference``, held against JAX."""
    rng = np.random.RandomState(22)
    preds = rng.rand(2, 2, 8, 5).astype(np.float32)
    target = rng.randint(0, 5, (2, 2, 8))
    port, jax_metric = tt.Perplexity(ignore_index=ignore_index, device="cpu"), jt.Perplexity(ignore_index=ignore_index)
    for i in range(2):
        port.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        jax_metric.update(jnp.asarray(preds[i]), jnp.asarray(target[i]))
    _close(port.compute(), jax_metric.compute())


def _stream(seed: int = 0, n: int = 3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(2, 8, 12)).astype(np.float32)
        target = rng.randint(0, 12, (2, 8))
        target[0, :2] = -100
        out.append((x, target))
    return out


def test_stream_with_ignored_tokens_equals_jax():
    """``test_text_stream_sweep.py``'s perplexity stream."""
    port, jax_metric = tt.Perplexity(ignore_index=-100, device="cpu"), jt.Perplexity(ignore_index=-100)
    for x, target in _stream():
        _close(port(torch.from_numpy(x), torch.from_numpy(target)), jax_metric(jnp.asarray(x), jnp.asarray(target)))
    state, jax_state = port.state_dict(persistent_only=False), jax_metric.state_dict(persistent_only=False)
    np.testing.assert_array_equal(_np(state["count"]), np.asarray(jax_state["count"]))
    _close(state["total_log_probs"], jax_state["total_log_probs"])
    _close(port.compute(), jax_metric.compute())


def test_merged_halves_equal_one_metric_fed_everything():
    batches = [(torch.from_numpy(x), torch.from_numpy(t)) for x, t in _stream(5, 4)]
    first, second, whole = (tt.Perplexity(ignore_index=-100, device="cpu") for _ in range(3))
    for b in batches[:2]:
        first.update(*b)
    for b in batches[2:]:
        second.update(*b)
    for b in batches:
        whole.update(*b)
    state = {k: merge_states(first.metric_state[k], second.metric_state[k], first._reductions[k], 2, 2)
             for k in first.metric_state}
    np.testing.assert_array_equal(_np(state["count"]), _np(whole.count))
    _close(whole.pure_compute(state), whole.compute())


def test_a_jax_state_loaded_into_the_port_goes_on_equal():
    batches = _stream(6, 3)
    jax_metric = jt.Perplexity(ignore_index=-100)
    jax_metric.update(jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    port = load_jax_state(tt.Perplexity(ignore_index=-100, device="cpu"), jax_metric.state_dict(persistent_only=False))
    for x, target in batches[1:]:
        jax_metric.update(jnp.asarray(x), jnp.asarray(target))
        port.update(torch.from_numpy(x), torch.from_numpy(target))
    assert port.count.dtype == torch.float32
    _close(port.compute(), jax_metric.compute())


def test_a_captured_update_equals_the_eager_one():
    eager = tt.Perplexity(ignore_index=-100, device="cpu")
    captured = tt.Perplexity(ignore_index=-100, device="cpu", jit_update=True)
    for x, target in _stream(7, 3):
        eager.update(torch.from_numpy(x), torch.from_numpy(target))
        captured.update(torch.from_numpy(x), torch.from_numpy(target))
    for key in ("total_log_probs", "count"):
        assert torch.equal(getattr(eager, key), getattr(captured, key))
    info = captured._jitted_update.cache_info()
    assert info["misses"] == 1 and info["hits"] == 2


def test_the_compute_group_key_is_the_ignore_index():
    assert tt.Perplexity(ignore_index=3, device="cpu")._compute_group_params() == (3,)
    assert tt.Perplexity(device="cpu")._compute_group_params() == jt.Perplexity()._compute_group_params()


def _message(fn, exc) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_type_and_shape_messages_equal_jax():
    """``TestPerplexity.test_raises_on_bad_shapes`` and the rest of the checks."""
    cases = [
        ((np.zeros((2, 8), np.float32), np.zeros((2, 8), np.int32)), ValueError),
        ((np.zeros((2, 8, 5), np.float32), np.zeros((2, 8, 1), np.int32)), ValueError),
        ((np.zeros((2, 8, 5), np.float32), np.zeros((2, 7), np.int32)), ValueError),
        ((np.zeros((2, 8, 5), np.int32), np.zeros((2, 8), np.int32)), TypeError),
        ((np.zeros((2, 8, 5), np.float32), np.zeros((2, 8), np.float32)), TypeError),
    ]
    for (x, target), exc in cases:
        got = _message(lambda: tf.perplexity(torch.from_numpy(x), torch.from_numpy(target)), exc)
        assert got == _message(lambda: jf.perplexity(jnp.asarray(x), jnp.asarray(target)), exc)
    assert _message(lambda: tt.Perplexity(ignore_index=1.5, device="cpu"), ValueError) == _message(
        lambda: jt.Perplexity(ignore_index=1.5), ValueError)
