"""The slice end to end: the classification evaluation loop in both packages.

A stateful loop of 4 batches of 64 samples, 10 classes, through the metric set of
``chip_smoke.py``'s ImageNet phase (and a binary set like its CTR phase), fed the
same numpy batches in the JAX package and in the port. Then the carry-across: 2
batches in JAX, ``state_dict`` → ``convert.jax_state`` → 2 more batches in the port
equals 4 batches in JAX. Last, importing the port pulls in neither JAX nor the JAX
package.

Integer states are compared exactly and floats at ``ATOL``, except the calibration
``bins`` state, at ``BINS_RTOL``: its confidence sums reach tens, where a float32
ulp is about 2e-6, and JAX sums them in float32 while the port sums in float64 and
rounds once.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
from torchmetrics_tpu_torch.convert import jax_state_to_torch, load_jax_state  # noqa: E402

C, BATCH, STEPS = 10, 64, 4
ATOL = 1e-6
BINS_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, factory(module, **kwargs)) — the ImageNet-style multiclass set
MULTICLASS_SET = {
    "accuracy_top1": lambda m, **k: m.MulticlassAccuracy(C, average="micro", validate_args=False, **k),
    "accuracy_macro": lambda m, **k: m.MulticlassAccuracy(C, average="macro", validate_args=False, **k),
    "f1_macro": lambda m, **k: m.MulticlassF1Score(C, average="macro", validate_args=False, **k),
    "confmat": lambda m, **k: m.MulticlassConfusionMatrix(C, validate_args=False, **k),
    "auroc_t100": lambda m, **k: m.MulticlassAUROC(C, thresholds=100, validate_args=False, **k),
    "prc_micro_t200": lambda m, **k: m.MulticlassPrecisionRecallCurve(
        C, average="micro", thresholds=200, validate_args=False, **k
    ),
    "precision_macro": lambda m, **k: m.MulticlassPrecision(C, average="macro", validate_args=False, **k),
    "recall_macro": lambda m, **k: m.MulticlassRecall(C, average="macro", validate_args=False, **k),
    "jaccard_macro": lambda m, **k: m.MulticlassJaccardIndex(C, average="macro", validate_args=False, **k),
    "matthews": lambda m, **k: m.MulticlassMatthewsCorrCoef(C, validate_args=False, **k),
    "cohen_kappa": lambda m, **k: m.MulticlassCohenKappa(C, validate_args=False, **k),
    "calibration_b15": lambda m, **k: m.MulticlassCalibrationError(C, n_bins=15, validate_args=False, **k),
}

# the CTR-style binary set, with ignored targets
BINARY_SET = {
    "auroc_t1000": lambda m, **k: m.BinaryAUROC(thresholds=1000, ignore_index=-1, validate_args=False, **k),
    "accuracy": lambda m, **k: m.BinaryAccuracy(ignore_index=-1, validate_args=False, **k),
    "f1": lambda m, **k: m.BinaryF1Score(ignore_index=-1, validate_args=False, **k),
    "confmat": lambda m, **k: m.BinaryConfusionMatrix(ignore_index=-1, validate_args=False, **k),
    "average_precision_t1000": lambda m, **k: m.BinaryAveragePrecision(
        thresholds=1000, ignore_index=-1, validate_args=False, **k
    ),
    "matthews": lambda m, **k: m.BinaryMatthewsCorrCoef(ignore_index=-1, validate_args=False, **k),
    "jaccard": lambda m, **k: m.BinaryJaccardIndex(ignore_index=-1, validate_args=False, **k),
    "calibration_b15": lambda m, **k: m.BinaryCalibrationError(n_bins=15, ignore_index=-1, validate_args=False, **k),
}


def _multiclass_batches(seed: int = 0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        target = rng.randint(0, C, BATCH).astype(np.int32)
        logits = rng.randn(BATCH, C).astype(np.float32)
        logits[np.arange(BATCH), target] += 1.5
        out.append((logits, target))
    return out


def _binary_batches(seed: int = 1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        target = rng.randint(0, 2, BATCH).astype(np.int32)
        scores = np.clip(rng.rand(BATCH) * 0.7 + 0.3 * target, 0, 1).astype(np.float32)
        target[rng.rand(BATCH) < 0.1] = -1
        out.append((scores, target))
    return out


def _assert_match(jax_out, torch_out, rtol: float = 0.0) -> None:
    if isinstance(jax_out, (tuple, list)):
        for a, b in zip(jax_out, torch_out, strict=True):
            _assert_match(a, b, rtol)
        return
    want = np.asarray(jax_out)
    got = torch_out.detach().cpu().numpy()
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol)


def _states_match(jm, tm) -> None:
    jsd = jm.state_dict(persistent_only=False)
    tsd = tm.state_dict(persistent_only=False)
    assert set(jsd) == set(tsd)
    for key in jsd:
        _assert_match(jsd[key], tsd[key], BINS_RTOL if key == "bins" else 0.0)


def _sets():
    return [("multiclass", name, MULTICLASS_SET[name], _multiclass_batches()) for name in sorted(MULTICLASS_SET)] + [
        ("binary", name, BINARY_SET[name], _binary_batches()) for name in sorted(BINARY_SET)
    ]


CASES = {f"{kind}-{name}": (factory, batches) for kind, name, factory, batches in _sets()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_loop_matches_jax(case):
    factory, batches = CASES[case]
    jm, tm = factory(jc), factory(tc, device="cpu")
    for p, t in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _states_match(jm, tm)
    _assert_match(jm.compute(), tm.compute())


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_carried_across_from_jax(case):
    factory, batches = CASES[case]
    jax_full = factory(jc)
    for p, t in batches:
        jax_full.update(jnp.asarray(p), jnp.asarray(t))
    jax_half = factory(jc)
    for p, t in batches[:2]:
        jax_half.update(jnp.asarray(p), jnp.asarray(t))

    port = load_jax_state(factory(tc, device="cpu"), jax_half.state_dict(persistent_only=False))
    for p, t in batches[2:]:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    _states_match(jax_full, port)
    _assert_match(jax_full.compute(), port.compute())


@pytest.mark.parametrize("kind, name", [("multiclass", "calibration_b15"), ("multiclass", "jaccard_macro"),
                                        ("binary", "calibration_b15")])
def test_jax_state_loads_into_the_port_and_computes_the_same(kind, name):
    factory = (MULTICLASS_SET if kind == "multiclass" else BINARY_SET)[name]
    batches = _multiclass_batches(seed=5) if kind == "multiclass" else _binary_batches(seed=6)
    jm = factory(jc)
    for p, t in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t))
    state = jm.state_dict(persistent_only=False)
    port = load_jax_state(factory(tc, device="cpu"), state)
    key = "bins" if name.startswith("calibration") else "confmat"
    assert port.state_dict(persistent_only=False)[key].dtype == (torch.float32 if key == "bins" else torch.int32)
    np.testing.assert_array_equal(port.state_dict(persistent_only=False)[key].numpy(), np.asarray(state[key]))
    _assert_match(jm.compute(), port.compute())


def test_jax_state_keeps_dtypes_and_lists():
    sd = {"tp": np.arange(3, dtype=np.int32), "preds": [np.ones(2, np.float32)], "valid": [np.ones(2, bool)],
          "__robust__": np.zeros(5, np.int64)}
    out = jax_state_to_torch(sd, device="cpu")
    assert set(out) == {"tp", "preds", "valid"}
    assert out["tp"].dtype == torch.int32 and out["preds"][0].dtype == torch.float32
    assert out["valid"][0].dtype == torch.bool
    # a MaskedBuffer comes as the JAX package writes it, a dict of data and count
    buf = jax_state_to_torch({"preds": {"data": np.arange(4, dtype=np.float32), "count": np.int32(3)}}, "cpu")
    assert buf["preds"]["data"].dtype == torch.float32 and int(buf["preds"]["count"]) == 3
    with pytest.raises(ValueError, match="MaskedBuffer"):
        jax_state_to_torch({"preds": {"data": np.zeros(2)}}, device="cpu")


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torchmetrics_tpu_torch, torchmetrics_tpu_torch.convert, torchmetrics_tpu_torch.ops,"
        " torchmetrics_tpu_torch.engine, torchmetrics_tpu_torch.obs, torchmetrics_tpu_torch.robust,"
        " torchmetrics_tpu_torch.utils.fileio, torchmetrics_tpu_torch.convert.__main__,"
        " torchmetrics_tpu_torch.functional.image._lpips_backbones, torchmetrics_tpu_torch.functional.image.lpips,"
        " torchmetrics_tpu_torch.functional.image.perceptual_path_length, torchmetrics_tpu_torch.image.lpip,"
        " torchmetrics_tpu_torch.image._inception_net, torchmetrics_tpu_torch.image.fid,"
        " torchmetrics_tpu_torch.image.inception, torchmetrics_tpu_torch.image.kid,"
        " torchmetrics_tpu_torch.image.mifid, torchmetrics_tpu_torch.image.perceptual_path_length,"
        " torchmetrics_tpu_torch.text.bert, torchmetrics_tpu_torch.text.infolm, torchmetrics_tpu_torch.multimodal,"
        " torchmetrics_tpu_torch.functional.multimodal, torchmetrics_tpu_torch.utils.hf.snapshot,"
        " torchmetrics_tpu_torch.utils.hf.tokenizer, torchmetrics_tpu_torch.utils.hf.wordpiece,"
        " torchmetrics_tpu_torch.utils.hf.bpe, torchmetrics_tpu_torch.utils.hf.encoders,"
        " torchmetrics_tpu_torch.utils.hf.clip, torchmetrics_tpu_torch.utils.hf.image_processor;"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'flax' or m.startswith('flax.')"
        " or m.split('.')[0] in ('transformers', 'tokenizers', 'safetensors', 'msgpack', 'regex', 'PIL')"
        " or m == 'torchmetrics_tpu' or m.startswith('torchmetrics_tpu.'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
