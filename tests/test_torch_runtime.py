"""The port's ``Metric`` runtime, held against the JAX package's where both have the API.

Covers update/compute/forward on both forward paths, reset, clone, the state_dict
round trip, the pure API, the operator algebra, the argmax tie rule, placement on a
device, and sync in one process and under ``torch.distributed``.
"""

from __future__ import annotations

import socket
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
from torchmetrics_tpu.utils.data import first_argmax as jax_first_argmax  # noqa: E402
from torchmetrics_tpu_torch import CompositionalMetric, Metric  # noqa: E402
from torchmetrics_tpu_torch.utils.data import first_argmax  # noqa: E402
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError  # noqa: E402

C = 6
ATOL = 1e-6


def _batches(seed: int, n_batches: int = 3, n: int = 32):
    rng = np.random.RandomState(seed)
    return [
        (rng.rand(n, C).astype(np.float32), rng.randint(0, C, n).astype(np.int32)) for _ in range(n_batches)
    ]


def _close(jax_value, torch_value) -> None:
    want = np.asarray(jax_value)
    got = torch_value.detach().cpu().numpy()
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


class _SumOfSquares(Metric):
    """A metric with an unknown ``full_state_update``: forward takes the full-state path."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.total = self.total + (x.to(torch.float32) ** 2).sum()
        self.count = self.count + x.numel()

    def compute(self) -> torch.Tensor:
        return self.total / self.count


PAIRS = {
    "acc_micro": (lambda m, **k: m.MulticlassAccuracy(C, average="micro", **k)),
    "acc_macro": (lambda m, **k: m.MulticlassAccuracy(C, average="macro", **k)),
    "f1_weighted": (lambda m, **k: m.MulticlassF1Score(C, average="weighted", **k)),
    "confmat": (lambda m, **k: m.MulticlassConfusionMatrix(C, **k)),
    "auroc_binned": (lambda m, **k: m.MulticlassAUROC(C, thresholds=25, **k)),
    "auroc_exact": (lambda m, **k: m.MulticlassAUROC(C, **k)),
}


def _pair(name):
    return PAIRS[name](jc), PAIRS[name](tc, device="cpu")


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_update_compute_forward_match_jax(name):
    jm, tm = _pair(name)
    for p, t in _batches(1):
        _close(jm(jnp.asarray(p), jnp.asarray(t)), tm(torch.from_numpy(p), torch.from_numpy(t)))
    for p, t in _batches(2):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(p, t)  # numpy arguments go to the metric's device as tensors
    _close(jm.compute(), tm.compute())
    assert tm.update_count == jm.update_count == 6


def test_full_state_forward_path():
    m = _SumOfSquares(device="cpu")
    assert m.full_state_update is None
    batch_val = m(torch.tensor([1.0, 2.0]))
    assert torch.allclose(batch_val, torch.tensor(2.5))
    batch_val = m(torch.tensor([3.0]))
    assert torch.allclose(batch_val, torch.tensor(9.0))
    assert torch.allclose(m.compute(), torch.tensor(14.0 / 3))
    assert m.update_count == 2


def test_reset_restores_defaults():
    m = tc.MulticlassAccuracy(C, device="cpu")
    for p, t in _batches(3):
        m.update(p, t)
    m.reset()
    assert m.update_count == 0
    for key in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(m, key), torch.zeros(C, dtype=torch.int32))
    with pytest.warns(UserWarning, match="called before the ``update``"):
        m.compute()


@pytest.mark.parametrize("name", ["acc_macro", "auroc_binned", "auroc_exact"])
def test_state_dict_round_trip_has_jax_keys(name):
    jm, tm = _pair(name)
    for p, t in _batches(4):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(p, t)
    jm.persistent(True)
    tm.persistent(True)
    sd = tm.state_dict()
    assert set(sd) == set(jm.state_dict())
    fresh = PAIRS[name](tc, device="cpu")
    fresh.load_state_dict(sd)
    _close(jm.compute(), fresh.compute())
    strict = PAIRS[name](tc, device="cpu")
    strict.persistent(True)
    with pytest.raises(KeyError, match="Missing key"):
        strict.load_state_dict({})


def test_state_dict_default_is_persistent_only():
    m = tc.MulticlassAccuracy(C, device="cpu")
    assert m.state_dict() == {}
    assert set(m.state_dict(persistent_only=False)) == {"tp", "fp", "tn", "fn"}


def test_pure_api_matches_stateful_and_jax():
    jm, tm = _pair("acc_macro")
    batches = _batches(5)
    jstate, tstate = jm.init_state(), tm.init_state()
    for p, t in batches:
        jstate = jm.pure_update(jstate, jnp.asarray(p), jnp.asarray(t))
        tstate = tm.pure_update(tstate, torch.from_numpy(p), torch.from_numpy(t))
    _close(jm.pure_compute(jstate), tm.pure_compute(tstate))
    assert tm.update_count == 0 and torch.equal(tm.tp, torch.zeros(C, dtype=torch.int32))
    preds = torch.from_numpy(np.stack([p for p, _ in batches]))
    target = torch.from_numpy(np.stack([t for _, t in batches]))
    scanned = tm.scan_update(tm.init_state(), preds, target)
    for key in tstate:
        assert torch.equal(scanned[key], tstate[key])
    assert tm.sync_state(tstate).keys() == tstate.keys()


def test_pure_update_never_touches_the_callers_list_state():
    m = tc.MulticlassAUROC(C, device="cpu")
    state = m.init_state()
    p, t = _batches(6)[0]
    new = m.pure_update(state, torch.from_numpy(p), torch.from_numpy(t))
    assert state["preds"] == [] and len(new["preds"]) == 1
    with pytest.raises(TorchMetricsUserError, match="ragged"):
        m.scan_update(state, torch.from_numpy(p)[None], torch.from_numpy(t)[None])


@pytest.mark.parametrize(
    "expr",
    ["a + b", "a - b", "a * b", "a / b", "a ** 2", "2 * a", "1 - a", "abs(a)", "-a", "a > b", "a[0]"],
)
def test_operator_algebra_matches_jax(expr):
    ja, jb = jc.MulticlassAccuracy(C, average="none"), jc.MulticlassF1Score(C, average="none")
    ta = tc.MulticlassAccuracy(C, average="none", device="cpu")
    tb = tc.MulticlassF1Score(C, average="none", device="cpu")
    jcomp = eval(expr, {"a": ja, "b": jb})
    tcomp = eval(expr, {"a": ta, "b": tb})
    assert isinstance(tcomp, CompositionalMetric)
    for p, t in _batches(7):
        jcomp.update(jnp.asarray(p), jnp.asarray(t))
        tcomp.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(jcomp.compute(), tcomp.compute())
    tcomp.reset()
    assert ta.update_count == 0


def test_clone_is_independent():
    m = tc.MulticlassConfusionMatrix(C, device="cpu")
    p, t = _batches(8)[0]
    m.update(p, t)
    c = m.clone()
    c.update(p, t)
    assert torch.equal(c.confmat, 2 * m.confmat)
    assert c.update_count == 2 and m.update_count == 1


def test_argmax_takes_the_first_maximum_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.0, 0.0, 0.0, 5.0], [7.0, 1.0, 7.0, 7.0]],
                 dtype=np.float32)
    got = first_argmax(torch.from_numpy(x), dim=1)
    np.testing.assert_array_equal(got.numpy(), [1, 0, 3, 0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_first_argmax(jnp.asarray(x), axis=1)))
    # tied scores in a metric: both packages credit the first class
    target = np.array([1, 0, 3, 2], dtype=np.int32)
    ja, ta = jc.MulticlassAccuracy(4, average="none"), tc.MulticlassAccuracy(4, average="none", device="cpu")
    _close(ja(jnp.asarray(x), jnp.asarray(target)), ta(torch.from_numpy(x), torch.from_numpy(target)))


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tc.MulticlassAccuracy(C).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.MulticlassAccuracy(C)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.Accuracy(task="binary")
    m = tc.MulticlassAccuracy(C, device="cpu")
    assert m.device == torch.device("cpu") and m.tp.device.type == "cpu"
    assert m.to("cpu") is m and m.device.type == "cpu"


def test_states_are_int32_and_float32():
    m = tc.MulticlassAccuracy(C, device="cpu")
    assert m.tp.dtype == torch.int32
    b = tc.BinaryAUROC(thresholds=10, device="cpu")
    assert b.confmat.dtype == torch.int32 and b.thresholds.dtype == torch.float32
    b.update(torch.rand(8), torch.randint(0, 2, (8,)))
    assert b.compute().dtype == torch.float32


def test_task_wrappers_dispatch_and_refuse_multilabel():
    assert type(tc.Accuracy(task="multiclass", num_classes=3, device="cpu")) is tc.MulticlassAccuracy
    assert type(tc.F1Score(task="binary", device="cpu")) is tc.BinaryF1Score
    assert type(tc.AUROC(task="multiclass", num_classes=3, device="cpu")) is tc.MulticlassAUROC
    for cls in (tc.Accuracy, tc.F1Score, tc.ConfusionMatrix, tc.AUROC, tc.StatScores, tc.PrecisionRecallCurve):
        with pytest.raises(NotImplementedError, match="multilabel"):
            cls(task="multilabel", num_labels=3, device="cpu")


def test_lifecycle_errors():
    m = tc.MulticlassAccuracy(C, device="cpu")
    with pytest.raises(ValueError, match="Unexpected keyword arguments"):
        tc.MulticlassAccuracy(C, device="cpu", bogus=1)
    with pytest.raises(RuntimeError, match="Can't change const"):
        m.full_state_update = True
    with pytest.raises(NotImplementedError, match="iteration"):
        iter(m)
    p, t = _batches(9)[0]
    m.update(p, t)
    before = {k: v.clone() for k, v in m.state_dict(persistent_only=False).items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.sync()  # one process: a no-op
    after = m.state_dict(persistent_only=False)
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sync_raises_under_torch_distributed(monkeypatch):
    """Under an initialised process group (gloo, a world of one) nothing raises any
    more: ``compute`` syncs and equals the local value, ``forward``'s batch value never
    syncs, and ``sync_state`` is the identity."""
    m = tc.MulticlassAccuracy(C, device="cpu")
    local = tc.MulticlassAccuracy(C, device="cpu")
    (p, t), (p2, t2) = _batches(9, n_batches=2)
    m.update(p, t)
    local.update(p, t)
    gathers = []
    all_gather = torch.distributed.all_gather
    monkeypatch.setattr(torch.distributed, "all_gather", lambda *a, **k: gathers.append(1) or all_gather(*a, **k))
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1
    )
    try:
        batch_value = m(p2, t2)
        assert not gathers  # forward's batch value never syncs
        local.update(p2, t2)
        torch.testing.assert_close(batch_value, tc.MulticlassAccuracy(C, device="cpu")(p2, t2), rtol=0, atol=0)
        value = m.compute()
        assert len(gathers) == len(m._defaults)  # one all_gather per state
        torch.testing.assert_close(value, local.compute(), rtol=0, atol=0)
        assert not m._is_synced and m._cache is None  # the local state is bound again
        state = m.state_dict(persistent_only=False)
        synced = m.sync_state(dict(state))
        assert synced.keys() == state.keys()
        assert all(torch.equal(synced[k], state[k]) for k in state)
    finally:
        torch.distributed.destroy_process_group()
    assert m.compute() is not None
