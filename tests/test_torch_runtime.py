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


# ------------------- compute_on_cpu, the list-state growth guard, the Metric surface


def _binary_batches(seed: int, n_batches: int = 5, n: int = 16):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n).astype(np.float32), rng.randint(0, 2, n).astype(np.int32)) for _ in range(n_batches)]


class _JitList(Metric):
    """``jit_update=True`` forced on a ragged list state (the JAX suite's ``_JitListMetric``)."""

    def __init__(self, **kwargs):
        super().__init__(**{"device": "cpu", "jit_update": True, "compute_on_cpu": True, **kwargs})
        self.add_state("items", [], dist_reduce_fx="cat")

    def update(self, x):
        self.items.append(x * 2)

    def compute(self):
        return torch.cat(self.items).sum()


@pytest.mark.parametrize("path", ["eager", "pipeline"])
def test_compute_on_cpu_lands_list_states_on_the_host_as_jax_does(path):
    """JAX's ``TestComputeOnCpuListStates``: list states move to the host after each
    update (the engine drives a list-state metric per batch) and compute as without."""
    from torchmetrics_tpu.engine import MetricPipeline as JPipe
    from torchmetrics_tpu.engine import PipelineConfig as JConf
    from torchmetrics_tpu_torch.engine import MetricPipeline as TPipe
    from torchmetrics_tpu_torch.engine import PipelineConfig as TConf

    batches = _binary_batches(31)
    jm = jc.BinaryPrecisionRecallCurve(thresholds=None, compute_on_cpu=True)
    tm = tc.BinaryPrecisionRecallCurve(thresholds=None, compute_on_cpu=True, device="cpu")
    if path == "eager":
        for p, t in batches:
            jm.update(jnp.asarray(p), jnp.asarray(t))
            tm.update(p, t)
    else:
        JPipe(jm, JConf(fuse=4)).run([(jnp.asarray(p), jnp.asarray(t)) for p, t in batches])
        TPipe(tm, TConf(fuse=4)).run([(torch.as_tensor(p), torch.as_tensor(t)) for p, t in batches])
    for key in ("preds", "target"):
        jlist, tlist = jm._state_values[key], tm._state_values[key]
        assert len(jlist) == len(tlist) == 5
        assert all(isinstance(v, np.ndarray) for v in jlist)
        assert all(v.device.type == "cpu" for v in tlist)
    for a, b in zip(jm.compute(), tm.compute()):
        _close(a, b)
    with pytest.raises(ValueError, match="compute_on_cpu"):
        tc.BinaryAccuracy(compute_on_cpu="yes", device="cpu")


def test_compute_on_cpu_after_a_captured_list_update_as_jax_does():
    """The forced-jit branch: the move runs after the captured update returns."""
    import torchmetrics_tpu.core.metric as jmetric

    class JaxJitList(jmetric.Metric):
        def __init__(self):
            super().__init__(jit_update=True, compute_on_cpu=True)
            self.add_state("items", [], dist_reduce_fx="cat")

        def update(self, x):
            self.items.append(x * 2)

        def compute(self):
            return jnp.concatenate([jnp.asarray(v) for v in self.items]).sum()

    jm, tm = JaxJitList(), _JitList()
    for _ in range(2):
        jm.update(jnp.ones(4))
        tm.update(torch.ones(4))
    assert len(jm.items) == len(tm.items) == 2
    assert all(isinstance(v, np.ndarray) for v in jm.items) and all(v.device.type == "cpu" for v in tm.items)
    _close(jm.compute(), tm.compute())


@pytest.mark.parametrize("path", ["eager", "pipeline"])
def test_list_state_growth_warns_once_and_gauges_as_jax_does(path):
    """JAX ``tests/core/test_obs_memory.py``: past the threshold both packages warn
    exactly once, and with tracing on both set the same ``state.list_items`` gauge."""
    import torchmetrics_tpu.obs.trace as jtrace
    import torchmetrics_tpu_torch.obs.trace as ttrace
    from torchmetrics_tpu.engine import MetricPipeline as JPipe
    from torchmetrics_tpu.engine import PipelineConfig as JConf
    from torchmetrics_tpu_torch.engine import MetricPipeline as TPipe
    from torchmetrics_tpu_torch.engine import PipelineConfig as TConf

    batches = _binary_batches(7)
    seen = {}
    for name, pkg, arr, pipe, conf, trace_mod, kw in (
        ("jax", jc, jnp.asarray, JPipe, JConf, jtrace, {}),
        ("torch", tc, torch.as_tensor, TPipe, TConf, ttrace, {"device": "cpu"}),
    ):
        m = pkg.BinaryPrecisionRecallCurve(thresholds=None, **kw)
        m.list_state_warn_threshold = 5
        with trace_mod.observe() as rec, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if path == "eager":
                for p, t in batches:
                    m.update(arr(p), arr(t))
            else:
                pipe(m, conf(fuse=4)).run([(arr(p), arr(t)) for p, t in batches])
        growth = [w for w in caught if "ragged list-state items" in str(w.message)]
        gauges = {g["name"]: g for g in rec.snapshot()["gauges"]}
        events = [e for e in rec.events() if e["name"] == "state.list_growth"]
        seen[name] = (len(growth), gauges["state.list_items"]["value"],
                      sorted(gauges["state.list_items"]["labels"]), len(events), str(growth[0].message))
    # three list states (preds, target and the mask) of 5 items each
    assert seen["jax"][:4] == seen["torch"][:4] == (1, 15, ["inst", "metric"], 1)
    # the one warning came at the second update: 6 items past the threshold of 5
    for name in ("jax", "torch"):
        assert "holds 6 ragged list-state items (threshold 5): preds: 2 items, target: 2 items, valid: 2 items" \
            in seen[name][4], name


def test_metric_surface_matches_jax():
    """``metric_state``, ``dtype`` (recorded by ``set_dtype``), ``state_reductions()``,
    ``to_device``, the top-level ``MaskedBuffer`` and the declared value bounds."""
    import torchmetrics_tpu as jtm
    import torchmetrics_tpu_torch as ttm

    jm, tm = jc.MulticlassAccuracy(C, average="macro"), tc.MulticlassAccuracy(C, average="macro", device="cpu")
    for p, t in _batches(3):
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(p, t)
    assert sorted(jm.metric_state) == sorted(tm.metric_state)
    for key in jm.metric_state:
        _close(jm.metric_state[key], tm.metric_state[key])
    assert {k: str(v) for k, v in jm.state_reductions().items()} == {k: str(v) for k, v in tm.state_reductions().items()}
    assert tm.dtype == torch.float32 and jm.dtype == jnp.float32
    jcal, tcal = jc.BinaryCalibrationError(), tc.BinaryCalibrationError(device="cpu")
    jcal.set_dtype(jnp.float16)
    tcal.set_dtype(torch.float16)
    assert tcal.dtype == torch.float16 and jcal.dtype == jnp.float16
    assert tm.to_device("cpu") is tm and tm.device.type == "cpu"
    assert ttm.MaskedBuffer.__name__ == jtm.MaskedBuffer.__name__ == "MaskedBuffer"
    for name in ("MulticlassAccuracy", "MulticlassMatthewsCorrCoef", "BinaryCalibrationError", "MulticlassAUROC",
                 "MulticlassConfusionMatrix", "BinaryAveragePrecision", "MulticlassCohenKappa"):
        jcls, tcls = getattr(jc, name), getattr(tc, name)
        args = () if name.startswith("Binary") else (C,)
        assert jcls(*args)._resolved_value_bounds() == tcls(*args, device="cpu")._resolved_value_bounds(), name

    class Bounded(_SumOfSquares):
        value_bounds = (0, None)

    assert Bounded(device="cpu")._resolved_value_bounds() == (0.0, None)
