"""The port's sync guard (``robust/degraded.py``) held against the JAX package's.

Three parts:

- the guard alone: every fault schedule of the table below runs through both packages'
  ``guarded_collective`` on the same plain-Python collective; the outcome (result, or
  error type and message), the calls that reached the collective, the thread they ran
  on, the warnings and the trace counters must be the same;
- ``Metric.sync`` in a faked two-rank world (JAX's ``two_host_world`` of
  ``tests/core/test_fault_tolerance.py``; in the port ``torch.distributed``'s
  ``all_gather`` hands back two copies): the JAX cases of ``TestDegradedSync``, with the
  state, the flags, the warnings and the ``sync.*`` counters compared exactly;
- a real one-rank gloo world over ``tcp://localhost``: an injected hang degrades
  ``Metric.sync`` and ``aggregate``, a guarded sync goes through the real collective,
  and the unconfigured guard calls ``all_gather`` on the caller's thread.

Injected hangs park on timeouts of 0.2 s or less; no case asserts a wall time.
"""

from __future__ import annotations

import os
import socket
import threading
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu.parallel.sync as jsync  # noqa: E402
import torchmetrics_tpu.robust as jrobust  # noqa: E402
import torchmetrics_tpu.robust.degraded as jdegraded  # noqa: E402
import torchmetrics_tpu.robust.faults as jfaults  # noqa: E402
import torchmetrics_tpu_torch.obs.aggregate as taggregate  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
import torchmetrics_tpu_torch.parallel.sync as tsync  # noqa: E402
import torchmetrics_tpu_torch.robust as trobust  # noqa: E402
import torchmetrics_tpu_torch.robust.degraded as tdegraded  # noqa: E402
import torchmetrics_tpu_torch.robust.faults as tfaults  # noqa: E402
from test_torch_robust import MeanSquaredError as TMeanSquaredError  # noqa: E402
from torchmetrics_tpu.regression import MeanSquaredError as JMeanSquaredError  # noqa: E402

JAX = SimpleNamespace(robust=jrobust, degraded=jdegraded, faults=jfaults, trace=jtrace)
PORT = SimpleNamespace(robust=trobust, degraded=tdegraded, faults=tfaults, trace=ttrace)
SIDES = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True)
def _clean_guard_and_trace():
    """Each case starts and ends with both guards unconfigured and tracing off."""
    for side in SIDES.values():
        side.degraded._CONFIG.update({"timeout": None, "retries": 1, "explicit": False})
        side.trace.disable()
        side.trace.get_recorder().clear()
    yield
    for side in SIDES.values():
        side.degraded._CONFIG.update({"timeout": None, "retries": 1, "explicit": False})
        side.trace.disable()
        side.trace.get_recorder().clear()


def _counters(side) -> dict:
    snap = side.trace.get_recorder().snapshot()
    out = {(c["name"], tuple(sorted(c["labels"].items()))): c["value"] for c in snap["counters"]}
    for h in snap["histograms"]:
        out[(h["name"] + ".count", tuple(sorted(h["labels"].items())))] = h["count"]
    return out


# ------------------------------------------------------------------ the guard alone

# (guard config or None, fault plan or None, collective behaviour, env)
GUARD_CASES = {
    "unconfigured_direct": (None, None, "ok", {}),
    "unconfigured_with_raise_fault": (None, ("raise", 1), "ok", {}),
    "unconfigured_with_hang_fault": (None, ("hang", 1), "ok", {}),
    "transient_raise_recovers": ((0.2, 1), ("raise", 1), "ok", {}),
    "raise_exhausts_two_attempts": ((0.2, 1), ("raise", 10), "ok", {}),
    "raise_no_retries": ((0.2, 0), ("raise", 1), "ok", {}),
    "raise_three_retries_recovers": ((0.2, 3), ("raise", 3), "ok", {}),
    "hang_never_retried": ((0.05, 3), ("hang", 1), "ok", {}),
    "oserror_retried": ((0.2, 2), None, "oserror_twice", {}),
    "runtime_error_exhausts": ((0.2, 1), None, "runtime_error", {}),
    "type_error_propagates": ((0.2, 3), None, "type_error", {}),
    "real_block_times_out": ((0.05, 2), None, "block", {}),
    "env_timeout_arms_guard": (None, ("raise", 1), "ok", {"TM_TPU_SYNC_TIMEOUT": "0.2", "TM_TPU_SYNC_RETRIES": "0"}),
    "env_bad_values_fall_back": (None, None, "ok", {"TM_TPU_SYNC_TIMEOUT": "soon", "TM_TPU_SYNC_RETRIES": "-1"}),
    "explicit_beats_env": ((0.2, 2), ("raise", 2), "ok", {"TM_TPU_SYNC_TIMEOUT": "0.01", "TM_TPU_SYNC_RETRIES": "0"}),
}


def _play_guard(side, config, plan, behaviour, env, monkeypatch) -> dict:
    for key in ("TM_TPU_SYNC_TIMEOUT", "TM_TPU_SYNC_RETRIES"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    side.degraded._ENV_WARNED.clear()
    side.trace.enable()
    calls = []
    release = threading.Event()

    def collective(x, scale=1):
        calls.append(threading.current_thread().name.startswith("guarded-"))
        n = len(calls)
        if behaviour == "oserror_twice" and n <= 2:
            raise OSError(f"link down {n}")
        if behaviour == "runtime_error":
            raise RuntimeError("transport failed")
        if behaviour == "type_error":
            raise TypeError("bad payload")
        if behaviour == "block":
            release.wait(2.0)
        return [x * scale, x * scale]

    out: dict = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            guard = side.robust.sync_guard(*config) if config is not None else None
            if guard is not None:
                guard.__enter__()
            try:
                fault = side.faults.inject_collective_fault(*plan) if plan is not None else None
                if fault is not None:
                    fault.__enter__()
                try:
                    out["result"] = side.degraded.guarded_collective(collective, 3, scale=2, description="probe")
                finally:
                    if fault is not None:
                        fault.__exit__(None, None, None)
            finally:
                if guard is not None:
                    guard.__exit__(None, None, None)
        except Exception as err:  # noqa: BLE001 - the outcome is what is compared
            out["error"] = (type(err).__name__, str(err), type(err.__cause__).__name__)
    release.set()
    out["calls"] = calls
    out["warnings"] = [(w.category.__name__, str(w.message)) for w in caught]
    out["counters"] = _counters(side)
    out["config_after"] = dict(side.degraded._CONFIG)
    return out


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_outcomes_and_counters_match_jax(case, monkeypatch):
    config, plan, behaviour, env = GUARD_CASES[case]
    jax_out = _play_guard(JAX, config, plan, behaviour, env, monkeypatch)
    port_out = _play_guard(PORT, config, plan, behaviour, env, monkeypatch)
    assert port_out == jax_out


@pytest.mark.parametrize(
    "args, message",
    [((0.0, 1), "Expected `timeout` to be positive or None, got 0.0"),
     ((-1.0, 1), "Expected `timeout` to be positive or None, got -1.0"),
     ((1.0, -1), "Expected `retries` to be >= 0, got -1")],
)
def test_configure_sync_guard_refuses_what_jax_refuses(args, message):
    for side in SIDES.values():
        with pytest.raises(ValueError, match=message.replace("(", r"\(")):
            side.robust.configure_sync_guard(*args)


def test_sync_guard_restores_the_previous_config_as_jax_does():
    seen = {}
    for name, side in SIDES.items():
        before = dict(side.degraded._CONFIG)
        previous = side.robust.configure_sync_guard(3.0, 2)
        with side.robust.sync_guard(0.5, 0):
            inside = dict(side.degraded._CONFIG)
        after = dict(side.degraded._CONFIG)
        seen[name] = (before, previous, inside, after)
    assert seen["port"] == seen["jax"]


def test_robust_all_lists_jax_names():
    assert sorted(trobust.__all__) == sorted(jrobust.__all__)
    assert sorted(tdegraded.__all__) == sorted(jdegraded.__all__)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("on_card", [True, False], ids=["cuda_payload", "host_payload"])
def test_guard_thread_enters_the_callers_device_and_stream(on_card, monkeypatch):
    """With a timeout set, the worker thread runs a CUDA payload's collective on the
    caller's device and current stream (a new thread starts on the default ones); a
    host payload's collective touches no CUDA state. ``torch.cuda`` is faked here."""
    current = threading.local()
    entered = []

    def scoped(attr):
        class _Scope:
            def __init__(self, value):
                self.value = value

            def __enter__(self):
                self.prev = getattr(current, attr, "default")
                setattr(current, attr, self.value)
                entered.append((attr, self.value))

            def __exit__(self, *exc):
                setattr(current, attr, self.prev)

        return _Scope

    def current_stream(device):
        return SimpleNamespace(device=f"card:{device}", name="caller's side stream")

    def no_cuda(*args, **kwargs):
        raise AssertionError("a host payload's collective touched CUDA state")

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream if on_card else no_cuda)
    monkeypatch.setattr(torch.cuda, "device", scoped("device") if on_card else no_cuda)
    monkeypatch.setattr(torch.cuda, "stream", scoped("stream") if on_card else no_cuda)
    payload = torch.arange(4.0)
    if on_card:
        payload = payload.as_subclass(_OnCard)
    seen = []

    def collective(parts, tensor, group=None):
        seen.append((threading.current_thread().name, getattr(current, "device", "default"),
                     getattr(getattr(current, "stream", None), "name", "default")))
        parts[0].copy_(tensor)

    parts = [torch.empty(4)]
    with trobust.sync_guard(5.0, 0):
        tdegraded.guarded_collective(collective, parts, payload, group=None, description="probe")
    assert torch.equal(parts[0], torch.arange(4.0))
    name, device, stream = seen[0]
    assert name == "guarded-probe"
    if on_card:
        assert (device, stream) == ("card:cpu", "caller's side stream")
        assert [attr for attr, _ in entered] == ["device", "stream"]
    else:
        assert (device, stream) == ("default", "default") and not entered


# --------------------------------------------------------- Metric.sync, two fake ranks


def _fake_allgather(x, tiled=False):
    x = jnp.asarray(x)
    return jnp.stack([x, x])


@pytest.fixture()
def two_rank_world(monkeypatch):
    """Both packages see a two-rank world whose other rank holds this rank's state."""
    monkeypatch.setattr(multihost_utils, "process_allgather", _fake_allgather)
    monkeypatch.setattr(jsync, "distributed_available", lambda: True)

    def all_gather(parts, payload, group=None):
        for part in parts:
            part.copy_(payload)

    monkeypatch.setattr(tsync, "distributed_available", lambda: True)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)


def _play_sync(name, guard, plan, second_sync=False) -> dict:
    side = SIDES[name]
    side.trace.enable()
    if name == "jax":
        m = JMeanSquaredError(distributed_available_fn=lambda: True)
        m.update(jnp.ones(4), jnp.zeros(4))
    else:
        m = TMeanSquaredError(distributed_available_fn=lambda: True)
        m.update(torch.ones(4), torch.zeros(4))
    local = {k: np.asarray(v).tolist() for k, v in m._state_values.items()}
    out: dict = {"local": local}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with side.robust.sync_guard(*guard):
            with side.faults.inject_collective_fault(*plan):
                m.sync()
            out["first"] = (m.sync_degraded, m._is_synced, m._cache is None)
            if second_sync:
                m.sync()
    out["state"] = {k: np.asarray(v).tolist() for k, v in m._state_values.items()}
    out["flags"] = (m.sync_degraded, m._is_synced)
    if m._is_synced:
        m.unsync()
    out["compute"] = float(np.asarray(m.compute()))
    out["warnings"] = [(w.category.__name__, str(w.message)) for w in caught]
    # the sync plane's series (JAX's jitted update also counts jit.* series, which the
    # port's eager update does not: ROADMAP Queue 3)
    out["counters"] = {k: v for k, v in _counters(side).items() if k[0].startswith(("sync.", "warnings.", "metric.sync"))}
    return out


SYNC_CASES = {
    "raise_degrades_to_local": ((0.2, 1), ("raise", 10), False),
    "hang_times_out_and_degrades": ((0.05, 1), ("hang", 10), False),
    "transient_failure_recovers_on_retry": ((0.5, 1), ("raise", 1), False),
    "flag_clears_on_success": ((0.2, 0), ("raise", 1), True),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_metric_sync_degrades_as_jax_does(case, two_rank_world):
    guard, plan, second = SYNC_CASES[case]
    jax_out = _play_sync("jax", guard, plan, second)
    port_out = _play_sync("port", guard, plan, second)
    assert port_out == jax_out
    if case == "transient_failure_recovers_on_retry":
        assert port_out["flags"] == (False, True)  # synced: both copies summed
        assert port_out["counters"][("sync.collective_retry", (("op", "Reduction.SUM leaf gather"),))] == 1


def test_degraded_sync_warns_with_jax_text(two_rank_world):
    m = TMeanSquaredError(distributed_available_fn=lambda: True)
    m.update(torch.ones(4), torch.zeros(4))
    with trobust.sync_guard(0.2, 1), tfaults.inject_collective_fault("raise", 10):
        with pytest.warns(RuntimeWarning, match="DEGRADED to local-only state"):
            m.sync()
    assert m.sync_degraded and not m._is_synced
    assert float(m.compute()) == 1.0


# ----------------------------------------------------------- a real one-rank gloo world


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_world():
    """A one-rank gloo world in this process, torn down after the module's cases."""
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1,
        timeout=__import__("datetime").timedelta(seconds=30),
    )
    try:
        yield
    finally:
        dist.destroy_process_group()


def _one_rank_metric():
    m = TMeanSquaredError()
    m.update(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 0.0, 1.0]))
    return m


def test_one_rank_world_injected_hang_degrades_sync(gloo_world):
    m = _one_rank_metric()
    local = m.compute().item()
    m._computed = None
    with trobust.sync_guard(0.1, 1), tfaults.inject_collective_fault("hang", 10):
        with pytest.warns(RuntimeWarning, match="DEGRADED"):
            m.sync()
    assert m.sync_degraded and not m._is_synced
    assert m.compute().item() == local


def test_one_rank_world_guarded_sync_runs_the_real_collective(gloo_world):
    m = _one_rank_metric()
    local = {k: v.clone() for k, v in m._state_values.items()}
    ttrace.enable()
    with trobust.sync_guard(5.0, 1):
        m.sync()
    assert m._is_synced and not m.sync_degraded
    for key, value in local.items():
        assert torch.equal(m._state_values[key], value)
    counters = _counters(PORT)
    assert counters[("sync.collectives", (("op", "Reduction.SUM leaf gather"),))] == 2
    assert counters[("sync.payload_bytes", (("op", "Reduction.SUM leaf gather"),))] == 8
    m.unsync()


def test_one_rank_world_unconfigured_guard_is_a_direct_call(gloo_world, monkeypatch):
    threads = []
    real = dist.all_gather

    def probe(parts, payload, group=None):
        threads.append(threading.current_thread().name)
        return real(parts, payload, group=group)

    monkeypatch.setattr(dist, "all_gather", probe)
    m = _one_rank_metric()
    m.sync()
    m.unsync()
    assert threads == [threading.current_thread().name] * 2
    with trobust.sync_guard(5.0, 0):
        m.sync()
        m.unsync()
    assert len(threads) == 4 and all(name.startswith("guarded-") for name in threads[2:])


def test_one_rank_world_injected_hang_degrades_aggregate(gloo_world):
    with trobust.sync_guard(0.1, 0), tfaults.inject_collective_fault("hang", 10):
        with pytest.warns(RuntimeWarning, match="DEGRADED"):
            agg = taggregate.aggregate()
    assert agg["aggregate_degraded"] is True
    assert agg["missing_hosts"] == []  # the world is this rank alone
    assert "timed out" in agg["degraded_error"]
    assert agg["n_hosts"] == 1 and agg["hosts"][0]["process_index"] == 0


def test_one_rank_world_aggregate_gathers_through_the_guard(gloo_world):
    ttrace.enable()
    ttrace.inc("probe.count", 3)
    with trobust.sync_guard(5.0, 0):
        agg = taggregate.aggregate()
    assert agg["aggregate_degraded"] is False
    counters = {c["name"]: c["value"] for c in agg["counters"]}
    assert counters["probe.count"] == 3
    assert os.getpid() == int(agg["hosts"][0]["host_id"].rsplit(":", 1)[1])
