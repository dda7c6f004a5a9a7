"""The port's retrying fetcher (``robust/retry.py``) held against the JAX package's.

Every case of ``tests/core/test_fault_tolerance.py::TestRetrySchedule`` and
``::TestFetchResource`` runs here as a scenario played in both packages with the same
injected ``sleep``, ``clock``, fetcher and download faults: the result (or the error
type and message), the backoff delays, the calls that reached the fetcher, the files
left on disk, the warnings and the ``retry.*`` counters must be the same. Nothing
reaches the network: every fetcher is a function of the test.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import warnings
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu.robust.faults as jfaults  # noqa: E402
import torchmetrics_tpu.robust.retry as jretry  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
import torchmetrics_tpu_torch.robust.faults as tfaults  # noqa: E402
import torchmetrics_tpu_torch.robust.retry as tretry  # noqa: E402

SIDES = {
    "jax": SimpleNamespace(retry=jretry, faults=jfaults, trace=jtrace),
    "port": SimpleNamespace(retry=tretry, faults=tfaults, trace=ttrace),
}
PAYLOAD = b"model-weights-payload-0123456789"
SHA = hashlib.sha256(PAYLOAD).hexdigest()
URL = "https://example.invalid/weights.bin"


def _read(path, mode="rb"):
    with open(path, mode) as fh:
        return fh.read()


def _load_json(path):
    return json.loads(_read(path, "r"))


@pytest.fixture(autouse=True)
def _tracing_on():
    for side in SIDES.values():
        side.trace.enable()
    yield
    for side in SIDES.values():
        side.trace.disable()
        side.trace.get_recorder().clear()


def _retry_flaky(side, tmp):
    sleeps, attempts, retried = [], [], []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise OSError(f"transient {len(attempts)}")
        return "ok"

    out = side.retry.retry_call(
        flaky, schedule=side.retry.RetrySchedule(max_attempts=4, base_delay=0.5, multiplier=2.0),
        sleep=sleeps.append, description="flaky op", on_retry=lambda i, e: retried.append((i, str(e))),
    )
    return {"out": out, "sleeps": sleeps, "attempts": len(attempts), "retried": retried}


def _retry_exhausts(side, tmp):
    sleeps = []
    side.retry.retry_call(lambda: (_ for _ in ()).throw(OSError("down")),
                          schedule=side.retry.RetrySchedule(max_attempts=3), sleep=sleeps.append)


def _retry_deadline(side, tmp):
    clock = iter([0.0, 0.0, 100.0]).__next__
    calls = []

    def failing():
        calls.append(1)
        raise OSError("down")

    try:
        side.retry.retry_call(failing, schedule=side.retry.RetrySchedule(max_attempts=10, base_delay=1.0, deadline=5.0),
                              sleep=lambda _: None, clock=clock)
    finally:
        tmp["calls"] = len(calls)


def _retry_capped_delays(side, tmp):
    sleeps = []
    schedule = side.retry.RetrySchedule(max_attempts=6, base_delay=1.0, multiplier=3.0, max_delay=10.0)
    try:
        side.retry.retry_call(lambda: (_ for _ in ()).throw(ValueError("bad")), schedule=schedule,
                              retry_on=ValueError, sleep=sleeps.append, description="capped")
    finally:
        tmp["sleeps"] = sleeps
        tmp["delays"] = [schedule.delay(i) for i in range(6)]


def _retry_wrong_type_propagates(side, tmp):
    side.retry.retry_call(lambda: (_ for _ in ()).throw(KeyError("k")), retry_on=OSError, sleep=lambda _: None)


def _fetch_bytes_truncated_then_ok(side, tmp):
    sleeps, fetched = [], []
    with side.faults.inject_download_fault(mode="truncate", times=1):
        data = side.retry.fetch_bytes(URL, fetcher=lambda u: fetched.append(u) or PAYLOAD, expected_sha256=SHA,
                                      schedule=side.retry.RetrySchedule(max_attempts=3, base_delay=0.25),
                                      sleep=sleeps.append)
    return {"data": data, "sleeps": sleeps, "fetched": len(fetched)}


def _fetch_bytes_too_small(side, tmp):
    side.retry.fetch_bytes(URL, fetcher=lambda u: b"x", min_size=8,
                           schedule=side.retry.RetrySchedule(max_attempts=2), sleep=lambda _: None)


def _fetch_custom_corruptor(side, tmp):
    sleeps = []
    with side.faults.inject_download_fault(mode="custom", times=2, corruptor=lambda d: d[::-1]):
        data = side.retry.fetch_bytes(URL, fetcher=lambda u: PAYLOAD, expected_sha256=SHA,
                                      schedule=side.retry.RetrySchedule(max_attempts=3, base_delay=0.1),
                                      sleep=sleeps.append)
    return {"data": data, "sleeps": sleeps}


def _resource_truncated_retried(side, tmp):
    dest = os.path.join(tmp["dir"], "weights.bin")
    sleeps = []
    with side.faults.inject_download_fault(mode="truncate", times=2):
        out = side.retry.fetch_resource(URL, dest, fetcher=lambda u: PAYLOAD, expected_sha256=SHA,
                                        schedule=side.retry.RetrySchedule(max_attempts=4, base_delay=0.5),
                                        sleep=sleeps.append)
    return {"out": os.path.basename(out), "sleeps": sleeps, "data": _read(dest)}


def _resource_corrupted_cache_refetched(side, tmp):
    dest = os.path.join(tmp["dir"], "weights.bin")
    with open(dest, "wb") as fh:
        fh.write(b"garbage")
    fetched = []
    side.retry.fetch_resource(URL, dest, fetcher=lambda u: fetched.append(u) or PAYLOAD, expected_sha256=SHA,
                              sleep=lambda _: None)
    return {"fetched": fetched, "data": _read(dest)}


def _resource_valid_cache_hit(side, tmp):
    dest = os.path.join(tmp["dir"], "weights.bin")
    with open(dest, "wb") as fh:
        fh.write(PAYLOAD)
    out = side.retry.fetch_resource(URL, dest, fetcher=lambda u: (_ for _ in ()).throw(AssertionError("fetched")),
                                    expected_sha256=SHA, sleep=lambda _: None)
    return {"out": os.path.basename(out)}


def _resource_persistent_corruption(side, tmp):
    dest = os.path.join(tmp["dir"], "weights.bin")
    try:
        with side.faults.inject_download_fault(mode="corrupt", times=10):
            side.retry.fetch_resource(URL, dest, fetcher=lambda u: PAYLOAD, expected_sha256=SHA,
                                      schedule=side.retry.RetrySchedule(max_attempts=3), sleep=lambda _: None)
    finally:
        tmp["left"] = sorted(os.listdir(tmp["dir"]))


def _resource_validate_hook(side, tmp):
    dest = os.path.join(tmp["dir"], "cfg.json")
    seen = []

    def validate(path):
        seen.append(os.path.basename(path) == "cfg.json")
        _load_json(path)

    payloads = iter([b"{not json", b'{"a": 1}'])
    side.retry.fetch_resource(URL, dest, fetcher=lambda u: next(payloads), validate=validate,
                              schedule=side.retry.RetrySchedule(max_attempts=2), sleep=lambda _: None)
    return {"seen": seen, "data": _read(dest, "r")}


def _cache_recovery_rebuilds_once(side, tmp):
    path = os.path.join(tmp["dir"], "cache.json")
    with open(path, "w") as fh:
        fh.write("{corrupt")
    rebuilt = []

    def rebuild():
        rebuilt.append(1)
        with open(path, "w") as fh:
            fh.write(json.dumps({"v": 7}))

    out = side.retry.load_with_cache_recovery(path, _load_json, rebuild=rebuild)
    return {"out": out, "rebuilt": rebuilt}


def _cache_recovery_without_rebuild(side, tmp):
    path = os.path.join(tmp["dir"], "cache.json")
    with open(path, "w") as fh:
        fh.write("{corrupt")
    side.retry.load_with_cache_recovery(path, _load_json, description="the cache")


def _cache_recovery_directory_rebuild_fails(side, tmp):
    path = os.path.join(tmp["dir"], "converted")
    os.makedirs(path)

    def loader(p):
        raise OSError(f"cannot read {os.path.basename(p)}")

    try:
        side.retry.load_with_cache_recovery(path, loader, rebuild=lambda: os.makedirs(path), description="dir")
    finally:
        tmp["left"] = sorted(os.listdir(tmp["dir"]))


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _retry_flaky, _retry_exhausts, _retry_deadline, _retry_capped_delays, _retry_wrong_type_propagates,
    _fetch_bytes_truncated_then_ok, _fetch_bytes_too_small, _fetch_custom_corruptor,
    _resource_truncated_retried, _resource_corrupted_cache_refetched, _resource_valid_cache_hit,
    _resource_persistent_corruption, _resource_validate_hook, _cache_recovery_rebuilds_once,
    _cache_recovery_without_rebuild, _cache_recovery_directory_rebuild_fails,
)}


def _play(name, side_name, tmp_path):
    side = SIDES[side_name]
    directory = tmp_path / side_name
    directory.mkdir()
    tmp = {"dir": str(directory)}
    out: dict = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out["result"] = SCENARIOS[name](side, tmp)
        except Exception as err:  # noqa: BLE001 - the outcome is what is compared
            cause = err.__cause__
            out["error"] = (type(err).__name__, str(err).replace(str(directory), "<dir>"),
                            type(cause).__name__ if cause is not None else None)
    tmp.pop("dir")
    out["tmp"] = tmp
    # the atomic writer's temp file name is random: "<name>.<random>.tmp"
    out["warnings"] = [
        (w.category.__name__, re.sub(r"\.[^./\s]+\.tmp", ".<random>.tmp", str(w.message).replace(str(directory), "<dir>")))
        for w in caught
    ]
    snap = side.trace.get_recorder().snapshot()
    out["counters"] = sorted((c["name"], sorted(c["labels"].items()), c["value"]) for c in snap["counters"])
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_retry_scenario_matches_jax(name, tmp_path):
    assert _play(name, "port", tmp_path) == _play(name, "jax", tmp_path)


def test_retry_names_are_jax_names():
    assert sorted(tretry.__all__) == sorted(jretry.__all__)
    assert tretry.DEFAULT_SCHEDULE == tretry.RetrySchedule()
    assert tretry.RetrySchedule() .__dict__ == jretry.RetrySchedule().__dict__


def test_default_fetcher_is_urllib_and_never_called_here(monkeypatch):
    """The default fetcher opens the URL with ``urllib``; here ``urlopen`` is replaced,
    so nothing reaches the network."""
    import urllib.request

    opened = []

    class _Response:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return PAYLOAD

    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout: opened.append((url, timeout)) or _Response())
    assert tretry.fetch_bytes(URL, expected_sha256=SHA, sleep=lambda _: None) == PAYLOAD
    assert opened == [(URL, 30.0)]
