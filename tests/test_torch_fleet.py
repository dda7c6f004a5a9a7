"""The port's fleet sampler (``obs/fleet.py``) held against the JAX package's.

Every case of ``tests/core/test_fleet.py`` runs in both packages (``side``): rates from
consecutive-sample deltas, the clamped counter reset, window smoothing, the bounded
ring, skew and its unbounded ratio, top-K tenants, advisory hints and the busy filter,
the cadence of ``tick``, the singleton, the ``imbalance_rule`` preset, the ``/fleet``
and ``/fleet/history`` routes on an ephemeral-port server and the scrape tick. Then
the same recorded series (tenant load fed through each package's ``obs.scope`` under
the same injected clock) must give equal ``rates``, ``skew``, ``rebalance_hints``,
``history`` and ``fleet.*`` gauges in both, within 1e-9 relative.

Clocks are injected; servers bind port 0; nothing sleeps.
"""

from __future__ import annotations

import json
import math
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.obs.cost as jcost  # noqa: E402
import torchmetrics_tpu.obs.fleet as jfleet  # noqa: E402
import torchmetrics_tpu.obs.scope as jscope  # noqa: E402
import torchmetrics_tpu.obs.server as jserver  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu_torch.obs.cost as tcost  # noqa: E402
import torchmetrics_tpu_torch.obs.fleet as tfleet  # noqa: E402
import torchmetrics_tpu_torch.obs.scope as tscope  # noqa: E402
import torchmetrics_tpu_torch.obs.server as tserver  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402

SIDES = {
    "jax": SimpleNamespace(fleet=jfleet, scope=jscope, server=jserver, trace=jtrace, cost=jcost),
    "port": SimpleNamespace(fleet=tfleet, scope=tscope, server=tserver, trace=ttrace, cost=tcost),
}
REL = 1e-9


@pytest.fixture(autouse=True)
def _fleet_clean():
    # the cost ledger is process-wide: captured variants of another test file would add
    # their real host's burn row ("0") to every rate table (ROADMAP Queue 3)
    previous = {}
    for name, side in SIDES.items():
        side.scope.reset()
        side.cost.get_ledger().clear()
        previous[name] = side.fleet.install_sampler(None)
    yield
    for name, side in SIDES.items():
        side.fleet.install_sampler(previous[name])
        side.scope.reset()


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def _sampler(side, placement=None, clock=None, **kwargs):
    """A sampler on a fresh recorder with an injectable list-backed clock."""
    clock = clock if clock is not None else [0.0]
    rec = side.trace.TraceRecorder()
    s = side.fleet.FleetSampler(
        recorder=rec,
        placement=placement,
        clock=lambda: clock[0],
        wall=lambda: 1.7e9 + clock[0],
        **kwargs,
    )
    return s, clock, rec


def _feed(side, tenant, n=1, computes=0):
    with side.scope.scope(tenant):
        side.scope.note_update(n=n)
        for _ in range(computes):
            side.scope.note_compute()


# ------------------------------------------------------------------ derivation


def test_rates_from_consecutive_sample_deltas(side):
    s, clock, _ = _sampler(side, placement={"a": "0", "b": "1"})
    s.sample()
    _feed(side, "a", n=30, computes=2)
    _feed(side, "b", n=10)
    clock[0] += 2.0
    s.sample()
    rates = s.rates()
    assert rates["window_seconds"] == 2.0
    assert rates["tenants"]["a"]["updates_per_second"] == 15.0
    assert rates["tenants"]["a"]["computes_per_second"] == 1.0
    assert rates["tenants"]["b"]["updates_per_second"] == 5.0
    assert rates["hosts"]["0"]["updates_per_second"] == 15.0
    assert rates["hosts"]["1"]["updates_per_second"] == 5.0
    assert rates["total"]["updates_per_second"] == 20.0


def test_fewer_than_two_samples_is_empty_not_an_error(side):
    s, _, _ = _sampler(side)
    assert s.rates() == {"samples": 0, "window_seconds": None, "tenants": {}, "hosts": {}, "total": {}}
    s.sample()
    assert s.rates()["window_seconds"] is None


def test_counter_reset_clamps_to_zero_not_negative_burn(side):
    s, clock, _ = _sampler(side, placement={"a": "0"})
    _feed(side, "a", n=10)
    s.sample()
    side.scope.reset()
    _feed(side, "a", n=2)
    clock[0] += 1.0
    s.sample()
    assert s.rates()["tenants"]["a"]["updates_per_second"] == 0.0


def test_window_smoothing_widens_the_delta_base(side):
    s, clock, _ = _sampler(side, placement={"a": "0"})
    s.sample()
    _feed(side, "a", n=40)
    clock[0] = 1.0
    s.sample()
    clock[0] = 2.0
    s.sample()
    assert s.rates()["tenants"]["a"]["updates_per_second"] == 0.0
    smoothed = s.rates(window=2.5)
    assert smoothed["window_seconds"] == 2.0
    assert smoothed["tenants"]["a"]["updates_per_second"] == 20.0
    assert s.skew(window=2.5)["hot_host"] == "0"


def test_ring_is_bounded_drop_oldest_but_lifetime_count_is_not(side):
    s, clock, _ = _sampler(side, ring=4)
    for i in range(10):
        clock[0] = float(i)
        s.sample()
    assert s.ring == 4
    assert s.rates()["samples"] == 4
    assert s.samples_taken == 10
    assert s.history()[0]["mono"] == 6.0


def test_shares_imbalance_and_ratio(side):
    s, clock, _ = _sampler(side, placement={"a": "0", "b": "1"})
    s.sample()
    _feed(side, "a", n=30)
    _feed(side, "b", n=10)
    clock[0] = 2.0
    s.sample()
    skew = s.skew()
    assert skew["hosts"]["0"]["share"] == 0.75
    assert skew["hosts"]["1"]["share"] == 0.25
    assert skew["imbalance"] == 0.5
    assert skew["max_min_ratio"] == 3.0
    assert skew["hot_host"] == "0" and skew["cold_host"] == "1"


def test_idle_cold_host_has_unbounded_ratio_reported_as_none(side):
    s, clock, _ = _sampler(side, placement={"a": "0", "b": "1"})
    s.sample()
    _feed(side, "a", n=30)
    _feed(side, "b", n=0)
    clock[0] = 1.0
    s.sample()
    skew = s.skew()
    assert skew["max_min_ratio"] is None
    assert skew["imbalance"] == 1.0


def test_provisioned_idle_host_pads_the_skew(side):
    s, clock, _ = _sampler(side, placement={"a": "host-a", "b": "host-a"}, hosts=("host-a", "host-b"))
    s.sample()
    _feed(side, "a", n=30)
    _feed(side, "b", n=10)
    clock[0] = 1.0
    s.sample()
    skew = s.skew()
    assert skew["imbalance"] == 1.0 and skew["cold_host"] == "host-b"
    assert [h["tenant"] for h in s.rebalance_hints()["hints"]] == ["a", "b"]


def test_top_tenants_per_host_capped_at_top_k(side):
    s, clock, _ = _sampler(side, placement={"a": "0", "b": "0", "c": "0"}, top_k=2)
    s.sample()
    for tenant, n in (("a", 30), ("b", 20), ("c", 10)):
        _feed(side, tenant, n=n)
    clock[0] = 1.0
    s.sample()
    assert [row["tenant"] for row in s.skew()["top_tenants"]["0"]] == ["a", "b"]


def _loaded(side):
    s, clock, rec = _sampler(side, placement={"a": "0", "b": "0", "c": "1"})
    s.sample()
    for tenant, n in (("a", 30), ("b", 10), ("c", 0)):
        _feed(side, tenant, n=n)
    clock[0] = 1.0
    s.sample()
    return s, clock, rec


def test_hints_are_advisory_and_ranked_best_projection_first(side):
    s, _, _ = _loaded(side)
    hints = s.rebalance_hints()
    assert hints["advisory"] is True and "nothing is executed" in hints["note"]
    moves = hints["hints"]
    assert [h["tenant"] for h in moves] == ["a", "b"]
    assert all(h["from"] == "0" and h["to"] == "1" for h in moves)
    assert moves[0]["projected_imbalance"] < s.skew()["imbalance"]


def test_counterproductive_whole_load_flip_is_not_advice(side):
    s, clock, _ = _sampler(side, placement={"a": "0", "c": "1"})
    s.sample()
    _feed(side, "a", n=30)
    _feed(side, "c", n=10)
    clock[0] = 1.0
    s.sample()
    assert s.rebalance_hints()["hints"] == []


def test_migrating_tenant_drops_out_of_the_advice(side):
    s, _, _ = _loaded(side)
    assert [h["tenant"] for h in s.rebalance_hints()["hints"]] == ["a", "b"]
    with side.scope.migration("a", "drain"):
        assert [h["tenant"] for h in s.rebalance_hints()["hints"]] == ["b"]
    assert [h["tenant"] for h in s.rebalance_hints()["hints"]] == ["a", "b"]


def test_fenced_tenant_is_not_advice(side):
    s, _, _ = _loaded(side)
    side.scope.note_fence("ep-busy", tenant="b")
    assert [h["tenant"] for h in s.rebalance_hints()["hints"]] == ["a"]


def test_same_process_restore_does_not_double_count(side):
    _feed(side, "m", n=40)
    reg = side.scope.get_registry()
    assert reg.restore_row("m", updates=40)["updates"] == 40
    assert reg.restore_row("m", updates=100)["updates"] == 100


def test_rate_consumer_sees_no_phantom_burst_across_a_move(side):
    s, clock, _ = _sampler(side, placement={"m": "0"})
    _feed(side, "m", n=100)
    s.sample()
    clock[0] = 1.0
    side.scope.get_registry().restore_row("m", updates=100)
    s.sample()
    assert s.rates()["tenants"]["m"]["updates_per_second"] == 0.0


# ------------------------------------------------------------ ticks & presets


def test_tick_honors_the_cadence(side):
    s, clock, _ = _sampler(side, cadence_seconds=5.0)
    assert s.tick() is not None
    clock[0] = 2.0
    assert s.tick() is None
    clock[0] = 6.0
    assert s.tick() is not None
    assert s.samples_taken == 2


def test_a_sample_taken_during_a_tick_lands_after_it(monkeypatch):
    """The port only. A scrape tick stamps its sample, then refreshes the cost gauges and
    gathers; a sample that another thread takes meanwhile (the end-of-run probe's forced
    one) waits for the tick, so the ring stays in clock order and the two newest samples
    span a positive window with every tenant's rate."""
    import threading

    port = SIDES["port"]
    s, clock, _ = _sampler(port, placement={"t0": "0", "t1": "1"}, cadence_seconds=0.5)
    _feed(port, "t0", n=2)
    s.sample()
    clock[0] = 1.0
    _feed(port, "t0", n=3)
    _feed(port, "t1", n=1)
    original = tcost.record_gauges
    other = {}

    def record_gauges(*args, **kwargs):
        if "thread" not in other:
            clock[0] = 2.0  # the other thread's stamp is later than the tick's
            other["thread"] = threading.Thread(target=s.sample)
            other["thread"].start()
            other["thread"].join(timeout=0.2)
        return original(*args, **kwargs)

    monkeypatch.setattr(tcost, "record_gauges", record_gauges)
    assert s.tick() is not None
    other["thread"].join(timeout=10)
    assert not other["thread"].is_alive()
    assert s.samples_taken == 3
    rates = s.rates()
    assert rates["window_seconds"] == 1.0
    assert sorted(rates["tenants"]) == ["t0", "t1"]


def test_constructor_validation_carries_jax_s_messages():
    for kwargs in ({"cadence_seconds": 0}, {"ring": 1}):
        with pytest.raises(ValueError) as jerr:
            jfleet.FleetSampler(**kwargs)
        with pytest.raises(ValueError) as terr:
            tfleet.FleetSampler(**kwargs)
        assert str(terr.value) == str(jerr.value)


def test_install_returns_previous_for_restore(side):
    s, _, _ = _sampler(side)
    assert side.fleet.install_sampler(s) is None
    assert side.fleet.get_sampler() is s
    assert side.fleet.install_sampler(None) is s
    assert side.fleet.get_sampler() is None


def test_imbalance_rule_preset_is_jax_s():
    jrule = jfleet.imbalance_rule(above=0.6, for_seconds=3.0, severity="warn")
    trule = tfleet.imbalance_rule(above=0.6, for_seconds=3.0, severity="warn")
    for attr in ("name", "kind", "series", "above", "for_seconds", "severity"):
        assert getattr(trule, attr) == getattr(jrule, attr), attr
    assert trule.name == "fleet_imbalance" and trule.series == "fleet.imbalance"
    assert sorted(tfleet.__all__) == sorted(jfleet.__all__)
    assert (tfleet.DEFAULT_CADENCE_SECONDS, tfleet.DEFAULT_RING, tfleet.DEFAULT_TOP_K) == (
        jfleet.DEFAULT_CADENCE_SECONDS,
        jfleet.DEFAULT_RING,
        jfleet.DEFAULT_TOP_K,
    )


def test_the_sampler_thread_starts_and_stops(side):
    s, _, _ = _sampler(side, cadence_seconds=3600.0)
    s.start()
    try:
        assert s.started
        assert s.start() is s
    finally:
        s.stop()
    assert not s.started and s.samples_taken >= 1


# --------------------------------------------------------------------- serving


def _get_json(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode("utf-8"))


@pytest.fixture()
def server(side):
    side.server.stop()
    srv = side.server.IntrospectionServer(port=0).start()
    yield srv
    srv.stop()


def _install_loaded_sampler(side):
    s, clock, _ = _sampler(side, placement={"a": "0", "b": "1"})
    s.sample()
    _feed(side, "a", n=30)
    _feed(side, "b", n=10)
    clock[0] = 2.0
    s.sample()
    side.fleet.install_sampler(s)
    return s


def test_fleet_off_is_an_answer_not_a_404(side, server):
    status, body = _get_json(server.url + "/fleet")
    assert status == 200 and body["enabled"] is False and "install_sampler" in body["error"]
    status, body = _get_json(server.url + "/fleet/history")
    assert status == 200 and body["enabled"] is False and body["samples"] == []


def test_fleet_page_serves_rates_skew_and_hints(side, server):
    _install_loaded_sampler(side)
    status, body = _get_json(server.url + "/fleet")
    assert status == 200 and body["enabled"] is True
    assert body["sampler"]["samples"] == 2
    assert body["tenants"]["a"]["updates_per_second"] == 15.0
    assert body["skew"]["hot_host"] == "0"
    assert body["rebalance"]["advisory"] is True


def test_fleet_tenant_filter_and_unknown_tenant_404(side, server):
    _install_loaded_sampler(side)
    status, body = _get_json(server.url + "/fleet?tenant=a")
    assert status == 200 and set(body["tenants"]) == {"a"}
    with pytest.raises(urllib.error.HTTPError) as err:
        _get_json(server.url + "/fleet?tenant=nope")
    assert err.value.code == 404


def test_fleet_history_window_and_bad_window_400(side, server):
    s = _install_loaded_sampler(side)
    status, body = _get_json(server.url + "/fleet/history?window=600")
    assert status == 200 and body["n_samples"] == 2 and body["ring"] == s.ring
    monos = [row["mono"] for row in body["samples"]]
    assert monos == sorted(monos)
    status, body = _get_json(server.url + "/fleet/history?window=1")
    assert body["n_samples"] == 1
    for bad in ("0", "-3", "nan-ish"):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get_json(server.url + f"/fleet/history?window={bad}")
        assert err.value.code == 400


def test_metrics_scrape_ticks_the_installed_sampler(side, server):
    s, _, _ = _sampler(side, cadence_seconds=3600.0)
    side.fleet.install_sampler(s)
    for _ in range(2):
        with urllib.request.urlopen(server.url + "/metrics", timeout=10) as resp:
            assert resp.status == 200
        assert s.samples_taken == 1


# ------------------------------------------------------------- cross-package


def _close(a, b, path="$"):
    """Equal structures; floats within REL relative of each other."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for key in a:
            _close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, (int, float)):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


SERIES = [
    # (clock, {tenant: (updates, computes)}) fed between samples
    (0.0, {}),
    (1.5, {"a": (30, 2), "b": (10, 0), "c": (0, 0), "d": (7, 1)}),
    (3.0, {"a": (45, 1), "b": (3, 0), "c": (12, 0)}),
    (3.25, {"d": (9, 3)}),
    (6.0, {"a": (2, 0), "b": (40, 4), "c": (1, 0), "d": (0, 0)}),
]
PLACEMENT = {"a": "host-a", "b": "host-a", "c": "host-b", "d": "host-a"}


def _recorded(side):
    s, clock, rec = _sampler(side, placement=dict(PLACEMENT), hosts=("host-a", "host-b", "host-c"), top_k=2)
    for t, load in SERIES:
        clock[0] = t
        for tenant, (n, computes) in load.items():
            _feed(side, tenant, n=n, computes=computes)
        s.sample()
    return s, rec


def _gauges(rec):
    return {(row["name"], tuple(sorted(row["labels"].items()))): row["value"] for row in rec.snapshot()["gauges"]
            if row["name"].startswith("fleet.")}


def _strip_stamps(history):
    for row in history:
        for key in ("unix", "host_snapshots", "wall_clock_anchor"):
            row.pop(key, None)
    return history


def test_rates_skew_hints_and_gauges_equal_jax_s_on_the_same_series():
    js, jrec = _recorded(SIDES["jax"])
    ts, trec = _recorded(SIDES["port"])
    for window in (None, 2.0, 10.0):
        _close(ts.rates(window=window), js.rates(window=window))
        _close(ts.skew(window=window), js.skew(window=window))
    _close(ts.rebalance_hints(), js.rebalance_hints())
    assert ts.rebalance_hints()["hints"], "the series must give at least one hint"
    _close(_gauges(trec), _gauges(jrec))
    assert [v for (name, _), v in _gauges(trec).items() if name == "fleet.imbalance"][0] > 0
    _close(ts.record_gauges(), js.record_gauges())
    jh, th = js.history(), ts.history()
    _close([sorted(r) for r in th], [sorted(r) for r in jh])
    _close([r["tenants"] for r in th], [r["tenants"] for r in jh])
    _close([r["mono"] for r in th], [r["mono"] for r in jh])


def test_current_payload_has_jax_s_shape():
    js, _ = _recorded(SIDES["jax"])
    ts, _ = _recorded(SIDES["port"])
    jc, tc = js.current(), ts.current()
    assert sorted(tc) == sorted(jc)
    assert sorted(tc["sampler"]) == sorted(jc["sampler"])
    for key in ("tenants", "total", "skew", "rebalance", "window_seconds"):
        _close(tc[key], jc[key])
    assert [sorted(r) for r in tc["hosts"]] == [sorted(r) for r in jc["hosts"]]
    _close(ts.current(tenant="a")["tenants"], js.current(tenant="a")["tenants"])
