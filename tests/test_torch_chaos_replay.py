"""The port's chaos replay, end to end on the CPU, against the JAX package.

One port replay per scenario (``device="cpu"``), at the JAX suite's test configs
(``tests/core/test_chaos.py`` ``run`` fixtures, ``sync_timeout_seconds=0.02``),
with ``skewed_load`` and ``flash_crowd`` at their presets. Each result is judged by
both packages' ``judge`` under the scenario's spec: the two reports must be equal,
and every SLO row that reads no wall clock must pass (the wall-clock rows are judged
on the card by ``chip_smoke.py``'s ``chaos_eval``). This file holds the default, the
multiplexed and the rolling-deploy scenarios, and one JAX replay of the default
scenario on the same schedule, which the port's must equal: batches fed, the
injected faults, the poisoned batches the dumps name, the alert episodes that fired
and resolved, and every tenant's final state and ``compute``.
``tests/test_torch_chaos_recovery.py`` holds the other four scenarios.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import torchmetrics_tpu.chaos.slo as jslo
import torchmetrics_tpu_torch.chaos.schedule as psched
import torchmetrics_tpu_torch.chaos.slo as pslo

torch.set_num_threads(2)

jreplay = importlib.import_module("torchmetrics_tpu.chaos.replay")
preplay = importlib.import_module("torchmetrics_tpu_torch.chaos.replay")

# the JAX suite's end-to-end schedule
TEST_SCHEDULE = dict(seed=0, tenants=8, warm_batches=2, churn_batches=2, drain_batches=3, hang_seconds=0.5,
                     absent_after_seconds=0.15, idle_gap_seconds=0.01)

# SLO rows that read a wall clock: judged on the card, reported here
WALL_ROWS = ("update_throughput", "scrape_", "time_to_", "migration_seconds", "recovery_seconds",
             "placement_convergence_seconds", "placement_throughput_ratio")


def clean_obs() -> None:
    """Both packages' process-global telemetry back to rest (the JAX suite's fixture)."""
    from torchmetrics_tpu.obs import scope as jscope
    from torchmetrics_tpu.obs import trace as jtrace
    from torchmetrics_tpu.obs import values as jvalues
    from torchmetrics_tpu_torch.obs import scope as pscope
    from torchmetrics_tpu_torch.obs import trace as ptrace
    from torchmetrics_tpu_torch.obs import values as pvalues

    for trace, values, scope in ((jtrace, jvalues, jscope), (ptrace, pvalues, pscope)):
        trace.disable()
        trace.get_recorder().clear()
        values.disable()
        values.get_log().clear()
        scope.reset()


def replay_capturing(module, schedule, config):
    """``module.replay(schedule, config)`` plus the tenants' metrics as the run left them."""
    built = {}
    original = module._build_tenants

    def build(*args, **kwargs):
        out = original(*args, **kwargs)
        built["metrics"] = out[0]
        return out

    module._build_tenants = build
    clean_obs()
    try:
        result = module.replay(schedule, config)
    finally:
        module._build_tenants = original
        clean_obs()
    return result, built["metrics"]


def judged_by_both(result, spec_name, prefix, **spec_kwargs):
    """The port's report, after checking that JAX's judge gives the same one."""
    jspec = getattr(jslo, spec_name)(**spec_kwargs)
    pspec = getattr(pslo, spec_name)(**spec_kwargs)
    want, got = jslo.judge(result, jspec, prefix=prefix), pslo.judge(result, pspec, prefix=prefix)
    assert got == want
    assert pslo.format_report(got) == jslo.format_report(want)
    return got


def assert_clock_free_rows_pass(report):
    bad = [row["slo"] for row in report["slos"]
           if not row["passed"] and not row["slo"].startswith(WALL_ROWS)]
    assert not bad, pslo.format_report(report)


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


@pytest.fixture(scope="module")
def default_runs():
    """The default scenario on the same schedule in both packages."""
    pconfig = preplay.ReplayConfig(fuse=1, scrape_interval_seconds=0.03, sync_timeout_seconds=0.02, device="cpu")
    jconfig = jreplay.ReplayConfig(fuse=1, scrape_interval_seconds=0.03, sync_timeout_seconds=0.02)
    port = replay_capturing(preplay, psched.generate(psched.ScheduleConfig(**TEST_SCHEDULE)), pconfig)
    import torchmetrics_tpu.chaos.schedule as jsched

    jax_run = replay_capturing(jreplay, jsched.generate(jsched.ScheduleConfig(**TEST_SCHEDULE)), jconfig)
    return port, jax_run


def test_default_replay_is_judged_alike_and_passes(default_runs):
    (result, _), _ = default_runs
    report = judged_by_both(result, "SLOSpec", "chaos")
    assert_clock_free_rows_pass(report)
    assert result["schedule"]["tenants"] == 8
    assert result["batches_fed"] == len(psched.generate(psched.ScheduleConfig(**TEST_SCHEDULE)).batches())


def test_default_replay_has_jax_s_keys(default_runs):
    (presult, _), (jresult, _) = default_runs
    assert sorted(presult) == sorted(jresult)
    for key in ("schedule", "scrapes", "cost", "flight", "lineage", "audit", "robust", "alerts"):
        assert set(presult[key] or {}) == set(jresult[key] or {}), key
    assert presult["schedule"] == jresult["schedule"]


def test_default_replay_equals_jax_s(default_runs):
    (presult, pmetrics), (jresult, jmetrics) = default_runs
    assert presult["batches_fed"] == jresult["batches_fed"]
    fault_keys = ("fault", "tenant", "rule", "batch_index", "window_seconds")
    assert [{k: f.get(k) for k in fault_keys} for f in presult["faults"]] == [
        {k: f.get(k) for k in fault_keys} for f in jresult["faults"]]

    def named(result):
        return {(d["tenant"], i) for d in result["flight"]["dumps"] for i in d["poisoned_batches"]}

    assert named(presult) == named(jresult) and named(presult)

    def episodes(result):
        return {(e["rule"], e["tenant"]) for e in result["alerts"]["episodes"]
                if e.get("fired_at") is not None and e.get("resolved_at") is not None}

    assert episodes(presult) == episodes(jresult) == {("chaos_poison_nonfinite", "tenant-00"),
                                                      ("chaos_hang_absent", "tenant-01")}
    assert presult["robust"] == jresult["robust"]
    assert presult["robust"]["sync_degraded"] == ["tenant-01"]
    assert [(r["tenant"], r["index"], r["linked"], r["outcome"]) for r in presult["lineage"]["poisoned"]] == [
        (r["tenant"], r["index"], r["linked"], r["outcome"]) for r in jresult["lineage"]["poisoned"]]
    assert sorted(pmetrics) == sorted(jmetrics)
    victim = presult["schedule"]["victim"]
    for tenant in sorted(pmetrics):
        pm, jm = pmetrics[tenant], jmetrics[tenant]
        assert pm.update_count == jm.update_count, tenant
        assert int(pm.updates_quarantined) == int(jm.updates_quarantined), tenant
        pstate = {k: _host(v) for k, v in pm.metric_state.items()}
        jstate = {k: np.asarray(v) for k, v in jm.metric_state.items()}
        assert sorted(pstate) == sorted(jstate), tenant
        pval, jval = _host(pm.compute()), np.asarray(jm.compute())
        if tenant == victim:  # MeanSquaredError: float sums
            np.testing.assert_allclose(pval, jval, rtol=1e-6, atol=0)
            for key in pstate:
                np.testing.assert_allclose(pstate[key], jstate[key], rtol=1e-6, atol=0)
        else:  # micro MulticlassAccuracy: integer counts exactly, the value bitwise
            for key in pstate:
                np.testing.assert_array_equal(pstate[key], jstate[key])
            assert pval.dtype == jval.dtype and pval.tobytes() == jval.tobytes(), tenant


def test_default_replay_counts_scrapes_on_both_sides(default_runs):
    (result, _), _ = default_runs
    assert result["scrapes"]["degraded_healthz_seen"] > 0
    for route in ("/metrics", "/alerts", "/tenants"):
        driver, server = result["scrapes"]["driver"][route], result["scrapes"]["server"][route]
        assert driver["count"] > 0 and driver["errors"] == 0
        assert server["count"] >= driver["count"] - 1
    # the CPU route keys and counts variants as the card does; nothing is captured
    assert result["cost"]["compiled_variants"] > 0 and result["cost"]["compile_seconds"] == 0.0
    assert {row["tenant"] for row in result["tenants"]["tenants"]} >= {f"tenant-{i:02d}" for i in range(8)}


def test_driver_quantiles_are_nearest_rank():
    scraper = preplay._Scraper("http://unused", ("/x",), 1.0)
    scraper.latencies["/x"] = [0.01, 0.02]
    summary = scraper.summary()["/x"]
    assert summary["p50_seconds"] == 0.01 and summary["p99_seconds"] == 0.02


@pytest.fixture(scope="module")
def multiplexed_run():
    schedule = psched.generate(psched.ScheduleConfig(**TEST_SCHEDULE))
    config = preplay.ReplayConfig(multiplex=True, mux_max_width=8, scrape_interval_seconds=0.03,
                                  sync_timeout_seconds=0.02, device="cpu")
    result, _ = replay_capturing(preplay, schedule, config)
    return schedule, result


def test_multiplexed_replay_is_judged_alike_and_passes(multiplexed_run):
    schedule, result = multiplexed_run
    report = judged_by_both(result, "SLOSpec", "chaos_mx", require_poisoned_named=True, require_multiplexed=True,
                            require_quarantine_attributed=True)
    assert_clock_free_rows_pass(report)
    # the JAX scenario's own spec too (its variant budget is 60)
    assert_clock_free_rows_pass(judged_by_both(result, "high_tenant_slo_spec", "chaos_ht"))
    mux = result["mux"]
    assert mux["tenants"] == 7 and mux["report"]["fused_updates"] > mux["report"]["dispatches"] > 0
    assert mux["report"]["max_width"] > 1
    poisoned_guarded = [t for t in schedule.poisoned() if t != schedule.victim]
    assert result["robust"]["quarantined"] == {t: 1 for t in poisoned_guarded}
    assert result["cost"]["compiled_variants"] < len(schedule.tenants) * len(schedule.config.batch_sizes)
    assert result["hostprof"]["enabled"] and result["hostprof"]["probe"] is not None


@pytest.fixture(scope="module")
def rolling_deploy_run():
    schedule = psched.generate(psched.ScheduleConfig(**TEST_SCHEDULE))
    config = preplay.ReplayConfig(rolling_deploy=True, fuse=2, scrape_interval_seconds=0.03,
                                  sync_timeout_seconds=0.02, device="cpu")
    result, _ = replay_capturing(preplay, schedule, config)
    return schedule, result


def test_rolling_deploy_is_judged_alike_and_passes(rolling_deploy_run):
    schedule, result = rolling_deploy_run
    assert_clock_free_rows_pass(judged_by_both(result, "rolling_deploy_slo_spec", "chaos_rd"))
    migration = result["migration"]
    assert migration["zero_loss"] is True and migration["healthz_named_migrating"] is True
    assert set(migration["tenants"]).isdisjoint({schedule.victim, schedule.hung})
    per_tenant = {ev["tenant"]: ev["index"] + 1 for ev in schedule.batches()}
    for tenant in migration["tenants"]:
        assert migration["controls"][tenant]["bit_identical"], tenant
        assert result["pipelines"][tenant]["batches"] == per_tenant[tenant]


def _process_state() -> dict:
    """The process-wide state a replay must leave as it found it: the value log's
    series, the cost ledger's entries, the tenant, migration, checkpoint, lease, fence
    and thread-tenant registries, the scope flag, and the live threads."""
    import threading

    from torchmetrics_tpu_torch.obs import cost, scope, values

    snap = scope.registries_snapshot()
    return {"series": len(values.get_log()), "ledger_entries": len(cost.get_ledger()),
            **{key: len(snap[key]) for key in ("rows", "migrations", "checkpoints", "leases", "fences", "threads")},
            "scope_enabled": snap["enabled"], "live_threads": threading.active_count()}


def test_three_replays_in_one_process_leave_its_state_as_they_found_it(monkeypatch):
    """Each flash-crowd replay leaves no value series, cost entry, tenant row or lease
    of its own behind: before the repair the value log gained 16 series and the ledger
    64 entries a replay, which every later replay's alert engine and ``/metrics``
    scrape read (40 replays in one process ran 137 -> 63 updates/s)."""
    clean_obs()
    schedule = psched.generate(psched.flash_crowd_config(seed=0, tenants=12))
    inside = []
    inner = preplay._replay

    def replay_noting_its_state(*args, **kwargs):
        result = inner(*args, **kwargs)
        inside.append(_process_state())
        return result

    monkeypatch.setattr(preplay, "_replay", replay_noting_its_state)
    before = _process_state()
    try:
        for n in range(3):
            result = preplay.replay(schedule, preplay.ReplayConfig(flash_crowd=True, device="cpu"))
            assert result["batches_fed"] > 0
            # the run had state of its own to leave behind, and left none
            assert inside[n]["series"] > before["series"] and inside[n]["ledger_entries"] > before["ledger_entries"]
            assert inside[n]["rows"] == 12 and inside[n]["leases"] > 0
            assert _process_state() == before, n
    finally:
        clean_obs()
