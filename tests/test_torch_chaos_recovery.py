"""The port's chaos replay of the recovery and fleet scenarios, on the CPU.

``host_crash`` and ``hung_host`` at the JAX suite's test schedule
(``tests/core/test_chaos.py``), ``skewed_load`` and ``flash_crowd`` (its control
arm first, as ``bench.py --chaos`` runs it) at their presets, all with
``device="cpu"``. Each result is judged by both packages' ``judge`` under the
scenario's spec; the reports must be equal and every row that reads no wall clock
must pass. The helpers are ``tests/test_torch_chaos_replay.py``'s.
"""

from __future__ import annotations

import pytest
import torch

import torchmetrics_tpu_torch.chaos.schedule as psched
from tests.test_torch_chaos_replay import (
    TEST_SCHEDULE,
    assert_clock_free_rows_pass,
    judged_by_both,
    preplay,
    replay_capturing,
)

torch.set_num_threads(2)


def _replay(schedule, **config):
    result, _ = replay_capturing(preplay, schedule, preplay.ReplayConfig(device="cpu", **config))
    return result


@pytest.fixture(scope="module")
def host_crash_run():
    schedule = psched.generate(psched.ScheduleConfig(**TEST_SCHEDULE))
    return schedule, _replay(schedule, host_crash=True, checkpoint_every_batches=4)


def test_host_crash_is_judged_alike_and_passes(host_crash_run):
    schedule, result = host_crash_run
    assert_clock_free_rows_pass(judged_by_both(result, "host_crash_slo_spec", "chaos_hc", cadence_batches=4))
    crash = result["crash"]
    assert crash["zero_loss"] is True and crash["torn_bundle_skipped"] is True
    assert set(crash["tenants"]).isdisjoint({schedule.victim, schedule.hung})
    assert crash["checkpoints"]["full_bundles"] >= 1 and crash["checkpoints"]["delta_bundles"] >= 1
    per_tenant = {ev["tenant"]: ev["index"] + 1 for ev in schedule.batches()}
    for tenant, session in crash["sessions"].items():
        assert 0 <= session["replay_gap_batches"] <= crash["cadence_batches"]
        assert session["restored_cursor"] <= session["fed_at_crash"]
        assert session["bundle"] != "bundle-999999"
        assert result["pipelines"][tenant]["batches"] == per_tenant[tenant]


@pytest.fixture(scope="module")
def hung_host_run():
    schedule = psched.generate(psched.ScheduleConfig(**TEST_SCHEDULE))
    return schedule, _replay(schedule, hung_host=True)


def test_hung_host_is_judged_alike_and_passes(hung_host_run):
    schedule, result = hung_host_run
    assert_clock_free_rows_pass(judged_by_both(result, "hung_host_slo_spec", "chaos_hh"))
    fence = result["fence"]
    assert fence["zero_double_count"] is True
    zombie = fence["zombie"]
    assert zombie["landed"] and zombie["rejected_count"] >= 1 and zombie["discarded"]
    assert zombie["selected"] != zombie["bundle"]
    assert fence["healthz_named_fenced"] is True and fence["leases_page_fences"] >= len(fence["tenants"])
    assert fence["time_to_detect_seconds"] >= fence["lease_seconds"] * 0.5
    per_tenant = {ev["tenant"]: ev["index"] + 1 for ev in schedule.batches()}
    for tenant, session in fence["sessions"].items():
        assert session["new_epoch"] != session["fenced_epoch"]
        assert session["restored_cursor"] <= session["fed_at_wedge"] and session["refed_batches"] >= 1
        assert result["pipelines"][tenant]["batches"] == per_tenant[tenant]
    # the hung tenant's guarded sync timed out under the injected hang and degraded
    assert schedule.hung in result["robust"]["sync_degraded"]


@pytest.fixture(scope="module")
def skewed_load_run():
    schedule = psched.generate(psched.skewed_load_config())
    return schedule, _replay(schedule, skewed_load=True)


def test_skewed_load_is_judged_alike_and_passes(skewed_load_run):
    _, result = skewed_load_run
    assert_clock_free_rows_pass(judged_by_both(result, "skewed_load_slo_spec", "chaos_sk"))
    fleet = result["fleet"]
    wedged = fleet["shift"]["wedged_sample"]
    # the gather under the injected hang degraded loudly, naming the missing host
    assert wedged["degraded"] is True and wedged["missing_hosts"]
    assert fleet["samples"] >= 2 and fleet["probe"]["enabled"]


@pytest.fixture(scope="module")
def flash_crowd_run():
    schedule = psched.generate(psched.flash_crowd_config())
    control = _replay(schedule, flash_crowd=True, placement_enabled=False)
    result = _replay(schedule, flash_crowd=True)
    result["placement"]["control_arm_updates_per_second"] = control["updates_per_second"]
    result["placement"]["control_arm"] = {
        "batches_fed": control["batches_fed"],
        "wall_seconds": control["wall_seconds"],
        "sleep_seconds": control["sleep_seconds"],
        "compile_seconds": control["cost"]["compile_seconds"],
        "updates_per_second": control["updates_per_second"],
    }
    return schedule, control, result


def test_flash_crowd_is_judged_alike_and_passes(flash_crowd_run):
    schedule, control, result = flash_crowd_run
    assert_clock_free_rows_pass(judged_by_both(result, "flash_crowd_slo_spec", "chaos_fc"))
    placement = result["placement"]
    assert placement["restored_from_disk"] is True and placement["zero_loss"] is True
    assert placement["moves_completed"] >= 2 and placement["post_shift_moves"] >= 1
    for tenant, row in placement["controls"].items():
        assert row["bit_identical"], (tenant, row)
    pinned = {schedule.victim, *schedule.poisoned()}
    assert pinned.isdisjoint(placement["moved"])
    # the control arm ran the same schedule with no controller
    assert control["placement"]["enabled"] is False and control["placement"]["moves_completed"] == 0


def test_a_footprint_never_reads_a_card_count_mid_update():
    """While an update of a buffered metric traces or captures, ``pure_update`` binds a
    state whose ``MaskedBuffer`` count is a 0-d card tensor. A scrape thread's footprint
    (``/metrics``, ``/tenants``, ``/memory``) must not read it: on the card that read
    synchronises inside the capture and breaks it (the host-crash scenario's CatMetric
    tenants). The fill is billed full then; a host count is read as before."""
    from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
    from torchmetrics_tpu_torch.obs import memory

    class CardCount(torch.Tensor):
        is_cuda = True

        def __int__(self):
            raise AssertionError("a card count was read")

        __index__ = __int__

    data = torch.zeros(32)
    card_count = torch.tensor(5).as_subclass(CardCount)
    row = memory._leaf_row(MaskedBuffer(data, card_count))
    assert (row["fill_items"], row["capacity"]) == (32, 32)
    assert memory._leaf_row(MaskedBuffer(data, torch.tensor(5)))["fill_items"] == 5
    assert memory._leaf_row(MaskedBuffer(data, 7))["fill_items"] == 7
