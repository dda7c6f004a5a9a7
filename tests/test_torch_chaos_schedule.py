"""The port's chaos traffic schedule against the JAX package's.

JAX's ``TestScheduleDeterminism`` and ``TestScheduleRejection``
(``tests/core/test_chaos.py``) played in both packages: the same config generates
byte-identical JSONL in each (the default config and the three presets at several
seeds), a schedule saved by one package loads in the other, and every rejection
raises the same exception type with the same message.
"""

from __future__ import annotations

import json

import pytest
import torch

import torchmetrics_tpu.chaos.schedule as jsched
import torchmetrics_tpu_torch.chaos.schedule as psched

torch.set_num_threads(2)

SEEDS = (0, 3, 7, 11)
PRESETS = {
    "default": lambda m, seed: m.ScheduleConfig(seed=seed),
    "default_small": lambda m, seed: m.ScheduleConfig(
        seed=seed, tenants=3, warm_batches=1, churn_batches=1, drain_batches=2,
        hang_seconds=0.2, absent_after_seconds=0.05, idle_gap_seconds=0.005),
    "high_tenant": lambda m, seed: m.high_tenant_config(seed=seed),
    "skewed_load": lambda m, seed: m.skewed_load_config(seed=seed),
    "flash_crowd": lambda m, seed: m.flash_crowd_config(seed=seed),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_generate_is_byte_identical_to_jax(preset, seed):
    want = jsched.generate(PRESETS[preset](jsched, seed)).to_jsonl()
    got = psched.generate(PRESETS[preset](psched, seed)).to_jsonl()
    assert got == want
    assert psched.generate(PRESETS[preset](psched, seed)).to_jsonl() == got  # same seed, same bytes


def test_overrides_and_roles_as_jax():
    want = jsched.generate(jsched.ScheduleConfig(seed=5), tenants=9, burst=3)
    got = psched.generate(psched.ScheduleConfig(seed=5), tenants=9, burst=3)
    assert got.to_jsonl() == want.to_jsonl()
    assert got.tenants == want.tenants and got.victim == want.victim and got.hung == want.hung
    assert got.guarded == want.guarded and got.poisoned() == want.poisoned()
    assert got.total_sleep_seconds() == want.total_sleep_seconds()
    flash_j = jsched.generate(jsched.flash_crowd_config(seed=2))
    flash_p = psched.generate(psched.flash_crowd_config(seed=2))
    assert flash_p.hot_tenants_initial == flash_j.hot_tenants_initial
    assert flash_p.hot_tenants_shifted == flash_j.hot_tenants_shifted


def test_different_seeds_differ():
    assert psched.generate(psched.ScheduleConfig(seed=7)).to_jsonl() != psched.generate(
        psched.ScheduleConfig(seed=8)).to_jsonl()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_other_s_saved_schedule(tmp_path, writer):
    src, dst = (jsched, psched) if writer == "jax" else (psched, jsched)
    sched = src.generate(src.flash_crowd_config(seed=4))
    path = str(tmp_path / "sched.jsonl")
    assert sched.save(path) == path
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    loaded = dst.load(path)
    assert loaded.to_jsonl() == text == sched.to_jsonl()
    assert loaded.roles == sched.roles and loaded.events == sched.events


def test_hung_tenant_is_silent_inside_the_window():
    sched = psched.generate(psched.ScheduleConfig(seed=0))
    inside = False
    for ev in sched.events:
        if ev["kind"] == "hang_start":
            inside = True
        elif ev["kind"] == "hang_end":
            inside = False
        elif inside and ev["kind"] == "batch":
            assert ev["tenant"] != sched.hung


def _text(mod, seed=0):
    return mod.generate(mod.ScheduleConfig(seed=seed)).to_jsonl()


def _schema(text, mod):
    lines = text.splitlines()
    meta = json.loads(lines[0])
    meta["schema"] = mod.SCHEDULE_SCHEMA + 1
    lines[0] = json.dumps(meta, sort_keys=True)
    return "\n".join(lines) + "\n"


def _swap(text, _):
    lines = text.splitlines()
    lines[1], lines[2] = lines[2], lines[1]
    return "\n".join(lines) + "\n"


def _blank(text, _):
    lines = text.splitlines()
    lines.insert(3, "")
    return "\n".join(lines) + "\n"


def _record(text, key, value):
    lines = text.splitlines()
    record = json.loads(lines[1])
    record[key] = value
    lines[1] = json.dumps(record, sort_keys=True)
    return "\n".join(lines) + "\n"


def _roles(text, roles_fn):
    lines = text.splitlines()
    meta = json.loads(lines[0])
    meta["roles"] = roles_fn(meta["roles"])
    lines[0] = json.dumps(meta, sort_keys=True)
    return "\n".join(lines) + "\n"


def _config(text, key, value):
    lines = text.splitlines()
    meta = json.loads(lines[0])
    meta["config"][key] = value
    lines[0] = json.dumps(meta, sort_keys=True)
    return "\n".join(lines) + "\n"


REJECTIONS = {
    "schema": _schema,
    "truncated_line": lambda text, _: text[: len(text) - 30],
    "missing_tail": lambda text, _: "\n".join(text.splitlines()[:-1]) + "\n",
    "reordered": _swap,
    "blank_line": _blank,
    "empty": lambda text, _: "",
    "no_meta": lambda text, _: '{"type": "event", "i": 0}\n',
    "unparseable_meta": lambda text, _: "{not json\n",
    "unknown_kind": lambda text, _: _record(text, "kind", "comet-strike"),
    "unknown_tenant": lambda text, _: _record(text, "tenant", "tenant-99"),
    "no_roles": lambda text, _: _roles(text, lambda r: {}),
    "no_victim": lambda text, _: _roles(text, lambda r: {t: "guarded" for t in r}),
    "unknown_role": lambda text, _: _roles(text, lambda r: dict(r, extra="supervisor")),
    "bad_config": lambda text, _: _config(text, "tenants", 2),
    "unknown_config_key": lambda text, _: _config(text, "comet", 1),
    "not_an_event": lambda text, _: _record(text, "type", "meta"),
}


def _raised(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the error itself is compared
        return type(err).__name__, str(err)
    return None


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_loads_rejects_as_jax_does(case):
    want = _raised(lambda: jsched.loads(REJECTIONS[case](_text(jsched), jsched), source="s.jsonl"))
    got = _raised(lambda: psched.loads(REJECTIONS[case](_text(psched), psched), source="s.jsonl"))
    assert want is not None and want[0] == "ScheduleError"
    assert got == want


def test_unreadable_path_rejected_as_jax(tmp_path):
    path = str(tmp_path / "nope.jsonl")
    want, got = _raised(lambda: jsched.load(path)), _raised(lambda: psched.load(path))
    assert want[0] == "ScheduleError" and got == want


CONFIG_ERRORS = {
    "tenants": {"tenants": 2},
    "batch_sizes": {"batch_sizes": ()},
    "batch_sizes_zero": {"batch_sizes": (0, 4)},
    "warm": {"warm_batches": 0},
    "churn": {"churn_batches": 0},
    "drain": {"drain_batches": 0},
    "poisoned": {"poisoned_guarded": 0},
    "hang": {"hang_seconds": 0.1, "absent_after_seconds": 0.2},
    "burst": {"burst": 0},
    "hot_negative": {"hot_tenants": -1},
    "hot_factor": {"hot_factor": 0},
    "hot_factor_one": {"hot_tenants": 1, "hot_factor": 1},
    "hot_too_many": {"hot_tenants": 3, "hot_factor": 2, "tenants": 8},
}


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_config_validation_as_jax(case):
    want = _raised(lambda: jsched.ScheduleConfig(**CONFIG_ERRORS[case]))
    got = _raised(lambda: psched.ScheduleConfig(**CONFIG_ERRORS[case]))
    assert want is not None and want[0] == "ValueError"
    assert got == want


@pytest.mark.parametrize(("preset", "tenants"), [("high_tenant_config", 8), ("skewed_load_config", 3),
                                                 ("flash_crowd_config", 8)])
def test_presets_reject_small_tenant_counts_as_jax(preset, tenants):
    want = _raised(lambda: getattr(jsched, preset)(tenants=tenants))
    got = _raised(lambda: getattr(psched, preset)(tenants=tenants))
    assert want is not None and got == want


def test_all_lists_match_jax():
    import torchmetrics_tpu.chaos as jchaos
    import torchmetrics_tpu_torch.chaos as pchaos

    assert pchaos.__all__ == jchaos.__all__
    assert psched.__all__ == jsched.__all__
    assert psched.EVENT_KINDS == jsched.EVENT_KINDS and psched.SCHEDULE_SCHEMA == jsched.SCHEDULE_SCHEMA
