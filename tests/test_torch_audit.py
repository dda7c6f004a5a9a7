"""The port's conservation audit (``obs/audit.py``) held against the JAX package's.

The JAX battery (``tests/core/test_audit.py``) runs here as scenarios played in both
packages on the same seeded numpy batches, with the auditor's clocks injected
(``tick(now=...)``, ``wall=``) and the session epochs minted in order (``ep0``,
``ep1``, ...): then the audit report — per tenant the flow ledger ``fed = processed +
shed + deferred_pending + quarantined + skipped + in_flight`` of every session and its
merged totals, the invariants, the violations with their tenant, trace id and detail,
the audit events — and the ``audit.*`` gauges must be the same in both. Scenarios:
clean pipeline and multiplexer streams, a multiplexer with a quarantined NaN batch and
a shed tenant, an admission-deferred backlog, a drain→restore migration, a continuous
checkpoint stream, a multiplexer slice checkpointed with its deferred backlog (the
hand-off), a fence, an auditor installed mid-life, and the five seeded violations.

``audit_stream`` runs over the checkpoint streams each package wrote (each package's
auditor over both), and the CLI (``python -m torchmetrics_tpu_torch.obs.audit``) exits
0, 1 and 2 as JAX's does. With no auditor installed the engine's hooks stay inert and
``Metric.update`` enters no ``record_function`` range.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.engine.migrate as jmigrate  # noqa: E402
import torchmetrics_tpu.obs.audit as jaudit  # noqa: E402
import torchmetrics_tpu_torch.engine.migrate as tmigrate  # noqa: E402
import torchmetrics_tpu_torch.obs.audit as taudit  # noqa: E402
import torchmetrics_tpu_torch.obs.profile as tprofile  # noqa: E402
from test_torch_mux import JAX as JMUX  # noqa: E402
from test_torch_mux import TORCH as TMUX  # noqa: E402

JAX = SimpleNamespace(**vars(JMUX), audit=jaudit, migrate=jmigrate)
PORT = SimpleNamespace(**vars(TMUX), audit=taudit, migrate=tmigrate)
PACKAGES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for P in PACKAGES:
        counter = itertools.count()
        monkeypatch.setattr(P.lineage, "new_epoch", lambda counter=counter: f"ep{next(counter)}")
        P.trace.disable()
        P.trace.get_recorder().clear()
        P.lineage.disable()
        P.scope.reset()
        P.scope.install_admission(None)
        P.alerts.uninstall()
        P.audit.install_auditor(None)
        P.cost.get_ledger().clear()
    yield
    for P in PACKAGES:
        P.audit.install_auditor(None)
        P.alerts.uninstall()
        P.scope.install_admission(None)
        P.scope.reset()
        P.lineage.disable()
        P.trace.disable()
        P.trace.get_recorder().clear()


def _install(P, **kwargs):
    kwargs.setdefault("cadence_seconds", 1e-6)
    auditor = P.audit.ConservationAuditor(wall=lambda: 1000.0, **kwargs)
    P.audit.install_auditor(auditor)
    return auditor


def _values(P, n, seed=0, size=4):
    rng = np.random.RandomState(seed)
    return [P.arr(rng.rand(size).astype(np.float32)) for _ in range(n)]


def _feed(P, pipe, n, seed=0, size=4):
    for value in _values(P, n, seed, size):
        pipe.feed(value)


def _normalize(obj, root):
    if isinstance(obj, dict):
        return {k: _normalize(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_normalize(v, root) for v in obj]
    if isinstance(obj, str) and root:
        return obj.replace(root, "<root>")
    return obj


def _audit_view(P, auditor, root=""):
    report = auditor.report()
    rec = P.trace.TraceRecorder()
    auditor.record_gauges(rec)
    gauges = sorted((g["name"], sorted(g["labels"].items()), g["value"]) for g in rec.snapshot()["gauges"])
    return _normalize({"report": report, "gauges": gauges, "violations": sorted(
        auditor.violations(), key=lambda v: (v["invariant"], v["tenant"], str(v["trace_id"])))}, root)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__.lstrip("_")] = fn
    return fn


@scenario
def _pipeline_clean_stream(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    pipe = P.Pipeline(P.mean(), P.Config(fuse=2, tenant="clean-p"))
    _feed(P, pipe, 7)
    pipe.flush()
    auditor.tick(now=1.0)
    out = [_audit_view(P, auditor)]
    pipe.close()
    auditor.tick(now=2.0)
    return out + [_audit_view(P, auditor)]


@scenario
def _mux_clean_stream(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    mux = P.Mux(lambda: P.mean(), P.MuxConfig(max_width=4))
    for step in range(6):
        for tenant in ("m-a", "m-b", "m-c"):
            mux.feed(tenant, P.arr(np.asarray([float(step), 1.0], np.float32)))
    mux.flush()
    auditor.tick(now=1.0)
    out = [_audit_view(P, auditor)]
    mux.close()
    auditor.tick(now=2.0)
    return out + [_audit_view(P, auditor)]


@scenario
def _mux_quarantine_and_shed(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    controller = P.scope.AdmissionController(clock=lambda: 0.0)
    controller.set_quota("noisy", P.scope.TenantQuota(updates_per_window=2, window_seconds=100.0, over_quota="shed"))
    mux = P.Mux(lambda: P.mse(error_policy="quarantine"), P.MuxConfig(max_width=4, admission=controller))
    rng = np.random.RandomState(3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for step in range(4):
            for tenant in ("q-a", "q-b", "noisy"):
                preds = rng.rand(4).astype(np.float32)
                if step == 1 and tenant == "q-a":
                    preds[:] = np.nan
                mux.feed(tenant, P.arr(preds), P.arr(np.zeros(4, np.float32)))
        mux.flush()
    auditor.tick(now=1.0)
    auditor.tick(now=2.0)
    out = [_audit_view(P, auditor)]
    mux.close()
    auditor.tick(now=3.0)
    return out + [_audit_view(P, auditor)]


@scenario
def _pipeline_deferred_backlog_drains_at_close(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    controller = P.scope.AdmissionController(clock=lambda: 0.0)
    controller.set_quota("slow", P.scope.TenantQuota(updates_per_window=1, window_seconds=100.0, over_quota="defer"))
    pipe = P.Pipeline(P.mean(), P.Config(fuse=1, tenant="slow", admission=controller))
    _feed(P, pipe, 4)
    auditor.tick(now=1.0)
    auditor.tick(now=2.0)
    out = [_audit_view(P, auditor)]
    pipe.close()
    auditor.tick(now=3.0)
    return out + [_audit_view(P, auditor)]


@scenario
def _drain_restore_migration(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    policy = P.engine.CheckpointPolicy(directory=os.path.join(tmp, "mig"), every_batches=4, segment_bytes=4096)
    pipe = P.Pipeline(P.cat(1 << 10), P.Config(fuse=2, tenant="mig-t", checkpoint=policy))
    _feed(P, pipe, 5)
    bundle = pipe.checkpoint_now()
    pipe.close()
    auditor.tick(now=1.0)
    out = [_audit_view(P, auditor, tmp)]
    new_pipe, _ = P.engine.restore_session(
        P.cat(1 << 10), bundle,
        checkpoint=P.engine.CheckpointPolicy(directory=policy.directory, every_batches=4, segment_bytes=4096),
    )
    _feed(P, new_pipe, 3, seed=1)
    new_pipe.flush()
    auditor.tick(now=2.0)
    out.append(_audit_view(P, auditor, tmp))
    new_pipe.close()
    auditor.tick(now=3.0)
    return out + [_audit_view(P, auditor, tmp)]


@scenario
def _continuous_checkpoint_stream(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    policy = P.engine.CheckpointPolicy(directory=os.path.join(tmp, "cont"), every_batches=1, segment_bytes=4096)
    pipe = P.Pipeline(P.cat(1 << 10), P.Config(fuse=1, tenant="cont-t", checkpoint=policy))
    out = []
    for step in range(4):
        _feed(P, pipe, 1, seed=step)
        auditor.tick(now=float(step + 1))
        out.append(auditor.report()["violations"])
    pipe.close()
    auditor.tick(now=99.0)
    return out + [_audit_view(P, auditor, tmp)]


@scenario
def _mux_slice_hands_off_its_deferred_backlog(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    controller = P.scope.AdmissionController(clock=lambda: 0.0)
    controller.set_quota("slow", P.scope.TenantQuota(updates_per_window=1, window_seconds=100.0, over_quota="defer"))
    mux = P.Mux(lambda: P.mean(), P.MuxConfig(max_width=2, admission=controller))
    for step in range(3):
        for tenant in ("slow", "fast"):
            mux.feed(tenant, P.arr(np.asarray([float(step), 2.0], np.float32)))
    mux.flush()
    auditor.tick(now=1.0)
    out = [_audit_view(P, auditor, tmp)]
    P.engine.checkpoint_session(mux, os.path.join(tmp, "slice"), tenant="slow")
    auditor.tick(now=2.0)
    out.append(_audit_view(P, auditor, tmp))
    mux.close()
    auditor.tick(now=3.0)
    return out + [_audit_view(P, auditor, tmp)]


@scenario
def _fenced_epoch_is_an_audit_event(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    directory = os.path.join(tmp, "zomb")
    pipe = P.Pipeline(P.cat(1 << 10), P.Config(fuse=1, tenant="zomb-t"))
    _feed(P, pipe, 2)
    P.migrate.fence_epoch(directory, pipe.lineage_epoch, tenant="zomb-t")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            P.engine.checkpoint_session(pipe, os.path.join(directory, "bundle-000001"))
        except Exception as err:  # noqa: BLE001 - the refusal is what is compared
            refused = type(err).__name__
        else:
            refused = None
    auditor.tick(now=1.0)
    pipe.close()
    auditor.tick(now=2.0)
    return [refused, _audit_view(P, auditor, tmp)]


@scenario
def _auditor_installed_mid_life(P, tmp):
    P.lineage.enable()
    pipe = P.Pipeline(P.mean(), P.Config(fuse=1, tenant="mid-t"))
    _feed(P, pipe, 3)
    auditor = _install(P)
    _feed(P, pipe, 2, seed=1)
    auditor.tick(now=1.0)
    out = [_audit_view(P, auditor)]
    pipe.close()
    return out


@scenario
def _seeded_double_fold(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    pipe = P.Pipeline(P.mean(), P.Config(fuse=1, tenant="dup-t"))
    _feed(P, pipe, 3)
    dup = pipe.trace_id_for(1)
    pipe.replay_tail([((P.arr(np.asarray([0.5, 0.5], np.float32)),), {}, dup)])
    auditor.tick(now=50.0)
    out = [dup, _audit_view(P, auditor)]
    pipe.close()
    return out


@scenario
def _seeded_dropped_deferred_batch(P, tmp):
    P.lineage.enable()
    auditor = _install(P, confirm_ticks=2)
    controller = P.scope.AdmissionController(clock=lambda: 0.0)
    controller.set_quota("drop-t", P.scope.TenantQuota(updates_per_window=1, window_seconds=100.0, over_quota="defer"))
    pipe = P.Pipeline(P.mean(), P.Config(fuse=1, tenant="drop-t", admission=controller))
    _feed(P, pipe, 2)
    dropped = pipe._deferred[0][2]
    pipe._deferred.pop()
    auditor.tick(now=1.0)
    first = auditor.violations()
    auditor.tick(now=2.0)
    out = [dropped, first, _audit_view(P, auditor)]
    pipe.close()
    return out


@scenario
def _seeded_watermark_ahead_of_cursor(P, tmp):
    P.lineage.enable()
    auditor = _install(P, confirm_ticks=2)
    pipe = P.Pipeline(P.mean(), P.Config(fuse=1, tenant="wm-t"))
    _feed(P, pipe, 3)
    P.lineage.note_checkpoint("wm-t", "/tmp/bundle-lies", 99)
    auditor.tick(now=1.0)
    auditor.tick(now=2.0)
    out = [_audit_view(P, auditor)]
    pipe.close()
    return out


@scenario
def _seeded_post_fence_fold(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    pipe = P.Pipeline(P.mean(), P.Config(fuse=1, tenant="fen-t"))
    _feed(P, pipe, 2)
    P.scope.note_fence(pipe.lineage_epoch, tenant="fen-t")
    _feed(P, pipe, 1, seed=9)
    auditor.tick(now=1.0)
    out = [_audit_view(P, auditor)]
    pipe.close()
    return out


@scenario
def _seeded_exec_reconcile(P, tmp):
    P.lineage.enable()
    auditor = _install(P, confirm_ticks=2)
    target = P.mse()
    pipe = P.Pipeline(target, P.Config(fuse=1, tenant="raw-t"))
    pipe.feed(P.arr(np.asarray([1.0, 0.5], np.float32)), P.arr(np.zeros(2, np.float32)))
    pipe.flush()
    state = dict(target.__dict__["_state_values"])
    state = target.pure_update(state, P.arr(np.asarray([2.0, 1.0], np.float32)), P.arr(np.zeros(2, np.float32)))
    target._engine_commit_state(state, 1)
    auditor.tick(now=1.0)
    auditor.tick(now=2.0)
    out = [pipe.trace_id_for(0), _audit_view(P, auditor)]
    pipe.close()
    return out


@scenario
def _transient_candidate_never_confirms(P, tmp):
    auditor = _install(P, confirm_ticks=2)
    live = set()
    for fingerprint in ((1, 0), (2, 1), (3, 2)):
        auditor._candidate("exec_reconcile", "t", None, "x", fingerprint, live)
    auditor.tick(now=1.0)
    return [auditor.violations(), auditor.tick(now=1.0 + 1e-7) is None, auditor.ticks]


@scenario
def _violation_alert_preset_fires(P, tmp):
    P.lineage.enable()
    auditor = _install(P)
    rule = P.audit.audit_violation_rule()
    engine = P.alerts.configure(rule)
    pipe = P.Pipeline(P.mean(), P.Config(fuse=1, tenant="sick-t"))
    _feed(P, pipe, 2)
    pipe.replay_tail([((P.arr(np.asarray([1.0, 1.0], np.float32)),), {}, pipe.trace_id_for(0))])
    auditor.tick(now=1.0)
    P.audit.record_gauges()
    engine.evaluate(now=10.0)
    firing = sorted(a["rule"] for a in engine.active() if a["state"] == "firing")
    pipe.close()
    return [firing, {k: getattr(rule, k) for k in ("name", "kind", "series", "above", "for_seconds", "severity")}]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_audit_scenario_matches_jax(name, tmp_path):
    results = []
    for P in PACKAGES:
        root = tmp_path / P.name
        root.mkdir()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            results.append(json.loads(json.dumps(SCENARIOS[name](P, str(root)), default=str)))
    assert results[1] == results[0]


def test_clean_scenarios_balance_with_no_violation(tmp_path):
    """The port's own reading of the clean streams: the ledger balances per tenant."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        views = _mux_quarantine_and_shed(PORT, str(tmp_path))
    report = views[-1]["report"]
    assert report["violations"] == [] and all(row["passed"] for row in report["invariants"])
    totals = {t: e["totals"] for t, e in report["tenants"].items()}
    assert totals["q-a"]["quarantined"] == 1 and totals["noisy"]["shed"] == 2
    for row in totals.values():
        assert row["fed"] == (row["processed"] + row["shed"] + row["deferred_pending"] + row["quarantined"]
                              + row["skipped"] + row["in_flight"])


# ------------------------------------------------------------------ offline stream audit


def _write_stream(P, root, tenant="cli-t", batches=5):
    P.lineage.enable()
    policy = P.engine.CheckpointPolicy(directory=os.path.join(root, tenant), every_batches=2, segment_bytes=4096)
    pipe = P.Pipeline(P.cat(1 << 10), P.Config(fuse=1, tenant=tenant, checkpoint=policy))
    _feed(P, pipe, batches)
    bundle = pipe.checkpoint_now()
    epoch = pipe.lineage_epoch
    pipe.close()
    return policy.directory, bundle, epoch


STREAM_CASES = ("clean", "fenced", "corrupt")


@pytest.mark.parametrize("case", STREAM_CASES)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_audit_stream_over_either_packages_bundles_matches_jax(case, writer, tmp_path):
    P = JAX if writer == "jax" else PORT
    directory, bundle, epoch = _write_stream(P, str(tmp_path))
    if case == "fenced":
        P.migrate.fence_epoch(directory, epoch, tenant="cli-t")
    if case == "corrupt":
        with open(os.path.join(bundle, "MANIFEST.json"), "a", encoding="utf-8") as fh:
            fh.write("GARBAGE")
    port = _normalize(taudit.audit_stream(directory), str(tmp_path))
    jax = _normalize(jaudit.audit_stream(directory), str(tmp_path))
    for result in (port, jax):
        for entry in result["corrupt"]:
            entry["error"] = entry["error"].split(":")[0]  # each package words its parse error
        for row in result["fenced_epochs"].values():
            row.pop("fenced_unix", None)
    assert port == jax
    assert bool(port["corrupt"]) == (case == "corrupt")
    assert port["violations"] == []
    assert any(e["event"] == "fenced_epoch_bundle" for e in port["events"]) == (case == "fenced")


def test_cli_exit_codes_are_jax_codes(tmp_path, capsys):
    assert taudit.main([str(tmp_path / "missing")]) == 2
    assert "no such directory" in capsys.readouterr().err
    (tmp_path / "empty").mkdir()
    assert taudit.main([str(tmp_path / "empty")]) == 2
    assert "no session bundles" in capsys.readouterr().err
    directory, bundle, _ = _write_stream(PORT, str(tmp_path))
    assert taudit.main([directory]) == 0
    out = capsys.readouterr().out
    assert "cli-t" in out and "bundle(s)" in out
    assert taudit.main([directory, "--json"]) == 0
    page = json.loads(capsys.readouterr().out)
    assert page["bundles"] >= 1 and page["violations"] == [] and "cli-t" in page["tenants"]
    with open(os.path.join(bundle, "MANIFEST.json"), "a", encoding="utf-8") as fh:
        fh.write("GARBAGE")
    assert taudit.main([directory, "--quiet"]) == 1
    assert "CORRUPT" in capsys.readouterr().err


def test_cli_runs_as_a_module(tmp_path):
    directory, _, _ = _write_stream(PORT, str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-m", "torchmetrics_tpu_torch.obs.audit", directory, "--json"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout)["tenants"]["cli-t"]["bundles"] >= 1


# --------------------------------------------------------------------- planes off


def test_planes_off_the_engine_and_update_touch_no_hook(monkeypatch):
    """No auditor: no audit hook is reached. No profile session: ``Metric.update``
    enters no ``record_function`` range."""
    assert not taudit.ENABLED and not tprofile.RANGES

    def forbidden(*args, **kwargs):
        raise AssertionError("reached with its plane off")

    for name in ("track", "note_fold", "note_handed_off", "note_close"):
        monkeypatch.setattr(taudit, name, forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(tprofile, "metric_range", forbidden)
    pipe = PORT.Pipeline(PORT.mean(), PORT.Config(fuse=2, tenant="off-t"))
    _feed(PORT, pipe, 5)
    pipe.flush()
    pipe.close()
    metric = PORT.acc()
    metric.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    metric.compute()
    assert taudit.record_gauges() is None and taudit.get_auditor() is None


def test_audit_names_are_jax_names():
    assert sorted(taudit.__all__) == sorted(jaudit.__all__)
    assert taudit.INVARIANTS == jaudit.INVARIANTS
    for name in ("track", "note_fold", "note_handed_off", "note_close", "audit_stream"):
        assert callable(getattr(taudit, name))
