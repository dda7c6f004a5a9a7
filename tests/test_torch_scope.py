"""The port's tenant scope held against the JAX package's.

Counterparts of the cases of ``tests/core/test_obs_tenants.py`` that need no
admission plane, obs server, cost ledger or memory accounting: the contextvar scope,
the bounded registry with its ``__overflow__`` bucket, label propagation through the
recorder, the ``PipelineConfig.tenant`` session seam, and the migration, checkpoint,
lease and fence notes that ``engine/migrate.py`` and ``robust/fence.py`` report into
the scope, with their gauges. Each scenario runs in both packages and what it
observes must be the same; wall clocks are passed in (``now=``), never slept on.
"""

from __future__ import annotations

import json
import math
import threading
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.obs.scope as jscope  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu_torch.obs.scope as tscope  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
from torchmetrics_tpu import MetricCollection as JCollection  # noqa: E402
from torchmetrics_tpu.engine import MetricPipeline as JPipeline  # noqa: E402
from torchmetrics_tpu.engine import PipelineConfig as JConfig  # noqa: E402
from torchmetrics_tpu.regression import MeanSquaredError as JMSE  # noqa: E402
from torchmetrics_tpu_torch import Metric  # noqa: E402
from torchmetrics_tpu_torch import MetricCollection as TCollection  # noqa: E402
from torchmetrics_tpu_torch.engine import MetricPipeline as TPipeline  # noqa: E402
from torchmetrics_tpu_torch.engine import PipelineConfig as TConfig  # noqa: E402


class MeanSquaredError(Metric):
    """The JAX package's ``MeanSquaredError`` (one output), under its name."""

    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs):
        super().__init__(**{"device": "cpu", **kwargs})
        self.add_state("sum_squared_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds, target):
        diff = preds.to(torch.float32) - target.to(torch.float32)
        self.sum_squared_error = self.sum_squared_error + (diff * diff).sum()
        self.total = self.total + preds.numel()

    def compute(self):
        return self.sum_squared_error / self.total


JAX = SimpleNamespace(name="jax", scope=jscope, trace=jtrace, arr=jnp.asarray, mse=JMSE, Collection=JCollection,
                      Pipeline=JPipeline, Config=JConfig)
TORCH = SimpleNamespace(name="torch", scope=tscope, trace=ttrace, arr=lambda a: torch.as_tensor(np.asarray(a)),
                        mse=MeanSquaredError, Collection=TCollection, Pipeline=TPipeline, Config=TConfig)
PACKAGES = (JAX, TORCH)

# registry fields that are wall-clock stamps: compared as orderings, not values
_WALL = ("first_seen_unix", "last_seen_unix")


@pytest.fixture(autouse=True)
def _clean():
    for P in PACKAGES:
        P.scope.reset()
        P.trace.disable()
        P.trace.get_recorder().clear()
    yield
    for P in PACKAGES:
        P.scope.reset()
        P.trace.disable()
        P.trace.get_recorder().clear()


def _ones(P, n=4):
    return P.arr(np.ones(n, dtype=np.float32)), P.arr(np.zeros(n, dtype=np.float32))


def _rows(P):
    """Registry rows without their wall stamps (their order is checked instead)."""
    out = []
    for row in P.scope.get_registry().rows():
        assert row["last_seen_unix"] >= row["first_seen_unix"]
        out.append({k: v for k, v in row.items() if k not in _WALL})
    return out


def _warned(caught, text):
    return sum(text in str(w.message) for w in caught)


# ------------------------------------------------------------------- scenarios


def _scope_basics(P):
    out = {"enabled_before": P.scope.ENABLED, "ambient_before": P.scope.current_tenant()}
    with P.scope.scope("acme") as tenant:
        out["inside"] = (tenant, P.scope.ENABLED, P.scope.current_tenant())
    out["after"] = (P.scope.current_tenant(), P.scope.ENABLED)
    with P.scope.scope("outer"):
        with P.scope.scope("inner"):
            out["nested"] = P.scope.current_tenant()
        out["unnested"] = P.scope.current_tenant()
    refused = []
    for bad in ("", "   ", None, 7, "__reserved", "__anything"):
        try:
            with P.scope.scope(bad):
                pass
        except (ValueError, TypeError) as err:
            refused.append(type(err).__name__)
    out["refused"] = refused
    with P.scope.scope(P.scope.OVERFLOW_TENANT) as label:
        out["overflow_label"] = label
    seen = {}
    with P.scope.scope("main-tenant"):
        thread = threading.Thread(target=lambda: seen.update(t=P.scope.current_tenant()))
        thread.start()
        thread.join()
    out["thread"] = seen["t"]
    out["adopt"] = (P.scope.adopt(), P.scope.adopt("adopted"))
    return out


def _registry_liveness(P):
    with P.scope.scope("acct"):
        m = P.mse()
        m.update(*_ones(P))
        m.update(*_ones(P))
        m.compute()
        m.compute()  # a cache hit is no new compute
    with P.scope.scope("sticky"):
        sticky = P.mse()
    sticky.update(*_ones(P, 2))  # no ambient scope: billed to the captured tenant
    with P.scope.scope("b"):
        sticky.update(*_ones(P, 2))  # the ambient scope wins
    member = P.mse()
    with P.scope.scope("team"):
        col = P.Collection([member])
    return {"rows": _rows(P), "captured": (sticky._obs_tenant, member._obs_tenant, col._obs_tenant),
            "labels": (sticky._obs_labels(), P.mse()._obs_labels())}


def _overflow(P):
    out = {}
    P.scope.configure(max_tenants=3)
    for i in range(3):
        with P.scope.scope(f"t{i}"):
            pass
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with P.scope.scope("t3") as label3:
            pass
        with P.scope.scope("t4") as label4:
            pass
        with P.scope.scope("t0") as known:  # already registered: no overflow
            pass
        for _ in range(3):
            with P.scope.scope("repeat"):
                pass
    reg = P.scope.get_registry()
    out["labels"] = (label3, label4, known)
    out["warned"] = _warned(caught, "registry is FULL")
    out["counts"] = (reg.overflow_names, reg.overflow_registrations, len(reg))
    out["rows"] = _rows(P)
    rec = P.trace.TraceRecorder()
    P.scope.record_gauges(recorder=rec)
    out["gauges"] = sorted(((g["name"], g["labels"].get("tenant"), g["value"]) for g in rec.snapshot()["gauges"]
                            if g["name"] not in ("tenant.last_activity_age_seconds",)), key=repr)
    return out


def _overflow_saturates(P):
    P.scope.configure(max_tenants=1)
    with P.scope.scope("only"):
        pass
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(5):
            with P.scope.scope("repeat-offender"):
                pass
        reg = P.scope.get_registry()
        first = (reg.overflow_names, reg.overflow_registrations)
        for _ in range(3):
            with P.scope.scope("untracked-name"):
                pass
    return {"first": first, "then": (reg.overflow_names, reg.overflow_registrations)}


def _overflowed_pipeline(P):
    P.scope.configure(max_tenants=1)
    with P.scope.scope("only"):
        pass
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        pipe = P.Pipeline(P.mse(), P.Config(fuse=2, prefetch=0, tenant="spillover"))
    label = pipe._tenant
    pipe.feed(*_ones(P))
    pipe.feed(*_ones(P))
    pipe.close()
    return {"label": label, "rows": _rows(P)}


def _recorder_propagation(P):
    rec = P.trace.get_recorder()
    with P.trace.observe():
        with P.scope.scope("acme"):
            P.trace.inc("work.items", 2.0)
            P.trace.set_gauge("queue.depth", 3.0)
            P.trace.observe_duration("step", 1e-3)
            P.trace.event("something", detail="x")
            with P.trace.span("metric.update", metric="M"):
                pass
        P.trace.inc("work.items", 1.0)  # outside: untagged
    snap = rec.snapshot()
    out = {
        "counters": sorted(((c["name"], c["labels"].get("tenant"), c["value"]) for c in snap["counters"]), key=repr),
        "gauges": sorted(((g["name"], g["labels"].get("tenant")) for g in snap["gauges"]), key=repr),
        "hists": sorted(((h["name"], h["labels"].get("tenant")) for h in snap["histograms"]), key=repr),
        "tagged_events": sorted(e["name"] for e in snap["events"] if e["attrs"].get("tenant") == "acme"),
    }
    other = P.trace.TraceRecorder()
    with P.scope.scope("ambient"):
        other.set_gauge("g", 1.0, tenant="explicit")
        other.set_gauge("global", 1.0, tenant=None)  # the opt-out: no label at all
    out["explicit"] = sorted((g["name"], sorted(g["labels"].items())) for g in other.snapshot()["gauges"])
    counts = P.trace.TraceRecorder()
    with P.scope.scope("a"):
        counts.inc("c1")
        counts.set_gauge("g1", 1.0)
    with P.scope.scope("b"):
        counts.inc("c1")
    counts.inc("untagged")
    out["series_counts"] = counts.series_counts_by_label("tenant")
    with P.scope.scope("idle"):
        pass
    meta = P.trace.TraceRecorder()
    P.scope.record_gauges(recorder=meta)
    P.scope.record_gauges(recorder=meta)  # the tenant.* meta-gauges never count themselves
    out["meta"] = sorted((g["name"], sorted(g["labels"])) for g in meta.snapshot()["gauges"]
                         if g["labels"].get("tenant") in ("idle", None))
    return out


def _metric_spans_tagged(P):
    with P.trace.observe() as rec:
        with P.scope.scope("acct"):
            m = P.mse()
            m.update(*_ones(P))
            m.compute()
    # the metric's own spans (a JAX update also records its jit spans: JAX jits by
    # default, the port's update is eager)
    spans = sorted((e["name"], e["attrs"].get("tenant")) for e in rec.events()
                   if e["kind"] == "span" and e["name"].startswith("metric."))
    return {"spans": spans}


def _pipeline_session(P, tmp_path):
    out = {}
    m = P.mse()
    pipe = P.Pipeline(m, P.Config(fuse=2, prefetch=0, tenant="sess"))
    out["adopted"] = m._obs_tenant
    out["started"] = _rows(P)
    for _ in range(4):
        pipe.feed(*_ones(P, 8))
    pipe.close()
    out["closed"] = _rows(P)
    pipe.close()  # idempotent: the session ends exactly once
    out["closed_twice"] = _rows(P)
    quarantined = P.mse(error_policy="quarantine")
    pipe = P.Pipeline(quarantined, P.Config(fuse=2, prefetch=0, tenant="sess", flight_records=8,
                                            flight_dump_dir=str(tmp_path / P.name)))
    with P.trace.observe() as rec, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe.feed(*_ones(P, 8))
        pipe.feed(P.arr(np.full(8, np.nan, dtype=np.float32)), P.arr(np.zeros(8, dtype=np.float32)))
        pipe.close()
    spans = [e for e in rec.events() if e["kind"] == "span" and e["name"] == "engine.dispatch"]
    out["spans_tagged"] = bool(spans) and all(s["attrs"].get("tenant") == "sess" for s in spans)
    meta = json.loads(open(pipe.flight_dumps[0]).readline())
    out["flight"] = (meta["tenant"], meta["config"]["tenant"], meta["reason"])
    out["trace_id"] = pipe.trace_id_for(3).split("-")[0]
    doomed = P.Pipeline(P.mse(error_policy="raise"), P.Config(fuse=4, prefetch=0, tenant="doomed"))
    doomed.feed(P.arr(np.full(4, np.nan, dtype=np.float32)), P.arr(np.zeros(4, dtype=np.float32)))
    with pytest.raises(Exception):
        doomed.close()
    out["doomed"] = next(r for r in _rows(P) if r["tenant"] == "doomed")["active_pipelines"]
    for bad in ("", "__reserved"):
        with pytest.raises(ValueError):
            P.Config(tenant=bad)
    return out


def _migration_and_checkpoint_notes(P):
    out = {}
    with P.scope.migration("acme", "drain"):
        with P.scope.migration("acme", "checkpoint"):
            out["inner"] = P.scope.migrating_tenants()
        out["outer"] = P.scope.migrating_tenants()
    out["after"] = P.scope.migrating_tenants()
    with pytest.raises(ValueError):
        with P.scope.migration("__bad"):
            pass
    P.scope.note_checkpoint("acme", path="/b/bundle-000000", nbytes=100, kind="full", seconds=0.5,
                            stale_after_seconds=30.0)
    P.scope.note_checkpoint("acme", path="/b/bundle-000001", nbytes=40, kind="delta", seconds=0.25)
    P.scope.note_checkpoint_failure("acme")
    P.scope.note_checkpoint_failure("fresh")
    status = P.scope.checkpoint_status()
    last = status["acme"]["last_unix"]
    out["status"] = {t: {k: v for k, v in row.items() if k != "last_unix"} for t, row in status.items()}
    out["overdue"] = (P.scope.checkpoint_overdue(now=last + 10.0), P.scope.checkpoint_overdue(now=last + 40.0))
    P.scope.note_checkpoint_closed("acme")
    out["overdue_closed"] = P.scope.checkpoint_overdue(now=last + 40.0)
    return out


def _lease_and_fence_notes(P):
    out = {}
    P.scope.note_lease("acme", holder="h:1", epoch="e1", ttl_seconds=30.0, expires_unix=130.0, renewed_unix=100.0)
    P.scope.note_lease("acme", holder="h:1", epoch="e1", ttl_seconds=30.0, expires_unix=140.0, renewed_unix=110.0)
    P.scope.note_lease(None, holder="h:2", epoch="e2", ttl_seconds=10.0, expires_unix=120.0, renewed_unix=110.0)
    out["status"] = P.scope.lease_status()
    out["expired"] = (P.scope.expired_leases(now=135.0), P.scope.expired_leases(now=150.0, grace=5.0))
    P.scope.note_lease_released(None)
    out["released"] = P.scope.expired_leases(now=150.0)
    record = P.scope.note_fence("e1", tenant="acme", holder="h:1", by="h:3", target="h:3", fenced_unix=151.0)
    again = P.scope.note_fence("e1", tenant="acme", holder="other", fenced_unix=999.0)  # the first record wins
    out["fence"] = (record, again, P.scope.is_fenced("e1"), P.scope.is_fenced("e9"), P.scope.is_fenced(None))
    # a zombie renewing its fenced epoch cannot clobber the failed-over session's row
    P.scope.note_lease("acme", holder="h:3", epoch="e3", ttl_seconds=30.0, expires_unix=190.0, renewed_unix=160.0)
    P.scope.note_lease("acme", holder="h:1", epoch="e1", ttl_seconds=30.0, expires_unix=200.0, renewed_unix=170.0)
    out["after_fence"] = (P.scope.lease_status()["acme"], P.scope.expired_leases(now=195.0),
                          P.scope.fenced_tenants(), sorted(P.scope.fence_status()))
    for note in (P.scope.note_torn_bundles, P.scope.note_fenced_bundle_rejected, P.scope.note_fenced_bundle_swept,
                 P.scope.note_failover_yielded):
        note(2)
        note(0)
    out["counts"] = (P.scope.torn_bundle_count(), P.scope.fenced_rejected_count(), P.scope.fenced_swept_count(),
                     P.scope.failover_yielded_count())
    with P.scope.scope("acme"):
        pass
    P.scope.note_checkpoint("acme", path="/b/x", nbytes=10, kind="full", seconds=0.1)
    rec = P.trace.TraceRecorder()
    summary = P.scope.record_gauges(recorder=rec)
    out["summary"] = {k: v for k, v in summary.items() if k != "quota_rows"}
    out["gauges"] = sorted((g["name"], sorted(g["labels"].items()))
                           for g in rec.snapshot()["gauges"])
    out["values"] = sorted((g["name"], g["value"]) for g in rec.snapshot()["gauges"]
                           if g["name"].startswith(("fence.", "checkpoint.torn", "lease.active", "lease.expired")))
    return out


def _restore_row(P):
    with P.scope.scope("moved"):
        m = P.mse()
        m.update(*_ones(P))
    merged = P.scope.get_registry().restore_row("moved", updates=1000, computes=3, first_seen_unix=1.0)
    again = P.scope.get_registry().restore_row("moved", updates=10, computes=1)  # a high-water max, not an add
    fresh = P.scope.get_registry().restore_row("new", updates=5)
    strip = ("last_seen_unix", "first_seen_unix", "first_step", "last_step")
    return {"merged": {k: v for k, v in merged.items() if k not in strip}, "first_seen": merged["first_seen_unix"],
            "again": {k: v for k, v in again.items() if k not in strip},
            "fresh": {k: v for k, v in fresh.items() if k not in strip}}


SCENARIOS = {
    "scope_basics": _scope_basics,
    "registry_liveness": _registry_liveness,
    "overflow": _overflow,
    "overflow_saturates": _overflow_saturates,
    "overflowed_pipeline": _overflowed_pipeline,
    "recorder_propagation": _recorder_propagation,
    "metric_spans_tagged": _metric_spans_tagged,
    "migration_and_checkpoint_notes": _migration_and_checkpoint_notes,
    "lease_and_fence_notes": _lease_and_fence_notes,
    "restore_row": _restore_row,
}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float):
        return "nan" if math.isnan(x) else round(x, 6)
    return x


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scope_scenario_matches_jax(scenario):
    run = SCENARIOS[scenario]
    want, got = run(JAX), run(TORCH)
    assert _plain(want) == _plain(got), scenario


def test_pipeline_session_matches_jax(tmp_path):
    want, got = _pipeline_session(JAX, tmp_path), _pipeline_session(TORCH, tmp_path)
    assert _plain(want) == _plain(got)
    assert got["closed"][0]["active_pipelines"] == 0 and got["closed"][0]["updates"] == 4
    assert got["doomed"] == 0 and got["spans_tagged"]
