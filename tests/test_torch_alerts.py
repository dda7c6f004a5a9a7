"""The port's value timelines and alert engine held against the JAX package's.

Counterparts of ``tests/core/test_obs_alerts.py`` (``TestValueTimeline``,
``TestRuleSpecs``, ``TestRuleConditions``, ``TestStateMachine``,
``TestFireResolveTimes``, ``TestEgress``, ``TestPipelineSeam``) and of the value and
alert cases of ``tests/core/test_obs_tenants.py``. A rule program — values recorded
into a ``ValueLog``, recorder writes, clock moves and evaluations — runs in both
packages with the same injected clock, and the transitions, live alerts, history,
episodes and ``ALERTS``-style gauges must be the same. The metric hooks, the pipeline
seam and an engine state exported by one package and restored by the other are held
the same way. CPU only, no sleeps.
"""

from __future__ import annotations

import json
import math
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.obs.alerts as jalerts  # noqa: E402
import torchmetrics_tpu.obs.scope as jscope  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu.obs.values as jvalues  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.obs.alerts as talerts  # noqa: E402
import torchmetrics_tpu_torch.obs.scope as tscope  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
import torchmetrics_tpu_torch.obs.values as tvalues  # noqa: E402
from torchmetrics_tpu import MetricCollection as JCollection  # noqa: E402
from torchmetrics_tpu.engine import MetricPipeline as JPipeline  # noqa: E402
from torchmetrics_tpu.engine import PipelineConfig as JConfig  # noqa: E402
from torchmetrics_tpu.regression import MeanSquaredError as JMSE  # noqa: E402
from torchmetrics_tpu_torch import Metric  # noqa: E402
from torchmetrics_tpu_torch import MetricCollection as TCollection  # noqa: E402
from torchmetrics_tpu_torch.engine import MetricPipeline as TPipeline  # noqa: E402
from torchmetrics_tpu_torch.engine import PipelineConfig as TConfig  # noqa: E402

ATOL = 1e-5


class MeanSquaredError(Metric):
    """The JAX package's ``MeanSquaredError`` (one output; its plot lower bound), under
    its name: value series are keyed by the metric's class name."""

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


JAX = SimpleNamespace(name="jax", alerts=jalerts, values=jvalues, trace=jtrace, scope=jscope, arr=jnp.asarray,
                      acc=lambda: jc.BinaryAccuracy(), mse=JMSE, Collection=JCollection, Pipeline=JPipeline,
                      Config=JConfig)
TORCH = SimpleNamespace(name="torch", alerts=talerts, values=tvalues, trace=ttrace, scope=tscope,
                        arr=lambda a: torch.as_tensor(np.asarray(a)), acc=lambda: tc.BinaryAccuracy(device="cpu"),
                        mse=MeanSquaredError, Collection=TCollection, Pipeline=TPipeline, Config=TConfig)
PACKAGES = (JAX, TORCH)


@pytest.fixture(autouse=True)
def _clean():
    for P in PACKAGES:
        P.values.disable()
        P.values.get_log().clear()
        P.alerts.uninstall()
        P.trace.disable()
        P.trace.get_recorder().clear()
        P.scope.reset()
    yield
    for P in PACKAGES:
        P.values.disable()
        P.values.get_log().clear()
        P.alerts.uninstall()
        P.trace.disable()
        P.trace.get_recorder().clear()
        P.scope.reset()


def _plain(x):
    """A comparable plain form: tensors and arrays as lists, floats rounded by the
    tolerance's digits, NaN as a string."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray) or type(x).__module__.startswith("jax"):
        x = np.asarray(x)
        return _plain(x.tolist()) if x.ndim else _plain(x.item())
    if isinstance(x, float):
        return "nan" if math.isnan(x) else round(x, 5)
    return x


def _same(a, b, where):
    assert _plain(a) == _plain(b), where


# ------------------------------------------------------------------ rule programs

NAN, INF = float("nan"), float("inf")


def _run_program(P, rules, steps, engine_kwargs=None, record_gauges=False):
    """Run a rule program in one package: a private value log and recorder, a fake
    clock; returns what the engine said at each evaluation and at the end."""
    now = [1000.0]
    log, rec = P.values.ValueLog(), P.trace.TraceRecorder()
    engine = P.alerts.AlertEngine(rules=[P.alerts.AlertRule(**r) for r in rules], value_log=log, recorder=rec,
                                  clock=lambda: now[0], **(engine_kwargs or {}))
    seen = []
    for op, *args in steps:
        if op == "rec":
            metric, step, value, kw = args[0], args[1], args[2], dict(args[3] if len(args) > 3 else {})
            log.record(metric, kw.pop("inst", "0"), kw.pop("leaf", "value"), step, value,
                       wall=kw.pop("wall", now[0]), **kw)
        elif op == "clock":
            now[0] = args[0]
        elif op == "inc":
            rec.inc(args[0], args[1], **args[2])
        elif op == "gauge":
            rec.set_gauge(args[0], args[1], **args[2])
        elif op == "clear_log":
            log.clear()
        elif op == "eval":
            seen.append(("eval", engine.evaluate()))
        elif op == "gauges":
            engine.record_gauges()
            seen.append(("gauges", sorted(
                (g["name"], sorted(g["labels"].items()), g["value"])
                for g in rec.snapshot()["gauges"] if g["name"].startswith("alerts"))))
    out = {"seen": seen, "active": engine.active(), "history": engine.history(),
           "episodes": engine.fire_resolve_times(), "samples": len(engine._samples),
           "dropped": engine.samples_dropped, "evaluations": engine.evaluations,
           "counters": sorted((c["name"], sorted(c["labels"].items()), c["value"])
                              for c in rec.snapshot()["counters"])}
    if record_gauges:
        engine.record_gauges()
        out["gauges"] = sorted((g["name"], sorted(g["labels"].items()), g["value"])
                               for g in rec.snapshot()["gauges"])
    out["report"] = engine.report()
    return out


PROGRAMS = {
    "non_finite_fires_and_resolves": (
        [dict(name="nf", kind="non_finite", metric="M")],
        [("rec", "M", 1, 0.5), ("eval",), ("rec", "M", 2, NAN), ("eval",), ("rec", "M", 3, 0.5), ("eval",)]),
    "bounds_from_rule_and_declared_metadata": (
        [dict(name="explicit", kind="bounds", metric="A", max_value=10.0),
         dict(name="declared", kind="bounds", metric="B"), dict(name="undeclared", kind="bounds", metric="C")],
        [("rec", "A", 1, 11.0), ("rec", "B", 1, 1.5, {"bounds": (0.0, 1.0)}), ("rec", "C", 1, 1e9), ("eval",)]),
    "bounds_below_minimum": (
        [dict(name="lo", kind="bounds", metric="M", min_value=0.0)], [("rec", "M", 1, -0.25), ("eval",)]),
    "frozen_after_n_identical": (
        [dict(name="fz", kind="frozen", metric="M", frozen_for=3)],
        [("rec", "M", 0, 0.5), ("rec", "M", 1, 0.5), ("eval",), ("rec", "M", 3, 0.5), ("eval",),
         ("rec", "M", 4, 0.75), ("eval",)]),
    "jump_z_score_on_spike_only": (
        [dict(name="jp", kind="jump", metric="M", window=8, z_threshold=3.0, min_samples=4)],
        [*(("rec", "M", s, v) for s, v in enumerate([1.0, 1.1, 0.9, 1.0, 1.05])), ("eval",),
         ("rec", "M", 9, 50.0), ("eval",)]),
    "jump_needs_min_samples": (
        [dict(name="jp", kind="jump", metric="M", min_samples=5)],
        [("rec", "M", 0, 1.0), ("rec", "M", 1, 100.0), ("eval",)]),
    "absent_on_stale_series_with_fake_clock": (
        [dict(name="ab", kind="absent", metric="M", max_age_seconds=30.0)],
        [("rec", "M", 1, 0.5), ("eval",), ("clock", 1031.0), ("eval",), ("rec", "M", 2, 0.5), ("eval",)]),
    "absent_placeholder_resolves_on_samples": (
        [dict(name="ab", kind="absent", metric="M", max_age_seconds=30.0)],
        [("eval",), ("rec", "M", 1, 0.5), ("eval",)]),
    "vanished_series_resolves": (
        [dict(name="nf", kind="non_finite", metric="M")],
        [("rec", "M", 1, NAN), ("eval",), ("clear_log",), ("eval",)]),
    "threshold_on_recorder_counter": (
        [dict(name="q", kind="threshold", series="robust.update_quarantined", above=2.0)],
        [("inc", "robust.update_quarantined", 2.0, {"metric": "M"}), ("eval",),
         ("inc", "robust.update_quarantined", 1.0, {"metric": "M"}), ("eval",)]),
    "threshold_below_on_gauge_with_label_filter": (
        [dict(name="depth", kind="threshold", series="engine.queue_depth", labels={"pipeline": "P"}, below=1.0)],
        [("gauge", "engine.queue_depth", 5.0, {"pipeline": "P"}),
         ("gauge", "engine.queue_depth", 0.0, {"pipeline": "other"}), ("eval",),
         ("gauge", "engine.queue_depth", 0.0, {"pipeline": "P"}), ("eval",)]),
    "frozen_on_recorder_series": (
        [dict(name="stuck", kind="frozen", series="work.items", frozen_for=3)],
        [("inc", "work.items", 5.0, {}), ("eval",), ("eval",), ("eval",)]),
    "for_seconds_dwell_pending_then_firing": (
        [dict(name="nf", kind="non_finite", metric="M", for_seconds=10.0)],
        [("clock", 0.0), ("rec", "M", 1, INF), ("eval",), ("clock", 5.0), ("eval",), ("clock", 10.0), ("eval",)]),
    "pending_cancels_when_condition_clears": (
        [dict(name="nf", kind="non_finite", metric="M", for_seconds=60.0)],
        [("rec", "M", 1, NAN), ("eval",), ("rec", "M", 2, 0.5), ("eval",)]),
    "resolved_alert_refires": (
        [dict(name="nf", kind="non_finite", metric="M")],
        [("rec", "M", 1, NAN), ("eval",), ("rec", "M", 2, 0.5), ("eval",), ("rec", "M", 3, NAN), ("eval",)]),
    "dwell_rule_episode_deltas": (
        [dict(name="nf", kind="non_finite", metric="M", for_seconds=5.0)],
        [("clock", 100.0), ("rec", "M", 1, NAN), ("eval",), ("clock", 106.0), ("eval",), ("clock", 110.0),
         ("rec", "M", 2, 0.5), ("eval",), ("gauges",)]),
    "refire_yields_one_episode_per_fire": (
        [dict(name="nf", kind="non_finite", metric="M")],
        [("rec", "M", 1, NAN), ("eval",), ("clock", 1002.0), ("rec", "M", 2, 0.5), ("eval",),
         ("clock", 1005.0), ("rec", "M", 3, NAN), ("eval",), ("gauges",)]),
    "alerts_series_and_totals_with_resolve_edge": (
        [dict(name="nf", kind="non_finite", metric="M", severity="critical"),
         dict(name="pend", kind="non_finite", metric="P", for_seconds=60.0)],
        [("rec", "M", 1, NAN), ("rec", "P", 1, NAN), ("eval",), ("gauges",), ("rec", "M", 2, 0.5),
         ("eval",), ("gauges",)]),
    "rule_tenant_glob_targets_one_tenant": (
        [dict(name="nf-a", kind="non_finite", metric="*", tenant="tenant-a")],
        [("rec", "M", 1, NAN, {"tenant": "tenant-a"}), ("rec", "M", 1, NAN, {"inst": "1", "tenant": "tenant-b"}),
         ("rec", "M", 1, NAN, {"inst": "2"}), ("eval",)]),
    "rule_tenant_glob_targets_cohort": (
        [dict(name="nf", kind="non_finite", metric="*", tenant="team-*")],
        [("rec", "M", 1, NAN, {"tenant": "team-red"}), ("rec", "M", 1, NAN, {"inst": "1", "tenant": "team-blue"}),
         ("rec", "M", 1, NAN, {"inst": "2", "tenant": "other"}), ("eval",)]),
    "same_metric_two_tenants_independent": (
        [dict(name="nf", kind="non_finite", metric="M")],
        [("rec", "M", 1, NAN, {"tenant": "a"}), ("rec", "M", 1, 0.5, {"tenant": "b"}), ("eval",),
         ("rec", "M", 2, 0.5, {"tenant": "a"}), ("rec", "M", 2, NAN, {"tenant": "b"}), ("eval",), ("gauges",)]),
    "tenant_star_excludes_untenanted": (
        [dict(name="nf", kind="non_finite", metric="*", tenant="*")],
        [("rec", "M", 1, NAN), ("rec", "M", 1, NAN, {"inst": "1", "tenant": "acct"}), ("eval",)]),
    "absent_placeholder_names_its_tenant": (
        [dict(name="acme-gone", kind="absent", metric="Acc", tenant="acme", max_age_seconds=60.0)], [("eval",)]),
    "series_rules_filter_on_tenant_label": (
        [dict(name="hot", kind="threshold", series="queue.depth", above=5.0, tenant="a")],
        [("gauge", "queue.depth", 10.0, {"tenant": "a"}), ("gauge", "queue.depth", 99.0, {"tenant": "b"}),
         ("eval",)]),
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_rule_program_matches_jax(program):
    rules, steps = PROGRAMS[program]
    _same(_run_program(JAX, rules, steps, record_gauges=True), _run_program(TORCH, rules, steps, record_gauges=True),
          program)


def test_history_ring_sampled_series_cap_and_clear_match_jax():
    steps = [("rec", "M", s, NAN if s % 2 == 0 else 0.5) for s in range(8) for _ in (0,)]
    program = [x for s in steps for x in (s, ("eval",))]
    outs = []
    for P in PACKAGES:
        out = _run_program(P, [dict(name="nf", kind="non_finite", metric="M")], program, {"history": 4})
        assert len(out["history"]) == 4
        now = [0.0]
        engine = P.alerts.AlertEngine(rules=[P.alerts.AlertRule(name="wide", kind="threshold", series="g.*",
                                                                above=1e9)],
                                      recorder=P.trace.TraceRecorder(), clock=lambda: now[0])
        engine.max_sampled_series = 3
        for i in range(6):
            engine._rec().set_gauge("g.depth", 1.0, inst=str(i))
        engine.evaluate()
        out["capped"] = (len(engine._samples), engine.samples_dropped)
        engine.clear()
        out["cleared"] = (engine.samples_dropped, engine.active(), engine.history(), len(engine.rules()))
        outs.append(out)
    _same(outs[0], outs[1], "history/cap/clear")


@pytest.mark.parametrize("spec, match", [
    (dict(name="r", kind="sideways"), "Unknown alert kind"),
    (dict(name="r", kind="threshold"), "requires `series="),
    (dict(name="r", kind="threshold", series="x"), "requires `above=` or `below="),
    (dict(name="r", kind="non_finite", metric="M", series="s"), "both a value source"),
])
def test_rule_specs_are_refused_as_jax_refuses_them(spec, match):
    for P in PACKAGES:
        with pytest.raises(ValueError, match=match):
            P.alerts.AlertRule(**spec)


def test_rule_coercion_defaults_and_duplicates_match_jax():
    seen = []
    for P in PACKAGES:
        engine = P.alerts.AlertEngine(rules=[{"name": "a", "kind": "non_finite"}])
        engine.add_rule(name="b", kind="frozen", metric="M")
        with pytest.raises(ValueError, match="Duplicate"):
            engine.add_rule(name="b", kind="non_finite")
        for kind in ("non_finite", "bounds", "frozen", "jump", "absent"):
            P.alerts.AlertRule(name=f"s-{kind}", kind=kind, series="x")
        seen.append(([r.name for r in engine.rules()], P.alerts.AlertRule(name="r", kind="non_finite").metric,
                     P.alerts.KINDS))
    assert seen[0] == seen[1]


def test_sinks_and_history_dump_match_jax(tmp_path):
    outs = []
    for P in PACKAGES:
        sink = tmp_path / P.name / "alerts" / "transitions.jsonl"
        now = [50.0]
        engine = P.alerts.AlertEngine(rules=[P.alerts.AlertRule(name="nf", kind="non_finite", metric="M")],
                                      value_log=P.values.ValueLog(), recorder=P.trace.TraceRecorder(),
                                      sink_path=str(sink), clock=lambda: now[0])
        log = engine._log()
        log.record("M", "0", "value", 1, NAN, wall=50.0)
        engine.evaluate()
        log.record("M", "0", "value", 2, 0.5, wall=50.0)
        engine.evaluate()
        dumped = engine.write_history(str(tmp_path / P.name / "history.jsonl"))
        blocker = tmp_path / P.name / "not-a-dir"
        blocker.write_text("file, not directory")
        bad = P.alerts.AlertEngine(rules=[P.alerts.AlertRule(name="nf", kind="non_finite", metric="M")],
                                   value_log=P.values.ValueLog(), recorder=P.trace.TraceRecorder(),
                                   sink_path=str(blocker / "x.jsonl"), clock=lambda: now[0])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bad._log().record("M", "0", "value", 1, NAN, wall=50.0)
            bad.evaluate()
            bad._log().record("M", "0", "value", 2, 0.5, wall=50.0)
            bad.evaluate()
        outs.append({"sink": [json.loads(line) for line in open(sink)], "dumped": dumped,
                     "history": [json.loads(line) for line in open(tmp_path / P.name / "history.jsonl")],
                     "warned": sum("unwritable" in str(w.message) for w in caught), "kept": len(bad.history())})
    _same(outs[0], outs[1], "sinks")
    assert outs[1]["warned"] == 1 and outs[1]["kept"] == 2


# ------------------------------------------------------------- metric hooks


def _acc_batch(P):
    return P.arr(np.array([1, 0, 1, 1], dtype=np.int32)), P.arr(np.array([1, 0, 1, 0], dtype=np.int32))


def _timeline_scenario(P):
    """The ``TestValueTimeline`` cases in one run: disabled records nothing, a fresh
    compute lands with its step anchor and bounds, a cache hit does not, collection
    members record on their own, the leaf flattening, the caps."""
    out = {}
    m = P.acc()
    m.update(*_acc_batch(P))
    m.compute()
    out["disabled"] = len(P.values.get_log())
    P.values.enable()
    m = P.acc()
    m.update(*_acc_batch(P))
    m.compute()
    m.compute()  # a cache hit is the same evaluation
    (series,) = P.values.get_log().series()
    out["series"] = {k: series[k] for k in ("metric", "leaf", "bounds")}
    out["points"] = [(p[0], p[2]) for p in series["points"]]
    m.update(P.arr(np.array([1], dtype=np.int32)), P.arr(np.array([0], dtype=np.int32)))
    m.compute()
    out["after_update"] = [(p[0], p[2]) for p in P.values.get_log().series()[0]["points"]]
    P.values.get_log().clear()
    col = P.Collection([P.acc(), P.mse()])
    col.update(P.arr(np.array([1.0, 0.0], dtype=np.float32)), P.arr(np.array([1.0, 0.0], dtype=np.float32)))
    col.compute()
    out["members"] = sorted(s["metric"] for s in P.values.get_log().series())
    out["gauges"] = sorted((g["name"], g["labels"].get("metric"), g["value"])
                           for g in P.trace.get_recorder().snapshot()["gauges"] if g["name"] == "value.current")
    out["leaves"] = dict(P.values.iter_scalar_leaves({"a": 1.0, "b": {"c": 2.0}, "d": (3.0, 4.0)}))
    out["scalar"] = dict(P.values.iter_scalar_leaves(P.arr(np.float32(0.25))))
    out["nonscalar"] = dict(P.values.iter_scalar_leaves(P.arr(np.ones(4, dtype=np.float32))))
    before = P.values.get_log().skipped_nonscalar
    P.values.record_compute(P.acc(), P.arr(np.ones(4, dtype=np.float32)))
    out["skipped"] = P.values.get_log().skipped_nonscalar - before
    ring = P.values.ValueLog(max_points=4)
    for i in range(10):
        ring.record("M", "0", "value", i, float(i))
    out["ring"] = [p[2] for p in ring.series()[0]["points"]]
    capped = P.values.ValueLog(max_series=2)
    out["cap"] = [capped.record(n, "0", "value", 0, 1.0) for n in "ABC"] + [capped.dropped_series, len(capped)]
    return out


def _sample_local_scenario(P):
    """``sample_local``: sync-free, no cache pollution, skips never-updated metrics,
    a collection samples its members; and the value bounds each metric declares."""
    out = {}
    m = P.mse()
    m.update(P.arr(np.array([1.0, 3.0], dtype=np.float32)), P.arr(np.array([0.0, 0.0], dtype=np.float32)))
    out["recorded"] = P.values.sample_local(m)
    out["cache"] = m._computed is None
    out["value"] = P.values.get_log().series()[0]["points"][0][2]
    col = P.Collection([P.acc(), P.mse()])
    out["never_updated"] = P.values.sample_local(col)
    col.update(P.arr(np.array([1.0, 0.0], dtype=np.float32)), P.arr(np.array([1.0, 0.0], dtype=np.float32)))
    out["collection"] = P.values.sample_local(col)
    acc = P.acc()
    out["bounds"] = [acc._resolved_value_bounds()]
    acc.value_bounds = (0.25, None)
    out["bounds"].append(acc._resolved_value_bounds())
    mse = P.mse()
    out["bounds"].append(mse._resolved_value_bounds())
    mse.plot_lower_bound = None
    out["bounds"].append(mse._resolved_value_bounds())
    return out


def _tenant_values_scenario(P):
    """Value timelines split per tenant and carry the tenant on their gauges; tenant
    egress of alerts stays unlabeled for untenanted alerts inside a scope."""
    out = {}
    P.values.enable()
    m = P.mse()
    with P.scope.scope("a"):
        m.update(P.arr(np.ones(2, dtype=np.float32)), P.arr(np.zeros(2, dtype=np.float32)))
        m.compute()
    m.update(P.arr(np.ones(2, dtype=np.float32)), P.arr(np.full(2, 3.0, dtype=np.float32)))
    with P.scope.scope("b"):
        m.compute()
    out["tenants"] = sorted(s["tenant"] for s in P.values.get_log().series())
    out["latest_a"] = P.values.get_log().latest("MeanSquaredError", tenant="a")
    out["gauge_tenants"] = sorted(g["labels"].get("tenant") for g in P.trace.get_recorder().snapshot()["gauges"]
                                  if g["name"] == "value.current")
    log, rec = P.values.ValueLog(), P.trace.TraceRecorder()
    engine = P.alerts.AlertEngine(rules=[P.alerts.AlertRule(name="nf", kind="non_finite", metric="*")],
                                  value_log=log, recorder=rec, clock=lambda: 5.0)
    log.record("M", "0", "value", 1, NAN, wall=5.0)
    with P.scope.scope("bystander"):
        engine.evaluate()
        engine.record_gauges()
        P.scope.record_gauges(recorder=rec)
    snap = rec.snapshot()
    out["egress"] = sorted((g["name"], sorted(g["labels"])) for g in snap["gauges"] + snap["counters"]
                           if g["name"].startswith(("alerts", "tenant.registered", "tenant.overflow")))
    return out


@pytest.mark.parametrize("scenario", [_timeline_scenario, _sample_local_scenario, _tenant_values_scenario],
                         ids=lambda f: f.__name__.strip("_"))
def test_value_hooks_match_jax(scenario):
    _same(scenario(JAX), scenario(TORCH), scenario.__name__)


# ------------------------------------------------------------- pipeline seam


def _seam_scenario(P, tmp_path):
    """A NaN batch through a session with the alert engine: the non-finite rule fires
    at the chunk that folded it, and one flight dump names the rule."""
    engine = P.alerts.AlertEngine(rules=[P.alerts.AlertRule(name="non_finite", kind="non_finite", metric="*"),
                                         P.alerts.AlertRule(name="oob", kind="bounds", metric="*")],
                                  value_log=P.values.ValueLog(), recorder=P.trace.TraceRecorder())
    m = P.mse()
    pipe = P.Pipeline(m, P.Config(fuse=2, prefetch=0, tenant="victim", alert_engine=engine,
                                  flight_dump_dir=str(tmp_path / P.name)))
    rng = np.random.RandomState(3)
    for i in range(6):
        x = rng.rand(8).astype(np.float32)
        if i == 3:
            x[2] = np.nan
        pipe.feed(P.arr(x), P.arr(np.zeros(8, dtype=np.float32)))
    pipe.close()
    meta = json.loads(open(pipe.flight_dumps[0]).readline()) if pipe.flight_dumps else {}
    return {"fired": sorted((a["rule"], a["tenant"]) for a in engine.firing()), "dumps": len(pipe.flight_dumps),
            "reason": meta.get("reason"), "tenant": meta.get("tenant"), "evaluations": engine.evaluations,
            "steps": [p[0] for p in engine._log().series()[0]["points"]]}


def _cadence_scenario(P, tmp_path):
    """``alert_every`` evaluates every Nth commit and ``close`` once more; a broken
    engine warns once and the stream flows; ``alert_every`` < 1 is refused."""
    out = {}
    engine = P.alerts.AlertEngine(rules=[P.alerts.AlertRule(name="nf", kind="non_finite", metric="*")],
                                  value_log=P.values.ValueLog(), recorder=P.trace.TraceRecorder())
    pipe = P.Pipeline(P.mse(), P.Config(fuse=1, prefetch=0, alert_engine=engine, alert_every=3))
    for _ in range(7):
        pipe.feed(P.arr(np.ones(4, dtype=np.float32)), P.arr(np.zeros(4, dtype=np.float32)))
    out["before_close"] = engine.evaluations
    pipe.close()
    out["after_close"] = engine.evaluations

    class Broken:
        def evaluate(self):
            raise RuntimeError("engine down")

    pipe = P.Pipeline(P.mse(), P.Config(fuse=1, prefetch=0, alert_engine=Broken()))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            pipe.feed(P.arr(np.ones(4, dtype=np.float32)), P.arr(np.zeros(4, dtype=np.float32)))
    out["warned"] = sum("Alert evaluation failed" in str(w.message) for w in caught)
    out["batches"] = pipe.report().batches
    with pytest.raises(ValueError, match="alert_every"):
        P.Config(alert_every=0)
    return out


@pytest.mark.parametrize("scenario", [_seam_scenario, _cadence_scenario], ids=lambda f: f.__name__.strip("_"))
def test_pipeline_alert_seam_matches_jax(scenario, tmp_path):
    _same(scenario(JAX, tmp_path), scenario(TORCH, tmp_path), scenario.__name__)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_engine_state_moves_between_packages_with_its_dwell_clock(direction):
    """A pending alert exported by one package resumes in the other after only the
    rest of its dwell, and both continue alike (the session-bundle seam)."""
    src, dst = (JAX, TORCH) if direction == "jax_to_torch" else (TORCH, JAX)
    now = [0.0]
    rules = [dict(name="nf", kind="non_finite", metric="M", for_seconds=10.0),
             dict(name="fire", kind="non_finite", metric="F")]
    origin = src.alerts.AlertEngine(rules=[src.alerts.AlertRule(**r) for r in rules], value_log=src.values.ValueLog(),
                                    recorder=src.trace.TraceRecorder(), clock=lambda: now[0])
    origin._log().record("M", "0", "value", 1, NAN, wall=0.0)
    origin._log().record("F", "0", "value", 1, NAN, wall=0.0)
    origin.evaluate()
    state = json.loads(json.dumps(origin.export_state()))
    outs = []
    for P, st in ((src, None), (dst, state)):
        engine = origin if st is None else P.alerts.AlertEngine(value_log=P.values.ValueLog(),
                                                                recorder=P.trace.TraceRecorder(),
                                                                clock=lambda: now[0])
        if st is not None:
            assert engine.restore_state(st) == 2
            engine._log().restore_series(origin._log().series())
        outs.append(engine)
    seen = []
    for t in (6.0, 10.0):
        now[0] = t
        seen.append([e.evaluate() for e in outs])
    for a, b in seen:
        _same(a, b, f"{direction}.transitions")
    _same(outs[0].active(), outs[1].active(), f"{direction}.active")
    _same(outs[0].history(), outs[1].history(), f"{direction}.history")
    assert [a["rule"] for a in outs[1].firing()] == ["fire", "nf"] or sorted(a["rule"] for a in outs[1].firing()) == \
        ["fire", "nf"]
