"""Chaos replay driver: a schedule through tenant pipelines under live scrape.

This is where a :class:`~torchmetrics_tpu_torch.chaos.schedule.TrafficSchedule`
becomes measured reality. :func:`replay` builds one
:class:`~torchmetrics_tpu_torch.engine.pipeline.MetricPipeline` **session per
tenant** (``PipelineConfig.tenant`` + the shared alert engine), starts the
live introspection server on an ephemeral port, and executes the schedule's
events in order while a background thread concurrently scrapes the server —
the Prometheus model, run *during* the chaos rather than after it. Faults
travel the production seams:

- **Poisoned batches** arrive as NaN inputs. Guarded tenants
  (``error_policy="quarantine"``) degrade the fused chunk to a per-batch
  replay that quarantines exactly the poisoned batch and dumps the flight
  recorder with it *named*; the victim tenant runs an unguarded
  ``MeanSquaredError`` whose state goes NaN, so the ``non_finite`` value
  watchdog fires mid-stream (and resolves after the scheduled ``repair``).
- **The hung host** fires the hanging-collective fake
  (:func:`~torchmetrics_tpu_torch.robust.faults.inject_collective_fault` under a
  short :func:`~torchmetrics_tpu_torch.robust.degraded.sync_guard`): the guarded
  eager collective times out, the metric degrades loudly
  (``sync_degraded``), and the tenant stays silent for the hang window so
  the ``absent`` watchdog fires — then resolves when drain traffic returns.
- **Scrape latency** is measured twice: by the driver's scrape thread
  (client-observed, per route) and by the server's own
  ``server.request`` histogram (:mod:`~torchmetrics_tpu_torch.obs.server`
  self-instrumentation) — the SLO judge reads the histogram via
  :func:`~torchmetrics_tpu_torch.obs.export.histogram_quantile`.

:func:`replay` returns a plain-data result dict;
:mod:`~torchmetrics_tpu_torch.chaos.slo` judges it. The driver leaves the process
clean (server stopped, pipelines closed, no engine installed globally), but
the tenant registry keeps the session rows — that is telemetry, not leakage.

On the card (``ReplayConfig.device``, default ``"cuda"``) every metric, shadow
control and batch lives on the device. A session restore captures CUDA graphs
(``core/jit.py``), and a capture in PyTorch's default global mode fails if
another thread issues CUDA work meanwhile. So every piece of device work of the
run holds one lock: the feeding loop's events, the placement mover's moves and
the fence watchdog's failovers (both ticked from a scrape handler thread). A
move or a failover therefore lands between two feeds, as JAX's ``flash_lock``
orders the flash crowd's moves, and its swap is visible to the next scrape.
"""

from __future__ import annotations

import gc
import json
import math
import os
import tempfile
import threading
import time
import urllib.request
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch.chaos.schedule import ROLE_VICTIM, TrafficSchedule
from torchmetrics_tpu_torch.obs import audit as _audit
from torchmetrics_tpu_torch.obs import hostprof as _hostprof
from torchmetrics_tpu_torch.obs import lineage as _lineage
from torchmetrics_tpu_torch.obs import trace as _trace
from torchmetrics_tpu_torch.obs.alerts import AlertEngine, AlertRule
from torchmetrics_tpu_torch.obs.server import IntrospectionServer
from torchmetrics_tpu_torch.robust import fence as _fence
from torchmetrics_tpu_torch.utils.checkpoint import _to_host

__all__ = ["ReplayConfig", "ReplayError", "replay"]


class ReplayError(RuntimeError):
    """The replay could not execute the schedule it was given."""


@dataclass
class ReplayConfig:
    """Execution knobs of :func:`replay` (the *workload* lives in the schedule).

    Args:
        fuse: micro-batch fusion depth of every tenant pipeline (``1`` keeps
            the per-batch path — faster to warm up, no scan variants).
        multiplex: drive the guarded/hung tenants through ONE
            :class:`~torchmetrics_tpu_torch.engine.mux.TenantMultiplexer` (cross-
            tenant fused dispatch, shared compiled programs) instead of one
            pipeline per tenant. The victim keeps its own unguarded pipeline
            — it runs a different metric class and the value-watchdog path is
            its whole point. This is the before/after lever for the
            compiled-variant-collapse SLO.
        mux_max_width: the multiplexer's top tenant-width bucket.
        rolling_deploy: simulate a rolling deploy — half the clean guarded
            tenants live on "host B", which is **killed mid-traffic** (at the
            schedule's midpoint): every host-B session is drained,
            checkpointed to a bundle, and restored as a fresh session on the
            survivor via the live-session migration protocol
            (:mod:`torchmetrics_tpu_torch.engine.migrate`), with a shadow control
            metric fed the identical stream proving the restored ``compute()``
            bit-identical. The fault-surface tenants (victim, hung, the
            poisoned guarded tenant) stay on host A so their scenarios run
            unchanged *through* the deploy. Incompatible with ``multiplex``.
        migrate_fraction: fraction of the eligible (clean guarded) tenants
            placed on host B.
        host_crash: simulate an **unplanned** host death — the crash-consistent
            twin of ``rolling_deploy``. Host B's tenants run pipelines with a
            :class:`~torchmetrics_tpu_torch.engine.migrate.CheckpointPolicy` writing
            **continuous periodic bundles** (delta-encoded, full compaction
            points, retention-swept) to per-tenant directories, and drive a
            large-state ``CatMetric`` (a capacity ``MaskedBuffer``) so the
            full-vs-delta bundle-bytes evidence is measurable. At the schedule
            midpoint host B is killed with SIGKILL semantics: **no drain, no
            close, no final checkpoint** — its pipelines are simply abandoned
            (batches in the open fusion chunk are lost). Recovery restores
            each tenant from :func:`~torchmetrics_tpu_torch.engine.migrate.latest_valid_bundle`
            (a planted mid-write garbage bundle must be skipped), re-feeds the
            replay gap from the retained deterministic stream, and the run
            continues; shadow controls prove end-of-run bit-identity and the
            gap is judged against the cadence. Incompatible with
            ``multiplex`` and ``rolling_deploy``.
        checkpoint_every_batches: the host-crash tenants' checkpoint cadence
            (batches between periodic bundles — the replay-gap bound the SLO
            judges).
        checkpoint_dir: where the bundle streams land (default: a fresh
            tempdir per replay, removed on return).
        hung_host: simulate a host that **hangs** mid-traffic — the fencing
            twin of ``host_crash``. Host B's tenants run continuous-checkpoint
            pipelines holding a short renewable **lease**
            (:mod:`torchmetrics_tpu_torch.robust.fence`); at the schedule midpoint
            host B wedges: no drain, no close, no lease release — its
            sessions simply stop renewing while their objects stay live (the
            defining difference from a crash: a zombie can still *write*).
            The scrape-driven :class:`~torchmetrics_tpu_torch.robust.fence.Watchdog`
            detects the stale leases, fences the zombie epochs and restores
            each tenant elsewhere under a fresh epoch; the driver re-feeds the
            gap plus the wedge-period traffic from the retained stream. The
            zombie then attempts a late bundle write, which must land
            fenced-out: the next recovery scan rejects it (counted) and never
            selects it. Shadow controls prove end-of-run bit-identity — zero
            double-counting between zombie and successor. Incompatible with
            ``multiplex``, ``rolling_deploy`` and ``host_crash``.
        skewed_load: simulate a fleet with **heavily skewed per-host load** —
            the fleet-telemetry-plane scenario. A static placement maps every
            tenant but one onto virtual host ``"0"`` (the hot host) and the
            last tenant onto host ``"1"``; a
            :class:`~torchmetrics_tpu_torch.obs.fleet.FleetSampler` with that
            placement is installed so the background scraper's ``/metrics``
            pulls drive continuous fleet sampling, rate derivation and the
            ``fleet.imbalance`` gauge, and the declarative
            :func:`~torchmetrics_tpu_torch.obs.fleet.imbalance_rule` must fire
            through the standard pending→firing machinery — detection comes
            from fleet samples alone, nothing is told where the skew is. At
            two-thirds of the schedule the **hot spot shifts** (the placement
            flips hosts — the load concentration moves), which the sampler
            must track without stranding a stale firing series; right after
            the shift one sample is taken under the hanging-collective fake,
            proving a wedged host yields a LOUD degraded partial sample
            (``missing_hosts``) instead of stalling the sampler. ``/fleet``
            is scraped throughout and probed at end of run. Incompatible with
            ``multiplex``, ``rolling_deploy``, ``host_crash`` and
            ``hung_host``.
        flash_crowd: simulate a **flash crowd with a mid-run hot-spot shift**
            — the placement-control-plane scenario. Every tenant is seeded
            onto virtual host ``"0"`` (durably: the seeded table is written
            to disk by a throwaway controller and the live
            :class:`~torchmetrics_tpu_torch.fleet.placement.PlacementController`
            is reconstructed FROM that state file — the restart path runs
            every replay), a :class:`~torchmetrics_tpu_torch.obs.fleet.FleetSampler`
            is installed, and the controller — ticked by the background
            scraper's ``/metrics`` pulls — must notice the measured
            imbalance, open a hysteresis episode and drain it with REAL
            moves: drain → checkpoint → restore → swap, each under
            ``scope.migration(tenant, "rebalance")``, targets chosen from
            ``FleetSampler.rebalance_hints()`` alone. The schedule's hot-spot
            shift (the ``repair`` event — hot set B takes over) invalidates
            the converged table mid-run, forcing a second episode. A settle
            loop keeps post-shift traffic flowing until the controller
            converges (bounded) — decay-to-zero idle "convergence" is not
            accepted. Every moved session's final ``compute()`` is proven
            bit-identical to an unmoved shadow control rebuilt from the
            retained stream. ``/placement`` is scraped throughout and probed
            at end of run. Incompatible with every other scenario flag.
        placement_enabled: ``False`` runs the flash-crowd **control arm**:
            identical traffic, sampler installed, static all-on-"0"
            placement, NO controller — the throughput baseline the
            placement-overhead SLO compares against.
        placement_cadence_seconds: the controller's reconcile cadence (short
            so convergence fits a CI run; production cadences are tens of
            seconds).
        placement_max_moves: the controller's per-pass move budget.
        fleet_cadence_seconds: the fleet sampler's cadence (short, so a CI
            run accumulates enough samples; production cadences are seconds).
        lease_seconds: the hung-host tenants' lease TTL (short, so detection
            fits a CI run; production leases are tens of seconds).
        scrape_interval_seconds: pause between scrape sweeps of the routes.
        scrape_routes: routes the background thread hits each sweep.
        sync_timeout_seconds: the sync guard's per-attempt timeout for the
            injected hanging collective (the hang "costs" this much wall).
        flight_dump_dir: where fault dumps land (default: a fresh tempdir per
            replay, so dump-correctness checks see only this run's dumps).
        max_events: trace ring capacity while the replay records.
        alert_history: bounded transition-history size of the shared engine.
        hostprof: host-profiler plane. ``None`` (default) auto-enables the
            continuous sampler for the multiplexed scenario only;
            ``True``/``False`` force it on/off for any scenario. While live,
            the per-seam breakdown + floor report land in the run record
            under ``hostprof`` and a mid-run ``GET /profile`` probe proves
            the plane answers over HTTP during the fault window.
        hostprof_rate_hz: sampling rate for the host profiler when live.
        audit: conservation audit plane. ``None`` (default) enables the
            continuous :class:`~torchmetrics_tpu_torch.obs.audit.ConservationAuditor`
            for every scenario — exactly-once accounting is part of what a
            chaos run proves (the ``accounting_clean`` SLO) — and the final
            ledger + invariant results land in the run record under
            ``audit``; ``False`` forces it off.
        device: where every tenant's metric, shadow control and batch lives
            (``"cuda"``, the card, unless the caller asks for ``"cpu"``). The
            one knob beyond JAX's: the batches are the same numpy stream either
            way.
    """

    fuse: int = 2
    multiplex: bool = False
    mux_max_width: int = 64
    rolling_deploy: bool = False
    migrate_fraction: float = 0.5
    host_crash: bool = False
    checkpoint_every_batches: int = 4
    checkpoint_dir: Optional[str] = None
    hung_host: bool = False
    skewed_load: bool = False
    flash_crowd: bool = False
    placement_enabled: bool = True
    placement_cadence_seconds: float = 0.15
    placement_max_moves: int = 1
    fleet_cadence_seconds: float = 0.1
    lease_seconds: float = 0.25
    scrape_interval_seconds: float = 0.05
    scrape_routes: Tuple[str, ...] = ("/metrics", "/alerts", "/tenants", "/healthz")
    # host-profiler plane: None = auto (live for the multiplexed/high-tenant
    # scenario, where the Python floor under the mux path is the question the
    # profiler exists to answer); True/False force it on/off for any scenario
    hostprof: Optional[bool] = None
    hostprof_rate_hz: float = 200.0
    audit: Optional[bool] = None
    sync_timeout_seconds: float = 0.05
    device: str = "cuda"
    flight_dump_dir: Optional[str] = None
    max_events: int = 8192
    alert_history: int = 1024

    def __post_init__(self) -> None:
        if self.fuse < 1:
            raise ValueError(f"Expected `fuse` >= 1, got {self.fuse}")
        if self.hostprof_rate_hz <= 0:
            raise ValueError(
                f"Expected positive `hostprof_rate_hz`, got {self.hostprof_rate_hz}"
            )
        if self.mux_max_width < 1:
            raise ValueError(f"Expected `mux_max_width` >= 1, got {self.mux_max_width}")
        if self.rolling_deploy and self.multiplex:
            raise ValueError(
                "`rolling_deploy` drives per-tenant pipeline sessions (each one a"
                " migratable bundle); it cannot be combined with `multiplex`"
            )
        if self.host_crash and (self.multiplex or self.rolling_deploy):
            raise ValueError(
                "`host_crash` drives per-tenant pipeline sessions with continuous"
                " checkpointing; it cannot be combined with `multiplex` or"
                " `rolling_deploy`"
            )
        if self.hung_host and (self.multiplex or self.rolling_deploy or self.host_crash):
            raise ValueError(
                "`hung_host` drives per-tenant leased pipeline sessions with"
                " continuous checkpointing; it cannot be combined with"
                " `multiplex`, `rolling_deploy` or `host_crash`"
            )
        if self.skewed_load and (
            self.multiplex or self.rolling_deploy or self.host_crash or self.hung_host
        ):
            raise ValueError(
                "`skewed_load` drives default per-tenant pipeline sessions under a"
                " fleet sampler; it cannot be combined with `multiplex`,"
                " `rolling_deploy`, `host_crash` or `hung_host`"
            )
        if self.flash_crowd and (
            self.multiplex
            or self.rolling_deploy
            or self.host_crash
            or self.hung_host
            or self.skewed_load
        ):
            raise ValueError(
                "`flash_crowd` drives default per-tenant pipeline sessions under a"
                " fleet sampler + placement controller; it cannot be combined with"
                " `multiplex`, `rolling_deploy`, `host_crash`, `hung_host` or"
                " `skewed_load`"
            )
        if self.placement_cadence_seconds <= 0:
            raise ValueError(
                f"Expected positive `placement_cadence_seconds`, got"
                f" {self.placement_cadence_seconds}"
            )
        if self.placement_max_moves < 1:
            raise ValueError(
                f"Expected `placement_max_moves` >= 1, got {self.placement_max_moves}"
            )
        if self.fleet_cadence_seconds <= 0:
            raise ValueError(
                f"Expected positive `fleet_cadence_seconds`, got {self.fleet_cadence_seconds}"
            )
        if self.lease_seconds <= 0:
            raise ValueError(f"Expected positive `lease_seconds`, got {self.lease_seconds}")
        if self.checkpoint_every_batches < 1:
            raise ValueError(
                f"Expected `checkpoint_every_batches` >= 1, got {self.checkpoint_every_batches}"
            )
        if (self.host_crash or self.hung_host) and self.fuse > self.checkpoint_every_batches:
            # the replay gap's worst case is cadence + fuse - 2 (commits land
            # on a fuse-spaced grid); a fusion depth beyond the cadence makes
            # the open chunk, not the cadence, the dominant loss window —
            # reject the misconfiguration instead of judging a vacuous bound
            # (host_crash_slo_spec(cadence, fuse=...) carries the exact bound)
            raise ValueError(
                f"`host_crash`/`hung_host` bound the replay gap by the checkpoint cadence"
                f" ({self.checkpoint_every_batches}) plus the open fusion chunk;"
                f" `fuse` ({self.fuse}) > the cadence would make the chunk the"
                " dominant loss window — deepen the cadence or shrink the fusion"
                " depth"
            )
        if not 0.0 < self.migrate_fraction <= 1.0:
            raise ValueError(
                f"Expected `migrate_fraction` in (0, 1], got {self.migrate_fraction}"
            )
        if self.scrape_interval_seconds <= 0:
            raise ValueError(
                f"Expected positive `scrape_interval_seconds`, got {self.scrape_interval_seconds}"
            )
        if self.sync_timeout_seconds <= 0:
            raise ValueError(
                f"Expected positive `sync_timeout_seconds`, got {self.sync_timeout_seconds}"
            )


# rule names are part of the replay's contract with the SLO judge
POISON_RULE = "chaos_poison_nonfinite"
HANG_RULE = "chaos_hang_absent"
IMBALANCE_RULE = "fleet_imbalance"  # minted by obs.fleet.imbalance_rule()


class _Scraper(threading.Thread):
    """Background scrape loop: client-observed per-route latencies + errors."""

    def __init__(self, base_url: str, routes: Tuple[str, ...], interval: float) -> None:
        super().__init__(name="tm-tpu-chaos-scraper", daemon=True)
        self.base_url = base_url
        self.routes = routes
        self.interval = interval
        self.latencies: Dict[str, List[float]] = {route: [] for route in routes}
        self.errors: Dict[str, int] = {route: 0 for route in routes}
        self.degraded_seen = 0
        self.sweeps = 0
        # NB: not `_stop` — threading.Thread owns an internal _stop() method
        self._halt = threading.Event()

    def stop(self, timeout: float = 10.0) -> None:
        self._halt.set()
        self.join(timeout)

    def run(self) -> None:
        while not self._halt.is_set():
            for route in self.routes:
                start = time.perf_counter()
                try:
                    with urllib.request.urlopen(self.base_url + route, timeout=10) as resp:
                        body = resp.read()
                except Exception:
                    self.errors[route] += 1
                    continue
                self.latencies[route].append(time.perf_counter() - start)
                if route == "/healthz" and b'"degraded"' in body:
                    # evidence that the injected faults were operator-visible
                    # mid-run, not only in the post-hoc history
                    self.degraded_seen += 1
            self.sweeps += 1
            self._halt.wait(self.interval)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for route in self.routes:
            samples = sorted(self.latencies[route])

            def q(p: float) -> Optional[float]:
                if not samples:
                    return None
                # nearest-rank: ceil(p*n)-th order statistic, 0-indexed —
                # int(p*n) would be one rank high (p50 of two samples must be
                # the first, not the max)
                rank = math.ceil(p * len(samples)) - 1
                return samples[min(len(samples) - 1, max(0, rank))]

            out[route] = {
                "count": len(samples),
                "errors": self.errors[route],
                "p50_seconds": q(0.50),
                "p95_seconds": q(0.95),
                "p99_seconds": q(0.99),
                "max_seconds": samples[-1] if samples else None,
            }
        return out


# the host-crash tenants' large-state metric: a capacity MaskedBuffer whose
# appends only touch a few delta segments per checkpoint interval — the
# full-vs-delta bundle-bytes evidence the SLO reads
_CRASH_CAT_CAPACITY = 1 << 15


def _eligible_clean_guarded(schedule: TrafficSchedule, fraction: float) -> List[str]:
    """The "host B" tenant set: clean guarded tenants (fault surfaces stay on
    host A so their scenarios run unchanged through the deploy/crash)."""
    poisoned_tenants = set(schedule.poisoned())
    eligible = [t for t in schedule.guarded if t not in poisoned_tenants]
    n = max(1, int(round(len(eligible) * fraction)))
    return eligible[:n]


def _build_tenants(
    schedule: TrafficSchedule,
    config: ReplayConfig,
    engine: AlertEngine,
    dump_dir: str,
    crash_tenants: Tuple[str, ...] = (),
    ckpt_dir: Optional[str] = None,
    lease_seconds: Optional[float] = None,
):
    """(metrics, pipelines, mux, guarded_metric, crash_metric) keyed by tenant.

    Per-tenant pipeline sessions by default; with ``config.multiplex`` every
    guarded/hung tenant instead rides ONE cross-tenant multiplexer (shared
    fused programs, per-tenant state and robust isolation) and only the
    victim keeps a pipeline of its own. ``guarded_metric`` is returned so the
    rolling-deploy path can build same-spec restore targets and shadow
    controls; ``crash_metric`` builds the host-crash tenants' large-state
    ``CatMetric`` the same way. Host-crash tenants' pipelines carry the
    continuous :class:`~torchmetrics_tpu_torch.engine.migrate.CheckpointPolicy`.
    """
    from torchmetrics_tpu_torch.aggregation import CatMetric
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy
    from torchmetrics_tpu_torch.engine.mux import MuxConfig, TenantMultiplexer
    from torchmetrics_tpu_torch.engine.pipeline import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.regression import MeanSquaredError

    def guarded_metric(tenant: str) -> Any:
        return MulticlassAccuracy(
            num_classes=schedule.config.num_classes,
            average="micro",
            validate_args=False,
            error_policy="quarantine",
            device=config.device,
            # the hung tenant's collective runs under the injected fault;
            # a 2-host world is claimed so Metric.sync enters the guard
            distributed_available_fn=(lambda: True) if tenant == schedule.hung else None,
        )

    def crash_metric() -> Any:
        # nan_strategy="disable" keeps the jitted (fusable) update path: the
        # crash tenants' streams are clean by selection, and the point is a
        # LARGE MaskedBuffer state whose periodic delta bundles only rewrite
        # the segments the appends touched
        return CatMetric(capacity=_CRASH_CAT_CAPACITY, nan_strategy="disable", device=config.device)

    metrics: Dict[str, Any] = {}
    pipelines: Dict[str, Any] = {}
    mux: Optional[TenantMultiplexer] = None
    if config.multiplex:
        mux = TenantMultiplexer(
            config=MuxConfig(
                max_width=config.mux_max_width,
                alert_engine=engine,
                alert_every=1,
                flight_records=64,
                flight_dump_dir=dump_dir,
            ),
            metrics={
                tenant: guarded_metric(tenant)
                for tenant in schedule.tenants
                if schedule.roles[tenant] != ROLE_VICTIM
            },
        )
        for tenant in mux.tenants():
            metrics[tenant] = mux.metric(tenant)
    for tenant in schedule.tenants:
        role = schedule.roles[tenant]
        if role != ROLE_VICTIM and mux is not None:
            continue  # multiplexed tenants built above
        checkpoint = None
        if role == ROLE_VICTIM:
            # deliberately unguarded: the NaN must REACH the value timeline so
            # the non-finite watchdog (not an input guard) is what catches it
            metric = MeanSquaredError(device=config.device)
        elif tenant in crash_tenants:
            metric = crash_metric()
            checkpoint = CheckpointPolicy(
                directory=os.path.join(ckpt_dir, tenant),
                every_batches=config.checkpoint_every_batches,
                full_every=4,
                keep=8,
                segment_bytes=4096,
            )
        else:
            metric = guarded_metric(tenant)
        metrics[tenant] = metric
        pipe_kwargs: Dict[str, Any] = {}
        if lease_seconds is not None and tenant in crash_tenants:
            # hung-host tenants lease short so stale-lease detection fits CI
            pipe_kwargs["lease_seconds"] = lease_seconds
        pipelines[tenant] = MetricPipeline(
            metric,
            PipelineConfig(
                fuse=config.fuse,
                max_in_flight=2,
                prefetch=1,
                tenant=tenant,
                alert_engine=engine,
                alert_every=1,
                flight_records=32,
                flight_dump_dir=dump_dir,
                checkpoint=checkpoint,
                **pipe_kwargs,
            ),
        )
    return metrics, pipelines, mux, guarded_metric, crash_metric


class _SerializedWatchdog(_fence.Watchdog):
    """The fence :class:`~torchmetrics_tpu_torch.robust.fence.Watchdog` whose
    failovers hold the replay's device lock.

    The scrape loop ticks it on every ``/metrics`` pull. A tick that finds no
    stale lease runs as it is; one that will fail a tenant over (fence, restore,
    capture) first waits for the feeding loop to finish its current event. The
    detection stamp is the scrape tick's, taken before that wait.
    """

    def __init__(self, lock: Any, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._device_lock = lock

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = time.time() if now is None else now
        if not any(self._stale_lease(key, watch, now) is not None for key, watch in list(self._watches.items())):
            return []
        with self._device_lock:
            return super().tick(now)


def _read_dump(path: str) -> Optional[Dict[str, Any]]:
    """The meta line of one flight dump (tenant, reason, poisoned batches)."""
    try:
        with open(path, encoding="utf-8") as fh:
            meta = json.loads(fh.readline())
    except (OSError, ValueError):
        return None
    if meta.get("type") != "meta":
        return None
    return {
        "path": path,
        "tenant": meta.get("tenant"),
        "reason": meta.get("reason"),
        "poisoned_batches": meta.get("poisoned_batches") or [],
        "poisoned_trace_ids": meta.get("poisoned_trace_ids") or [],
    }


def replay(schedule: TrafficSchedule, config: Optional[ReplayConfig] = None) -> Dict[str, Any]:
    """Execute ``schedule`` end to end; returns the plain-data measurement.

    The result dict carries everything :func:`torchmetrics_tpu_torch.chaos.slo.judge`
    needs: wall/throughput totals, driver- and server-side scrape latencies,
    the alert transition history plus derived fire/resolve episodes, the
    injected-fault timeline (wall-stamped at injection), flight-dump metadata
    against the schedule's poisoned-batch ground truth, compiled-variant and
    compile-seconds deltas from the cost ledger, and the end-of-run health and
    tenant pages.
    """
    from unittest import mock

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.obs import cost as _cost
    from torchmetrics_tpu_torch.obs import fleet as _fleet_mod
    from torchmetrics_tpu_torch.obs import values as _values
    from torchmetrics_tpu_torch.parallel import sync as _sync_mod
    from torchmetrics_tpu_torch.robust import faults as _faults
    from torchmetrics_tpu_torch.robust.degraded import sync_guard

    config = config or ReplayConfig()
    device = config.device
    rng = np.random.RandomState(schedule.config.seed)
    # batch lineage is part of what a chaos run proves (the fault_causality
    # SLO): enable it for this run, restoring the prior enabled-state on
    # return. A caller that already runs with lineage on keeps its live index
    # (reset only when WE turned lineage on — clobbering a serving process's
    # /trace records to run a bench would be theft); per-session epochs keep
    # this run's ids collision-free either way.
    lineage_was_enabled = _lineage.ENABLED
    _lineage.enable(reset=not lineage_was_enabled)
    # the conservation audit plane (obs/audit.py): live for the run unless
    # forced off, so the accounting_clean SLO has evidence. Sessions register
    # their ledger hooks at construction — install BEFORE _build_tenants. The
    # caller's auditor (a serving process's) is restored on return.
    auditor: Optional[_audit.ConservationAuditor] = None
    auditor_prev: Optional[_audit.ConservationAuditor] = None
    if config.audit is not False:
        auditor = _audit.ConservationAuditor(
            cadence_seconds=max(0.05, config.scrape_interval_seconds)
        )
        auditor_prev = _audit.install_auditor(auditor)
    # an auto-created dump dir is consumed (metas read into the result) and
    # removed before returning — repeated replays must not litter the tempdir;
    # a caller-provided directory is theirs to keep
    own_dump_dir = config.flight_dump_dir is None
    dump_dir = config.flight_dump_dir or tempfile.mkdtemp(prefix="tm_tpu_chaos_")

    # host crash: "host B" gets the clean guarded tenants, re-metric'd onto a
    # large-state CatMetric with a continuous CheckpointPolicy; their fed
    # batches are retained so the post-restore replay gap can be re-fed from
    # the deterministic stream (seeded, so this IS the schedule's traffic)
    own_ckpt_dir = config.checkpoint_dir is None
    crash_tenants: List[str] = []
    ckpt_dir: Optional[str] = None
    if config.host_crash:
        crash_tenants = _eligible_clean_guarded(schedule, config.migrate_fraction)
        if not crash_tenants:
            raise ReplayError(
                "host_crash needs at least one clean guarded tenant to kill;"
                f" the schedule offers none (guarded={schedule.guarded},"
                f" poisoned={sorted(schedule.poisoned())})"
            )
        ckpt_dir = config.checkpoint_dir or tempfile.mkdtemp(prefix="tm_tpu_ckpt_")
    # hung host: "host B" gets the clean guarded tenants on leased continuous-
    # checkpoint pipelines (the same large-state CatMetric build as host_crash
    # — they ride the crash-tenant build path below); their fed batches are
    # retained so the post-failover gap + wedge-period traffic can be re-fed
    fence_tenants: List[str] = []
    if config.hung_host:
        fence_tenants = _eligible_clean_guarded(schedule, config.migrate_fraction)
        if not fence_tenants:
            raise ReplayError(
                "hung_host needs at least one clean guarded tenant to wedge;"
                f" the schedule offers none (guarded={schedule.guarded},"
                f" poisoned={sorted(schedule.poisoned())})"
            )
        ckpt_dir = config.checkpoint_dir or tempfile.mkdtemp(prefix="tm_tpu_ckpt_")

    rules = [
        AlertRule(
            name=POISON_RULE,
            kind="non_finite",
            metric="MeanSquaredError",
            tenant=schedule.victim,
            severity="critical",
        )
    ]
    if config.skewed_load or config.flash_crowd:
        # the declarative preset, armed BEFORE any load lands: detection must
        # come from the fleet samples alone through the standard pending→
        # firing machinery (dwell = 2 cadences, so one noisy sample never
        # pages). The rule name is obs.fleet's IMBALANCE_RULE contract.
        # The flash-crowd scenario arms it too: the page and the placement
        # controller read the SAME samples — paging is not suppressed just
        # because something is acting on the skew.
        rules.append(
            _fleet_mod.imbalance_rule(
                above=0.5,
                for_seconds=2 * config.fleet_cadence_seconds,
                severity="page",
            )
        )
    engine = AlertEngine(rules=rules, history=config.alert_history)
    metrics, pipelines, mux, guarded_metric, crash_metric = _build_tenants(
        schedule,
        config,
        engine,
        dump_dir,
        crash_tenants=tuple(crash_tenants) or tuple(fence_tenants),
        ckpt_dir=ckpt_dir,
        lease_seconds=config.lease_seconds if fence_tenants else None,
    )
    # the checkpoint liveness registry is process-global and tenant names are
    # deterministic: snapshot it NOW so this run's full-vs-delta evidence is a
    # delta against whatever earlier replays in this process recorded
    ckpt_baseline: Dict[str, Any] = {}
    if crash_tenants:
        import torchmetrics_tpu_torch.obs.scope as _scope_mod

        ckpt_baseline = _scope_mod.checkpoint_status()
    victim, hung = schedule.victim, schedule.hung
    n_classes = schedule.config.num_classes

    # rolling deploy: "host B" gets half the CLEAN guarded tenants (the fault
    # surfaces — victim, hung, the poisoned guarded tenant — stay on host A so
    # their scenarios run unchanged THROUGH the deploy); each host-B tenant
    # also feeds a shadow control metric eagerly, the bit-identity oracle
    migrate_tenants: List[str] = []
    controls: Dict[str, Any] = {}
    if config.rolling_deploy:
        migrate_tenants = _eligible_clean_guarded(schedule, config.migrate_fraction)
        if not migrate_tenants:
            raise ReplayError(
                "rolling_deploy needs at least one clean guarded tenant to migrate;"
                f" the schedule offers none (guarded={schedule.guarded},"
                f" poisoned={sorted(set(schedule.poisoned()))})"
            )
        controls = {tenant: guarded_metric(tenant) for tenant in migrate_tenants}
    # the crash tenants' shadow controls: eager CatMetrics fed the identical
    # stream, the unkilled side of the end-of-run bit-identity proof
    controls.update({tenant: crash_metric() for tenant in crash_tenants})
    crash_set = set(crash_tenants)
    crash_history: Dict[str, List[tuple]] = {tenant: [] for tenant in crash_tenants}
    # the hung-host tenants' shadow controls: the no-hang world the failed-over
    # sessions must match bit-for-bit (zero double-counting, zero loss)
    controls.update({tenant: crash_metric() for tenant in fence_tenants})
    fence_set = set(fence_tenants)
    fence_history: Dict[str, List[tuple]] = {tenant: [] for tenant in fence_tenants}

    # controller-ordered moves and watchdog failovers run on scrape handler
    # threads (render_metrics ticks both), so their drain/restore/swap must be
    # serialized against the schedule's feed loop — the replay's stand-in for
    # the serving process's per-session ownership (JAX's flash-crowd lock),
    # held here by every piece of device work so that a restore's CUDA-graph
    # capture never overlaps another thread's CUDA calls
    device_lock = threading.RLock()

    def feed_tenant(tenant: str, *args: Any) -> None:
        if mux is not None and tenant not in pipelines:
            mux.feed(tenant, *args)
        else:
            pipelines[tenant].feed(*args)

    def tenant_trace_id(tenant: str, index: int) -> str:
        """The lineage id of a tenant's ``index``-th fed batch — computable by
        the driver because ids are deterministic given the session epoch."""
        if mux is not None and tenant not in pipelines:
            return mux.trace_id_for(tenant, index)
        return pipelines[tenant].trace_id_for(index)

    def flush_tenant(tenant: str) -> None:
        if mux is not None and tenant not in pipelines:
            mux.flush()
        else:
            pipelines[tenant].flush()

    def make_batch(tenant: str, size: int, poison: bool) -> Tuple[Any, ...]:
        if tenant in crash_set or tenant in fence_set:
            # the host-crash/hung-host tenants drive single-array CatMetric
            # appends; their streams are clean by selection (no poison)
            return (torch.as_tensor(rng.rand(size).astype(np.float32), device=device),)
        if schedule.roles[tenant] == ROLE_VICTIM:
            preds = rng.rand(size).astype(np.float32)
            target = rng.rand(size).astype(np.float32)
        else:
            preds = rng.rand(size, n_classes).astype(np.float32)
            target = rng.randint(0, n_classes, size)
        if poison:
            preds = np.full_like(preds, np.nan)
        return torch.as_tensor(preds, device=device), torch.as_tensor(target, device=device)

    faults_injected: List[Dict[str, Any]] = []
    batches_fed = 0
    sleep_seconds = 0.0
    cost_mark = _cost.get_ledger().mark()
    server = IntrospectionServer(metrics=list(metrics.values()), port=0, alert_engine=engine)
    scraper: Optional[_Scraper] = None
    closed = False
    migration_info: Optional[Dict[str, Any]] = None
    migrate_at = len(schedule.events) // 2 if migrate_tenants else None
    bundle_dir = tempfile.mkdtemp(prefix="tm_tpu_migrate_") if migrate_tenants else None
    crash_info: Optional[Dict[str, Any]] = None
    crash_at = len(schedule.events) // 2 if crash_tenants else None
    fence_info: Optional[Dict[str, Any]] = None
    wedge_at = len(schedule.events) // 2 if fence_tenants else None
    # skewed load: a static placement concentrates every tenant but the last
    # onto virtual host "0"; the installed sampler's ticks ride the scraper's
    # /metrics pulls, so detection cadence IS the serving path's cadence. The
    # hot spot shifts (placement flips) two-thirds in — late enough that the
    # pre-shift skew had time to page, early enough to observe the re-point.
    fleet_info: Optional[Dict[str, Any]] = None
    fleet_sampler: Optional[Any] = None
    fleet_placement: Dict[str, str] = {}
    fleet_shift: Optional[Dict[str, Any]] = None
    fleet_shift_at: Optional[int] = None
    fleet_probe: Optional[Dict[str, Any]] = None
    fleet_history_n: Optional[int] = None
    if config.skewed_load:
        cold = set(schedule.tenants[-1:])
        fleet_placement = {
            tenant: ("1" if tenant in cold else "0") for tenant in schedule.tenants
        }
        fleet_sampler = _fleet_mod.FleetSampler(
            cadence_seconds=config.fleet_cadence_seconds,
            placement=dict(fleet_placement),
        )
        _fleet_mod.install_sampler(fleet_sampler)
        fleet_shift_at = (len(schedule.events) * 2) // 3
    # flash crowd: every tenant seeded on host "0" under a live placement
    # controller whose reconcile ticks ride the scraper's /metrics pulls —
    # the controller must notice the measured skew and fix it with real
    # session moves, twice (at `repair` the schedule shifts the hot spot AND
    # the second wave of the crowd re-lands concentrated on host "0")
    placement_info: Optional[Dict[str, Any]] = None
    placement_controller: Optional[Any] = None
    placement_prev: Optional[Any] = None
    placement_probe: Optional[Dict[str, Any]] = None
    placement_restored_from_disk = False
    flash_streams: Dict[str, List[Tuple[Any, ...]]] = {}
    flash_shift_wall: Optional[float] = None
    flash_settle_sweeps = 0
    # driver-side record of every tenant the mover physically relocated: the
    # assignment table's per-row `moves` counters reset when the shift-time
    # re-seed adopts the second wave's placement, so the zero-loss verdict
    # keys off this set, not the table
    flash_moved: set = set()
    flash_dir: Optional[str] = None
    if config.flash_crowd:
        from torchmetrics_tpu_torch import fleet as _placement_mod

        # the flash crowd arrives concentrated: EVERY tenant starts on host
        # "0", so the first measured imbalance is 1.0 and the seeded table is
        # maximally wrong on purpose
        fleet_placement = dict.fromkeys(schedule.tenants, "0")
        fleet_sampler = _fleet_mod.FleetSampler(
            cadence_seconds=config.fleet_cadence_seconds,
            placement=dict(fleet_placement),
            # the provisioned universe: host "1" is idle at t=0 (the whole
            # crowd lands on "0") and must still count in the skew math —
            # without it the concentrated fleet reads as balanced
            hosts=("0", "1"),
        )
        _fleet_mod.install_sampler(fleet_sampler)
        flash_dir = tempfile.mkdtemp(prefix="tm_tpu_rebalance_")

        def flash_mover(tenant: str, from_host: str, to_host: str) -> bool:
            """One controller-ordered move, executed on whatever scrape
            handler thread ticked the controller: the live-session handoff
            (drain → checkpoint → restore → swap the serving surface) —
            the same sequence the rolling deploy runs, here chosen by the
            control plane instead of an operator."""
            from torchmetrics_tpu_torch.engine import migrate as _migrate

            with device_lock:
                old_pipe = pipelines.get(tenant)
                if old_pipe is None:
                    raise ReplayError(
                        f"placement mover asked to move unknown tenant {tenant!r}"
                    )
                bundle = os.path.join(flash_dir, f"move-{tenant}-{len(os.listdir(flash_dir))}")
                _migrate.checkpoint_session(old_pipe, bundle, alert_engine=engine)
                old_pipe.close()
                fresh = guarded_metric(tenant)
                new_pipe, _manifest = _migrate.restore_session(
                    fresh, bundle, alert_engine=engine
                )
                pipelines[tenant] = new_pipe
                server.unregister(metrics[tenant])
                metrics[tenant] = fresh
                server.register(fresh)
                flash_moved.add(tenant)
            return True

        placement_config = _placement_mod.PlacementConfig(
            hosts=("0", "1"),
            cadence_seconds=config.placement_cadence_seconds,
            max_concurrent_moves=config.placement_max_moves,
            state_path=os.path.join(flash_dir, "placement.json"),
            # operator pins on the fault surfaces: the victim's session is a
            # different metric class than the guarded factory restores, and
            # the poisoned tenant's repair resets its state mid-run — both
            # are exactly the "drain/restore known-unsafe" sessions the pin
            # knob exists for
            pinned=(victim,) + tuple(sorted(schedule.poisoned())),
        )
        if config.placement_enabled:
            # the durable-restore proof is folded into every run: a throwaway
            # controller seeds + persists the all-on-"0" table, then the LIVE
            # controller reconstructs its assignment table from that state
            # file — the restart path, not a fresh in-memory table
            _placement_mod.PlacementController(placement_config).seed(fleet_placement)
            placement_controller = _placement_mod.PlacementController(
                placement_config, mover=flash_mover
            )
            placement_restored_from_disk = bool(
                placement_controller.assignments()
            ) and all(
                placement_controller.lookup(tenant) == "0"
                for tenant in schedule.tenants
            )
            placement_prev = _placement_mod.install_controller(placement_controller)
    # zombie sessions after the wedge (still live objects — a hung host is not
    # a dead one) and the failovers the scrape-driven watchdog completes
    # (appended from the scraper thread; list.append is atomic)
    zombies: Dict[str, Any] = {}
    failover_swaps: List[Tuple[Any, Dict[str, Any]]] = []

    def kill_host_b_sigkill() -> Dict[str, Any]:
        """The unplanned death: host B dies with SIGKILL semantics.

        No drain, no close, no final checkpoint — the crashed pipelines are
        simply abandoned mid-flight, so batches in their open fusion chunks
        are LOST. The supervisor restart then recovers each tenant from
        :func:`~torchmetrics_tpu_torch.engine.migrate.latest_valid_bundle` (a
        planted torn mid-write bundle proves the scan skips garbage), re-feeds
        the replay gap from the retained deterministic stream, and re-attaches
        the restored session (checkpoint policy included — the bundle stream
        continues past the crash). The measured gap and recovery wall time are
        what the host-crash SLO spec judges.
        """
        from torchmetrics_tpu_torch.engine import migrate as _migrate
        from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy

        fed_at_crash = {tenant: len(crash_history[tenant]) for tenant in crash_tenants}
        for tenant in crash_tenants:
            # SIGKILL: the session object is dropped where it stands
            pipelines.pop(tenant)
            server.unregister(metrics[tenant])
        # a torn mid-write artifact next to the first victim's stream: the
        # recovery scan must skip it (loudly) and restore from the intact link
        planted = os.path.join(ckpt_dir, crash_tenants[0], "bundle-999999")
        os.makedirs(planted, exist_ok=True)
        with open(os.path.join(planted, "state.npz"), "wb") as fh:
            fh.write(b"\x00torn-mid-write")
        sessions: Dict[str, Dict[str, Any]] = {}
        start = time.perf_counter()
        for tenant in crash_tenants:
            tenant_dir = os.path.join(ckpt_dir, tenant)
            bundle = _migrate.latest_valid_bundle(tenant_dir)
            if bundle is None:
                raise ReplayError(
                    f"no intact bundle under {tenant_dir} for crashed tenant {tenant!r}"
                )
            fresh = crash_metric()
            new_pipe, manifest = _migrate.restore_session(
                fresh,
                bundle,
                alert_engine=engine,
                # the restored session keeps checkpointing into the same
                # stream (the checkpointer seeds its sequence past the
                # existing bundles instead of clobbering the chain)
                checkpoint=CheckpointPolicy(
                    directory=tenant_dir,
                    every_batches=config.checkpoint_every_batches,
                    full_every=4,
                    keep=8,
                    segment_bytes=4096,
                ),
            )
            cursor = int((manifest.get("cursor") or {}).get("batches_ingested", 0) or 0)
            gap = fed_at_crash[tenant] - cursor
            for args in crash_history[tenant][cursor : fed_at_crash[tenant]]:
                new_pipe.feed(*args)
            pipelines[tenant] = new_pipe
            metrics[tenant] = fresh
            server.register(fresh)
            sessions[tenant] = {
                "fed_at_crash": fed_at_crash[tenant],
                "restored_cursor": cursor,
                "replay_gap_batches": gap,
                "bundle": os.path.basename(bundle),
            }
        recovery_seconds = time.perf_counter() - start
        return {
            "tenants": list(crash_tenants),
            "cadence_batches": config.checkpoint_every_batches,
            "recovery_seconds": round(recovery_seconds, 6),
            "replay_gap_batches": max(row["replay_gap_batches"] for row in sessions.values()),
            "sessions": sessions,
            # the planted torn bundle was never chosen as a restore point
            "torn_bundle_skipped": all(
                row["bundle"] != "bundle-999999" for row in sessions.values()
            ),
        }

    def wedge_host_b() -> Dict[str, Any]:
        """The hung host: host B wedges mid-traffic — alive but silent.

        No drain, no close, no lease release: the sessions are popped off the
        serving set with their objects (and leases) intact, which is exactly
        what distinguishes a hang from a crash — the zombie can still write.
        A scrape-driven :class:`~torchmetrics_tpu_torch.robust.fence.Watchdog` is
        installed watching each wedged tenant's bundle stream; the background
        scraper's ``/metrics`` pulls drive its ticks, so detection + failover
        ride the production observation path, not a bespoke timer. The
        survivor's guarded collective with the hung host is also exercised:
        under the injected hanging-collective fake it must time out and
        degrade loudly instead of hanging the run.
        """
        from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy

        wedge_unix = time.time()
        for tenant in fence_tenants:
            zombies[tenant] = pipelines.pop(tenant)
        # the survivor's collective with the hung host: guarded, so it times
        # out and degrades loudly (sync_degraded) instead of wedging the run
        probe = metrics[fence_tenants[0]]
        with mock.patch.object(_sync_mod, "distributed_available", lambda: True):
            with sync_guard(timeout=config.sync_timeout_seconds, retries=0):
                with _faults.inject_collective_fault(mode="hang", times=99):
                    try:
                        probe.sync()
                    except Exception:
                        pass  # raise-path builds still mean "degraded"
        watchdog = _SerializedWatchdog(
            device_lock,
            on_failover=lambda pipe, report: failover_swaps.append((pipe, report)),
        )
        for tenant in fence_tenants:
            tenant_dir = os.path.join(ckpt_dir, tenant)
            watchdog.watch(
                tenant,
                tenant_dir,
                crash_metric,
                config=_fence.WatchdogConfig(
                    # both halves of detection: the lease must be past TTL AND
                    # the bundle stream must be provably stale (a host whose
                    # renewals are lost but whose bundles still land is slow,
                    # not hung)
                    require_checkpoint_stale=True,
                    restore_overrides={
                        "alert_engine": engine,
                        "checkpoint": CheckpointPolicy(
                            directory=tenant_dir,
                            every_batches=config.checkpoint_every_batches,
                            full_every=4,
                            keep=8,
                            segment_bytes=4096,
                        ),
                    },
                ),
            )
        _fence.install_watchdog(watchdog)
        return {
            "tenants": list(fence_tenants),
            "lease_seconds": config.lease_seconds,
            "wedge_unix": wedge_unix,
            "fed_at_wedge": {t: len(fence_history[t]) for t in fence_tenants},
            "degraded_collective": bool(getattr(probe, "sync_degraded", False)),
        }

    def finish_failover(base: Dict[str, Any]) -> Dict[str, Any]:
        """Wait for the scrape-driven failovers, prove zombie rejection,
        re-feed the gap + wedge-period traffic into the restored sessions."""
        import torchmetrics_tpu_torch.obs.scope as _scope_mod
        from torchmetrics_tpu_torch.engine import migrate as _migrate

        deadline = time.monotonic() + 30.0
        while len(failover_swaps) < len(fence_tenants) and time.monotonic() < deadline:
            time.sleep(0.02)
        if len(failover_swaps) < len(fence_tenants):
            raise ReplayError(
                f"the scrape-driven watchdog failed over {len(failover_swaps)}"
                f"/{len(fence_tenants)} hung tenant(s) within 30s (lease"
                f" {config.lease_seconds}s, scrape every"
                f" {config.scrape_interval_seconds}s)"
            )
        with device_lock:
            reports = {report["tenant"]: report for _, report in failover_swaps}
            # zombie write-rejection proof, BEFORE the restored sessions write any
            # bundles of their own: the zombie's late bundle must LAND on disk
            # (the write path is the zombie's own view — it cannot know it is
            # fenced) and then be rejected, counted, and never selected by the
            # next recovery scan
            zt = fence_tenants[0]
            rejected_before = _scope_mod.fenced_rejected_count()
            zombie_bundle = zombies[zt].checkpoint_now()
            selected = _migrate.latest_valid_bundle(os.path.join(ckpt_dir, zt))
            rejected_delta = _scope_mod.fenced_rejected_count() - rejected_before
            zombie_name = os.path.basename(zombie_bundle) if zombie_bundle else None
            selected_name = os.path.basename(selected) if selected else None
            zombie_info = {
                "tenant": zt,
                "bundle": zombie_name,
                "landed": bool(zombie_bundle and os.path.isdir(zombie_bundle)),
                "rejected_count": rejected_delta,
                "selected": selected_name,
                "discarded": bool(
                    zombie_name is not None
                    and rejected_delta >= 1
                    and selected_name is not None
                    and selected_name != zombie_name
                ),
            }
            # hand each tenant to its restored session: swap the serving surface,
            # then close the gap — everything from the restore point's cursor
            # through the wedge-period backlog, replayed from the retained stream
            sessions: Dict[str, Any] = {}
            detect_max = failover_max = 0.0
            for pipe, report in failover_swaps:
                tenant = report["tenant"]
                cursor = int(report.get("restored_cursor") or 0)
                for args in fence_history[tenant][cursor:]:
                    pipe.feed(*args)
                server.unregister(metrics[tenant])
                metrics[tenant] = pipe.metric
                server.register(pipe.metric)
                pipelines[tenant] = pipe
                detect = max(0.0, report["detected_unix"] - base["wedge_unix"])
                detect_max = max(detect_max, detect)
                failover_max = max(failover_max, float(report["failover_seconds"]))
                sessions[tenant] = {
                    "fed_at_wedge": base["fed_at_wedge"][tenant],
                    "restored_cursor": cursor,
                    "refed_batches": len(fence_history[tenant]) - cursor,
                    "fenced_epoch": report["fenced_epoch"],
                    "new_epoch": report["new_epoch"],
                    "bundle": os.path.basename(report["bundle"]),
                    "detect_seconds": round(detect, 6),
                    "failover_seconds": round(float(report["failover_seconds"]), 6),
                }
            # operator visibility: /healthz must be degraded with every fenced
            # tenant NAMED (plus its failover target), and /leases must carry the
            # fence ledger — probed deterministically, not left to scraper luck
            healthz_named = False
            leases_fences = 0
            try:
                with urllib.request.urlopen(server.url + "/healthz", timeout=10) as resp:
                    payload = json.loads(resp.read())
                healthz_named = payload.get("status") == "degraded" and all(
                    tenant in (payload.get("tenants_fenced") or {})
                    for tenant in fence_tenants
                )
                with urllib.request.urlopen(server.url + "/leases", timeout=10) as resp:
                    leases_fences = len((json.loads(resp.read()) or {}).get("fences") or {})
            except Exception:
                pass  # visibility is judged; a missed probe fails the SLO
        return {
            **base,
            "time_to_detect_seconds": round(detect_max, 6),
            "time_to_failover_seconds": round(failover_max, 6),
            "sessions": sessions,
            "zombie": zombie_info,
            "healthz_named_fenced": healthz_named,
            "leases_page_fences": leases_fences,
        }

    def kill_host_b() -> Dict[str, Any]:
        """The rolling deploy: host B dies; its sessions move to the survivor.

        Per migrated tenant: drain → checkpoint (atomic bundle) → the dying
        host's pipeline closes → restore onto a fresh same-spec metric →
        replay-tail. A /healthz probe mid-handoff records whether the
        migration was operator-visible (degraded, tenant NAMED) — the
        deterministic observation the SLO judges, independent of the
        background scraper's timing luck.
        """
        import json as _json

        import torchmetrics_tpu_torch.obs.scope as _scope_mod
        from torchmetrics_tpu_torch.engine import migrate as _migrate

        healthz_named = False
        start = time.perf_counter()
        for tenant in migrate_tenants:
            old_pipe = pipelines[tenant]
            with _scope_mod.migration(tenant, "rolling_deploy"):
                bundle = os.path.join(bundle_dir, tenant)
                _migrate.checkpoint_session(old_pipe, bundle, alert_engine=engine)
                try:
                    with urllib.request.urlopen(server.url + "/healthz", timeout=10) as resp:
                        payload = _json.loads(resp.read())
                    if payload.get("status") == "degraded" and tenant in (
                        payload.get("tenants_migrating") or {}
                    ):
                        healthz_named = True
                except Exception:
                    pass  # visibility is judged; a missed probe fails the SLO
                old_pipe.close()  # host B's session ends
                fresh = guarded_metric(tenant)
                new_pipe, _manifest = _migrate.restore_session(
                    fresh, bundle, alert_engine=engine
                )
                pipelines[tenant] = new_pipe
                # the dead host's instance leaves the serving surface with its
                # session: /metrics, /healthz and /memory must not keep a
                # stale duplicate frozen at checkpoint-time values
                server.unregister(metrics[tenant])
                metrics[tenant] = fresh
                server.register(fresh)
        return {
            "tenants": list(migrate_tenants),
            "migration_seconds": round(time.perf_counter() - start, 6),
            "healthz_named_migrating": healthz_named,
            "bundles": len(migrate_tenants),
        }

    def shift_hot_spot() -> Dict[str, Any]:
        """Mid-run hot-spot shift + wedged-gather probe (``skewed_load`` only).

        The load concentration MOVES: every placement host label flips, so
        the tenants that made host "0" hot now make host "1" hot. Nothing
        tells the alert plane — ``fleet.imbalance`` is deliberately one
        unlabeled series, so the already-firing page must follow the new hot
        host (named live by ``/healthz`` from the skew block) instead of
        stranding a stale per-host labelset. Immediately after the flip one
        sample is forced under the hanging-collective fake — a claimed
        2-host world (the ``_host_meta`` seam) whose allgather hangs — and
        must come back as a LOUD degraded partial sample naming the missing
        peer within the sync guard's budget, never a stalled sampler.
        """
        # hot-host verdicts smooth over ~10 cadences: adjacent-sample rates
        # are twitchy (one quiet tick can momentarily crown the cold host)
        before = fleet_sampler.skew(
            window=10 * config.fleet_cadence_seconds
        ).get("hot_host")
        fleet_sampler.placement = {
            tenant: ("0" if host == "1" else "1")
            for tenant, host in fleet_sampler.placement.items()
        }
        shifted_at = time.time()
        wedge_started = time.perf_counter()
        with mock.patch.object(
            _trace,
            "_host_meta",
            lambda: {"process_index": 0, "process_count": 2, "host_id": "chaos-host-a:0"},
        ):
            with mock.patch.object(_sync_mod, "distributed_available", lambda: True):
                with sync_guard(timeout=config.sync_timeout_seconds, retries=0):
                    with _faults.inject_collective_fault(mode="hang", times=99):
                        degraded = fleet_sampler.sample()
        return {
            "hot_host_before": before,
            "shifted_at": shifted_at,
            "wedged_sample": {
                "degraded": bool(degraded.get("degraded")),
                "missing_hosts": list(degraded.get("missing_hosts") or []),
                "sample_seconds": round(time.perf_counter() - wedge_started, 6),
            },
        }

    profiler: Optional[_hostprof.HostProfiler] = None
    profiler_prev: Optional[_hostprof.HostProfiler] = None
    profile_probe: Optional[Dict[str, Any]] = None
    profile_probe_at = max(1, len(schedule.events) // 2)
    # No garbage collection while the server's threads live: a collection on a scrape
    # thread would destroy dropped sessions' CUDA graphs there, in the middle of
    # another thread's capture, which the global capture mode forbids. Earlier
    # garbage goes now, on this thread; this run's goes after the threads stop.
    gc_was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with _trace.observe(max_events=config.max_events):
            server.start()
            scrape_routes = tuple(config.scrape_routes)
            if (config.skewed_load or config.flash_crowd) and "/fleet" not in scrape_routes:
                # the control-plane read API is scraped throughout: /fleet
                # latency rides the same per-route SLO stats as /metrics
                scrape_routes += ("/fleet",)
            if config.flash_crowd and "/placement" not in scrape_routes:
                # the placement table/decision-log API is scraped throughout
                # too — reading the control plane must stay cheap WHILE it is
                # moving sessions, and its latency is judged like /metrics
                scrape_routes += ("/placement",)
            scraper = _Scraper(
                server.url, scrape_routes, config.scrape_interval_seconds
            )
            scraper.start()
            if config.hostprof or (config.hostprof is None and config.multiplex):
                # the continuous host profiler rides the replay: sampling is
                # live through the fault window, the per-seam breakdown and
                # floor report land in the run record, and GET /profile is
                # probed MID-RUN below — live attribution, not a post-mortem
                profiler = _hostprof.HostProfiler(rate_hz=config.hostprof_rate_hz)
                profiler_prev = _hostprof.install(profiler)
                profiler.start()
            wall_start, perf_start = time.time(), time.perf_counter()
            with warnings.catch_warnings():
                # degrade/quarantine warnings are the *expected* output of a
                # chaos run; their counts land in the result, not on stderr
                warnings.simplefilter("ignore")
                for ev_index, ev in enumerate(schedule.events):
                    with device_lock:
                        if migrate_at is not None and ev_index >= migrate_at:
                            migration_info = kill_host_b()
                            migrate_at = None  # one deploy per run
                        if crash_at is not None and ev_index >= crash_at:
                            crash_info = kill_host_b_sigkill()
                            crash_at = None  # one crash per run
                        if wedge_at is not None and ev_index >= wedge_at:
                            fence_info = wedge_host_b()
                            wedge_at = None  # one hang per run
                        if fleet_shift_at is not None and ev_index >= fleet_shift_at:
                            fleet_shift = shift_hot_spot()
                            fleet_shift_at = None  # one shift per run
                        if profiler is not None and profile_probe is None and ev_index >= profile_probe_at:
                            # the live mid-run GET /profile: the host-vs-device
                            # floor split must be servable while the run is
                            # still feeding, not only in the post-hoc record
                            try:
                                with urllib.request.urlopen(
                                    server.url + "/profile?top=5", timeout=10
                                ) as resp:
                                    page = json.loads(resp.read())
                                profile_probe = {
                                    "at_event": ev_index,
                                    "running": page.get("running"),
                                    "samples": page.get("samples"),
                                    "self_overhead_percent": page.get("self_overhead_percent"),
                                    "attributed_percent": page.get("attributed_percent"),
                                    "mux_floor": ((page.get("floor") or {}).get("paths") or {}).get("mux"),
                                }
                            except Exception:
                                profile_probe = None  # retried at the next event
                        kind = ev["kind"]
                        if kind == "batch":
                            tenant = ev["tenant"]
                            if tenant in fence_set:
                                # retained for the post-failover re-feed; while
                                # host B is wedged its traffic cannot land — the
                                # shadow control (the no-hang world) still folds
                                # it, and the restored session catches up later
                                batch_args = make_batch(tenant, ev["size"], False)
                                fence_history[tenant].append(batch_args)
                                controls[tenant].update(*batch_args)
                                if tenant not in zombies:
                                    feed_tenant(tenant, *batch_args)
                                    batches_fed += 1
                                continue
                            if ev.get("poison") and tenant == victim:
                                faults_injected.append(
                                    {
                                        "fault": "poison",
                                        "tenant": tenant,
                                        "rule": POISON_RULE,
                                        "injected_at": time.time(),
                                        "batch_index": ev["index"],
                                    }
                                )
                            batch_args = make_batch(tenant, ev["size"], bool(ev.get("poison")))
                            if config.flash_crowd and tenant != victim:
                                # retained: a moved tenant's unmoved shadow
                                # control is rebuilt from this exact stream at end
                                # of run (the bit-identity side of zero-loss)
                                flash_streams.setdefault(tenant, []).append(batch_args)
                            if tenant in crash_set:
                                # retained so the post-restore replay gap can be
                                # re-fed exactly (the stream is seeded — this IS
                                # the deterministic traffic schedule's data)
                                crash_history[tenant].append(batch_args)
                            feed_tenant(tenant, *batch_args)
                            if ev.get("poison"):
                                # the poisoned batch's OWN lineage record is the
                                # causal anchor: time-to-fire is measured from its
                                # ingest stamp (not the pre-feed wall stamp), and
                                # the trace id rides the fault row so the SLO
                                # judge and /trace read the same identity
                                poison_tid = tenant_trace_id(tenant, ev["index"])
                                poison_rec = _lineage.lookup(poison_tid)
                                if tenant == victim and faults_injected:
                                    fault_row = faults_injected[-1]
                                    if fault_row.get("fault") == "poison":
                                        fault_row["trace_id"] = poison_tid
                                        if poison_rec is not None:
                                            fault_row["injected_at"] = poison_rec[
                                                "ingest_unix"
                                            ]
                            if tenant in controls:
                                # the shadow control folds the identical batch
                                # eagerly — the unmigrated side of the
                                # bit-identity proof
                                controls[tenant].update(*batch_args)
                            batches_fed += 1
                        elif kind == "sleep":
                            pass  # slept below, with the device lock released
                        elif kind == "arm":
                            if "hang_absent" in ev.get("rules", ()):
                                engine.add_rule(
                                    name=HANG_RULE,
                                    kind="absent",
                                    metric="*",
                                    tenant=hung,
                                    max_age_seconds=schedule.config.absent_after_seconds,
                                    severity="critical",
                                )
                        elif kind == "hang_start":
                            # freshen the hung tenant's value timeline and settle
                            # the watchdog BEFORE stamping the injection: an
                            # absence that began during an earlier idle gap must
                            # not be credited to this hang window (time-to-fire
                            # would otherwise measure the schedule, not the alert)
                            flush_tenant(ev["tenant"])
                            _values.sample_local(metrics[ev["tenant"]], log=engine._log())
                            engine.evaluate()
                            faults_injected.append(
                                {
                                    "fault": "hang",
                                    "tenant": ev["tenant"],
                                    "rule": HANG_RULE,
                                    "injected_at": time.time(),
                                    "window_seconds": ev.get("seconds"),
                                }
                            )
                            # the hanging-collective fake: a 2-host world is
                            # claimed at the module seam (the _obs_demo pattern —
                            # the injected hang raises before any real allgather
                            # could run), then the guarded eager sync parks until
                            # the guard's timeout and degrades loudly. times=99
                            # covers every per-leaf collective — a partially-hung
                            # sync that quietly completed its remaining leaves
                            # would not be a hung host
                            with mock.patch.object(_sync_mod, "distributed_available", lambda: True):
                                with sync_guard(timeout=config.sync_timeout_seconds, retries=0):
                                    with _faults.inject_collective_fault(mode="hang", times=99):
                                        try:
                                            metrics[ev["tenant"]].sync()
                                        except Exception:
                                            pass  # raise-path builds still mean "degraded"
                        elif kind == "hang_end":
                            for fault in faults_injected:
                                if fault["fault"] == "hang" and "ended_at" not in fault:
                                    fault["ended_at"] = time.time()
                        elif kind == "repair":
                            fault_tenant = ev["tenant"]
                            flush_tenant(fault_tenant)
                            metrics[fault_tenant].reset()
                            for fault in faults_injected:
                                if fault["tenant"] == fault_tenant and fault["fault"] == "poison":
                                    fault.setdefault("repaired_at", time.time())
                            if config.flash_crowd and flash_shift_wall is None:
                                # the schedule's hot-spot shift rides the repair
                                # event: from here the drain traffic belongs to
                                # hot set B — and the SECOND WAVE of the crowd
                                # lands exactly like the first, concentrated on
                                # host "0". The re-seed below is the operator
                                # surface for that re-landing (a redeploy that
                                # pins everything back to the primary): without
                                # it, pre-shift convergence can happen to leave
                                # hot set B already split across hosts, the
                                # post-shift table is legitimately balanced, and
                                # a correct controller would (rightly) never
                                # move again — re-convergence must be FORCED to
                                # be provable
                                flash_shift_wall = time.time()
                                if placement_controller is not None:
                                    placement_controller.seed(
                                        dict.fromkeys(schedule.tenants, "0")
                                    )
                        else:  # pragma: no cover - generate()/loads() only emit known kinds
                            raise ReplayError(f"unknown schedule event kind {kind!r}")
                    if ev["kind"] == "sleep":
                        # idle gaps run with the lock released: a move or a failover
                        # waiting on a scrape thread lands here, between two feeds
                        sleep_seconds += ev["seconds"]
                        time.sleep(ev["seconds"])
                if config.flash_crowd and placement_controller is not None:
                    # settle loop: the schedule has ended but the controller
                    # converges on its own cadence. Convergence is judged
                    # UNDER LOAD, not during decay-to-idle — keep the
                    # post-shift traffic shape flowing until the table has
                    # answered the hot-spot shift with at least one clean
                    # move and closed the imbalance episode, or the hard
                    # deadline passes and the SLO judge flunks convergence
                    settle_deadline = time.monotonic() + 30.0
                    hot_b = set(schedule.hot_tenants_shifted)
                    sweep_size = schedule.config.batch_sizes[0]
                    while time.monotonic() < settle_deadline:
                        rep = placement_controller.report()
                        settled = (
                            not rep["convergence"]["episode_open"]
                            and not rep["moving"]
                            and flash_shift_wall is not None
                            and any(
                                row.get("action") == "move"
                                and row.get("ok")
                                and row.get("unix", 0.0) >= flash_shift_wall
                                for row in rep["decisions"]
                            )
                        )
                        if settled:
                            break
                        # feed cap: past ~150 sweeps keep polling but stop
                        # feeding — a run that hasn't settled by then is
                        # already flunking convergence, and an unbounded
                        # sweep flood would evict the poisoned batches'
                        # records from the bounded lineage ring and take the
                        # causality verdict down as collateral
                        with device_lock:
                            if flash_settle_sweeps < 150:
                                for tenant in schedule.tenants:
                                    if tenant == victim:
                                        continue
                                    repeats = (
                                        schedule.config.hot_factor
                                        if tenant in hot_b
                                        else 1
                                    )
                                    for _ in range(repeats):
                                        sweep_args = make_batch(
                                            tenant, sweep_size, False
                                        )
                                        flash_streams.setdefault(tenant, []).append(
                                            sweep_args
                                        )
                                        if tenant in controls:
                                            controls[tenant].update(*sweep_args)
                                        feed_tenant(tenant, *sweep_args)
                                        batches_fed += 1
                        flash_settle_sweeps += 1
                        time.sleep(config.scrape_interval_seconds)
                if fence_info is not None:
                    fence_info = finish_failover(fence_info)
                with device_lock:
                    for pipe in pipelines.values():
                        pipe.close()
                    if mux is not None:
                        mux.close()
                    closed = True
                    engine.evaluate()
                    # one stitched GET /trace/<id> of an injected NaN batch,
                    # fetched over HTTP while the server is still up — the CI
                    # artifact proving the lookup plane answers end to end
                    sample_trace = None
                    sample_trace_id = next(
                        (
                            fault.get("trace_id")
                            for fault in faults_injected
                            if fault.get("fault") == "poison" and fault.get("trace_id")
                        ),
                        None,
                    )
                    if sample_trace_id is not None:
                        try:
                            with urllib.request.urlopen(
                                server.url + "/trace/" + sample_trace_id, timeout=10
                            ) as resp:
                                sample_trace = json.loads(resp.read())
                        except Exception:
                            sample_trace = None
                    if migration_info is not None:
                        # the zero-loss verdict: every migrated session's final
                        # compute must be BIT-identical to its unmigrated shadow
                        control_rows: Dict[str, Any] = {}
                        for tenant in migrate_tenants:
                            restored_val = _to_host(metrics[tenant].compute())
                            control_val = _to_host(controls[tenant].compute())
                            control_rows[tenant] = {
                                "restored": float(restored_val),
                                "control": float(control_val),
                                "bit_identical": bool(
                                    restored_val.dtype == control_val.dtype
                                    and restored_val.tobytes() == control_val.tobytes()
                                ),
                            }
                        migration_info["controls"] = control_rows
                        migration_info["zero_loss"] = all(
                            row["bit_identical"] for row in control_rows.values()
                        )
                    if crash_info is not None:
                        # the crash-consistency verdict: every recovered session's
                        # final compute must be BIT-identical to its unkilled
                        # shadow control (the replay gap was re-fed, so no loss)
                        crash_rows: Dict[str, Any] = {}
                        for tenant in crash_tenants:
                            restored_val = _to_host(metrics[tenant].compute())
                            control_val = _to_host(controls[tenant].compute())
                            crash_rows[tenant] = {
                                "dtype": str(restored_val.dtype),
                                "items": int(restored_val.size),
                                "bit_identical": bool(
                                    restored_val.dtype == control_val.dtype
                                    and restored_val.tobytes() == control_val.tobytes()
                                ),
                            }
                        crash_info["controls"] = crash_rows
                        crash_info["zero_loss"] = all(
                            row["bit_identical"] for row in crash_rows.values()
                        )
                        # full-vs-delta bundle-bytes evidence, read back from the
                        # checkpoint liveness registry (it outlives the crashed
                        # session objects; the same numbers feed the
                        # checkpoint.bundle_bytes gauge the scrapes exported)
                        import torchmetrics_tpu_torch.obs.scope as _scope_mod

                        status = _scope_mod.checkpoint_status()
                        ck_rows: Dict[str, Any] = {}
                        full_bytes = full_count = delta_bytes = delta_count = 0
                        for tenant in crash_tenants:
                            row = status.get(tenant) or {}
                            base = ckpt_baseline.get(tenant) or {}
                            bundles = {
                                kind: (row.get("bundles") or {}).get(kind, 0)
                                - (base.get("bundles") or {}).get(kind, 0)
                                for kind in ("full", "delta")
                            }
                            nbytes = {
                                kind: (row.get("bytes") or {}).get(kind, 0)
                                - (base.get("bytes") or {}).get(kind, 0)
                                for kind in ("full", "delta")
                            }
                            ck_rows[tenant] = {
                                "bundles": dict(bundles),
                                "bytes": dict(nbytes),
                                "failures": row.get("failures", 0) - base.get("failures", 0),
                            }
                            full_count += bundles.get("full", 0)
                            full_bytes += nbytes.get("full", 0)
                            delta_count += bundles.get("delta", 0)
                            delta_bytes += nbytes.get("delta", 0)
                        full_mean = full_bytes / full_count if full_count else None
                        delta_mean = delta_bytes / delta_count if delta_count else None
                        crash_info["checkpoints"] = {
                            "per_tenant": ck_rows,
                            "full_bundles": full_count,
                            "delta_bundles": delta_count,
                            "full_bytes_mean": full_mean,
                            "delta_bytes_mean": delta_mean,
                            "delta_full_ratio": (
                                delta_mean / full_mean if full_mean and delta_mean is not None else None
                            ),
                        }
                    if fence_info is not None:
                        # the zero-double-counting verdict: every failed-over
                        # session's final compute must be BIT-identical to its
                        # never-hung shadow control — the zombie contributed
                        # nothing past the fence, the successor missed nothing
                        fence_rows: Dict[str, Any] = {}
                        for tenant in fence_tenants:
                            restored_val = _to_host(metrics[tenant].compute())
                            control_val = _to_host(controls[tenant].compute())
                            fence_rows[tenant] = {
                                "dtype": str(restored_val.dtype),
                                "items": int(restored_val.size),
                                "bit_identical": bool(
                                    restored_val.dtype == control_val.dtype
                                    and restored_val.tobytes() == control_val.tobytes()
                                ),
                            }
                        fence_info["controls"] = fence_rows
                        fence_info["zero_double_count"] = all(
                            row["bit_identical"] for row in fence_rows.values()
                        )
                    if fleet_sampler is not None:
                        # one final forced sample (the scrape loop may have just
                        # gone idle), then the end-of-run control-plane probes:
                        # the /fleet payload an operator would actually read, and
                        # the bounded-history depth — both over real HTTP
                        fleet_sampler.sample()
                        try:
                            with urllib.request.urlopen(
                                server.url + "/fleet", timeout=10
                            ) as resp:
                                fleet_probe = json.loads(resp.read())
                        except Exception:
                            fleet_probe = None  # visibility is judged; a missed probe fails the SLO
                        try:
                            with urllib.request.urlopen(
                                server.url + "/fleet/history?window=600", timeout=10
                            ) as resp:
                                fleet_history_n = json.loads(resp.read()).get("n_samples")
                        except Exception:
                            fleet_history_n = None
                    if config.flash_crowd:
                        # the placement verdict. Three proofs are assembled here:
                        # the read plane answered over real HTTP while the run was
                        # still live; every controller-ordered move was zero-loss
                        # (moved session bit-identical to an unmoved shadow fed
                        # the exact retained stream); and the table converged —
                        # including at least one clean move AFTER the hot-spot
                        # shift, the re-convergence the scenario exists to test
                        try:
                            with urllib.request.urlopen(
                                server.url + "/placement", timeout=10
                            ) as resp:
                                placement_probe = json.loads(resp.read())
                        except Exception:
                            placement_probe = None
                        placement_rows: Dict[str, Any] = {}
                        post_shift_moves = 0
                        final_report: Optional[Dict[str, Any]] = None
                        if placement_controller is not None:
                            final_report = placement_controller.report()
                            moved = sorted(
                                flash_moved
                                | {
                                    tenant
                                    for tenant, row in final_report[
                                        "assignments"
                                    ].items()
                                    if row.get("moves", 0) > 0
                                }
                            )
                            for tenant in moved:
                                shadow = guarded_metric(tenant)
                                for args in flash_streams.get(tenant, ()):
                                    shadow.update(*args)
                                restored_val = _to_host(metrics[tenant].compute())
                                control_val = _to_host(shadow.compute())
                                placement_rows[tenant] = {
                                    "host": final_report["assignments"][tenant]["host"],
                                    "moves": final_report["assignments"][tenant]["moves"],
                                    "restored": float(restored_val),
                                    "control": float(control_val),
                                    "bit_identical": bool(
                                        restored_val.dtype == control_val.dtype
                                        and restored_val.tobytes() == control_val.tobytes()
                                    ),
                                }
                            post_shift_moves = sum(
                                1
                                for row in final_report["decisions"]
                                if row.get("action") == "move"
                                and row.get("ok")
                                and flash_shift_wall is not None
                                and row.get("unix", 0.0) >= flash_shift_wall
                            )
                        placement_info = {
                            "enabled": bool(config.placement_enabled),
                            "hosts": ["0", "1"],
                            "initial_placement": dict(fleet_placement),
                            "restored_from_disk": placement_restored_from_disk,
                            "shift_wall_unix": flash_shift_wall,
                            "settle_sweeps": flash_settle_sweeps,
                            "moved": sorted(placement_rows),
                            "controls": placement_rows,
                            "zero_loss": (
                                all(
                                    row["bit_identical"]
                                    for row in placement_rows.values()
                                )
                                if placement_rows
                                else None
                            ),
                            "moves_completed": (
                                final_report["moves"]["completed"]
                                if final_report is not None
                                else 0
                            ),
                            "moves_failed": (
                                final_report["moves"]["failed"]
                                if final_report is not None
                                else 0
                            ),
                            "post_shift_moves": post_shift_moves,
                            "converged": (
                                final_report is not None
                                and not final_report["convergence"]["episode_open"]
                                and final_report["convergence"]["episodes_closed"] >= 1
                            ),
                            "episodes_closed": (
                                final_report["convergence"]["episodes_closed"]
                                if final_report is not None
                                else 0
                            ),
                            "convergence_seconds": (
                                final_report["convergence"]["last_convergence_seconds"]
                                if final_report is not None
                                else None
                            ),
                            "final_placement": (
                                {
                                    tenant: row["host"]
                                    for tenant, row in final_report[
                                        "assignments"
                                    ].items()
                                }
                                if final_report is not None
                                else {}
                            ),
                            "report": final_report,
                            "probe": placement_probe,
                        }
            elapsed = time.perf_counter() - perf_start
            scraper.stop()
            driver_scrapes = scraper.summary()
            degraded_seen = scraper.degraded_seen
            scraper = None
            health = server.health()
            tenants_page = server.tenants_report()
            server_scrapes = server.request_stats()
    finally:
        # back to the one-branch disabled path (the index keeps this run's
        # records for the post-hoc joins below — lookups work either way)
        if not lineage_was_enabled:
            _lineage.disable()
        if config.hung_host:
            # the scrape-driven watchdog is process-global: leave none behind
            _fence.install_watchdog(None)
        if config.skewed_load:
            # the installed sampler is process-global too: leave none behind
            _fleet_mod.install_sampler(None)
        if config.flash_crowd:
            # the sampler AND the controller are process-global: restore the
            # caller's controller (usually none) and leave no sampler behind
            from torchmetrics_tpu_torch import fleet as _placement_mod

            _fleet_mod.install_sampler(None)
            _placement_mod.install_controller(placement_prev)
        if profiler is not None:
            # stop sampling and restore whatever profiler the caller had
            # installed; the stopped profiler's tables stay readable for the
            # run-record join below
            profiler.stop()
            _hostprof.install(profiler_prev)
        if scraper is not None:
            scraper.stop()
        server.stop()
        if not closed:
            for pipe in pipelines.values():
                try:
                    pipe.close()
                except Exception:
                    pass
            if mux is not None:
                try:
                    mux.close()
                except Exception:
                    pass
        if auditor is not None:
            # uninstall AFTER the live-session close loop (close() freezes
            # each session's final ledger rows) but BEFORE the zombie closes
            # below; the auditor object stays readable for the run-record
            # join below
            _audit.install_auditor(auditor_prev)
        # the zombies never serve again; closing them releases resources but
        # NOT the successors' leases (close only releases a lease whose epoch
        # still owns the scope row — the fenced epochs don't). Closed with the
        # audit plane already detached: a close-time flush of a wedge-split
        # chunk would fold under the fenced epoch, and in the real deployment
        # that fold happens on the DEAD host, outside the fencer's process —
        # its audited footprint is the rejected late bundle (an event this
        # run already recorded), not a local no_post_fence_fold violation
        for zpipe in zombies.values():
            try:
                zpipe.close()
            except Exception:
                pass
        if gc_was_enabled:
            gc.enable()

    cost_delta = _cost.get_ledger().since(cost_mark)
    dump_paths = [path for pipe in pipelines.values() for path in pipe.flight_dumps]
    if mux is not None:
        # the mux flight recorder's dumps (per faulted tenant, tenant-local
        # batch indices) ride the same correctness check as pipeline dumps
        dump_paths += mux.flight_dumps
    dumps = [meta for meta in (_read_dump(path) for path in dump_paths) if meta is not None]
    if own_dump_dir:
        import shutil

        shutil.rmtree(dump_dir, ignore_errors=True)
    if bundle_dir is not None:
        import shutil

        shutil.rmtree(bundle_dir, ignore_errors=True)
    if own_ckpt_dir and ckpt_dir is not None:
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if flash_dir is not None:
        import shutil

        shutil.rmtree(flash_dir, ignore_errors=True)
    # batch-lineage causality evidence (the fault_causality SLO's input): one
    # row per injected NaN batch — does its trace id resolve to a record, and
    # does that record link the full story (guarded tenants: quarantine
    # outcome + a dump naming the id; the victim: the value watchdog its
    # commit fired, or an episode already covering its ingest)?
    episodes = engine.fire_resolve_times()
    if fleet_sampler is not None:
        # skew detection verdict: time from skew onset (the first batch — the
        # static placement concentrates load from the very start) to the
        # imbalance page's fired_at, measured off the standard episode stream
        fired = [
            ep["fired_at"]
            for ep in episodes
            if ep.get("rule") == IMBALANCE_RULE and ep.get("fired_at") is not None
        ]
        first_fired = min(fired) if fired else None
        final_skew = fleet_sampler.skew(window=10 * config.fleet_cadence_seconds)
        hot_after = final_skew.get("hot_host")
        fleet_info = {
            "cadence_seconds": config.fleet_cadence_seconds,
            "placement": fleet_placement,
            "samples": fleet_sampler.samples_taken,
            "degraded_samples": fleet_sampler.degraded_samples,
            "history_samples": fleet_history_n,
            "alert_fired": first_fired is not None,
            "time_to_detect_imbalance_seconds": (
                round(max(0.0, first_fired - wall_start), 6)
                if first_fired is not None
                else None
            ),
            "imbalance": final_skew.get("imbalance"),
            "hot_host": hot_after,
            "shift": (
                dict(
                    fleet_shift,
                    hot_host_after=hot_after,
                    hot_host_shifted=bool(
                        fleet_shift.get("hot_host_before") is not None
                        and hot_after is not None
                        and fleet_shift["hot_host_before"] != hot_after
                    ),
                )
                if fleet_shift is not None
                else None
            ),
            "probe": fleet_probe,
        }
    causality_rows: List[Dict[str, Any]] = []
    for poisoned_tenant, poisoned_indices in schedule.poisoned().items():
        for poisoned_index in poisoned_indices:
            tid = tenant_trace_id(poisoned_tenant, poisoned_index)
            rec = _lineage.lookup(tid)
            dump_named = any(tid in (d.get("poisoned_trace_ids") or []) for d in dumps)
            ingest = float(rec["ingest_unix"]) if rec is not None else None
            alert_linked = bool(rec and rec.get("alerts"))
            if not alert_linked and rec is not None:
                # a later poison landing while the watchdog is already raised
                # fired no fresh transition — a covering episode still links
                alert_linked = any(
                    ep.get("tenant") == poisoned_tenant
                    and ep.get("fired_at") is not None
                    and (
                        ep["fired_at"] >= ingest - 0.005
                        or ep.get("resolved_at") is None
                        or ep["resolved_at"] > ingest
                    )
                    for ep in episodes
                )
            quarantine_out = bool(
                rec and rec.get("outcome") in ("quarantined", "skipped", "raised")
            )
            linked = bool(rec) and (
                (quarantine_out and dump_named)
                if poisoned_tenant != victim
                else alert_linked
            )
            causality_rows.append(
                {
                    "tenant": poisoned_tenant,
                    "index": poisoned_index,
                    "trace_id": tid,
                    "found": rec is not None,
                    "outcome": rec.get("outcome") if rec else None,
                    "dump_named": dump_named,
                    "alert_linked": alert_linked,
                    "linked": linked,
                }
            )
    lineage_info = {
        "enabled": True,
        "index": _lineage.get_index().stats(),
        "poisoned": causality_rows,
        "sample_trace_id": sample_trace_id,
        "sample_trace": sample_trace,
    }
    hostprof_info = None
    if profiler is not None:
        # the continuous profiler's verdict for this run: per-seam breakdown,
        # the Python-floor report (incl. the mux-path host-vs-device split), the
        # measured self-overhead, and the mid-run HTTP probe evidence
        hostprof_info = {
            "enabled": True,
            "rate_hz": profiler.rate_hz,
            "duration_seconds": round(profiler.duration_seconds(), 6),
            "self_overhead_percent": round(profiler.self_overhead_percent(), 4),
            "attributed_percent": round(profiler.attributed_percent(), 4),
            "breakdown": profiler.breakdown(),
            "floor": profiler.floor_report(),
            "stats": profiler.stats(),
            "probe": profile_probe,
            # bounded collapsed-stack text (flamegraph.pl input) so the bench
            # can ship the flamegraph as a CI artifact without re-sampling
            "collapsed": profiler.collapsed(top=500),
        }
    audit_info = None
    if auditor is not None:
        # one final audit pass over the frozen ledgers (the scrape-cadence
        # gate has long passed by now), then the full /audit-shaped payload:
        # per-tenant ledgers, invariant results, named violations, fence
        # events — the accounting_clean SLO's evidence
        auditor.tick()
        audit_info = auditor.report()
    reports = {tenant: pipe.report().asdict() for tenant, pipe in pipelines.items()}
    sync_degraded = sorted(
        tenant for tenant, metric in metrics.items() if getattr(metric, "sync_degraded", False)
    )
    quarantined = {
        tenant: int(getattr(metric, "updates_quarantined", 0) or 0)
        for tenant, metric in metrics.items()
        if int(getattr(metric, "updates_quarantined", 0) or 0)
    }
    return {
        "schedule": {
            "seed": schedule.config.seed,
            "tenants": len(schedule.tenants),
            "events": len(schedule.events),
            "victim": victim,
            "hung": hung,
            "poisoned": schedule.poisoned(),
        },
        "wall_seconds": round(elapsed, 6),
        "sleep_seconds": round(sleep_seconds, 6),
        "batches_fed": batches_fed,
        "updates_per_second": round(batches_fed / elapsed, 3) if elapsed > 0 else None,
        "wall_start_unix": wall_start,
        "faults": faults_injected,
        "alerts": {
            "history": engine.history(),
            "episodes": engine.fire_resolve_times(),
            "evaluations": engine.evaluations,
        },
        "scrapes": {
            "driver": driver_scrapes,
            "server": server_scrapes,
            # how many mid-run /healthz scrapes saw "degraded": the injected
            # faults were operator-visible while they were happening
            "degraded_healthz_seen": degraded_seen,
        },
        "cost": {
            "compiled_variants": cost_delta.get("variants_compiled", 0),
            "compile_seconds": cost_delta.get("compile_seconds", 0.0),
        },
        # dump metas were read above; an auto-created dir is gone by now
        "flight": {"dump_dir": None if own_dump_dir else dump_dir, "dumps": dumps},
        # batch-lineage causality evidence + trace-index cardinality (the
        # fault_causality SLO's input and the recorded-never-judged bench key)
        "lineage": lineage_info,
        # conservation-audit evidence (None when ReplayConfig.audit=False):
        # the /audit-shaped payload — per-tenant flow ledgers, invariant
        # results and named violations — the accounting_clean SLO's input
        "audit": audit_info,
        # cross-tenant fused dispatch accounting (None when unmultiplexed):
        # the SLO judge's mux-engagement check and the before/after evidence
        # next to the compiled-variant delta above
        "mux": (
            {
                "max_width": config.mux_max_width,
                "tenants": len(mux.tenants()),
                "report": mux.report().asdict(),
                "cache": mux.cache_info(),
            }
            if mux is not None
            else None
        ),
        # continuous host-profiler accounting (None unless the profiler was
        # live — auto for the multiplexed scenario): per-seam host-time
        # breakdown, the Python-floor report with the mux-path host-vs-device
        # split, sampler self-overhead, and the mid-run GET /profile probe
        "hostprof": hostprof_info,
        "robust": {"sync_degraded": sync_degraded, "quarantined": quarantined},
        # rolling-deploy accounting (None unless ReplayConfig.rolling_deploy):
        # migrated tenants, handoff wall time, the mid-flight /healthz
        # observation, and the per-tenant bit-identity verdicts vs controls
        "migration": migration_info,
        # host-crash accounting (None unless ReplayConfig.host_crash): crashed
        # tenants, per-session replay gaps vs the checkpoint cadence, recovery
        # wall time, bit-identity verdicts vs unkilled controls, and the
        # full-vs-delta bundle-bytes evidence
        "crash": crash_info,
        # hung-host fencing accounting (None unless ReplayConfig.hung_host):
        # wedged tenants, time-to-detect / time-to-failover via the scrape-
        # driven watchdog, the zombie's rejected late bundle write, operator
        # visibility probes, and the zero-double-counting verdicts vs controls
        "fence": fence_info,
        # fleet-telemetry accounting (None unless ReplayConfig.skewed_load):
        # sample/degraded counts, time-to-detect for the imbalance page, the
        # mid-run hot-spot shift + wedged-gather evidence, and the HTTP-probed
        # /fleet payload an operator would read
        "fleet": fleet_info,
        # placement-control-plane accounting (None unless
        # ReplayConfig.flash_crowd): durable-restore evidence, the controller's
        # move ledger + decision log, zero-loss bit-identity verdicts for every
        # moved session, convergence (including the post-shift re-convergence),
        # and the HTTP-probed /placement payload an operator would read
        "placement": placement_info,
        "health": health,
        "tenants": tenants_page,
        "pipelines": reports,
    }
