"""Declarative SLOs + the judge that turns a chaos replay into pass/fail.

A replay result (:func:`torchmetrics_tpu_torch.chaos.replay.replay`) is a pile of
measurements; an :class:`SLOSpec` says which of them the serving stack
*promises*, and :func:`judge` renders the verdict:

- **update throughput** — batches folded per wall second across every tenant
  session, chaos included (sleeps, faults, replays and scrapes all count
  against it — that is the point).
- **scrape latency p95/p99 per route** — read from the obs server's own
  ``server.request`` histogram via
  :func:`~torchmetrics_tpu_torch.obs.export.histogram_quantile` (bucket-midpoint
  estimates; the driver-side client-observed quantiles ride along in the
  report as corroboration).
- **time-to-fire / time-to-resolve per injected fault** — the wall delta from
  the fault's injection stamp to its watchdog's ``firing`` transition, and
  from ``firing`` to ``resolved``, derived from the alert engine's bounded
  transition history (:meth:`~torchmetrics_tpu_torch.obs.alerts.AlertEngine.fire_resolve_times`).
  A fault whose alert never fired — or never resolved — is an SLO failure
  with that exact detail, not a missing number.
- **peak compiled-variant count under churn** — the cost ledger's
  variants-compiled delta across the run: signature churn that recompiles
  per tenant instead of per bucket shows up here first (the pjit-scaling
  paper's cost, gated).
- **flight-dump correctness** — every poisoned batch the schedule injected
  into a guarded tenant must be *named* (tenant + tenant-local batch index)
  in some flight-recorder dump.
- **fault causality** — every injected NaN batch's **trace id**
  (:mod:`~torchmetrics_tpu_torch.obs.lineage`) must resolve end-to-end: the lineage
  record exists, a guarded tenant's poison shows a quarantine outcome AND a
  flight dump naming its id, and the victim's poison links to the value
  watchdog that fired on its commit — injection → evidence → alert as one
  joined record, not three greps.

:func:`judge` returns a plain report: per-SLO rows (value, threshold, pass,
detail), an overall verdict, and a ``configs`` dict shaped exactly like
``bench.py`` configs — units the regression sentinel
(:mod:`~torchmetrics_tpu_torch.obs.regress`) judges, plus the strict ``slo_pass``
config — so a chaos run lands in ``BENCH_HISTORY.jsonl`` and is gated like
any perf number.

Pure stdlib. The rows, configs and report text are the JAX package's, so either
package's :func:`judge` gives the same report on the same result.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch.obs.export import histogram_quantile, quantile_bucket

__all__ = [
    "SLOSpec",
    "flash_crowd_slo_spec",
    "format_report",
    "high_tenant_slo_spec",
    "host_crash_slo_spec",
    "hung_host_slo_spec",
    "judge",
    "rolling_deploy_slo_spec",
    "skewed_load_slo_spec",
]


@dataclass
class SLOSpec:
    """The promises a chaos run is judged against (absolute, same-hardware).

    Thresholds default loose enough for an oversubscribed CI host — the
    regression sentinel's noise-aware history gate is the tight screw; these
    are the "is the system even operable" floor. ``None`` disables an SLO
    (reported, never judged).
    """

    min_updates_per_second: Optional[float] = 5.0
    max_scrape_p95_seconds: Optional[float] = 0.75
    max_scrape_p99_seconds: Optional[float] = 1.5
    max_time_to_fire_seconds: Optional[float] = 5.0
    max_time_to_resolve_seconds: Optional[float] = 15.0
    max_compiled_variants: Optional[int] = 160
    require_poisoned_named: bool = True
    # end-to-end batch-lineage causality (obs/lineage.py): every injected NaN
    # batch's trace id must link schedule injection → quarantine/flight dump
    # (guarded tenants) or → value-watchdog firing (the victim) — the
    # grep-and-guess eliminator, judged as one strict boolean
    require_fault_causality: bool = True
    # cross-tenant fused dispatch promises (the multiplexed scenarios):
    # the run must actually have fused across tenants, and every guarded
    # tenant's poisoned batch must be quarantined by exactly its own session
    require_multiplexed: bool = False
    require_quarantine_attributed: bool = False
    # live-session migration promises (the rolling-deploy scenario): every
    # migrated tenant's restored session must compute BIT-IDENTICAL to its
    # unmigrated shadow control, the handoff must be operator-visible
    # (/healthz degraded with the migrating tenant NAMED while in flight),
    # and the whole host handoff must land inside the wall budget
    require_migration_zero_loss: bool = False
    require_migration_visible: bool = False
    max_migration_seconds: Optional[float] = None
    # continuous-checkpointing promises (the host-crash scenario): after an
    # unplanned SIGKILL-semantics death, the replay gap (batches fed but not
    # covered by the last periodic bundle) must be bounded by the cadence,
    # recovery from the newest intact bundle must land inside the wall budget,
    # post-recovery compute must be bit-identical to an unkilled shadow
    # control, and delta bundles must be measurably smaller than full ones
    # on the large-state metric (mean-bytes ratio, bundle-bytes gauge)
    max_replay_gap_batches: Optional[int] = None
    require_crash_zero_loss: bool = False
    max_recovery_seconds: Optional[float] = None
    max_delta_full_ratio: Optional[float] = None
    # hung-host fencing promises (the hung-host scenario): the scrape-driven
    # watchdog must detect the stale lease and complete the failover inside
    # the wall budgets, the zombie's late bundle write must land fenced-out
    # (rejected + counted by the next recovery scan, never selected), every
    # failed-over session must compute bit-identical to a never-hung shadow
    # control (zero double-counting), and the fence must be operator-visible
    # (/healthz degraded naming the fenced tenant + target, /leases carrying
    # the fence ledger)
    max_time_to_detect_seconds: Optional[float] = None
    max_time_to_failover_seconds: Optional[float] = None
    require_zombie_writes_rejected: bool = False
    require_fence_zero_double_count: bool = False
    require_fence_visible: bool = False
    # fleet-telemetry promises (the skewed-load scenario): the imbalance page
    # must fire from fleet samples alone (the declarative imbalance_rule over
    # the fleet.imbalance gauge — nothing is told where the skew is) inside
    # the detection budget; /fleet must serve the per-tenant rate table, the
    # skew block and ranked advisory rebalance hints derived from >= 2 real
    # samples; the mid-run hot-spot shift must re-point the hot host; and a
    # wedged gather must yield a LOUD degraded partial sample (missing hosts
    # named), never a stalled sampler
    max_time_to_detect_imbalance_seconds: Optional[float] = None
    require_fleet_served: bool = False
    require_fleet_shift_tracked: bool = False
    require_fleet_degraded_loud: bool = False
    # placement-control-plane promises (the flash-crowd scenario): the
    # controller must fix the measured skew with real session moves and close
    # its convergence episode inside the budget — including at least one
    # clean move AFTER the mid-run hot-spot shift (re-convergence, the reason
    # the scenario exists); every moved session must compute BIT-IDENTICAL to
    # an unmoved shadow control fed the exact same stream (zero-loss moves);
    # the assignment table must have been reconstructed from the durable
    # state file (the restart path, not a fresh in-memory table); GET
    # /placement must serve the table, move ledger and decision log over real
    # HTTP; and serving throughput under the live controller must hold a
    # floor ratio of the static-placement control arm's, both net of their
    # own measured compile wall (the controller must not COST meaningful
    # throughput; compile churn is capped separately by compiled_variants)
    max_placement_convergence_seconds: Optional[float] = None
    min_placement_moves: Optional[int] = None
    require_placement_zero_loss: bool = False
    require_placement_served: bool = False
    require_placement_durable_restore: bool = False
    require_placement_shift_move: bool = False
    min_placement_throughput_ratio: Optional[float] = None
    # conservation-audit promise (every scenario): the continuous auditor
    # (obs/audit.py) must have balanced every tenant's flow ledger over the
    # whole run — zero violations across admission, fusion, migration, crash
    # recovery and fencing — judged as one strict boolean
    require_accounting_clean: bool = False
    # routes whose scrape latency is judged (the driver may scrape more)
    scrape_routes: Tuple[str, ...] = ("/metrics", "/alerts", "/tenants")

    def asdict(self) -> Dict[str, Any]:
        return asdict(self)


def high_tenant_slo_spec() -> SLOSpec:
    """The SLO spec of the high-tenant multiplexed scenario
    (:func:`~torchmetrics_tpu_torch.chaos.schedule.high_tenant_config` replayed with
    ``ReplayConfig.multiplex=True``).

    The compiled-variant budget is the headline: 64 tenants sharing two batch
    signatures must compile O(width-buckets × signatures) programs — the
    fused-program ladder (7 buckets × 2 signatures), the per-tenant replay /
    victim / hung-path programs and warmup leave comfortable slack under 60,
    where the unmultiplexed same-schedule run compiles ~4–5× more (every
    tenant's own jit cache pays every signature). Poisoned-batch evidence is
    held to BOTH standards: quarantine attribution (exactly the owning
    tenant's robust counters move) AND flight-dump naming — the multiplexer
    now carries the per-row lineage ring + dump-on-fault, so a poisoned
    tenant row produces a named-batch JSONL dump exactly like a per-tenant
    pipeline's.
    """
    return SLOSpec(
        min_updates_per_second=5.0,
        max_compiled_variants=60,
        require_poisoned_named=True,
        require_multiplexed=True,
        require_quarantine_attributed=True,
        require_accounting_clean=True,
    )


def rolling_deploy_slo_spec() -> SLOSpec:
    """The SLO spec of the rolling-deploy scenario
    (``ReplayConfig.rolling_deploy=True``): one "host" is killed mid-traffic
    and its tenant sessions migrate to the survivor via the live-session
    drain→checkpoint→restore→replay-tail protocol
    (:mod:`torchmetrics_tpu_torch.engine.migrate`).

    The promises: every migrated session's final ``compute()`` is
    bit-identical to an unmigrated shadow control fed the same stream
    (zero loss), the handoff window is degraded-but-visible (``/healthz``
    names the migrating tenant mid-flight), the whole host handoff lands
    inside a generous wall budget, and the ordinary fault SLOs (poison
    fire/resolve, hang fire/resolve, named dumps) keep holding through the
    deploy — chaos does not pause for the migration.
    """
    return SLOSpec(
        min_updates_per_second=5.0,
        require_poisoned_named=True,
        require_migration_zero_loss=True,
        require_migration_visible=True,
        max_migration_seconds=30.0,
        require_accounting_clean=True,
    )


def host_crash_slo_spec(cadence_batches: int = 4, fuse: int = 2) -> SLOSpec:
    """The SLO spec of the host-crash scenario
    (``ReplayConfig.host_crash=True``): one "host" is SIGKILL'd mid-traffic —
    no drain, no close, no final checkpoint — and its tenant sessions are
    recovered from the last **periodic** bundle their continuous
    :class:`~torchmetrics_tpu_torch.engine.migrate.CheckpointPolicy` wrote.

    The promises: the replay gap (batches fed but not covered by the restore
    point) stays within the exact crash-loss bound — the cadence plus the open
    fusion chunk, ``cadence_batches + max(0, fuse - 2)``, which is the cadence
    itself at the scenario's ``fuse=2`` — the whole point of periodic
    chunk-consistent bundles; recovery (scan → chain-verified restore
    → gap re-feed) lands inside a generous wall budget; post-recovery
    ``compute()`` is **bit-identical** to an unkilled shadow control fed the
    same stream; delta bundles are measurably smaller than full bundles on the
    large-state ``CatMetric`` (mean-bytes ratio ≤ 0.8, the
    ``checkpoint.bundle_bytes`` gauge's evidence); and the ordinary fault SLOs
    (poison fire/resolve, hang fire/resolve, named dumps) keep holding through
    the crash — chaos does not pause for the recovery. ``cadence_batches`` and
    ``fuse`` must match ``ReplayConfig.checkpoint_every_batches`` / ``.fuse``.
    """
    return SLOSpec(
        min_updates_per_second=5.0,
        require_poisoned_named=True,
        max_replay_gap_batches=int(cadence_batches) + max(0, int(fuse) - 2),
        require_crash_zero_loss=True,
        max_recovery_seconds=30.0,
        max_delta_full_ratio=0.8,
        require_accounting_clean=True,
    )


def hung_host_slo_spec() -> SLOSpec:
    """The SLO spec of the hung-host scenario (``ReplayConfig.hung_host=True``):
    one "host" wedges mid-traffic — alive but silent, no drain, no close, no
    lease release — and its leased tenant sessions are fenced + failed over by
    the scrape-driven :class:`~torchmetrics_tpu_torch.robust.fence.Watchdog`.

    The promises: the stale lease is **detected** within a budget that covers
    the lease TTL plus scrape cadence plus scheduler slack; the fence + restore
    completes inside its own wall budget; the zombie's late bundle write lands
    fenced-out — rejected and counted by the next recovery scan, never selected
    as a restore point; every failed-over session's final ``compute()`` is
    **bit-identical** to a never-hung shadow control fed the same stream (zero
    double-counting: the zombie contributed nothing past the fence, the
    successor missed nothing); the fence is operator-visible (``/healthz``
    degraded with the fenced tenant and failover target named, ``/leases``
    carrying the fence ledger); and the ordinary fault SLOs keep holding —
    chaos does not pause for the failover. Detection/failover walls are
    scheduler-jitter-dominated, so (like ``migration_seconds``) their recorded
    spreads make the ABSOLUTE budgets the regression sentinel's cap.
    """
    return SLOSpec(
        min_updates_per_second=5.0,
        require_poisoned_named=True,
        max_time_to_detect_seconds=15.0,
        max_time_to_failover_seconds=30.0,
        require_zombie_writes_rejected=True,
        require_fence_zero_double_count=True,
        require_fence_visible=True,
        require_accounting_clean=True,
    )


def skewed_load_slo_spec() -> SLOSpec:
    """The SLO spec of the skewed-load scenario
    (:func:`~torchmetrics_tpu_torch.chaos.schedule.skewed_load_config` replayed with
    ``ReplayConfig.skewed_load=True``): a static placement concentrates every
    tenant but one onto one virtual host, and the fleet telemetry plane —
    continuous sampling, rate derivation, skew signals, the ``/fleet`` read
    API — must *notice*.

    The promises: the ``fleet_imbalance`` page fires from fleet samples alone
    (the declarative :func:`~torchmetrics_tpu_torch.obs.fleet.imbalance_rule` over
    the derived ``fleet.imbalance`` gauge, through the standard pending→firing
    machinery) within the detection budget; ``/fleet`` serves the per-tenant
    rate table, the skew block and ranked advisory rebalance hints from ≥ 2
    real samples, and its scrape latency holds the same p95/p99 bounds as
    ``/metrics``; the mid-run hot-spot shift re-points the hot host (the
    unlabeled-series design: the firing page follows the load, no stale
    labelset strands); one gather taken under a wedged 2-host fake degrades
    LOUDLY — partial sample, missing host named — instead of stalling the
    sampler; and the ordinary fault SLOs keep holding through it all, because
    skew detection that only works in a sterile run is not detection.
    Detection wall is sample-cadence + dwell + scrape-jitter dominated, so
    (like the fencing walls) the recorded spread makes the absolute budget
    the regression sentinel's cap.
    """
    return SLOSpec(
        min_updates_per_second=5.0,
        require_poisoned_named=True,
        max_time_to_detect_imbalance_seconds=10.0,
        require_fleet_served=True,
        require_fleet_shift_tracked=True,
        require_fleet_degraded_loud=True,
        require_accounting_clean=True,
        scrape_routes=("/metrics", "/alerts", "/tenants", "/fleet"),
    )


def flash_crowd_slo_spec() -> SLOSpec:
    """The SLO spec of the flash-crowd scenario
    (:func:`~torchmetrics_tpu_torch.chaos.schedule.flash_crowd_config` replayed with
    ``ReplayConfig.flash_crowd=True``): the whole crowd lands on one of two
    provisioned virtual hosts — burst arrivals, two tenants running hot at a
    heavy factor — and the **placement controller** (not an operator) must fix
    it with real drain→checkpoint→restore session moves, then fix it AGAIN
    when the schedule shifts the hot spot mid-run.

    The promises: the ``fleet_imbalance`` page fires from fleet samples alone
    within the detection budget (the controller and the pager read the same
    gauge); the controller closes its convergence episode inside the wall
    budget, with at least one clean post-shift move — a controller that only
    converges once is a seeded table, not a control loop; every moved session
    computes bit-identical to an unmoved shadow control fed the identical
    retained stream (zero-loss moves, judged over EVERY move the run
    executed); the live table was reconstructed from the durable state file
    at startup; ``GET /placement`` serves assignments, the move ledger and
    the decision log over real HTTP at the same latency bounds as
    ``/metrics``; throughput under the live controller holds a floor ratio
    of the static-placement control arm (same schedule, controller off); and
    the conservation audit stays strict-green through every move — a
    rebalance that loses or double-counts a batch is corruption, not load
    management. Convergence walls are sampler-cadence + reconcile-cadence +
    move-wall dominated, so the recorded spread makes the absolute budget
    the regression sentinel's cap.
    """
    return SLOSpec(
        min_updates_per_second=5.0,
        require_poisoned_named=True,
        max_time_to_detect_imbalance_seconds=15.0,
        require_fleet_served=True,
        max_placement_convergence_seconds=20.0,
        min_placement_moves=2,
        require_placement_zero_loss=True,
        require_placement_served=True,
        require_placement_durable_restore=True,
        require_placement_shift_move=True,
        min_placement_throughput_ratio=0.5,
        require_accounting_clean=True,
        scrape_routes=("/metrics", "/alerts", "/tenants", "/fleet", "/placement"),
    )


def _slug(route: str) -> str:
    return route.strip("/").replace("/", "_") or "root"


def _row(
    rows: List[Dict[str, Any]],
    name: str,
    value: Optional[float],
    threshold: Optional[float],
    unit: str,
    direction: str,
    detail: str = "",
) -> Dict[str, Any]:
    """Append one judged SLO row; ``direction`` is 'max' (value <= threshold)
    or 'min' (value >= threshold). A ``None`` value with a live threshold is a
    failure (the promised number could not even be measured)."""
    if threshold is None:
        passed = True
        detail = (detail + "; " if detail else "") + "not judged (no threshold configured)"
    elif value is None:
        passed = False
        detail = detail or "no measurement"
    elif direction == "max":
        passed = value <= threshold
    else:
        passed = value >= threshold
    row = {
        "slo": name,
        "value": value,
        "threshold": threshold,
        "unit": unit,
        "direction": direction,
        "passed": bool(passed),
        "detail": detail,
    }
    rows.append(row)
    return row


def _server_route_quantile(result: Dict[str, Any], route: str, q: float) -> Optional[float]:
    """The self-instrumented scrape-latency quantile for one route, seconds."""
    stats = (result.get("scrapes") or {}).get("server") or {}
    hist = stats.get(route)
    if not hist or not hist.get("buckets"):
        return None
    return histogram_quantile(hist["buckets"], q)


def _quantile_bucket_bounds(
    result: Dict[str, Any], route: str, q: float
) -> Optional[Tuple[float, float]]:
    """``(lower, next_upper)`` error bar of the route's quantile estimate.

    A bucket-midpoint estimate is only known to ±its bucket, and a true value
    sitting near a boundary flips the estimate between *adjacent* buckets
    across runs. The recorded error bar therefore spans the estimate's bucket
    plus one bucket of slack upward (``next_upper`` is the following bound) —
    written as the config's ``spread`` so the regression sentinel's spread-cap
    tolerance absorbs adjacent-bucket quantization hops while a multi-bucket
    jump (a real order-of-magnitude regression on these log buckets) still
    flags.
    """
    stats = (result.get("scrapes") or {}).get("server") or {}
    hist = stats.get(route)
    if not hist or not hist.get("buckets"):
        return None
    buckets = hist["buckets"]
    bucket = quantile_bucket(buckets, q)  # the SAME walk the estimate used
    if bucket is None:
        return None
    lower, upper = bucket
    if upper <= lower:
        return (lower, lower)  # open-ended +Inf bucket: no further slack to give
    bounds = [bound for bound, _ in buckets]
    index = bounds.index(upper)
    next_bound = bounds[index + 1] if index + 1 < len(bounds) else upper
    return (lower, upper if math.isinf(next_bound) else next_bound)


def _fault_episode(
    result: Dict[str, Any], fault: Dict[str, Any]
) -> Tuple[Optional[Dict[str, Any]], bool]:
    """``(episode, already_firing)`` for the fault's rule.

    Preferred: the first episode that *fired* at/after the injection stamp.
    Fallback (``already_firing=True``): an episode that was still firing when
    the fault landed — a second fault of the same kind injected while the
    watchdog is already raised (recorded schedules may do this) is covered,
    not unalerted; its time-to-fire is zero by definition.
    """
    episodes = (result.get("alerts") or {}).get("episodes") or []
    injected_at = fault.get("injected_at")
    if injected_at is None:
        return None, False
    same_rule = [
        ep for ep in episodes if ep.get("rule") == fault.get("rule") and ep.get("fired_at") is not None
    ]
    candidates = [
        ep
        for ep in same_rule
        # small slack: the watchdog can catch the fault within the same
        # chunk-commit microseconds the injection stamp was taken in
        if ep["fired_at"] >= injected_at - 0.005
    ]
    if candidates:
        return min(candidates, key=lambda ep: ep["fired_at"]), False
    covering = [
        ep
        for ep in same_rule
        if ep["fired_at"] <= injected_at
        and (ep.get("resolved_at") is None or ep["resolved_at"] > injected_at)
    ]
    if covering:
        return max(covering, key=lambda ep: ep["fired_at"]), True
    return None, False


def judge(
    result: Dict[str, Any], spec: Optional[SLOSpec] = None, prefix: str = "chaos"
) -> Dict[str, Any]:
    """Judge one replay result against ``spec``; returns the SLO report.

    Report shape: ``{"passed", "n_slos", "failed": [names], "slos": [rows],
    "spec": {...}, "configs": {bench-config-shaped numbers}}``. ``prefix``
    names the emitted bench configs (default ``chaos_*``) — distinct scenarios
    MUST use distinct prefixes (e.g. ``chaos_ht`` for the high-tenant
    scenario), or the regression sentinel would baseline one scenario's
    numbers against another's workload.
    """
    spec = spec or SLOSpec()
    rows: List[Dict[str, Any]] = []
    configs: Dict[str, Any] = {}

    def config(
        name: str,
        value: Optional[float],
        unit: str,
        threshold: Optional[float],
        spread: Optional[Dict[str, float]] = None,
    ) -> None:
        if value is None:
            return  # run_record drops non-numeric values anyway; stay explicit
        entry: Dict[str, Any] = {
            "value": round(float(value), 6),
            "unit": unit,
            "kind": "slo",
            "threshold": threshold,
        }
        if spread is not None:
            entry["spread"] = spread
        configs[name] = entry

    # ------------------------------------------------------------- throughput
    throughput = result.get("updates_per_second")
    _row(
        rows,
        "update_throughput",
        throughput,
        spec.min_updates_per_second,
        "updates/sec",
        "min",
        detail=f"{result.get('batches_fed', 0)} batches over"
        f" {result.get('wall_seconds', 0)}s wall"
        f" ({result.get('sleep_seconds', 0)}s scheduled idle)",
    )
    # chaos throughput includes in-replay compiles, fault handling and scrape
    # load — runner-speed-dominated, so (like the time_to_* configs) the
    # recorded spread floor makes the ABSOLUTE SLO budget the sentinel's cap
    config(
        f"{prefix}_update_throughput",
        throughput,
        "updates/sec",
        spec.min_updates_per_second,
        spread={"min": spec.min_updates_per_second, "max": throughput, "reps": 1}
        if spec.min_updates_per_second is not None and throughput is not None
        else None,
    )

    # ---------------------------------------------------------- scrape latency
    for route in spec.scrape_routes:
        for q, bound, label in (
            (0.95, spec.max_scrape_p95_seconds, "p95"),
            (0.99, spec.max_scrape_p99_seconds, "p99"),
        ):
            estimate = _server_route_quantile(result, route, q)
            driver = ((result.get("scrapes") or {}).get("driver") or {}).get(route) or {}
            _row(
                rows,
                f"scrape_{label}_{_slug(route)}",
                estimate,
                bound,
                "s",
                "max",
                detail=(
                    f"server histogram estimate (bucket midpoint);"
                    f" driver-observed {label}:"
                    f" {driver.get(f'{label}_seconds')}"
                    if estimate is not None
                    else f"no server-side samples for {route}"
                ),
            )
            if estimate is not None:
                bucket = _quantile_bucket_bounds(result, route, q)
                config(
                    f"{prefix}_scrape_{label}_{_slug(route)}",
                    estimate * 1e6,
                    "us",
                    bound * 1e6 if bound is not None else None,
                    # the estimate's error bar is its bucket: the regression
                    # sentinel's spread cap absorbs one-bucket quantization
                    # hops without absorbing real multi-bucket regressions
                    spread={
                        "min": round(bucket[0] * 1e6, 3),
                        "max": round(bucket[1] * 1e6, 3),
                        "reps": 1,
                    }
                    if bucket is not None
                    else None,
                )

    # ------------------------------------------------- fault fire/resolve times
    kind_counts: Dict[str, int] = {}
    for fault in result.get("faults", []):
        kind = fault["fault"]
        kind_counts[kind] = kind_counts.get(kind, 0) + 1
        # a schedule may inject the same fault kind more than once: every
        # occurrence gets its own row/config (ordinal-suffixed past the
        # first) instead of the last silently overwriting the others
        name = kind if kind_counts[kind] == 1 else f"{kind}_{kind_counts[kind]}"
        episode, already_firing = _fault_episode(result, fault)
        if episode is None:
            _row(
                rows,
                f"time_to_fire_{name}",
                None,
                spec.max_time_to_fire_seconds,
                "s",
                "max",
                detail=f"alert {fault.get('rule')!r} never fired after the"
                f" {kind} fault on {fault.get('tenant')!r}",
            )
            _row(
                rows,
                f"time_to_resolve_{name}",
                None,
                spec.max_time_to_resolve_seconds,
                "s",
                "max",
                detail="nothing fired, so nothing could resolve",
            )
            continue
        # a fault landing while its watchdog is already raised was alerted
        # the whole time: time-to-fire is zero by definition, and recovery
        # is measured from this fault's injection
        anchor = fault["injected_at"] if already_firing else episode["fired_at"]
        # clamped at zero: the matching slack exists exactly because the
        # injection stamp and the catching evaluation can share an instant
        ttf = 0.0 if already_firing else max(0.0, episode["fired_at"] - fault["injected_at"])
        _row(
            rows,
            f"time_to_fire_{name}",
            round(ttf, 6),
            spec.max_time_to_fire_seconds,
            "s",
            "max",
            detail=(
                f"rule {fault.get('rule')!r} was already firing on"
                f" {episode.get('series')!r} when the fault landed"
                if already_firing
                else f"rule {fault.get('rule')!r} on {episode.get('series')!r}"
                f" fired {ttf:.3f}s after injection"
            ),
        )
        # wall-clock reaction times are scheduler-jitter-dominated (they
        # quantize to the alert-evaluation cadence), so history-relative
        # gating at 1.5x-of-best would flap on a loaded CI runner. The
        # recorded spread makes the ABSOLUTE SLO budget the sentinel's cap:
        # within budget any value is noise; beyond it the SLO row itself
        # fails and the strict slo_pass config regresses.
        config(
            f"{prefix}_time_to_fire_{name}",
            ttf,
            "s",
            spec.max_time_to_fire_seconds,
            spread={"min": 0.0, "max": spec.max_time_to_fire_seconds, "reps": 1}
            if spec.max_time_to_fire_seconds is not None
            else None,
        )
        if episode.get("resolved_at") is None:
            _row(
                rows,
                f"time_to_resolve_{name}",
                None,
                spec.max_time_to_resolve_seconds,
                "s",
                "max",
                detail=f"rule {fault.get('rule')!r} was still firing when the run ended",
            )
        else:
            ttr = episode["resolved_at"] - anchor
            _row(
                rows,
                f"time_to_resolve_{name}",
                round(ttr, 6),
                spec.max_time_to_resolve_seconds,
                "s",
                "max",
                detail=f"resolved {ttr:.3f}s after "
                + ("this fault's injection" if already_firing else "firing"),
            )
            config(
                f"{prefix}_time_to_resolve_{name}",
                ttr,
                "s",
                spec.max_time_to_resolve_seconds,
                spread={"min": 0.0, "max": spec.max_time_to_resolve_seconds, "reps": 1}
                if spec.max_time_to_resolve_seconds is not None
                else None,
            )

    # -------------------------------------------------- compiled-variant churn
    variants = (result.get("cost") or {}).get("compiled_variants")
    _row(
        rows,
        "compiled_variants",
        variants,
        spec.max_compiled_variants,
        "variants",
        "max",
        # the JAX package's wording, kept so both judges print the same report; in
        # the port the variants are captured CUDA graphs and the seconds their
        # capture (0.0 on the CPU route)
        detail=f"{(result.get('cost') or {}).get('compile_seconds', 0)}s total compile"
        " wall across the run's fresh XLA executables",
    )
    config(f"{prefix}_compiled_variants", variants, "variants", spec.max_compiled_variants)

    # ------------------------------------------------- flight-dump correctness
    expected = {
        (tenant, index)
        for tenant, indices in ((result.get("schedule") or {}).get("poisoned") or {}).items()
        for index in indices
        # the victim's NaN is CAUGHT by the value watchdog, not quarantined —
        # only guarded tenants owe a named-batch dump
        if tenant != (result.get("schedule") or {}).get("victim")
    }
    named = {
        (dump.get("tenant"), index)
        for dump in ((result.get("flight") or {}).get("dumps") or [])
        for index in dump.get("poisoned_batches", [])
    }
    missing = sorted(expected - named)
    if spec.require_poisoned_named:
        _row(
            rows,
            "flight_dump_names_poisoned",
            float(len(expected - named) == 0),
            1.0,
            "bool",
            "min",
            detail=(
                f"all {len(expected)} injected poisoned batch(es) named in dumps"
                if not missing
                else f"poisoned batches never named in any dump: {missing}"
            ),
        )

    # ------------------------------------------------ batch-lineage causality
    if spec.require_fault_causality:
        lineage = result.get("lineage") or {}
        causality_rows = lineage.get("poisoned") or []
        all_poisoned = {
            (tenant, index)
            for tenant, indices in ((result.get("schedule") or {}).get("poisoned") or {}).items()
            for index in indices
        }
        covered_rows = {(row.get("tenant"), row.get("index")) for row in causality_rows}
        unlinked = sorted(
            f"{row.get('tenant')}[{row.get('index')}]"
            for row in causality_rows
            if not row.get("linked")
        )
        unmeasured = sorted(all_poisoned - covered_rows)
        if not lineage.get("enabled"):
            value: Optional[float] = None
            detail = "replay result carries no batch-lineage section"
        else:
            value = float(not unlinked and not unmeasured)
            detail = (
                f"all {len(causality_rows)} injected NaN batch(es) resolve end-to-end:"
                " trace id → quarantine/flight dump (guarded) or alert firing (victim)"
                if value
                else f"unlinked poisoned batches: {unlinked}; unmeasured: {unmeasured}"
            )
        _row(rows, "fault_causality", value, 1.0, "bool", "min", detail=detail)

    # -------------------------------------------- cross-tenant fused dispatch
    if spec.require_multiplexed:
        mux = result.get("mux") or {}
        mux_report = mux.get("report") or {}
        fused = mux_report.get("fused_updates") or 0
        dispatches = mux_report.get("dispatches") or 0
        engaged = bool(fused) and bool(dispatches) and fused > dispatches
        _row(
            rows,
            "mux_engaged",
            float(engaged),
            1.0,
            "bool",
            "min",
            detail=(
                f"{fused} tenant-updates fused into {dispatches} dispatch(es),"
                f" peak width {mux_report.get('max_width')}"
                if mux
                else "replay result carries no multiplexer accounting"
            ),
        )
    if spec.require_quarantine_attributed:
        # isolation without dump evidence: exactly the tenants the schedule
        # poisoned (victim aside) show quarantines — no cohort bleed, no miss
        expected_tenants = sorted({tenant for tenant, _ in expected})
        quarantined = (result.get("robust") or {}).get("quarantined") or {}
        missed = [t for t in expected_tenants if not quarantined.get(t)]
        bled = sorted(set(quarantined) - set(expected_tenants))
        _row(
            rows,
            "quarantine_attributed",
            float(not missed and not bled),
            1.0,
            "bool",
            "min",
            detail=(
                f"quarantines on exactly {expected_tenants}"
                if not missed and not bled
                else f"missed poisoned tenants {missed}; cohort bleed onto {bled}"
            ),
        )

    # --------------------------------------------- live-session migration
    migration = result.get("migration") or {}
    if spec.require_migration_zero_loss:
        migrated = migration.get("tenants") or []
        controls = migration.get("controls") or {}
        identical = [t for t in migrated if (controls.get(t) or {}).get("bit_identical")]
        divergent = sorted(set(migrated) - set(identical))
        ok = bool(migrated) and not divergent
        _row(
            rows,
            "migration_zero_loss",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"all {len(migrated)} migrated session(s) computed bit-identical to"
                " their unmigrated controls"
                if ok
                else (
                    f"migrated sessions diverged from their controls: {divergent}"
                    if migrated
                    else "no tenants were migrated (the rolling deploy never happened)"
                )
            ),
        )
        config(f"{prefix}_migrated_tenants", float(len(migrated)), "tenants", None)
    if spec.require_migration_visible:
        named = migration.get("healthz_named_migrating")
        _row(
            rows,
            "migration_visible_degraded",
            float(bool(named)),
            1.0,
            "bool",
            "min",
            detail=(
                "mid-migration /healthz was degraded with the migrating tenant named"
                if named
                else "no mid-migration /healthz observation named the migrating tenant"
            ),
        )
    if spec.max_migration_seconds is not None:
        seconds = migration.get("migration_seconds")
        _row(
            rows,
            "migration_seconds",
            seconds,
            spec.max_migration_seconds,
            "s",
            "max",
            detail=f"{len(migration.get('tenants') or [])} session(s)"
            " drained, checkpointed, restored and tail-replayed",
        )
        # handoff wall time is dominated by bundle I/O + restore compiles on
        # the runner: like the time_to_* configs, the recorded spread makes
        # the ABSOLUTE SLO budget the sentinel's cap
        config(
            f"{prefix}_migration_seconds",
            seconds,
            "s",
            spec.max_migration_seconds,
            spread={"min": 0.0, "max": spec.max_migration_seconds, "reps": 1},
        )

    # --------------------------------------- crash-consistent checkpointing
    crash = result.get("crash") or {}
    if spec.max_replay_gap_batches is not None:
        gap = crash.get("replay_gap_batches")
        cadence = crash.get("cadence_batches")
        _row(
            rows,
            "replay_gap_batches",
            gap,
            float(spec.max_replay_gap_batches),
            "batches",
            "max",
            detail=(
                f"max over {len(crash.get('tenants') or [])} crashed session(s);"
                f" checkpoint cadence {cadence} batches, per-session gaps"
                f" {[s['replay_gap_batches'] for s in (crash.get('sessions') or {}).values()]}"
                if crash
                else "replay result carries no crash accounting"
            ),
        )
        # the gap quantizes to where the crash lands inside the cadence
        # window: any value inside the budget is schedule geometry, not a
        # regression — the recorded spread makes the absolute bound the cap
        config(
            f"{prefix}_replay_gap_batches",
            gap,
            "batches",
            float(spec.max_replay_gap_batches),
            spread={"min": 0.0, "max": float(spec.max_replay_gap_batches), "reps": 1},
        )
    if spec.require_crash_zero_loss:
        crashed = crash.get("tenants") or []
        crash_controls = crash.get("controls") or {}
        identical = [t for t in crashed if (crash_controls.get(t) or {}).get("bit_identical")]
        divergent = sorted(set(crashed) - set(identical))
        ok = bool(crashed) and not divergent and bool(crash.get("torn_bundle_skipped", True))
        _row(
            rows,
            "crash_zero_loss",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"all {len(crashed)} recovered session(s) computed bit-identical to"
                " their unkilled controls (torn mid-write bundle skipped)"
                if ok
                else (
                    f"recovered sessions diverged from their controls: {divergent}"
                    if crashed and divergent
                    else (
                        "the torn mid-write bundle was chosen as a restore point"
                        if crashed
                        else "no tenants were crashed (the host crash never happened)"
                    )
                )
            ),
        )
        config(f"{prefix}_crashed_tenants", float(len(crashed)), "tenants", None)
    if spec.max_recovery_seconds is not None:
        seconds = crash.get("recovery_seconds")
        _row(
            rows,
            "recovery_seconds",
            seconds,
            spec.max_recovery_seconds,
            "s",
            "max",
            detail=f"{len(crash.get('tenants') or [])} session(s) scanned,"
            " chain-verified, restored and gap-re-fed",
        )
        config(
            f"{prefix}_recovery_seconds",
            seconds,
            "s",
            spec.max_recovery_seconds,
            spread={"min": 0.0, "max": spec.max_recovery_seconds, "reps": 1},
        )
    if spec.max_delta_full_ratio is not None:
        checkpoints = crash.get("checkpoints") or {}
        ratio = checkpoints.get("delta_full_ratio")
        _row(
            rows,
            "delta_bundle_bytes_ratio",
            ratio,
            spec.max_delta_full_ratio,
            "ratio",
            "max",
            detail=(
                f"delta mean {checkpoints.get('delta_bytes_mean'):.0f}B over"
                f" {checkpoints.get('delta_bundles')} bundle(s) vs full mean"
                f" {checkpoints.get('full_bytes_mean'):.0f}B over"
                f" {checkpoints.get('full_bundles')} (checkpoint.bundle_bytes gauge)"
                if ratio is not None
                else "no full+delta bundle pair was written"
            ),
        )
        config(
            f"{prefix}_delta_bundle_bytes_ratio",
            ratio,
            "ratio",
            spec.max_delta_full_ratio,
            spread={"min": 0.0, "max": spec.max_delta_full_ratio, "reps": 1},
        )

    # --------------------------------------------------- hung-host fencing
    fence = result.get("fence") or {}
    if spec.max_time_to_detect_seconds is not None:
        seconds = fence.get("time_to_detect_seconds")
        _row(
            rows,
            "time_to_detect_seconds",
            seconds,
            spec.max_time_to_detect_seconds,
            "s",
            "max",
            detail=(
                f"max wedge-to-detection wall over {len(fence.get('tenants') or [])}"
                f" fenced session(s); lease TTL {fence.get('lease_seconds')}s,"
                " detection driven by the /metrics scrape loop"
                if fence
                else "replay result carries no fence accounting"
            ),
        )
        # detection lands wherever the next scrape tick falls after the lease
        # expires: any wall inside the budget is scrape cadence + scheduler
        # jitter, not a regression — the recorded spread makes the absolute
        # budget the regression sentinel's cap
        config(
            f"{prefix}_time_to_detect_seconds",
            seconds,
            "s",
            spec.max_time_to_detect_seconds,
            spread={"min": 0.0, "max": spec.max_time_to_detect_seconds, "reps": 1},
        )
    if spec.max_time_to_failover_seconds is not None:
        seconds = fence.get("time_to_failover_seconds")
        _row(
            rows,
            "time_to_failover_seconds",
            seconds,
            spec.max_time_to_failover_seconds,
            "s",
            "max",
            detail=f"{len(fence.get('tenants') or [])} session(s) fenced, restored"
            " elsewhere under a new epoch and gap-re-fed",
        )
        config(
            f"{prefix}_time_to_failover_seconds",
            seconds,
            "s",
            spec.max_time_to_failover_seconds,
            spread={"min": 0.0, "max": spec.max_time_to_failover_seconds, "reps": 1},
        )
    if spec.require_zombie_writes_rejected:
        zombie = fence.get("zombie") or {}
        ok = bool(
            zombie.get("landed")
            and int(zombie.get("rejected_count") or 0) >= 1
            and zombie.get("discarded")
        )
        _row(
            rows,
            "zombie_writes_rejected",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"zombie {zombie.get('tenant')!r} wrote {zombie.get('bundle')!r}"
                " post-fence; the recovery scan counted it rejected"
                f" ({zombie.get('rejected_count')}x) and selected"
                f" {zombie.get('selected')!r} instead"
                if ok
                else (
                    "the zombie's post-fence bundle write was not provably"
                    f" discarded: {zombie or 'no zombie accounting recorded'}"
                )
            ),
        )
    if spec.require_fence_zero_double_count:
        fenced = fence.get("tenants") or []
        fence_controls = fence.get("controls") or {}
        identical = [t for t in fenced if (fence_controls.get(t) or {}).get("bit_identical")]
        divergent = sorted(set(fenced) - set(identical))
        ok = bool(fenced) and not divergent and bool(fence.get("zero_double_count"))
        _row(
            rows,
            "fence_zero_double_count",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"all {len(fenced)} failed-over session(s) computed bit-identical"
                " to their never-hung controls (zombie contributed nothing past"
                " the fence, the successor missed nothing)"
                if ok
                else (
                    f"failed-over sessions diverged from their controls: {divergent}"
                    if fenced and divergent
                    else (
                        "double-count check did not pass"
                        if fenced
                        else "no tenants were fenced (the host never hung)"
                    )
                )
            ),
        )
        config(f"{prefix}_failed_over_tenants", float(len(fenced)), "tenants", None)
    if spec.require_fence_visible:
        ok = bool(fence.get("healthz_named_fenced")) and int(fence.get("leases_page_fences") or 0) >= 1
        _row(
            rows,
            "fence_visible_degraded",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                "/healthz went degraded-not-dead naming the fenced tenant and"
                f" failover target; /leases carried {fence.get('leases_page_fences')}"
                " fence ledger entr(ies)"
                if ok
                else (
                    f"fence visibility probes failed: healthz_named_fenced="
                    f"{fence.get('healthz_named_fenced')!r},"
                    f" leases_page_fences={fence.get('leases_page_fences')!r}"
                )
            ),
        )

    # ------------------------------------------------ fleet telemetry plane
    fleet = result.get("fleet") or {}
    if spec.max_time_to_detect_imbalance_seconds is not None:
        seconds = fleet.get("time_to_detect_imbalance_seconds")
        _row(
            rows,
            "time_to_detect_imbalance_seconds",
            seconds,
            spec.max_time_to_detect_imbalance_seconds,
            "s",
            "max",
            detail=(
                "skew onset (first batch under the hot placement) to the"
                " fleet_imbalance page's fired_at, derived from"
                f" {fleet.get('samples')} fleet sample(s) at"
                f" {fleet.get('cadence_seconds')}s cadence — the rule read"
                " only the fleet.imbalance gauge"
                if fleet
                else "replay result carries no fleet accounting"
            ),
        )
        # the page lands wherever dwell + the next sample + the next scrape
        # tick fall: any wall inside the budget is cadence + scheduler
        # jitter, not a regression — the recorded spread makes the absolute
        # budget the regression sentinel's cap
        config(
            f"{prefix}_time_to_detect_imbalance_seconds",
            seconds,
            "s",
            spec.max_time_to_detect_imbalance_seconds,
            spread={
                "min": 0.0,
                "max": spec.max_time_to_detect_imbalance_seconds,
                "reps": 1,
            },
        )
    if spec.require_fleet_served:
        probe = fleet.get("probe") or {}
        n_samples = int(((probe.get("sampler") or {}).get("samples")) or 0)
        has_rates = bool(
            any(
                (row or {}).get("updates_per_second") is not None
                for row in (probe.get("tenants") or {}).values()
            )
        )
        skew_block = probe.get("skew") or {}
        has_skew = skew_block.get("imbalance") is not None and bool(skew_block.get("hosts"))
        rebalance = probe.get("rebalance") or {}
        has_hints = bool(rebalance.get("advisory")) and "hints" in rebalance
        ok = bool(probe.get("enabled")) and n_samples >= 2 and has_rates and has_skew and has_hints
        _row(
            rows,
            "fleet_served",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"GET /fleet served the per-tenant rate table, the skew block"
                f" and {len(rebalance.get('hints') or [])} advisory rebalance"
                f" hint(s) from {n_samples} real samples"
                f" ({fleet.get('history_samples')} in /fleet/history)"
                if ok
                else (
                    "the /fleet probe did not serve a full report:"
                    f" enabled={probe.get('enabled')!r} samples={n_samples}"
                    f" rates={has_rates} skew={has_skew} hints={has_hints}"
                )
            ),
        )
        config(f"{prefix}_fleet_samples", float(fleet.get("samples") or 0), "samples", None)
    if spec.require_fleet_shift_tracked:
        shift = fleet.get("shift") or {}
        ok = bool(shift.get("hot_host_shifted")) and bool(fleet.get("alert_fired"))
        _row(
            rows,
            "fleet_shift_tracked",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                "the mid-run placement flip re-pointed the hot host"
                f" ({shift.get('hot_host_before')!r} →"
                f" {shift.get('hot_host_after')!r}) while the imbalance page"
                " stayed on the single unlabeled fleet.imbalance series"
                if ok
                else (
                    "hot-spot shift was not tracked:"
                    f" before={shift.get('hot_host_before')!r}"
                    f" after={shift.get('hot_host_after')!r}"
                    f" alert_fired={fleet.get('alert_fired')!r}"
                )
            ),
        )
    if spec.require_fleet_degraded_loud:
        wedged = (fleet.get("shift") or {}).get("wedged_sample") or {}
        ok = bool(wedged.get("degraded")) and bool(wedged.get("missing_hosts"))
        _row(
            rows,
            "fleet_degraded_loud",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                "the gather under a wedged 2-host fake degraded loudly in"
                f" {wedged.get('sample_seconds')}s — partial sample, hosts"
                f" {wedged.get('missing_hosts')} named missing — instead of"
                " stalling the sampler"
                if ok
                else f"no loud degraded sample recorded: {wedged or 'no wedged-sample evidence'}"
            ),
        )

    # ------------------------------------------- placement control plane
    placement = result.get("placement") or {}
    if spec.max_placement_convergence_seconds is not None:
        converged = bool(placement.get("converged"))
        seconds = placement.get("convergence_seconds") if converged else None
        _row(
            rows,
            "placement_convergence_seconds",
            seconds,
            spec.max_placement_convergence_seconds,
            "s",
            "max",
            detail=(
                f"the controller closed {placement.get('episodes_closed')}"
                " convergence episode(s); the last imbalance episode closed"
                f" {seconds}s after it opened, with"
                f" {placement.get('moves_completed')} move(s) completed over"
                f" the run and {placement.get('settle_sweeps')} settle"
                " sweep(s) past the schedule's end"
                if seconds is not None
                else (
                    "the run ended with the imbalance episode still open"
                    f" (episodes_closed={placement.get('episodes_closed')!r})"
                    if placement
                    else "replay result carries no placement accounting"
                )
            ),
        )
        # convergence lands wherever sampler cadence + reconcile cadence +
        # the moves' checkpoint/restore walls fall: any wall inside the
        # budget is cadence + scheduler jitter, not a regression — the
        # recorded spread makes the absolute budget the sentinel's cap
        config(
            f"{prefix}_placement_convergence_seconds",
            seconds,
            "s",
            spec.max_placement_convergence_seconds,
            spread={
                "min": 0.0,
                "max": spec.max_placement_convergence_seconds,
                "reps": 1,
            },
        )
    if spec.min_placement_moves is not None:
        moves = placement.get("moves_completed")
        _row(
            rows,
            "placement_moves_completed",
            None if moves is None else float(moves),
            float(spec.min_placement_moves),
            "moves",
            "min",
            detail=(
                f"{moves} controller-ordered drain→checkpoint→restore move(s)"
                f" completed, {placement.get('moves_failed')} failed,"
                f" {placement.get('post_shift_moves')} after the hot-spot"
                " shift"
                if moves is not None
                else "replay result carries no placement accounting"
            ),
        )
        config(f"{prefix}_placement_moves", None if moves is None else float(moves), "moves", None)
    if spec.require_placement_zero_loss:
        controls = placement.get("controls") or {}
        ok = bool(placement.get("zero_loss")) and bool(controls)
        _row(
            rows,
            "placement_zero_loss",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"all {len(controls)} moved session(s) computed BIT-identical"
                " to unmoved shadow controls fed the identical retained"
                f" stream: {sorted(controls)}"
                if ok
                else (
                    "moved sessions diverged from their shadow controls: "
                    + ", ".join(
                        f"{t} (restored={row.get('restored')!r},"
                        f" control={row.get('control')!r})"
                        for t, row in sorted(controls.items())
                        if not row.get("bit_identical")
                    )
                    if controls
                    else "no moved sessions to compare — a flash crowd the"
                    " controller never answered is a failed run"
                )
            ),
        )
    if spec.require_placement_served:
        probe = placement.get("probe") or {}
        has_table = bool(probe.get("assignments"))
        has_moves = isinstance(probe.get("moves"), dict)
        has_decisions = isinstance(probe.get("decisions"), list)
        has_convergence = isinstance(probe.get("convergence"), dict)
        ok = has_table and has_moves and has_decisions and has_convergence
        _row(
            rows,
            "placement_served",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"GET /placement served {len(probe.get('assignments') or {})}"
                f" assignment(s), the move ledger and"
                f" {len(probe.get('decisions') or [])} decision-log row(s)"
                " over real HTTP"
                if ok
                else (
                    "the /placement probe did not serve a full report:"
                    f" table={has_table} moves={has_moves}"
                    f" decisions={has_decisions} convergence={has_convergence}"
                )
            ),
        )
    if spec.require_placement_durable_restore:
        ok = bool(placement.get("restored_from_disk"))
        _row(
            rows,
            "placement_durable_restore",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                "the live controller reconstructed its assignment table from"
                " the durable schema-versioned state file a prior controller"
                " persisted — the restart path, not a fresh in-memory table"
                if ok
                else "the assignment table was not restored from disk"
            ),
        )
    if spec.require_placement_shift_move:
        n = int(placement.get("post_shift_moves") or 0)
        _row(
            rows,
            "placement_shift_move",
            float(n >= 1),
            1.0,
            "bool",
            "min",
            detail=(
                f"{n} clean move(s) landed after the schedule's hot-spot"
                " shift — the controller re-converged on the NEW skew, it"
                " did not just ride out its first table"
                if n >= 1
                else "no clean move landed after the hot-spot shift"
            ),
        )
    if spec.min_placement_throughput_ratio is not None:
        # feed-rate ratio with each arm's measured compile (capture) wall and
        # scheduled idle excluded from its own denominator. Every restore a
        # move performs mints a fresh compiled program, so on a cold-cache
        # harness raw wall-clock charges the controller for compile time the
        # compiled_variants SLO already measures and caps separately — the
        # ratio judges the steady-state serving rate, not compile churn
        def _adjusted_rate(sample: Optional[Dict[str, Any]]) -> Optional[float]:
            if not sample:
                return None
            batches = sample.get("batches_fed")
            wall = sample.get("wall_seconds")
            if batches is None or wall is None:
                return None
            active = (
                float(wall)
                - float(sample.get("sleep_seconds") or 0.0)
                - float(sample.get("compile_seconds") or 0.0)
            )
            if active <= 0:
                return None
            return float(batches) / active

        control_sample = placement.get("control_arm") or {}
        control_arm = placement.get("control_arm_updates_per_second")
        live = result.get("updates_per_second")
        live_adjusted = _adjusted_rate(
            {
                "batches_fed": result.get("batches_fed"),
                "wall_seconds": result.get("wall_seconds"),
                "sleep_seconds": result.get("sleep_seconds"),
                "compile_seconds": (result.get("cost") or {}).get(
                    "compile_seconds"
                ),
            }
        )
        control_adjusted = _adjusted_rate(control_sample)
        if live_adjusted is not None and control_adjusted:
            ratio = live_adjusted / control_adjusted
        elif live is not None and control_arm:
            # older payloads carry only the raw scalar — fall back honestly
            ratio = float(live) / float(control_arm)
        else:
            ratio = None
        _row(
            rows,
            "placement_throughput_ratio",
            ratio,
            spec.min_placement_throughput_ratio,
            "ratio",
            "min",
            detail=(
                f"{round(live_adjusted, 3) if live_adjusted is not None else live}"
                " updates/s under the live controller vs"
                f" {round(control_adjusted, 3) if control_adjusted else control_arm}"
                " updates/s for the static-placement control arm (same"
                " schedule, controller off), both net of measured compile"
                " wall + scheduled idle — the floor proves the controller"
                " does not COST meaningful serving throughput; same-host"
                " virtual moves cannot prove it ADDS any, and compile churn"
                " is judged separately by compiled_variants"
                if ratio is not None
                else "no control-arm throughput recorded (run the scenario"
                " through bench.py --chaos, which replays the control arm"
                " first)"
            ),
        )
        config(
            f"{prefix}_placement_throughput_ratio",
            ratio,
            "ratio",
            spec.min_placement_throughput_ratio,
            spread={
                "min": spec.min_placement_throughput_ratio,
                "max": ratio,
                "reps": 1,
            }
            if ratio is not None
            else None,
        )

    # ------------------------------------------------- conservation audit
    if spec.require_accounting_clean:
        audit = result.get("audit") or {}
        violations = audit.get("violations") or []
        ok = (
            bool(audit.get("enabled"))
            and int(audit.get("ticks") or 0) >= 1
            and not violations
        )
        _row(
            rows,
            "accounting_clean",
            float(ok),
            1.0,
            "bool",
            "min",
            detail=(
                f"the conservation auditor balanced every flow ledger over"
                f" {audit.get('ticks')} tick(s) across {audit.get('sessions')}"
                " session(s): zero violations"
                + (
                    " (honest-approximate: lineage records evicted)"
                    if audit.get("approximate")
                    else ""
                )
                if ok
                else (
                    "conservation violations: "
                    + "; ".join(
                        f"{v.get('invariant')} [tenant {v.get('tenant')}"
                        + (
                            f", trace {v.get('trace_id')}"
                            if v.get("trace_id")
                            else ""
                        )
                        + f"]: {v.get('detail')}"
                        for v in violations[:5]
                    )
                    if violations
                    else (
                        "no audit evidence recorded:"
                        f" {audit or 'audit plane was off'}"
                    )
                )
            ),
        )
        config(
            f"{prefix}_audit_violations", float(len(violations)), "violations", None
        )

    failed = [row["slo"] for row in rows if not row["passed"]]
    passed = not failed
    config(f"{prefix}_slo_pass", 1.0 if passed else 0.0, "slo_pass", 1.0)
    return {
        "passed": passed,
        "n_slos": len(rows),
        "failed": failed,
        "slos": rows,
        "spec": spec.asdict(),
        "configs": configs,
    }


def format_report(report: Dict[str, Any]) -> str:
    """Aligned human-readable SLO table (the chaos analog of regress tables)."""
    rows = report.get("slos", [])
    header = "== chaos SLO report =="
    if not rows:
        return header + "\n  (no SLOs judged)\n"
    width = max(len(r["slo"]) for r in rows)
    lines = [header]
    for row in rows:
        verdict = "ok" if row["passed"] else "FAILED"
        value = "n/a" if row["value"] is None else f"{row['value']:g}"
        bound = "-" if row["threshold"] is None else f"{row['threshold']:g}"
        op = "<=" if row["direction"] == "max" else ">="
        lines.append(
            f"  {row['slo']:<{width}}  {verdict:<7} value={value} {op} {bound}"
            f" {row['unit']}  {row['detail']}"
        )
    n_bad = len(report.get("failed", []))
    lines.append(
        f"-- {'PASS' if report.get('passed') else 'FAIL'}:"
        f" {n_bad} failure(s) across {len(rows)} SLO(s) --"
    )
    return "\n".join(lines) + "\n"
