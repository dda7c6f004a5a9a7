"""Fleet telemetry plane: continuous cross-host sampling, rates, skew.

Counterpart of ``torchmetrics_tpu/obs/fleet.py``: the same sampler, derivations,
payloads and ``fleet.*`` gauge families. A host is a ``torch.distributed`` rank
(process index), or a virtual host of ``placement=`` in one process.

:mod:`~torchmetrics_tpu_torch.obs.aggregate` merges host snapshots *on demand*, and
everything it reports is a lifetime counter — no rates, no history, no trend.
This module closes that gap with a :class:`FleetSampler` that

- periodically gathers every host's snapshot over the guarded collective seam
  (:func:`~torchmetrics_tpu_torch.obs.aggregate.gather_snapshots` under the
  configured ``robust.sync_guard`` — a hung host yields a LOUD degraded
  sample with ``missing_hosts``, never a stall),
- retains a bounded drop-oldest ring of compact timestamped samples
  (:func:`~torchmetrics_tpu_torch.obs.aggregate.fleet_sample`), and
- derives what lifetime counters cannot give: per-tenant and per-host
  **rates** (updates/sec, computes/sec, cost-ledger flop/byte burn per
  second, checkpoint-bytes/sec) and **skew signals** (per-host load share,
  max/min host ratio, a normalized imbalance coefficient, the top-K hottest
  tenants per host), exported as ``fleet.*`` gauges through the ordinary
  recorder → Prometheus/snapshot/Perfetto path.

Driving the sampler follows the fence-watchdog pattern exactly: install the
process singleton with :func:`install_sampler` and every ``/metrics`` scrape
ticks it (:meth:`FleetSampler.tick` respects the cadence), or call
:meth:`FleetSampler.start` for a background daemon thread, or call
:meth:`FleetSampler.sample` yourself with an injectable clock for
deterministic tests. :func:`imbalance_rule` is the declarative AlertRule
preset over the ``fleet.imbalance`` gauge, so sustained skew fires through
the standard pending→firing machinery and flips ``/healthz``
degraded-not-dead (the server joins the hot host's name into the reason).

Rates come from **consecutive-sample deltas**, not lifetime counters: a
counter that has been climbing for six hours says nothing about what is
burning *now*, and a restarted host's counter reset would read as negative
burn — deltas are clamped at zero instead. The derivation window is
therefore exactly the sampling cadence (``rates(window=...)`` widens it).

Single-process worlds sample the local snapshot with no collective. For
single-process harnesses that *model* a fleet (``chip_smoke.py``'s
``fleet_eval``, the serve CLI's ``--demo``), ``placement=`` maps tenants onto
virtual hosts so per-host shares and skew derive from the measured per-tenant
rates under that placement. Name the virtual hosts by process index ("0",
"1", ...): the cost ledger's burn rows are keyed by the real process index, and
a virtual host named otherwise stands beside a phantom host "0" in the skew.

Pure stdlib; every collective stays behind the aggregate seam.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torchmetrics_tpu_torch.obs.trace as trace
from torchmetrics_tpu_torch.obs import aggregate as _aggregate
from torchmetrics_tpu_torch.obs.alerts import AlertRule

__all__ = [
    "DEFAULT_CADENCE_SECONDS",
    "DEFAULT_IMBALANCE_THRESHOLD",
    "FleetSampler",
    "get_sampler",
    "imbalance_rule",
    "install_sampler",
]

DEFAULT_CADENCE_SECONDS = 5.0
DEFAULT_RING = 256
DEFAULT_TOP_K = 3
# imbalance is normalized to [0, 1]: 0 = every host carries an equal share,
# 1 = one host carries everything. 0.5 ≈ the hottest host carrying half the
# fleet's headroom above its fair share — sustained, that is a paging signal.
DEFAULT_IMBALANCE_THRESHOLD = 0.5


def imbalance_rule(
    above: float = DEFAULT_IMBALANCE_THRESHOLD,
    for_seconds: float = 2.0,
    severity: str = "page",
) -> AlertRule:
    """The declarative sustained-skew watchdog over ``fleet.imbalance``.

    A plain threshold rule: the normalized imbalance coefficient staying
    ``above`` the limit for ``for_seconds`` walks pending→firing through the
    standard machinery, flips ``/healthz`` degraded-not-dead, and resolves
    itself when the fleet rebalances. Install it like any other rule
    (``alerts.configure(fleet.imbalance_rule(), ...)``).
    """
    return AlertRule(
        name="fleet_imbalance",
        kind="threshold",
        series="fleet.imbalance",
        above=float(above),
        for_seconds=float(for_seconds),
        severity=severity,
    )


class FleetSampler:
    """Continuous cross-host sampling with a bounded drop-oldest sample ring.

    Args:
        cadence_seconds: target seconds between samples (``tick`` honors it;
            the daemon thread sleeps it).
        ring: sample-ring capacity; the oldest sample drops when full.
        top_k: hottest tenants listed per host in the skew block.
        recorder: the :class:`~torchmetrics_tpu_torch.obs.trace.TraceRecorder` the
            ``fleet.*`` gauges land in (default: the process-global one).
        placement: optional ``{tenant: host_name}`` map for single-process
            harnesses modeling a fleet — per-host shares and skew then group
            measured per-tenant rates by this static placement instead of by
            real process indices.
        hosts: optional explicit host universe. Rate tables only contain
            hosts that carried load, so a fully idle provisioned host is
            invisible to them — and a fleet concentrated on one host would
            read as a single-host fleet with nothing to balance. Naming the
            provisioned hosts pads :meth:`skew` (and therefore
            :meth:`rebalance_hints` and the ``fleet.imbalance`` gauge) with
            zero-load entries for the idle ones, so concentration on one of
            two provisioned hosts reads as imbalance 1.0, not 0.0.
        clock: monotonic clock rate deltas divide by (injectable).
        wall: wall clock for display stamps (injectable).
    """

    def __init__(
        self,
        cadence_seconds: float = DEFAULT_CADENCE_SECONDS,
        ring: int = DEFAULT_RING,
        top_k: int = DEFAULT_TOP_K,
        recorder: Optional[trace.TraceRecorder] = None,
        placement: Optional[Mapping[str, str]] = None,
        hosts: Optional[Sequence[str]] = None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        description: str = "fleet sample",
    ) -> None:
        if cadence_seconds <= 0:
            raise ValueError(f"Expected `cadence_seconds` > 0, got {cadence_seconds}")
        if ring < 2:
            raise ValueError(f"Expected `ring` >= 2 (rates need two samples), got {ring}")
        self.cadence_seconds = float(cadence_seconds)
        self.top_k = max(1, int(top_k))
        self.placement = dict(placement) if placement else None
        self.hosts = tuple(dict.fromkeys(str(h) for h in hosts)) if hosts else None
        self.description = description
        self._recorder = recorder
        self._clock = clock
        self._wall = wall
        self._ring: deque = deque(maxlen=int(ring))
        self._lock = threading.RLock()
        # one gather (a collective!) in flight at a time: concurrent scrape
        # ticks must coalesce, not pile collectives onto a wedged guard
        self._gather_lock = threading.Lock()
        self._last_merged: Optional[Dict[str, Any]] = None
        self._samples_taken = 0
        self._degraded_samples = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- sampling

    def _rec(self) -> trace.TraceRecorder:
        return self._recorder if self._recorder is not None else trace.get_recorder()

    def sample(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Take one fleet sample NOW: gather, merge, derive, export gauges.

        In a multi-host world this is a collective — every rank must call it
        (the scrape ticks and the daemon thread run per process, so each rank
        supplies its own side). A hung peer degrades the sample
        loudly (``degraded=True`` + ``missing_hosts``) under the configured
        ``sync_guard`` instead of stalling. Returns the appended sample.
        """
        with self._gather_lock:
            return self._sample_locked(now)

    def _sample_locked(self, now: Optional[float]) -> Dict[str, Any]:
        """One sample with ``_gather_lock`` held from the gather to the append, so
        that samples enter the ring in the order of their clock stamps: a stamp
        taken before another thread's whole sample would otherwise land after it,
        and the ring's two newest samples would span a negative window (no rates,
        no skew until the next sample)."""
        rec = self._rec()
        # refresh the burn numerators this host contributes before the gather:
        # the cost ledger's cumulative flop/byte estimates live as gauges only
        # after an explicit record_gauges (scrape-time refresh pattern)
        from torchmetrics_tpu_torch.obs import cost as _cost

        _cost.record_gauges(recorder=rec)
        merged = _aggregate.aggregate(
            recorder=rec, include_events=False, description=self.description
        )
        mono = float(now if now is not None else self._clock())
        sample = _aggregate.fleet_sample(merged, unix=self._wall(), mono=mono)
        with self._lock:
            self._ring.append(sample)
            self._last_merged = merged
            self._samples_taken += 1
            if sample["degraded"]:
                self._degraded_samples += 1
        self.record_gauges(recorder=rec, now=mono)
        return sample

    def tick(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Sample iff the cadence elapsed since the newest sample.

        The synchronous path: wire it into the ``/metrics`` render chain
        (the fence-watchdog pattern) and scrape traffic keeps the ring warm
        with no thread at all. Returns the new sample, or ``None`` when the
        cadence has not elapsed or another gather is already in flight.
        """
        if not self._gather_lock.acquire(blocking=False):
            return None  # a concurrent scrape is already mid-gather
        try:
            # stamped with the gather lock held: no other sample can land
            # between this stamp and this sample's append
            mono = float(now if now is not None else self._clock())
            with self._lock:
                if self._ring and mono - self._ring[-1]["mono"] < self.cadence_seconds:
                    return None
            return self._sample_locked(mono)
        finally:
            self._gather_lock.release()

    def start(self) -> "FleetSampler":
        """Start the background daemon sampling thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tm-tpu-fleet-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the daemon thread (no-op when never started)."""
        thread = self._thread
        self._stop.set()
        if thread is not None:
            thread.join(timeout=timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception:  # noqa: BLE001 - the sampler must outlive one bad tick
                with self._lock:
                    self._degraded_samples += 1
            if self._stop.wait(self.cadence_seconds):
                return

    @property
    def started(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def ring(self) -> int:
        """The ring capacity (drop-oldest bound on retained samples)."""
        return int(self._ring.maxlen or 0)

    @property
    def samples_taken(self) -> int:
        """Lifetime sample count (monotonic; the ring only keeps the newest)."""
        with self._lock:
            return self._samples_taken

    @property
    def degraded_samples(self) -> int:
        """Lifetime count of degraded (partial/failed-gather) samples."""
        with self._lock:
            return self._degraded_samples

    # ------------------------------------------------------------ derivation

    def _host_of(self, tenant: str, fallback: str) -> str:
        if self.placement is not None:
            return str(self.placement.get(tenant, fallback))
        return fallback

    def rates(self, window: Optional[float] = None) -> Dict[str, Any]:
        """Per-tenant / per-host / total rates from the two newest samples.

        Deltas are clamped at zero (a restarted host's counter reset must not
        read as negative burn); the window is the real monotonic gap between
        the samples. With fewer than two samples every table is empty and
        ``window_seconds`` is ``None``.

        ``window`` widens the delta base: the oldest retained sample within
        ``window`` seconds of the newest, instead of the immediately
        preceding one. Adjacent-sample rates are exact but twitchy — one
        quiet tick reads as a rate collapse and can momentarily crown the
        wrong hot host — so trend consumers (the hot-spot tracker, shift
        verdicts) smooth over a few cadences while the gauges stay
        instantaneous.
        """
        with self._lock:
            retained = len(self._ring)
            samples = list(self._ring)
        if window is not None and len(samples) >= 2:
            newest = samples[-1]
            eligible = [s for s in samples[:-1] if newest["mono"] - s["mono"] <= window]
            samples = [eligible[0] if eligible else samples[-2], newest]
        else:
            samples = samples[-2:]
        out: Dict[str, Any] = {
            "samples": retained,
            "window_seconds": None,
            "tenants": {},
            "hosts": {},
            "total": {},
        }
        if len(samples) < 2:
            return out
        old, new = samples
        dt = new["mono"] - old["mono"]
        if dt <= 0:
            return out
        out["window_seconds"] = dt

        def delta(a: float, b: float) -> float:
            return max(0.0, float(b) - float(a)) / dt

        hosts: Dict[str, Dict[str, float]] = {}
        tenants: Dict[str, Dict[str, Any]] = {}
        old_tenants = old.get("tenants") or {}
        for tenant, row in (new.get("tenants") or {}).items():
            prev = old_tenants.get(tenant) or {}
            updates = delta(prev.get("updates", 0), row.get("updates", 0))
            computes = delta(prev.get("computes", 0), row.get("computes", 0))
            ckpt_prev = (old.get("checkpoint") or {}).get("per_tenant", {}).get(tenant, 0.0)
            ckpt_new = (new.get("checkpoint") or {}).get("per_tenant", {}).get(tenant, 0.0)
            ckpt = delta(ckpt_prev, ckpt_new)
            # host attribution: the static placement map when modeling a
            # fleet in one process, else the real per-host deltas
            if self.placement is not None:
                real = sorted((row.get("per_host") or {}).keys()) or ["0"]
                host_rates = {self._host_of(tenant, real[0]): updates}
            else:
                host_rates = {}
                prev_hosts = prev.get("per_host") or {}
                for host, sub in (row.get("per_host") or {}).items():
                    prev_sub = prev_hosts.get(host) or {}
                    host_rates[host] = delta(
                        prev_sub.get("updates", 0), sub.get("updates", 0)
                    )
                if not host_rates and updates:
                    host_rates = {"0": updates}
            tenants[tenant] = {
                "updates_per_second": updates,
                "computes_per_second": computes,
                "checkpoint_bytes_per_second": ckpt,
                "hosts": sorted(host_rates),
            }
            for host, rate in host_rates.items():
                row_h = hosts.setdefault(
                    host,
                    {"updates_per_second": 0.0, "computes_per_second": 0.0},
                )
                row_h["updates_per_second"] += rate
                # computes attribute proportionally to the update split when a
                # tenant spans hosts; with one host per tenant this is exact
                share = rate / updates if updates else 1.0 / max(1, len(host_rates))
                row_h["computes_per_second"] += computes * share
        # cost-ledger burn: per REAL host (the ledger is per metric class, so
        # a virtual placement cannot split it) plus the fleet total
        old_cost = old.get("cost") or {}
        new_cost = new.get("cost") or {}
        for host, sub in (new_cost.get("per_host") or {}).items():
            prev_sub = (old_cost.get("per_host") or {}).get(host) or {}
            row_h = hosts.setdefault(
                host, {"updates_per_second": 0.0, "computes_per_second": 0.0}
            )
            row_h["flops_per_second"] = delta(prev_sub.get("flops", 0.0), sub.get("flops", 0.0))
            row_h["bytes_per_second"] = delta(prev_sub.get("bytes", 0.0), sub.get("bytes", 0.0))
        out["tenants"] = tenants
        out["hosts"] = hosts
        out["total"] = {
            "updates_per_second": sum(t["updates_per_second"] for t in tenants.values()),
            "computes_per_second": sum(t["computes_per_second"] for t in tenants.values()),
            "flop_burn_per_second": delta(old_cost.get("flops", 0.0), new_cost.get("flops", 0.0)),
            "byte_burn_per_second": delta(old_cost.get("bytes", 0.0), new_cost.get("bytes", 0.0)),
            "checkpoint_bytes_per_second": delta(
                (old.get("checkpoint") or {}).get("bytes", 0.0),
                (new.get("checkpoint") or {}).get("bytes", 0.0),
            ),
        }
        return out

    def skew(
        self,
        rates: Optional[Dict[str, Any]] = None,
        window: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Skew signals from the per-host rate table.

        ``imbalance`` is normalized to [0, 1]: ``(max_share - 1/H) / (1 -
        1/H)`` over ``H`` hosts — 0 when every host carries an equal share, 1
        when one host carries everything, and 0 for an idle or single-host
        fleet (nothing to balance). ``max_min_ratio`` is ``None`` when the
        coldest host is fully idle (the ratio would be unbounded; the
        imbalance coefficient already saturates there). ``window`` is passed
        through to :meth:`rates` when no precomputed table is given.
        """
        rates = self.rates(window=window) if rates is None else rates
        hosts = rates.get("hosts") or {}
        loads = {host: float(row.get("updates_per_second", 0.0)) for host, row in hosts.items()}
        if self.hosts is not None and loads:
            # provisioned-but-idle hosts carried no load, so the rate table
            # never mentions them — pad them in at zero or concentration on
            # one provisioned host reads as a balanced single-host fleet
            for host in self.hosts:
                loads.setdefault(host, 0.0)
        total = sum(loads.values())
        n = len(loads)
        out: Dict[str, Any] = {
            "hosts": {},
            "imbalance": 0.0,
            "max_min_ratio": None,
            "hot_host": None,
            "cold_host": None,
            "top_tenants": {},
        }
        if not n:
            return out
        shares = {
            host: (load / total if total > 0 else 1.0 / n) for host, load in loads.items()
        }
        out["hosts"] = {
            host: {"updates_per_second": loads[host], "share": shares[host]}
            for host in sorted(loads)
        }
        hot = max(shares, key=lambda h: (shares[h], h))
        cold = min(shares, key=lambda h: (shares[h], h))
        out["hot_host"] = hot
        out["cold_host"] = cold
        if n > 1 and total > 0:
            out["imbalance"] = max(0.0, (shares[hot] - 1.0 / n) / (1.0 - 1.0 / n))
            if loads[cold] > 0:
                out["max_min_ratio"] = loads[hot] / loads[cold]
        # top-K hottest tenants per host (measured update rate, descending)
        per_host_tenants: Dict[str, List] = {}
        for tenant, row in (rates.get("tenants") or {}).items():
            for host in row.get("hosts") or []:
                per_host_tenants.setdefault(host, []).append(
                    {"tenant": tenant, "updates_per_second": row["updates_per_second"]}
                )
        out["top_tenants"] = {
            host: sorted(
                rows, key=lambda r: (-r["updates_per_second"], r["tenant"])
            )[: self.top_k]
            for host, rows in sorted(per_host_tenants.items())
        }
        return out

    def rebalance_hints(
        self,
        rates: Optional[Dict[str, Any]] = None,
        skew: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """ADVISORY ranked tenant→host candidate moves scored from measured burn.

        Each hint projects the imbalance coefficient after moving one hot-host
        tenant to the coldest host; hints are ranked best-projection first.
        Purely advisory — nothing here executes a move (that is the future
        placement controller's job); every payload says so explicitly.
        """
        rates = self.rates() if rates is None else rates
        skew = self.skew(rates) if skew is None else skew
        out: Dict[str, Any] = {
            "advisory": True,
            "note": "ranked candidate moves scored from measured burn;"
            " nothing is executed — placement stays operator-controlled",
            "hints": [],
        }
        hot, cold = skew.get("hot_host"), skew.get("cold_host")
        if hot is None or cold is None or hot == cold:
            return out
        loads = {
            host: float(row.get("updates_per_second", 0.0))
            for host, row in (skew.get("hosts") or {}).items()
        }
        total = sum(loads.values())
        n = len(loads)
        if total <= 0 or n < 2:
            return out

        def coefficient(host_loads: Dict[str, float]) -> float:
            top = max(host_loads.values())
            return max(0.0, (top / total - 1.0 / n) / (1.0 - 1.0 / n))

        current = coefficient(loads)
        # a tenant mid-migration or fenced is not movable advice: its state is
        # in flight (or its session is a zombie awaiting failover), and a
        # controller acting on the hint would double-drain it — the hint
        # ranking must join the control-plane busy set, not just the rates
        from torchmetrics_tpu_torch.obs import scope as _scope

        busy = set(_scope.migrating_tenants()) | set(_scope.fenced_tenants())
        hints = []
        for tenant, row in (rates.get("tenants") or {}).items():
            if tenant in busy:
                continue
            if hot not in (row.get("hosts") or []):
                continue
            rate = float(row.get("updates_per_second", 0.0))
            if rate <= 0:
                continue
            moved = dict(loads)
            moved[hot] -= rate
            moved[cold] += rate
            # a counterproductive move (the whole hot load just flips hosts)
            # is not advice — only strictly improving projections rank
            if coefficient(moved) >= current:
                continue
            hints.append(
                {
                    "tenant": tenant,
                    "from": hot,
                    "to": cold,
                    "updates_per_second": rate,
                    "load_share_moved": rate / total,
                    "projected_imbalance": coefficient(moved),
                    "advisory": True,
                }
            )
        hints.sort(key=lambda h: (h["projected_imbalance"], -h["updates_per_second"], h["tenant"]))
        out["hints"] = hints[: self.top_k]
        return out

    # -------------------------------------------------------------- exports

    def record_gauges(
        self,
        recorder: Optional[trace.TraceRecorder] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Write the ``fleet.*`` gauge families into the recorder.

        Totals and per-host gauges are deliberately unlabeled/host-labeled
        with ``tenant=None`` (the scope-tag opt-out); per-tenant rate gauges
        carry the tenant label. Returns a small summary dict.
        """
        rec = recorder if recorder is not None else self._rec()
        mono = float(now if now is not None else self._clock())
        with self._lock:
            latest = self._ring[-1] if self._ring else None
            n_samples = len(self._ring)
            degraded_samples = self._degraded_samples
        if latest is None:
            return {"samples": 0}
        rates = self.rates()
        skew = self.skew(rates)
        rec.set_gauge("fleet.hosts", float(latest["n_hosts"]), tenant=None)
        rec.set_gauge("fleet.missing_hosts", float(len(latest["missing_hosts"])), tenant=None)
        rec.set_gauge("fleet.degraded", 1.0 if latest["degraded"] else 0.0, tenant=None)
        rec.set_gauge("fleet.samples", float(n_samples), tenant=None)
        rec.set_gauge("fleet.degraded_samples", float(degraded_samples), tenant=None)
        rec.set_gauge(
            "fleet.sample_age_seconds", max(0.0, mono - latest["mono"]), tenant=None
        )
        rec.set_gauge("fleet.imbalance", float(skew["imbalance"]), tenant=None)
        if skew["max_min_ratio"] is not None:
            rec.set_gauge("fleet.host_ratio", float(skew["max_min_ratio"]), tenant=None)
        for host, row in skew["hosts"].items():
            rec.set_gauge("fleet.host_load_share", row["share"], host=host, tenant=None)
            rec.set_gauge(
                "fleet.host_updates_per_second",
                row["updates_per_second"],
                host=host,
                tenant=None,
            )
        total = rates.get("total") or {}
        for name, field in (
            ("fleet.updates_per_second", "updates_per_second"),
            ("fleet.computes_per_second", "computes_per_second"),
            ("fleet.flop_burn_per_second", "flop_burn_per_second"),
            ("fleet.byte_burn_per_second", "byte_burn_per_second"),
            ("fleet.checkpoint_bytes_per_second", "checkpoint_bytes_per_second"),
        ):
            if field in total:
                rec.set_gauge(name, float(total[field]), tenant=None)
        for tenant, row in (rates.get("tenants") or {}).items():
            rec.set_gauge(
                "fleet.updates_per_second", row["updates_per_second"], tenant=tenant
            )
            rec.set_gauge(
                "fleet.computes_per_second", row["computes_per_second"], tenant=tenant
            )
            if row.get("checkpoint_bytes_per_second"):
                rec.set_gauge(
                    "fleet.checkpoint_bytes_per_second",
                    row["checkpoint_bytes_per_second"],
                    tenant=tenant,
                )
        return {
            "samples": n_samples,
            "hosts": len(skew["hosts"]),
            "tenants": len(rates.get("tenants") or {}),
            "imbalance": skew["imbalance"],
        }

    # --------------------------------------------------------------- serving

    def current(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """The ``GET /fleet`` payload: merged view + rates + skew + hints.

        Per-host rows join the control-plane liveness each host shipped with
        its snapshot (lease/fence/checkpoint freshness) and the fleet alerts
        naming that host. ``tenant=`` filters the per-tenant tables (the
        server 404s unknown tenants before calling in).
        """
        with self._lock:
            latest = self._ring[-1] if self._ring else None
            merged = self._last_merged
            n_samples = len(self._ring)
            degraded_samples = self._degraded_samples
        rates = self.rates()
        skew = self.skew(rates)
        hints = self.rebalance_hints(rates, skew)
        host_rows: List[Dict[str, Any]] = []
        if merged is not None:
            alert_hosts: Dict[int, List[str]] = {}
            for alert in merged.get("alerts", ()):
                if alert.get("state") != "firing":
                    continue
                for pidx in alert.get("hosts", ()):
                    alert_hosts.setdefault(int(pidx), []).append(str(alert.get("rule")))
            for row in merged.get("hosts", ()):
                pidx = int(row.get("process_index", 0))
                status = row.get("scope_status") or {}
                checkpoints = status.get("checkpoints") or {}
                host_row = {
                    "process_index": pidx,
                    "host_id": row.get("host_id"),
                    "leases": status.get("leases") or {},
                    "fences": status.get("fences") or {},
                    "checkpoint_freshness": {
                        t: {
                            "last_unix": c.get("last_unix"),
                            "stale_after_seconds": c.get("stale_after_seconds"),
                            "closed": bool(c.get("closed")),
                        }
                        for t, c in checkpoints.items()
                    },
                    "alerts_firing": sorted(set(alert_hosts.get(pidx, []))),
                }
                share_row = skew["hosts"].get(str(pidx))
                if share_row is not None:
                    host_row["load_share"] = share_row["share"]
                    host_row["updates_per_second"] = share_row["updates_per_second"]
                host_rows.append(host_row)
        tenants = rates.get("tenants") or {}
        if tenant is not None:
            tenants = {t: row for t, row in tenants.items() if t == tenant}
            hints = dict(hints)
            hints["hints"] = [h for h in hints["hints"] if h["tenant"] == tenant]
        return {
            "sampler": {
                "cadence_seconds": self.cadence_seconds,
                "ring": self._ring.maxlen,
                "samples": n_samples,
                "degraded_samples": degraded_samples,
                "started": self.started,
                "placement": self.placement,
                "last_sample_unix": latest["unix"] if latest else None,
                "degraded": bool(latest and latest["degraded"]),
                "missing_hosts": list(latest["missing_hosts"]) if latest else [],
            },
            "window_seconds": rates.get("window_seconds"),
            "hosts": host_rows,
            "tenants": tenants,
            "total": rates.get("total") or {},
            "skew": skew,
            "rebalance": hints,
        }

    def history(
        self, window: Optional[float] = None, tenant: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """Bounded sample history, oldest first (``GET /fleet/history``).

        ``window`` keeps only samples within that many seconds of the newest
        (monotonic stamps); ``tenant`` narrows each sample's tenant table.
        """
        with self._lock:
            samples = list(self._ring)
        if window is not None and samples:
            horizon = samples[-1]["mono"] - float(window)
            samples = [s for s in samples if s["mono"] >= horizon]
        if tenant is not None:
            samples = [
                {**s, "tenants": {t: r for t, r in (s.get("tenants") or {}).items() if t == tenant}}
                for s in samples
            ]
        return [dict(s) for s in samples]


# ------------------------------------------------------------ module singleton

# the process singleton the /metrics render chain ticks and /fleet serves —
# the robust/fence.py install_watchdog pattern exactly
_SAMPLER: Optional[FleetSampler] = None


def install_sampler(sampler: Optional[FleetSampler]) -> Optional[FleetSampler]:
    """Install (or clear, with ``None``) the process-wide fleet sampler.

    Returns the previous singleton so callers can restore it (test hygiene).
    """
    global _SAMPLER
    previous = _SAMPLER
    _SAMPLER = sampler
    return previous


def get_sampler() -> Optional[FleetSampler]:
    """The installed fleet sampler, or ``None`` (the disabled path)."""
    return _SAMPLER
