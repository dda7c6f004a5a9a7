"""Seeded, deterministic traffic schedules for the chaos replay bench.

``bench.py`` has always timed one clean loop; production is many tenants with
mixed batch shapes, signature churn, bursts and idle gaps, poisoned batches
and the occasional hung host. A :class:`TrafficSchedule` is that workload as
*data*: an ordered event timeline generated from one integer seed, so a chaos
round is exactly reproducible and a recorded schedule can be replayed against
any later build (the serving-comparison argument: operational behavior under
churn is the number that matters, so the workload that produces it must be
pinned).

Determinism contract: :func:`generate` uses a single ``random.Random(seed)``
stream and embeds **no wall-clock timestamps** — the same config serializes to
byte-identical JSONL every time (asserted by tests). Replay wall times are
measured by :mod:`~torchmetrics_tpu_torch.chaos.replay`, never stored here.

Wire format (JSONL, atomic writes via ``utils/fileio``): one ``meta`` line
(``schema`` = :data:`SCHEDULE_SCHEMA`, the generating config, tenant roles,
``n_events``), then one ``event`` line per event carrying its ordinal ``i``.
Loading is **loud**: a schema mismatch, an unparseable line, an ordinal gap or
a truncated tail raises :class:`ScheduleError` — a chaos bench driven by half
a schedule would report SLOs for a workload nobody asked for.

Event kinds (executed in order by the replay driver):

- ``batch`` — one update batch for ``tenant`` (``size`` rows, ``poison`` True
  replaces the floating-point inputs with NaNs at the fault-injection seam).
- ``sleep`` — an idle gap of ``seconds`` (bursts are simply runs of ``batch``
  events with no ``sleep`` between them).
- ``arm`` — arm the named alert rules (the absence watchdog is armed only
  after warm traffic exists, so it watches for *going* quiet, not for never
  having spoken).
- ``hang_start`` / ``hang_end`` — the simulated hung host: the driver fires
  the hanging-collective fake (``robust/faults.py``) against the hung
  tenant's metric at ``hang_start``, and the schedule keeps that tenant
  silent until ``hang_end``.
- ``repair`` — the operator fixes the poisoned tenant (state reset); the
  drain traffic that follows lets its watchdog resolve.

Pure stdlib — importable without torch/numpy; the same config gives the same
bytes as the JAX package's ``generate``, and either package loads what the other
saved.
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch.utils.fileio import atomic_write_text

__all__ = [
    "EVENT_KINDS",
    "ROLE_GUARDED",
    "ROLE_HUNG",
    "ROLE_VICTIM",
    "SCHEDULE_SCHEMA",
    "ScheduleConfig",
    "ScheduleError",
    "TrafficSchedule",
    "flash_crowd_config",
    "generate",
    "high_tenant_config",
    "skewed_load_config",
    "load",
    "loads",
]

# wire-format version of the JSONL schedule; bump on any structural change —
# loaders REJECT other versions (a schedule is a pinned workload, not a hint)
SCHEDULE_SCHEMA = 1

EVENT_KINDS = ("batch", "sleep", "arm", "hang_start", "hang_end", "repair")

# tenant roles: guarded tenants quarantine poisoned batches (flight-dump
# correctness), the victim lets NaN through to its value timeline (the
# non-finite watchdog's fire/resolve), the hung tenant goes silent for the
# hang window (the absence watchdog's fire/resolve + the collective fake)
ROLE_GUARDED = "guarded"
ROLE_VICTIM = "victim"
ROLE_HUNG = "hung"


class ScheduleError(RuntimeError):
    """A schedule file/text that cannot be trusted (schema, truncation, order)."""


@dataclass
class ScheduleConfig:
    """Knobs of :func:`generate`; serialized into the schedule's meta line.

    Args:
        seed: the single RNG seed — same config, same bytes.
        tenants: total tenant sessions (>= 3: one victim, one hung, the rest
            guarded).
        warm_batches: clean batches per tenant before any fault (the absence
            watchdog arms only after these).
        churn_batches: mixed-shape burst batches per tenant mid-run (the
            signature-churn phase that prices compiled-variant growth).
        drain_batches: recovery batches per tenant after the faults (lets the
            watchdogs resolve and the throughput tail stabilize).
        batch_sizes: the shape buckets batches are drawn from (mixed sizes on
            one tenant stream force chunk flushes and fresh compiles).
        num_classes: classification width of the guarded/hung tenants'
            metric.
        poisoned_guarded: NaN batches injected into one guarded tenant
            (quarantined, flight-dumped, named).
        hang_seconds: how long the hung tenant stays silent.
        absent_after_seconds: the absence watchdog's staleness budget (must be
            < ``hang_seconds`` or the hang can end before the alert fires).
        idle_gap_seconds: the small sleep between bursts.
        burst: batch events emitted back-to-back between idle gaps.
        hot_tenants: flash-crowd width — how many guarded tenants run HOT
            (``hot_factor`` × the baseline per-sweep traffic). ``0`` (the
            default) emits no hot traffic and preserves the historical byte
            stream exactly. With ``hot_tenants`` set, the first
            ``hot_tenants`` guarded tenants are hot through warm + churn, and
            at the ``repair`` event the hot spot SHIFTS: the *next*
            ``hot_tenants`` guarded tenants take over for the drain phase —
            the mid-run load migration a placement controller must chase.
        hot_factor: the hot tenants' traffic multiple per sweep (>= 2 when
            ``hot_tenants`` is set — a crowd of 1× is no crowd).
    """

    seed: int = 0
    tenants: int = 8
    warm_batches: int = 3
    churn_batches: int = 3
    drain_batches: int = 4
    batch_sizes: Tuple[int, ...] = (16, 24)
    num_classes: int = 4
    poisoned_guarded: int = 1
    hang_seconds: float = 0.8
    absent_after_seconds: float = 0.25
    idle_gap_seconds: float = 0.02
    burst: int = 4
    hot_tenants: int = 0
    hot_factor: int = 1

    def __post_init__(self) -> None:
        if self.tenants < 3:
            raise ValueError(
                f"Expected `tenants` >= 3 (victim + hung + >=1 guarded), got {self.tenants}"
            )
        self.batch_sizes = tuple(int(b) for b in self.batch_sizes)
        if not self.batch_sizes or min(self.batch_sizes) < 1:
            raise ValueError(f"Expected positive `batch_sizes`, got {self.batch_sizes}")
        for name in ("warm_batches", "churn_batches", "drain_batches"):
            if getattr(self, name) < 1:
                raise ValueError(f"Expected `{name}` >= 1, got {getattr(self, name)}")
        if self.poisoned_guarded < 1:
            raise ValueError(
                f"Expected `poisoned_guarded` >= 1, got {self.poisoned_guarded}"
            )
        if self.hang_seconds <= self.absent_after_seconds:
            raise ValueError(
                f"`hang_seconds` ({self.hang_seconds}) must exceed"
                f" `absent_after_seconds` ({self.absent_after_seconds}) or the hang"
                " window ends before the absence watchdog can fire"
            )
        if self.burst < 1:
            raise ValueError(f"Expected `burst` >= 1, got {self.burst}")
        if self.hot_tenants < 0:
            raise ValueError(f"Expected `hot_tenants` >= 0, got {self.hot_tenants}")
        if self.hot_factor < 1:
            raise ValueError(f"Expected `hot_factor` >= 1, got {self.hot_factor}")
        if self.hot_tenants:
            if self.hot_factor < 2:
                raise ValueError(
                    f"Expected `hot_factor` >= 2 with hot tenants, got {self.hot_factor}"
                    " (a flash crowd at 1x baseline traffic is no crowd)"
                )
            # two disjoint hot sets (initial + shifted) must fit inside the
            # guarded pool with at least one plain guarded tenant left over
            # for the poison draw — the fault surfaces never run hot
            if self.tenants < 2 * self.hot_tenants + 3:
                raise ValueError(
                    f"Expected `tenants` >= {2 * self.hot_tenants + 3} for"
                    f" `hot_tenants`={self.hot_tenants} (victim + hung + two"
                    " disjoint hot sets + >=1 cold guarded tenant), got"
                    f" {self.tenants}"
                )


@dataclass
class TrafficSchedule:
    """One generated (or loaded) chaos workload: config + roles + events."""

    config: ScheduleConfig
    roles: Dict[str, str]
    events: List[Dict[str, Any]] = field(default_factory=list)

    # ---------------------------------------------------------------- reading

    @property
    def tenants(self) -> List[str]:
        return sorted(self.roles)

    def tenants_with_role(self, role: str) -> List[str]:
        return sorted(t for t, r in self.roles.items() if r == role)

    @property
    def victim(self) -> str:
        return self.tenants_with_role(ROLE_VICTIM)[0]

    @property
    def hung(self) -> str:
        return self.tenants_with_role(ROLE_HUNG)[0]

    @property
    def guarded(self) -> List[str]:
        return self.tenants_with_role(ROLE_GUARDED)

    @property
    def hot_tenants_initial(self) -> List[str]:
        """The flash-crowd hot set through warm + churn (empty when the
        config runs no hot traffic). Derived, not stored: hot sets are the
        first ``hot_tenants`` guarded tenants in sorted order, so a loaded
        schedule reconstructs them from its config alone."""
        hot = getattr(self.config, "hot_tenants", 0)
        return self.guarded[:hot] if hot else []

    @property
    def hot_tenants_shifted(self) -> List[str]:
        """The post-shift hot set (takes over at the ``repair`` event)."""
        hot = getattr(self.config, "hot_tenants", 0)
        return self.guarded[hot : 2 * hot] if hot else []

    def batches(self) -> List[Dict[str, Any]]:
        return [ev for ev in self.events if ev["kind"] == "batch"]

    def poisoned(self) -> Dict[str, List[int]]:
        """Tenant-local poisoned batch ordinals, per tenant (the ground truth
        the flight-dump-correctness SLO checks replay output against)."""
        out: Dict[str, List[int]] = {}
        for ev in self.batches():
            if ev.get("poison"):
                out.setdefault(ev["tenant"], []).append(ev["index"])
        return {tenant: sorted(indices) for tenant, indices in out.items()}

    def total_sleep_seconds(self) -> float:
        return sum(ev["seconds"] for ev in self.events if ev["kind"] == "sleep")

    # ------------------------------------------------------------ wire format

    def to_jsonl(self) -> str:
        """The canonical byte representation (sorted keys, no timestamps)."""
        lines = [
            json.dumps(
                {
                    "type": "meta",
                    "schema": SCHEDULE_SCHEMA,
                    "config": asdict(self.config),
                    "roles": self.roles,
                    "n_events": len(self.events),
                },
                sort_keys=True,
            )
        ]
        for i, ev in enumerate(self.events):
            lines.append(json.dumps({"type": "event", "i": i, **ev}, sort_keys=True))
        return "\n".join(lines) + "\n"

    def save(self, path: str) -> str:
        """Atomically materialize the schedule at ``path``; returns the path."""
        return atomic_write_text(path, self.to_jsonl())


def loads(text: str, source: str = "<string>") -> TrafficSchedule:
    """Parse schedule JSONL, loudly. See the module docstring for what's fatal."""
    lines = text.splitlines()
    if not lines or not lines[0].strip():
        raise ScheduleError(f"{source}: empty schedule (no meta line)")
    try:
        meta = json.loads(lines[0])
    except ValueError as err:
        raise ScheduleError(f"{source}:1: unparseable meta line ({err})") from None
    if not isinstance(meta, dict) or meta.get("type") != "meta":
        raise ScheduleError(f"{source}:1: first line is not a schedule meta record")
    schema = meta.get("schema")
    if schema != SCHEDULE_SCHEMA:
        raise ScheduleError(
            f"{source}: schedule schema {schema!r} does not match this build's"
            f" {SCHEDULE_SCHEMA} — regenerate the schedule (a silently reinterpreted"
            " workload would invalidate every SLO judged from it)"
        )
    try:
        config = ScheduleConfig(**meta["config"])
    except (KeyError, TypeError, ValueError) as err:
        raise ScheduleError(f"{source}:1: bad schedule config ({err})") from None
    roles = meta.get("roles")
    if not isinstance(roles, dict) or not roles:
        raise ScheduleError(f"{source}:1: meta line carries no tenant roles")
    known_roles = (ROLE_GUARDED, ROLE_VICTIM, ROLE_HUNG)
    unknown = sorted({role for role in roles.values() if role not in known_roles})
    if unknown:
        raise ScheduleError(
            f"{source}:1: unknown tenant role(s) {unknown}; this build understands {known_roles}"
        )
    counts = {role: sum(1 for r in roles.values() if r == role) for role in known_roles}
    if counts[ROLE_VICTIM] != 1 or counts[ROLE_HUNG] != 1 or counts[ROLE_GUARDED] < 1:
        raise ScheduleError(
            f"{source}:1: roles must name exactly one victim, exactly one hung tenant"
            f" and at least one guarded tenant; got {counts} — the replay driver"
            " cannot run a fault scenario with missing surfaces"
        )
    events: List[Dict[str, Any]] = []
    for lineno, line in enumerate(lines[1:], 2):
        if not line.strip():
            raise ScheduleError(
                f"{source}:{lineno}: blank line inside the event stream (truncated"
                " or hand-edited schedule)"
            )
        try:
            record = json.loads(line)
        except ValueError:
            raise ScheduleError(
                f"{source}:{lineno}: unparseable (likely truncated) event line —"
                " refusing to replay a partial schedule"
            ) from None
        if record.get("type") != "event":
            raise ScheduleError(f"{source}:{lineno}: expected an event record")
        if record.get("i") != len(events):
            raise ScheduleError(
                f"{source}:{lineno}: event ordinal {record.get('i')!r} != expected"
                f" {len(events)} (reordered or spliced schedule)"
            )
        if record.get("kind") not in EVENT_KINDS:
            raise ScheduleError(
                f"{source}:{lineno}: unknown event kind {record.get('kind')!r};"
                f" this build understands {EVENT_KINDS}"
            )
        tenant = record.get("tenant")
        if tenant is not None and tenant not in roles:
            raise ScheduleError(
                f"{source}:{lineno}: event references tenant {tenant!r} that the"
                " roles map does not name — a spliced or hand-edited schedule"
            )
        events.append({k: v for k, v in record.items() if k not in ("type", "i")})
    n_events = meta.get("n_events")
    if n_events != len(events):
        raise ScheduleError(
            f"{source}: meta promises {n_events} event(s) but {len(events)} parsed"
            " — truncated schedule rejected"
        )
    return TrafficSchedule(config=config, roles=roles, events=events)


def load(path: str) -> TrafficSchedule:
    """Load (and validate, loudly) a schedule JSONL file."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError as err:
        raise ScheduleError(f"cannot read schedule {path}: {err}") from None
    return loads(text, source=path)


def high_tenant_config(seed: int = 0, tenants: int = 64) -> ScheduleConfig:
    """The high-tenant-count chaos preset: the multiplexer's stress workload.

    ≥64 tenant sessions sharing two batch-size signatures (shared signatures
    are what cross-tenant fusion batches on; two sizes keep signature churn in
    play), bursty arrivals (long back-to-back runs, short idle gaps) and a
    compressed warm/churn/drain cycle so the scenario stays CI-sized while the
    tenant axis — not the per-tenant stream length — carries the load. The
    fault surfaces (one victim, one hung tenant, one poisoned guarded tenant)
    are unchanged from the default scenario, so the same SLO fire/resolve
    machinery judges it.

    This is the workload behind ``bench.py --chaos --chaos-scenario
    high_tenant``: unmultiplexed it compiles O(tenants × signatures) variants
    (every tenant's metric instance owns its own jit cache); through
    :class:`~torchmetrics_tpu_torch.engine.mux.TenantMultiplexer` the same traffic
    compiles O(width-buckets × signatures) — ``chaos_ht_compiled_variants``
    is that collapse, measured.
    """
    if tenants < 64:
        raise ValueError(
            f"Expected `tenants` >= 64 for the high-tenant preset, got {tenants}"
            " (the point is the tenant axis)"
        )
    return ScheduleConfig(
        seed=seed,
        tenants=tenants,
        warm_batches=2,
        churn_batches=2,
        drain_batches=2,
        batch_sizes=(16, 24),
        num_classes=4,
        poisoned_guarded=1,
        hang_seconds=0.8,
        absent_after_seconds=0.25,
        idle_gap_seconds=0.005,
        burst=16,
    )


def skewed_load_config(seed: int = 0, tenants: int = 8) -> ScheduleConfig:
    """The skewed-load chaos preset: the fleet telemetry plane's workload.

    A modest tenant count (the skew lives in the *placement*, which the
    replay supplies — every tenant but one lands on virtual host "0", so the
    hot host carries ~⅞ of the measured rate) with a slightly longer drain
    phase than the default: the imbalance page needs dwell time to ride the
    pending→firing machinery, and the post-shift world needs enough trailing
    traffic for the sampler to re-point the hot host before the run ends.
    The standard fault surfaces (victim, hung tenant, poisoned guarded
    tenant) are unchanged — skew detection must hold up WHILE the usual
    faults fire, not in a sterile run.

    This is the workload behind ``bench.py --chaos --chaos-scenario
    skewed_load``: the judged number is ``chaos_sk_time_to_detect_imbalance``
    — skew onset (first batch) to the ``fleet_imbalance`` page's fired_at,
    derived from fleet samples alone.
    """
    if tenants < 4:
        raise ValueError(
            f"Expected `tenants` >= 4 for the skewed-load preset, got {tenants}"
            " (one cold tenant against fewer than three hot ones is not skew)"
        )
    return ScheduleConfig(
        seed=seed,
        tenants=tenants,
        warm_batches=3,
        churn_batches=3,
        drain_batches=6,
        batch_sizes=(16, 24),
        num_classes=4,
        poisoned_guarded=1,
        hang_seconds=0.8,
        absent_after_seconds=0.25,
        idle_gap_seconds=0.02,
        burst=4,
    )


def flash_crowd_config(seed: int = 0, tenants: int = 12) -> ScheduleConfig:
    """The flash-crowd chaos preset: the placement control plane's workload.

    Two guarded tenants run HOT (5× the baseline per-sweep traffic, emitted
    as back-to-back bursts) through warm + churn, and at the ``repair`` event
    the hot spot SHIFTS to a disjoint pair for the drain phase. Replayed with
    ``ReplayConfig.flash_crowd=True`` every tenant is seeded onto virtual
    host ``"0"``, so the measured imbalance opens at 1.0; the
    :class:`~torchmetrics_tpu_torch.fleet.placement.PlacementController` must drain
    it below the hysteresis floor by executing real
    drain→checkpoint→restore→replay-tail moves chosen from
    ``FleetSampler.rebalance_hints()`` alone — then do it AGAIN when the
    shift invalidates the converged table. The drain phase runs long so the
    post-shift world has traffic to converge against (the replay's settle
    loop extends it adaptively when the runner is slow).

    This is the workload behind ``bench.py --chaos --chaos-scenario
    flash_crowd``: judged on convergence wall time, completed-move counts
    (pre- and post-shift), bit-identity of every moved session vs an unmoved
    shadow control, and throughput against a controller-off control arm
    (configs prefixed ``chaos_fc_*``).
    """
    if tenants < 9:
        raise ValueError(
            f"Expected `tenants` >= 9 for the flash-crowd preset, got {tenants}"
            " (two disjoint 2-tenant hot sets + the fault surfaces + cold ballast)"
        )
    return ScheduleConfig(
        seed=seed,
        tenants=tenants,
        warm_batches=4,
        churn_batches=3,
        drain_batches=10,
        batch_sizes=(16, 24),
        num_classes=4,
        poisoned_guarded=1,
        hang_seconds=0.8,
        absent_after_seconds=0.25,
        idle_gap_seconds=0.03,
        burst=6,
        hot_tenants=2,
        hot_factor=5,
    )


# ------------------------------------------------------------------ generation


def _tenant_names(n: int) -> List[str]:
    return [f"tenant-{i:02d}" for i in range(n)]


def generate(config: Optional[ScheduleConfig] = None, **overrides: Any) -> TrafficSchedule:
    """Generate a deterministic chaos workload from ``config`` (or kwargs).

    Phases (all interleaving and shape choices drawn from one seeded stream):

    1. **warm** — round-robin clean traffic for every tenant, mixed sizes.
    2. **arm** — the absence watchdog arms (warm timelines now exist).
    3. **poison** — NaN batches land on the victim (value watchdog) and on one
       rng-chosen guarded tenant (quarantine + flight dump).
    4. **churn** — shuffled cross-tenant bursts with per-batch size draws: the
       signature-churn phase, hung tenant still participating.
    5. **hang** — ``hang_start``; every *other* tenant keeps bursting while
       sleeps accumulate to ``hang_seconds``; ``hang_end``.
    6. **repair + drain** — the victim is repaired, then every tenant
       (hung and victim included) drains clean traffic so the watchdogs
       resolve on measured wall clock.
    """
    if config is None:
        config = ScheduleConfig(**overrides)
    elif overrides:
        config = ScheduleConfig(**{**asdict(config), **overrides})
    rng = random.Random(config.seed)
    names = _tenant_names(config.tenants)
    victim, hung = names[0], names[1]
    roles = {name: ROLE_GUARDED for name in names}
    roles[victim] = ROLE_VICTIM
    roles[hung] = ROLE_HUNG
    # flash-crowd hot sets (empty at the default hot_tenants=0): chosen
    # deterministically WITHOUT the rng so the default byte stream is
    # untouched — the first `hot_tenants` guarded tenants run hot through
    # warm + churn, the next `hot_tenants` take over for the drain phase
    # (the shift lands at the `repair` event, which replay wall-stamps)
    guarded_sorted = names[2:]
    hot_initial = guarded_sorted[: config.hot_tenants] if config.hot_tenants else []
    hot_shifted = (
        guarded_sorted[config.hot_tenants : 2 * config.hot_tenants]
        if config.hot_tenants
        else []
    )

    counters = {name: 0 for name in names}
    events: List[Dict[str, Any]] = []

    def batch(tenant: str, poison: bool = False) -> None:
        events.append(
            {
                "kind": "batch",
                "tenant": tenant,
                "index": counters[tenant],
                "size": rng.choice(config.batch_sizes),
                "poison": bool(poison),
            }
        )
        counters[tenant] += 1

    def sleep(seconds: float) -> None:
        events.append({"kind": "sleep", "seconds": round(float(seconds), 6)})

    # 1. warm: round-robin, one idle gap per sweep; the initial hot set's
    # extra batches ride each sweep back-to-back (burst arrivals)
    for _ in range(config.warm_batches):
        for name in names:
            batch(name)
        for name in hot_initial:
            for _ in range(config.hot_factor - 1):
                batch(name)
        sleep(config.idle_gap_seconds)

    # 2. arm the absence watchdog now that every tenant has a warm timeline
    events.append({"kind": "arm", "rules": ["hang_absent"]})

    # 3. poison: the victim's NaN batch (value watchdog) + guarded quarantines.
    # Hot tenants are excluded from the draw (fault surfaces never run hot —
    # a moved-AND-poisoned tenant would entangle two proofs); at hot_tenants=0
    # the candidate list is the historical one, so the rng stream is unchanged
    poisoned_guarded_tenant = rng.choice(
        sorted(
            t
            for t, r in roles.items()
            if r == ROLE_GUARDED and t not in hot_initial and t not in hot_shifted
        )
    )
    batch(victim, poison=True)
    for _ in range(config.poisoned_guarded):
        batch(poisoned_guarded_tenant, poison=True)
    # clean traffic rides along so the poisoned batches sit inside real streams
    for name in names:
        batch(name)
    sleep(config.idle_gap_seconds)

    # 4. churn: shuffled cross-tenant bursts, per-batch size draws; the hot
    # set's traffic multiple holds through the churn (an empty extension at
    # hot_tenants=0 leaves the shuffle — and the byte stream — unchanged)
    churn_pool = [name for name in names for _ in range(config.churn_batches)]
    churn_pool += [
        name
        for name in hot_initial
        for _ in range((config.hot_factor - 1) * config.churn_batches)
    ]
    rng.shuffle(churn_pool)
    for i, name in enumerate(churn_pool):
        batch(name)
        if (i + 1) % config.burst == 0:
            sleep(config.idle_gap_seconds)

    # 5. hang: the hung tenant goes silent; everyone else keeps serving
    events.append({"kind": "hang_start", "tenant": hung, "seconds": config.hang_seconds})
    others = [name for name in names if name != hung]
    # split the window into slices, each a short sleep plus a small burst from
    # the surviving tenants — the obs plane is scraped under load, not at rest
    slices = max(2, int(round(config.hang_seconds / max(config.absent_after_seconds / 2, 0.05))))
    for _ in range(slices):
        sleep(config.hang_seconds / slices)
        for name in rng.sample(others, k=min(2, len(others))):
            batch(name)
    events.append({"kind": "hang_end", "tenant": hung})

    # 6. repair the victim, then drain everyone so the watchdogs resolve.
    # The repair event is also the flash crowd's HOT-SPOT SHIFT: the drained
    # world's extra traffic belongs to the second hot set — yesterday's hot
    # tenants go cold, a disjoint set heats up, and whatever placement the
    # controller converged on pre-shift is wrong again
    events.append({"kind": "repair", "tenant": victim})
    for _ in range(config.drain_batches):
        for name in names:
            batch(name)
        for name in hot_shifted:
            for _ in range(config.hot_factor - 1):
                batch(name)
        sleep(config.idle_gap_seconds)

    return TrafficSchedule(config=config, roles=roles, events=events)
