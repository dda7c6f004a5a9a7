"""Cross-tenant fused dispatch: many tenants' updates in ONE captured CUDA graph.

Counterpart of ``torchmetrics_tpu/engine/mux.py``. A serving process with many tenant
sessions otherwise issues one dispatch stream per tenant and captures
O(tenants × signatures) graphs, since every tenant's pipeline owns its own capture
cache. :class:`TenantMultiplexer` is the batching layer that makes tenants share
*graphs*:

- **One dispatch, many tenants** — same-signature update batches from *different*
  tenants form a group; the group folds every row into its own tenant's state with
  ONE call of a fused function that runs each fused leader's ``pure_update`` row by
  row (collections: per compute-group leader, as the pipeline's fused chunk). JAX
  folds the group with one ``jax.vmap``; the port's kernels launch through ctypes,
  which ``torch.func.vmap`` cannot batch, so the rows are unrolled inside the
  function, as the pipeline unrolls the steps of a chunk. Through the capture cache
  (``core/jit.py``) a group is one CUDA-graph replay holding each row's K1, K2 and K3
  launches. Results are bitwise the per-tenant updates: each row runs the same
  transition on its own state.
- **Tenant-width buckets** — a group of N tenants is padded up to the next width
  bucket (powers of two up to ``max_width`` by default) with repeated rows that are
  masked out (``torch.where(valid[i], new, old)``), so the captured variant count
  stays **O(width buckets × signatures)**, independent of the tenant population.
  :meth:`warmup` captures every (width bucket, signature) variant.
- **Per-tenant fault isolation** — a group is screened once for non-finite inputs
  (guarded tenants' rows only, one host sync per group); a poisoned row degrades
  exactly *its* tenant's batch to that tenant's own guarded ``update``
  (skip/quarantine/raise per its policy) while the rest of the group still lands
  fused. A fused dispatch that raises replays every row through its tenant's own
  update, as in JAX, except a CUDA error: that raises, so a kernel that fails to
  launch never hides behind the replay.
- **Cost-aware admission** — with an
  :class:`~torchmetrics_tpu_torch.obs.scope.AdmissionController` configured (or
  installed process-wide), every fed batch is admitted, shed or deferred against the
  tenant's quota, and executed work is billed back, priced by the cost ledger's
  per-dispatch counts (flops and bytes per fused row of the width bucket that ran,
  capture seconds split across the group that forced them).
- **Flight recorder** — the pipeline's per-row lineage ring and dump-on-fault, on the
  cross-tenant plane: every fed row keeps (tenant, tenant-local batch index,
  signature, group id, dispatch path), and a poisoned row produces a dump attributed
  to exactly its owning tenant. ``MuxConfig.flight_records=0`` disables it.
- **Sessions** — every adopted tenant is a live session in the scope registry; the
  mux holds ONE lease (one epoch, the fencing token of every tenant), renewed on
  feed and commit; ``MuxConfig.checkpoint`` writes each tenant's slice as its own
  bundle stream (``engine/migrate.py``); ``MuxConfig.alert_engine`` samples every
  committed tenant's values.

Per-tenant stream order is preserved: a tenant feeding a second batch (or a new
signature) before its pending group dispatched flushes that group first.

Telemetry (``obs/trace.py``, off by default) keeps the JAX names: ``engine.mux_*``
counters and gauges, ``engine.dispatch`` spans with ``path="mux"``. :meth:`report`
returns the same accounting as plain ints. The conservation audit (``obs/audit.py``)
hooks in where the JAX module's does, each behind ``if _audit.ENABLED:``; a fold is
noted on the host after a group's replay has returned, never inside a capture.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import time
from dataclasses import dataclass, fields, replace
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

import torchmetrics_tpu_torch.obs.audit as _audit
import torchmetrics_tpu_torch.obs.cost as _cost
import torchmetrics_tpu_torch.obs.lineage as _lineage
import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as _trace
import torchmetrics_tpu_torch.obs.values as _values
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.jit import (
    StaticLeafJit,
    _ArraySlot,
    _aval_signature,
    jit_with_static_leaves,
    partition_static_leaves,
    signature_str,
    tree_flatten,
    tree_unflatten,
)
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.engine import warmup as _warmup
from torchmetrics_tpu_torch.engine.pipeline import FLIGHT_DIR_ENV, _FlightRecorder, _masked, _target_device
from torchmetrics_tpu_torch.robust import fence as _fence
from torchmetrics_tpu_torch.robust.policy import effective_policy, nonfinite_step_indices
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["MuxConfig", "MuxReport", "TenantMultiplexer"]


@dataclass
class MuxConfig:
    """Tuning knobs for :class:`TenantMultiplexer`.

    Args:
        max_width: max tenants fused into one dispatch (the top width bucket).
        width_buckets: explicit tenant-width buckets (ascending). Default: powers of
            two up to ``max_width`` — a partial group pads up to the next bucket with
            a masked tail, so the captured variant count stays ``O(log max_width)``
            per signature.
        admission: an :class:`~torchmetrics_tpu_torch.obs.scope.AdmissionController`
            consulted per fed batch. ``None`` falls back to the process-wide
            controller (:func:`~torchmetrics_tpu_torch.obs.scope.get_admission`),
            which may also be ``None`` — everything admitted.
        alert_engine: an :class:`~torchmetrics_tpu_torch.obs.alerts.AlertEngine`
            evaluated per committed group — each committed tenant's values are
            sampled sync-free under its own session.
        alert_every: evaluate the alert engine every Nth committed group
            (``close()`` always runs a final evaluation).
        max_deferred: per-tenant cap on the deprioritized backlog — deferred batches
            hold real device tensors. Past the cap, further defer decisions degrade to
            shed (counted).
        readmit_check_seconds: how often the per-feed sweep probes deferred tenants'
            quotas (read-only ``would_admit``) for wall-clock re-admission, so an
            idle-but-deferred tenant drains on any *other* tenant's traffic once its
            window rolls.
        flight_records: flight-recorder ring capacity (``0`` disables it).
        flight_dump_dir: where fault dumps land. ``None``: the ``TM_TPU_FLIGHT_DIR``
            environment variable, else ``<tempdir>/tm_tpu_flight``.
        flight_max_dumps: hard cap on dump files one multiplexer writes (suppressed
            dumps are counted).
        device: the device batches are put on and groups run on. ``None``: the
            template tenant's device (``cuda`` unless its metrics were built on the
            CPU).
        checkpoint: a :class:`~torchmetrics_tpu_torch.engine.migrate.CheckpointPolicy`
            — continuous checkpointing for the multiplexed plane. On cadence (counted
            over the mux's committed batches / wall clock, checked at group-commit
            boundaries) every adopted tenant's **slice** is written as its own
            pipeline-restorable bundle stream under ``<directory>/<tenant>/``.
            ``None`` (default) disables.
        lease_seconds: TTL of the multiplexer's renewable session **lease**
            (``robust/fence.py``): ONE lease — one session epoch, the fencing token of
            every adopted tenant — renewed on feed and commit (at most every ~TTL/4),
            recorded per tenant and stamped into every tenant slice bundle. Default
            30 s.
    """

    max_width: int = 64
    width_buckets: Optional[Tuple[int, ...]] = None
    admission: Any = None
    alert_engine: Any = None
    alert_every: int = 1
    max_deferred: int = 1024
    readmit_check_seconds: float = 0.25
    flight_records: int = 64
    flight_dump_dir: Optional[str] = None
    flight_max_dumps: int = 16
    device: Any = None
    checkpoint: Any = None
    lease_seconds: float = 30.0

    def __post_init__(self) -> None:
        if self.max_width < 1:
            raise ValueError(f"Expected `max_width` >= 1, got {self.max_width}")
        if self.lease_seconds <= 0:
            raise ValueError(f"Expected `lease_seconds` > 0, got {self.lease_seconds}")
        if self.alert_every < 1:
            raise ValueError(f"Expected `alert_every` >= 1, got {self.alert_every}")
        if self.max_deferred < 1:
            raise ValueError(f"Expected `max_deferred` >= 1, got {self.max_deferred}")
        if self.readmit_check_seconds < 0:
            raise ValueError(f"Expected `readmit_check_seconds` >= 0, got {self.readmit_check_seconds}")
        if self.flight_records < 0:
            raise ValueError(f"Expected `flight_records` >= 0, got {self.flight_records}")
        if self.flight_max_dumps < 0:
            raise ValueError(f"Expected `flight_max_dumps` >= 0, got {self.flight_max_dumps}")
        if self.width_buckets is not None:
            buckets = tuple(sorted(set(int(b) for b in self.width_buckets)))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"Expected positive `width_buckets`, got {self.width_buckets}")
            if buckets[-1] > self.max_width:
                raise ValueError(
                    f"`width_buckets` top bucket {buckets[-1]} exceeds `max_width`"
                    f" {self.max_width} — every full group would pad (and bill) phantom"
                    " rows past the dispatch cap"
                )
            if buckets[-1] < self.max_width:
                buckets = buckets + (self.max_width,)
            self.width_buckets = buckets

    def buckets(self) -> Tuple[int, ...]:
        if self.width_buckets is not None:
            return self.width_buckets
        return _warmup.pow2_buckets(self.max_width)


@dataclass
class MuxReport:
    """Plain-int accounting of one multiplexer's work (no obs tracing needed)."""

    batches: int = 0  # batches ingested (admitted + deferred-replayed)
    fused_updates: int = 0  # tenant-updates landed via a fused dispatch
    eager_updates: int = 0  # tenant-updates driven through per-tenant `update`
    replayed_updates: int = 0  # guarded per-tenant replays of poisoned rows
    dispatches: int = 0  # fused dispatches issued
    eager_dispatches: int = 0  # per-tenant update dispatches (incl. replays)
    shed_batches: int = 0  # admission decisions: dropped over-quota batches
    deferred_batches: int = 0  # admission decisions: deprioritized batches
    deferred_replayed: int = 0  # deferred batches later ingested
    padded_rows: int = 0  # masked tenant rows added by width-bucket padding
    order_flushes: int = 0  # groups dispatched early to keep a tenant's order
    flight_dumps: int = 0  # flight-recorder fault dumps written
    max_width: int = 0
    last_width: int = 0

    def host_dispatches(self) -> int:
        return self.dispatches + self.eager_dispatches

    def dispatches_per_update(self) -> Optional[float]:
        """Host dispatches per landed tenant-update (< 1.0 once fusion engages)."""
        landed = self.fused_updates + self.eager_updates + self.replayed_updates
        if not landed:
            return None
        return self.host_dispatches() / landed

    def processed_batches(self) -> int:
        """Canonical processed count: every tenant-update that landed."""
        return self.fused_updates + self.eager_updates + self.replayed_updates

    def asdict(self) -> Dict[str, Any]:
        out = {f.name: getattr(self, f.name) for f in fields(self)}
        out["host_dispatches"] = self.host_dispatches()
        out["dispatches_per_update"] = self.dispatches_per_update()
        # the pipeline report's vocabulary; the mux's own names stay as aliases
        out["processed_batches"] = self.processed_batches()
        out["fused_batches"] = self.fused_updates
        out["eager_batches"] = self.eager_updates
        out["replayed_batches"] = self.replayed_updates
        out["padded_steps"] = self.padded_rows
        out["shape_flushes"] = self.order_flushes
        return out


# runtime state that legitimately differs between healthy same-config instances;
# everything else public and hashable is configuration the fused function bakes in
# (error_policy is per tenant by design: it guards the eager/replay path only)
_RUNTIME_ATTRS = frozenset(
    {
        "updates_ok",
        "updates_skipped",
        "updates_quarantined",
        "quarantine_dropped",
        "last_update_ok",
        "sync_degraded",
        "error_policy",
    }
)


def _config_fingerprint(target: Any) -> Any:
    """Hashable-config snapshot of a metric (or collection, per member).

    The fused function runs the TEMPLATE's ``pure_update``, so every adopted target
    must agree on the configuration that transition bakes in. Public scalar/tuple
    attributes are the configuration surface, and so are tensor-valued ones and module
    buffers (a curve metric's thresholds); runtime counters and per-tenant robust
    policy are excluded.
    """

    def one(m: Any) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in {**vars(m), **getattr(m, "_buffers", {})}.items():
            if k.startswith("_") or k in _RUNTIME_ATTRS:
                continue
            if isinstance(v, (bool, int, float, str, bytes, tuple, frozenset, type(None))):
                out[k] = v
            elif isinstance(v, (torch.Tensor, np.ndarray)):
                arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                if arr.size <= 65536:
                    out[k] = (str(arr.dtype), arr.shape, arr.tobytes())
        return out

    if isinstance(target, MetricCollection):
        return {name: (type(m).__name__, one(m)) for name, m in target._modules.items()}
    return one(target)


def _is_device_fault(err: BaseException) -> bool:
    """A CUDA error (sticky or a kernel that failed to launch): it is raised, never
    replayed around."""
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(err, accelerator_error):
        return True
    return isinstance(err, RuntimeError) and ("CUDA error" in str(err) or "CUDA kernel" in str(err))


class _MuxGroup:
    """One open fusion group: same-signature rows from distinct tenants."""

    __slots__ = ("sig", "treedef", "template", "tenants", "traced", "originals", "records", "trace_ids")

    def __init__(self, sig: tuple, treedef: Any, template: tuple) -> None:
        self.sig = sig
        self.treedef = treedef
        self.template = template
        self.tenants: List[str] = []
        self.traced: List[list] = []  # per row: traced leaves, template order
        self.originals: List[Tuple[tuple, dict]] = []
        self.records: List[Optional[dict]] = []  # per row: flight record (or None)
        self.trace_ids: List[Optional[str]] = []  # per row: lineage id (None when off)

    def __len__(self) -> int:
        return len(self.tenants)


class TenantMultiplexer:
    """Fold same-signature updates from many tenants with one captured dispatch.

    Usage::

        mux = TenantMultiplexer(lambda: MulticlassAccuracy(num_classes=4),
                                MuxConfig(max_width=64))
        for tenant in tenants:
            mux.adopt(tenant)
        mux.warmup(example_preds, example_target)    # capture every width bucket
        for tenant, batch in traffic:
            mux.feed(tenant, *batch)                 # fuses across tenants
        mux.close()
        value = mux.compute("acme-prod")

    Every tenant owns a *separate* metric instance (``factory()``) — state is never
    shared; only the captured graphs are. Targets with ragged list states (or
    ``jit_update=False``) degrade to per-tenant eager updates automatically, exactly
    like the streaming pipeline.
    """

    _instance_seq = itertools.count()

    def __init__(
        self,
        factory: Optional[Callable[[], Union[Metric, MetricCollection]]] = None,
        config: Optional[MuxConfig] = None,
        metrics: Optional[Dict[str, Union[Metric, MetricCollection]]] = None,
        **overrides: Any,
    ) -> None:
        if config is None:
            config = MuxConfig(**overrides)
        elif overrides:
            config = replace(config, **overrides)
        if factory is None and not metrics:
            raise ValueError("TenantMultiplexer needs a metric factory or an initial `metrics` dict")
        self.config = config
        self._factory = factory
        self._metrics: Dict[str, Union[Metric, MetricCollection]] = {}
        # raw tenant name -> effective label (identity for in-cap tenants; past-cap
        # names collapse onto the shared OVERFLOW_TENANT session)
        self._aliases: Dict[str, str] = {}
        self._template: Optional[Union[Metric, MetricCollection]] = None
        self._is_collection = False
        self._fused_leaders: List[Optional[str]] = []
        self._eager_leaders: List[str] = []
        self._fusable = False
        self._label = "TenantMultiplexer"
        self._buckets = config.buckets()
        self._device: Optional[torch.device] = None  # fixed by the template
        self._pool: Any = None  # one CUDA graph memory pool for every fused variant
        self._valid_masks: Dict[Tuple[int, int], torch.Tensor] = {}
        self._groups: Dict[tuple, _MuxGroup] = {}
        self._pending: Dict[str, tuple] = {}  # tenant -> sig of its open row
        self._fused_fns: Dict[tuple, StaticLeafJit] = {}
        # per-tenant deprioritized backlogs as (args, kwargs, trace_id): the id was
        # minted at first arrival, so defer -> re-admission keeps it
        self._deferred: Dict[str, List[Tuple[tuple, dict, Optional[str]]]] = {}
        self._report = MuxReport()
        self._warmup_manifest: Optional[Dict[str, Any]] = None
        self._alert_commits = 0
        self._alert_warned = False
        self._shed_warned: set = set()
        # per-tenant ingest ordinals: flight records and dump attribution name
        # TENANT-LOCAL batch indices
        self._tenant_batch_index: Dict[str, int] = {}
        # per-tenant ARRIVAL ordinals (lineage ids only): assigned at feed, before
        # admission, so shed/deferred rows keep identity
        self._tenant_arrivals: Dict[str, int] = {}
        # per-tenant shed+defer counts: once a tenant detoured, its arrival and
        # processed ordinals no longer line up (slice captures consult this)
        self._tenant_detours: Dict[str, int] = {}
        self._tenant_shed: Dict[str, int] = {}
        self._tenant_deferred: Dict[str, int] = {}
        self._tenant_deferred_replayed: Dict[str, int] = {}
        # per-tenant PROCESSED counts (fused commits + eager + replays): the slice
        # checkpoint cursor — never counts a row still pending in an open group
        self._tenant_folded: Dict[str, int] = {}
        self._group_seq = 0
        self._last_readmit_check = 0.0
        # batch lineage (obs/lineage.py): one epoch per multiplexer; trace ids are
        # minted per ROW from the tenant-local arrival ordinal
        self._lineage_epoch = _lineage.new_epoch()
        self._instance = str(next(TenantMultiplexer._instance_seq))
        if config.flight_records > 0:
            dump_dir = (
                config.flight_dump_dir
                or os.environ.get(FLIGHT_DIR_ENV)
                or os.path.join(tempfile.gettempdir(), "tm_tpu_flight")
            )
            self._flight: Optional[_FlightRecorder] = _FlightRecorder(
                "TenantMultiplexer", self._instance, config.flight_records, dump_dir, config.flight_max_dumps
            )
        else:
            self._flight = None
        # per-width-bucket (flops, bytes) per dispatch: a width-1 group costs about
        # 1/64 of a width-64 one, so billing prices the bucket that actually ran
        self._width_prices: Dict[int, Tuple[Optional[float], Optional[float]]] = {}
        self._closed = False
        # continuous checkpointing (engine/migrate.py): one bundle stream per adopted
        # tenant under <policy.directory>/<tenant>, gated by ONE mux-level cadence
        self._checkpointers: Dict[str, Any] = {}
        self._ckpt_last_batches = 0
        self._ckpt_last_time = time.monotonic()
        # ONE session lease for the whole mux — one epoch, one fencing token shared by
        # every adopted tenant; adopt() and renewals record it per TENANT
        lease_now = time.time()
        self._lease = {
            "holder": _fence.holder_id(),
            "epoch": self._lineage_epoch,
            "ttl_seconds": float(config.lease_seconds),
            "expires_unix": lease_now + float(config.lease_seconds),
            "renewed_unix": lease_now,
        }
        self._lease_renew_at = lease_now + config.lease_seconds / 4.0
        if _audit.ENABLED:
            _audit.track(self, "mux", self._label)
        for tenant, metric in (metrics or {}).items():
            self.adopt(tenant, metric)

    # ------------------------------------------------------------------ membership

    def adopt(
        self, tenant: str, metric: Optional[Union[Metric, MetricCollection]] = None
    ) -> Union[Metric, MetricCollection]:
        """Register ``tenant`` with its own metric instance (created by the factory
        when not given); returns the instance.

        The tenant is registered with the scope registry as a live session, and the
        metric adopts the tenant label so its eager paths stay attributed. The first
        adopted target fixes the template (and the device): every later target must
        be the same class with the same configuration. Past the registry cap, new
        tenant names collapse onto the shared
        :data:`~torchmetrics_tpu_torch.obs.scope.OVERFLOW_TENANT` session.
        """
        raw = _scope.validate_tenant(tenant)
        if raw in self._aliases:
            raise ValueError(f"Tenant {raw!r} is already multiplexed")
        effective = _scope.adopt(raw)
        if effective in self._metrics:
            if effective == raw:
                raise ValueError(f"Tenant {raw!r} is already multiplexed")
            # past-cap collapse: the raw name joins the overflow session
            self._aliases[raw] = effective
            return self._metrics[effective]
        if metric is None:
            if self._factory is None:
                raise ValueError(f"No factory to build a metric for tenant {tenant!r}")
            with _scope.session(effective):
                metric = self._factory()
        if not isinstance(metric, (Metric, MetricCollection)):
            raise ValueError(
                f"TenantMultiplexer drives Metric or MetricCollection targets, got {type(metric).__name__}"
            )
        if self._template is None:
            self._template = metric
            self._is_collection = isinstance(metric, MetricCollection)
            self._label = f"Mux[{type(metric).__name__}]"
            if self._is_collection:
                self._fused_leaders, self._eager_leaders = metric._engine_fusable_leaders()
            else:
                self._fused_leaders, self._eager_leaders = [], []
                if metric._engine_fusable():
                    self._fused_leaders = [None]  # sentinel: the metric itself fuses
            self._fusable = bool(self._fused_leaders)
            self._device = (
                torch.device(self.config.device) if self.config.device is not None else _target_device(metric)
            )
            if self._device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
        elif type(metric) is not type(self._template):
            raise ValueError(
                f"Tenant {tenant!r} brings a {type(metric).__name__} but this multiplexer"
                f" fuses {type(self._template).__name__} targets — one captured function"
                " cannot fold mismatched state structures"
            )
        else:
            # same class is not enough: the fused function runs the TEMPLATE's
            # pure_update, so configuration must match too
            ours, theirs = _config_fingerprint(self._template), _config_fingerprint(metric)
            if ours != theirs:
                differing = sorted(k for k in set(ours) | set(theirs) if ours.get(k) != theirs.get(k))
                raise ValueError(
                    f"Tenant {tenant!r} brings a {type(metric).__name__} whose"
                    f" configuration differs from the template's on {differing} —"
                    " the fused function bakes in ONE configuration; use a separate"
                    " multiplexer (or per-tenant pipelines) for divergent configs"
                )
        if getattr(metric, "_obs_tenant", None) is None:
            metric._obs_tenant = effective
        if self._is_collection:
            for m in metric._modules.values():
                if getattr(m, "_obs_tenant", None) is None:
                    m._obs_tenant = effective
        self._metrics[effective] = metric
        self._aliases[raw] = effective
        _scope.get_registry().pipeline_started(effective)
        self._note_tenant_lease(effective)
        if self.config.checkpoint is not None and effective not in self._checkpointers:
            # lazy import: migrate.py imports the pipeline, and the mux is exported beside it
            from torchmetrics_tpu_torch.engine.migrate import ContinuousCheckpointer

            directory = os.path.join(self.config.checkpoint.directory, effective)
            policy = replace(self.config.checkpoint, directory=directory)
            self._checkpointers[effective] = ContinuousCheckpointer(policy, tenant=effective, label=self._label)
        return metric

    def _note_tenant_lease(self, effective: str) -> None:
        _scope.note_lease(
            effective,
            holder=self._lease["holder"],
            epoch=self._lease["epoch"],
            ttl_seconds=self._lease["ttl_seconds"],
            expires_unix=self._lease["expires_unix"],
            renewed_unix=self._lease["renewed_unix"],
        )

    def _renew_lease(self, force: bool = False) -> None:
        """Renew the mux's one lease (at most every ~TTL/4) and refresh every adopted
        tenant's registry row with the new expiry."""
        now = time.time()
        if not force and now < self._lease_renew_at:
            return
        self._lease["expires_unix"] = now + self._lease["ttl_seconds"]
        self._lease["renewed_unix"] = now
        self._lease_renew_at = now + self._lease["ttl_seconds"] / 4.0
        for effective in self._metrics:
            self._note_tenant_lease(effective)
        if _trace.ENABLED:
            _trace.inc("lease.renewals")

    def lease_snapshot(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """The lease stamp a tenant slice bundle carries, freshly renewed — every
        slice write doubles as a renewal for the whole mux."""
        self._renew_lease(force=True)
        return {key: self._lease[key] for key in ("holder", "epoch", "ttl_seconds", "expires_unix", "renewed_unix")}

    def _maybe_checkpoint(self, force: bool = False, skip_covered: bool = False) -> int:
        """Group-commit-boundary hook: when the mux-level cadence is due, every
        tenant's slice is written (its own delta stream). Returns bundles written.
        Open rows are excluded per tenant, so each slice is commit-consistent without
        flushing anyone's pending group; ``skip_covered`` (the close path) skips slices
        the last bundle already covers."""
        if not self._checkpointers:
            return 0
        policy = self.config.checkpoint
        committed = self._report.fused_updates + self._report.eager_updates + self._report.replayed_updates
        if not force:
            due_batches = policy.every_batches and committed - self._ckpt_last_batches >= policy.every_batches
            due_time = policy.every_seconds and time.monotonic() - self._ckpt_last_time >= policy.every_seconds
            if not due_batches and not due_time:
                return 0
        self._ckpt_last_batches = committed
        self._ckpt_last_time = time.monotonic()
        written = 0
        for tenant, checkpointer in self._checkpointers.items():
            if checkpointer.maybe_mux_slice(self, tenant, force=True, skip_if_covered=skip_covered) is not None:
                written += 1
        return written

    def checkpoint_now(self) -> int:
        """Force one slice bundle per tenant (cadence bypassed); returns the number
        written (0 without a configured ``CheckpointPolicy``)."""
        return self._maybe_checkpoint(force=True)

    def _effective(self, tenant: str) -> str:
        """The session label a raw tenant name maps to (adopting on demand)."""
        effective = self._aliases.get(tenant)
        if effective is None:
            self.adopt(tenant)
            effective = self._aliases[tenant]
        return effective

    def tenants(self) -> List[str]:
        return list(self._metrics)

    def metric(self, tenant: str) -> Union[Metric, MetricCollection]:
        return self._metrics[self._aliases.get(tenant, tenant)]

    def report(self) -> MuxReport:
        """Copy of the accounting so far (safe to keep across further feeds)."""
        return replace(self._report)

    @property
    def warmup_manifest(self) -> Optional[Dict[str, Any]]:
        return self._warmup_manifest

    def cache_info(self) -> Dict[str, Any]:
        """Summed fused-function capture-cache accounting across signature families."""
        infos = [fn.cache_info() for fn in self._fused_fns.values()]
        return {
            "families": len(infos),
            "static_variants": sum(i["static_variants"] for i in infos),
            "compiled_variants": sum(i["compiled_variants"] for i in infos),
            "hits": sum(i["hits"] for i in infos),
            "misses": sum(i["misses"] for i in infos),
            "replays": sum(i["replays"] for i in infos),
            "capture_seconds": sum(i["capture_seconds"] for i in infos),
        }

    def flight_records(self) -> List[dict]:
        """Copies of the flight-recorder ring (empty when ``flight_records=0``)."""
        return self._flight.records() if self._flight is not None else []

    @property
    def flight_dumps(self) -> List[str]:
        """Paths of the fault dumps this multiplexer has written."""
        return list(self._flight.dump_paths) if self._flight is not None else []

    @property
    def lineage_epoch(self) -> str:
        """The epoch this multiplexer's trace ids are minted under."""
        return self._lineage_epoch

    def trace_id_for(self, tenant: str, ordinal: int) -> str:
        """The (deterministic) trace id of ``tenant``'s ``ordinal``-th FED row."""
        return _lineage.mint(self._aliases.get(tenant, tenant), self._lineage_epoch, ordinal)

    # ---------------------------------------------------------------------- feeding

    def _next_ordinal(self, tenant: str) -> int:
        """The tenant-local batch ordinal (flight records)."""
        ordinal = self._tenant_batch_index.get(tenant, 0)
        self._tenant_batch_index[tenant] = ordinal + 1
        return ordinal

    def feed(self, tenant: str, *args: Any, **kwargs: Any) -> None:
        """Ingest one update batch for ``tenant`` (admission applies first)."""
        # everything downstream keys on the EFFECTIVE label, so past-cap tenants
        # (collapsed onto the overflow session) keep being served
        tenant = self._effective(tenant)
        self._renew_lease()
        trace_id = None
        if _lineage.ENABLED:
            # identity is assigned at FIRST arrival, before the admission decision
            ordinal = self._tenant_arrivals.get(tenant, 0)
            self._tenant_arrivals[tenant] = ordinal + 1
            trace_id = _lineage.mint(tenant, self._lineage_epoch, ordinal)
            _lineage.get_index().open(trace_id, tenant, ordinal)
        # wall-clock re-admission sweep over OTHER tenants' deferred backlogs; the fed
        # tenant's own backlog drains through the admit() path below
        self._maybe_readmit_deferred(exclude=tenant)
        controller = self._admission()
        if controller is not None:
            decision = controller.admit(tenant)
            if decision == _scope.DEFER:
                backlog = self._deferred.setdefault(tenant, [])
                if len(backlog) >= self.config.max_deferred:
                    # a full backlog holds real device tensors: degrade to shed, and
                    # tell the controller, whose admit() counted this as deferred
                    controller.note_degraded_shed(tenant)
                    decision = _scope.SHED
                else:
                    backlog.append((args, kwargs, trace_id))
                    self._report.deferred_batches += 1
                    self._tenant_detours[tenant] = self._tenant_detours.get(tenant, 0) + 1
                    self._tenant_deferred[tenant] = self._tenant_deferred.get(tenant, 0) + 1
                    if trace_id is not None:
                        _lineage.get_index().update(trace_id, outcome="deferred")
                    if _trace.ENABLED:
                        _trace.inc("engine.mux_deferred", mux=self._label, tenant=tenant)
                    return
            if decision == _scope.SHED:
                self._report.shed_batches += 1
                self._tenant_detours[tenant] = self._tenant_detours.get(tenant, 0) + 1
                self._tenant_shed[tenant] = self._tenant_shed.get(tenant, 0) + 1
                if trace_id is not None:
                    _lineage.get_index().update(trace_id, outcome="shed")
                if tenant not in self._shed_warned:
                    self._shed_warned.add(tenant)
                    rank_zero_warn(
                        f"Tenant {tenant!r} is over quota: its update batches are being"
                        " SHED (dropped, counted in tenant.quota_shed). This warning"
                        " fires once per tenant.",
                        RuntimeWarning,
                    )
                if _trace.ENABLED:
                    _trace.inc("engine.mux_shed", mux=self._label, tenant=tenant)
                return
            # back under quota: the tenant's deferred backlog drains first so its
            # stream order is preserved
            backlog = self._deferred.pop(tenant, None)
            if backlog:
                for b_args, b_kwargs, b_trace_id in backlog:
                    self._note_deferred_replayed(tenant)
                    controller.charge(tenant, updates=1)
                    self._ingest(tenant, b_args, b_kwargs, trace_id=b_trace_id)
            controller.charge(tenant, updates=1)
        self._ingest(tenant, args, kwargs, trace_id=trace_id)

    def _note_deferred_replayed(self, tenant: str) -> None:
        self._report.deferred_replayed += 1
        self._tenant_deferred_replayed[tenant] = self._tenant_deferred_replayed.get(tenant, 0) + 1

    def _admission(self) -> Optional[Any]:
        return self.config.admission if self.config.admission is not None else _scope.get_admission()

    def _ingest(self, tenant: str, args: tuple, kwargs: dict, trace_id: Optional[str] = None) -> None:
        self._report.batches += 1
        # tenant-local INGEST ordinal: the index a dump names is the tenant's own
        # ingested-batch count, as in the per-tenant pipeline
        batch_index = self._next_ordinal(tenant)
        if trace_id is not None and _lineage.ENABLED:
            # idempotent re-open: live records keep their arrival stamps
            _lineage.get_index().open(trace_id, tenant, _lineage.ordinal_of(trace_id))
        record = None
        if self._flight is not None:
            record = self._flight.open_record(batch_index, trace_id=trace_id)
            record["tenant"] = tenant
        if _trace.ENABLED:
            _trace.inc("engine.mux_batches", mux=self._label)
            if record is not None:
                _trace.set_gauge("flight.records", len(self._flight), pipeline=self._label, inst=self._instance)
        if not self._fusable:
            self._drive_eager(tenant, args, kwargs, record, trace_id)
            return
        if self._eager_leaders:
            # unfusable group leaders advance per batch, in stream order
            self._drive_eager_leaders(tenant, args, kwargs)
        args, kwargs = self._device_put(args, kwargs)
        leaves, treedef = tree_flatten((args, kwargs))
        traced, template, unhashable = partition_static_leaves(leaves)
        if unhashable is not None:
            # unhashable statics cannot key a group signature: keep this tenant's
            # order (dispatch its pending group) and go eager
            self._flush_pending(tenant)
            self._drive_fused_leaders_eagerly(tenant, args, kwargs, record, trace_id)
            return
        sig = (treedef, tuple(template), _aval_signature(traced))
        if record is not None or trace_id is not None:
            sig_str = signature_str(sig[2])
            if record is not None:
                record["signature"] = sig_str
            if trace_id is not None:
                _lineage.get_index().update(trace_id, signature=sig_str)
        pending = self._pending.get(tenant)
        if pending is not None:
            # the tenant already has an undispatched row: its earlier batch must land
            # before this one, whatever group it sits in
            self._report.order_flushes += 1
            if _trace.ENABLED:
                _trace.inc("engine.mux_order_flush", mux=self._label)
            self._dispatch_sig(pending)
        group = self._groups.get(sig)
        if group is None:
            group = self._groups[sig] = _MuxGroup(sig, treedef, tuple(template))
        group.tenants.append(tenant)
        group.traced.append(traced)
        group.originals.append((args, kwargs))
        group.records.append(record)
        group.trace_ids.append(trace_id)
        self._pending[tenant] = sig
        if _trace.ENABLED:
            _trace.set_gauge("engine.mux_open_groups", len(self._groups), mux=self._label)
        if len(group) >= self.config.max_width:
            self._dispatch_sig(sig)

    def _device_put(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
        device = self._device

        def _put(x: Any) -> Any:
            if isinstance(x, (torch.Tensor, np.ndarray)):
                return torch.as_tensor(x).to(device, non_blocking=True)
            return x

        return tuple(_put(a) for a in args), {k: _put(v) for k, v in kwargs.items()}

    def _flush_pending(self, tenant: str) -> None:
        sig = self._pending.get(tenant)
        if sig is not None:
            self._dispatch_sig(sig)

    def flush(self) -> None:
        """Dispatch every open group (insertion order, padded to its bucket). Also
        runs the wall-clock re-admission sweep (time gate bypassed)."""
        self._maybe_readmit_deferred(force=True)
        for sig in list(self._groups):
            self._dispatch_sig(sig)

    def poll_admission(self) -> int:
        """Wall-clock re-admission sweep over every deferred tenant's backlog (an
        external ticker's hook): each deferred tenant is probed read-only and, back
        under quota, its backlog drains in order (billed). Returns the batches drained."""
        return self._maybe_readmit_deferred(force=True)

    def _maybe_readmit_deferred(self, force: bool = False, exclude: Optional[str] = None) -> int:
        """Drain deferred backlogs whose tenants are back under quota.

        Interval-gated by ``readmit_check_seconds`` unless ``force``; ``exclude``
        skips one tenant (the per-feed sweep's caller, whose own backlog the admit()
        path drains). Backlogs drain highest priority class first."""
        if not self._deferred:
            return 0
        controller = self._admission()
        if controller is None:
            # the controller was uninstalled mid-stream: nothing meters these tenants
            # anymore, so their backlogs drain unconditionally
            deferred, self._deferred = self._deferred, {}
            drained = 0
            for tenant, backlog in deferred.items():
                for args, kwargs, trace_id in backlog:
                    self._note_deferred_replayed(tenant)
                    self._ingest(tenant, args, kwargs, trace_id=trace_id)
                    drained += 1
            return drained
        probe = getattr(controller, "would_admit", None)
        if not callable(probe):
            return 0
        now = time.monotonic()
        if not force and now - self._last_readmit_check < self.config.readmit_check_seconds:
            return 0
        self._last_readmit_check = now
        drained = 0
        order = getattr(controller, "drain_order", None)
        tenants = order(list(self._deferred)) if callable(order) else list(self._deferred)
        for tenant in tenants:
            if tenant == exclude or not probe(tenant):
                continue
            backlog = self._deferred.pop(tenant, None) or []
            for args, kwargs, trace_id in backlog:
                self._note_deferred_replayed(tenant)
                controller.charge(tenant, updates=1)
                self._ingest(tenant, args, kwargs, trace_id=trace_id)
                drained += 1
            if _trace.ENABLED and backlog:
                _trace.event("engine.mux_readmitted", mux=self._label, tenant=tenant, batches=len(backlog))
        return drained

    def flush_deferred(self) -> None:
        """Drain every tenant's deprioritized backlog (admission decisions bypassed,
        executed updates still billed), highest priority class first."""
        controller = self._admission()
        deferred, self._deferred = self._deferred, {}
        order = getattr(controller, "drain_order", None)
        tenants = order(list(deferred)) if callable(order) else list(deferred)
        for tenant in tenants:
            for args, kwargs, trace_id in deferred[tenant]:
                self._note_deferred_replayed(tenant)
                if controller is not None:
                    controller.charge(tenant, updates=1)
                self._ingest(tenant, args, kwargs, trace_id=trace_id)
        self.flush()

    def close(self) -> MuxReport:
        """Flush open groups AND the deferred backlog; end the tenant sessions."""
        try:
            self.flush()
            self.flush_deferred()
            # the slice streams end complete (slices the cadence already covered skip
            # the duplicate write)
            if self._checkpointers and self._report.batches:
                self._maybe_checkpoint(force=True, skip_covered=True)
            self._evaluate_alerts([], force=True)
        finally:
            if not self._closed:
                self._closed = True
                registry = _scope.get_registry()
                for tenant in self._metrics:
                    registry.pipeline_finished(tenant)
                for tenant in self._checkpointers:
                    _scope.note_checkpoint_closed(tenant)
                lease_rows = _scope.lease_status()
                for tenant in self._metrics:
                    # release only rows this mux's epoch still owns: a failed-over
                    # tenant's fresh lease must stay live
                    if lease_rows.get(tenant, {}).get("epoch") == self._lease["epoch"]:
                        _scope.note_lease_released(tenant)
                if _audit.ENABLED:
                    # freeze every tenant's final ledger rows for the merge
                    _audit.note_close(self)
        return self.report()

    def __enter__(self) -> "TenantMultiplexer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def compute(self, tenant: str) -> Any:
        """Flush the tenant's pending work, then compute its metric."""
        tenant = self._aliases.get(tenant, tenant)
        self._flush_pending(tenant)
        with _scope.session(tenant):
            return self._metrics[tenant].compute()

    # ---------------------------------------------------------------------- warmup

    def warmup(self, *args: Any, manifest_path: Optional[str] = None, **kwargs: Any) -> Dict[str, Any]:
        """Capture every (tenant-width bucket, signature) fused variant for one example
        batch (real tensors or ``torch.empty(..., device="meta")`` specs), plus the
        template's per-batch path (the replay fallback) where its metrics capture
        their updates (``jit_update=True``). Returns (and stores) the warmup manifest,
        whose entries carry each variant's counted flops and bytes."""
        if self._template is None:
            raise RuntimeError("TenantMultiplexer.warmup needs at least one adopted tenant")
        leaves, treedef = tree_flatten((args, kwargs))
        traced, template, unhashable = partition_static_leaves(leaves)
        if unhashable is not None:
            raise TypeError(
                "TenantMultiplexer.warmup received an unhashable static argument of type"
                f" {type(unhashable).__name__}; such batches dispatch per tenant eagerly"
                " and cannot be captured."
            )
        specs = [torch.empty(tuple(t.shape), dtype=torch.as_tensor(t).dtype, device="meta") for t in traced]
        shapes = [list(map(int, s.shape)) for s in specs]
        entries: List[Dict[str, Any]] = []
        if self._fusable:
            fused = self._get_fused_fn(treedef, tuple(template))
            state = self._fused_state(self._template)
            for width in self._buckets:
                valid = torch.empty((width,), dtype=torch.bool, device="meta")
                info = fused.warmup(
                    tuple(state for _ in range(width)), tuple(tuple(specs) for _ in range(width)), valid,
                    self._lower(width),
                )
                if info.get("flops") is not None or info.get("bytes_accessed") is not None:
                    self._width_prices[width] = (info.get("flops"), info.get("bytes_accessed"))
                entries.append({**info, "kind": "mux", "width": width, "shapes": shapes})
        # the template's per-batch path: the replay/eager fallback
        it = iter(specs)
        abstract = [next(it) if isinstance(t, _ArraySlot) else t for t in template]
        a_args, a_kwargs = tree_unflatten(treedef, abstract)
        for m in self._per_batch_metrics(self._template):
            if not m._jit_enabled():
                continue
            if m._jitted_update is None:
                m._jitted_update = jit_with_static_leaves(m.pure_update)
            filtered = m._filter_kwargs(**a_kwargs) if self._is_collection else a_kwargs
            info = m._jitted_update.warmup(m._traced_state(), *a_args, **filtered)
            entries.append({**info, "kind": "per_batch", "width": None, "shapes": shapes})
        manifest = _warmup.build_manifest(entries, cache_dir=_warmup.configured_cache_dir())
        self._warmup_manifest = manifest
        if _trace.ENABLED:
            _trace.event(
                "engine.mux_warmup",
                mux=self._label,
                variants=manifest["variants"],
                fresh=manifest["fresh_compiles"],
                seconds=manifest["total_compile_seconds"],
            )
        if manifest_path is not None:
            _warmup.save_manifest(manifest, manifest_path)
        return manifest

    # ------------------------------------------------------------------ fused path

    def _per_batch_metrics(self, target: Union[Metric, MetricCollection]) -> List[Metric]:
        """The metrics the per-tenant eager/replay path drives directly."""
        if not self._is_collection:
            return [target]
        return [target._modules[name] for name in self._fused_leaders if name is not None]

    def _fused_state(self, target: Union[Metric, MetricCollection]) -> Any:
        if not self._is_collection:
            return target._traced_state()
        return {name: target._modules[name]._traced_state() for name in self._fused_leaders}

    def _lower(self, width: int) -> int:
        """Rows of a group padded to ``width`` that are always real: those below the
        next smaller bucket of the ladder in force (the rest are masked)."""
        return max((b for b in self._buckets if b < width), default=0)

    def _get_fused_fn(self, treedef: Any, template: tuple) -> StaticLeafJit:
        key = (treedef, template)
        fused = self._fused_fns.get(key)
        if fused is not None:
            return fused
        target = self._template
        leaders = [(name, target._modules[name]) for name in self._fused_leaders] if self._is_collection else None

        def step(state: Any, row: tuple) -> Any:
            it = iter(row)
            full = [next(it) if isinstance(t, _ArraySlot) else t for t in template]
            a, kw = tree_unflatten(treedef, full)
            if leaders is None:
                return target.pure_update(state, *a, **kw)
            return {name: m.pure_update(state[name], *a, **m._filter_kwargs(**kw)) for name, m in leaders}

        def mux_update(states, rows, valid, lower):
            # one row per tenant, each folding its own state: JAX's vmap over the
            # tenant axis, unrolled (the kernels launch through ctypes). Padded rows
            # past `lower` pass their state through, so a partial group padded up to
            # its width bucket stays bitwise the unpadded per-tenant run.
            out = []
            for i in range(valid.shape[0]):
                new = step(states[i], rows[i])
                out.append(_masked(valid[i], new, states[i]) if i >= lower else new)
            return tuple(out)

        mux_update.__name__ = "mux_update"
        mux_update.__qualname__ = f"{self._label}.mux_update"
        fused = jit_with_static_leaves(mux_update, pool=self._pool)
        self._fused_fns[key] = fused
        return fused

    def _width_bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _valid_mask(self, width: int, n: int) -> torch.Tensor:
        mask = self._valid_masks.get((width, n))
        if mask is None:
            mask = self._valid_masks[(width, n)] = torch.arange(width, device=self._device) < n
        return mask

    def retune_width_buckets(self, buckets) -> Tuple[int, ...]:
        """Adopt a new width-bucket ladder (admission-driven tuning).

        The proposal is validated through the same ``MuxConfig`` rules as a
        construction-time ladder — positive, deduped, ascending, top bucket clamped to
        ``max_width`` — and an invalid proposal raises without touching state. Groups
        already open keep the width they were admitted under; only future dispatch
        padding consults the new ladder. Captured variants are kept per padded width,
        so a retune adds at most O(log W) new captures and orphans none.
        """
        cfg = MuxConfig(max_width=self.config.max_width, width_buckets=tuple(buckets))
        resolved = cfg.buckets()
        self.config.width_buckets = resolved
        self._buckets = resolved
        return resolved

    def _row_policy(self, tenant: str):
        """The error policy guarding this tenant's row (any fused metric's, else the
        global default) — mirrors the pipeline's chunk policy."""
        for m in self._per_batch_metrics(self._metrics[tenant]):
            policy = effective_policy(m.error_policy)
            if policy is not None:
                return policy
        return None

    @staticmethod
    def _stack_probe(rows: list) -> list:
        """Each traced column of the group stacked along the row axis, on the device:
        the non-finite screen reads it with one host sync."""
        return [torch.stack([row[1][i] for row in rows]) for i in range(len(rows[0][1]))]

    def _dispatch_sig(self, sig: tuple) -> None:
        group = self._groups.pop(sig, None)
        if group is None or not len(group):
            return
        for tenant in group.tenants:
            self._pending.pop(tenant, None)
        rows = list(zip(group.tenants, group.traced, group.originals, group.records, group.trace_ids))
        # one non-finite screen per GROUP; only guarded tenants' rows count — an
        # unguarded tenant's NaN must flow into ITS state like always
        guarded = {i for i, row in enumerate(rows) if self._row_policy(row[0]) is not None}
        if guarded:
            bad = [i for i in nonfinite_step_indices(self._stack_probe(rows)) if i in guarded]
            if bad:
                if _trace.ENABLED:
                    _trace.event(
                        "engine.mux_degraded",
                        mux=self._label,
                        reason="nonfinite",
                        tenants=",".join(rows[i][0] for i in bad),
                        width=len(rows),
                    )
                # the clean cohort lands FIRST, then exactly the poisoned tenants'
                # batches replay through their OWN guarded updates
                poisoned = set(bad)
                clean = [row for i, row in enumerate(rows) if i not in poisoned]
                if clean:
                    self._dispatch_rows(group, clean)
                self._replay_rows([rows[i] for i in bad], reason="group_replay")
                return
        self._dispatch_rows(group, rows)

    def _tenant_robust_counts(self, tenant: str) -> Tuple[int, int]:
        """(quarantined, skipped) totals of one tenant's metrics — diffed around a
        replay/eager update to attribute the fault to its batch."""
        target = self._metrics[tenant]
        metrics = list(target._modules.values()) if self._is_collection else [target]
        quarantined = skipped = 0
        for m in metrics:
            quarantined += int(getattr(m, "updates_quarantined", 0) or 0)
            skipped += int(getattr(m, "updates_skipped", 0) or 0)
        return quarantined, skipped

    def _dump_flight(
        self, reason: str, tenant: str, poisoned: List[int], trace_ids: Optional[List[str]] = None
    ) -> Optional[str]:
        """One fault dump naming ONE tenant's poisoned tenant-local batches (the full
        cross-tenant ring rides along as context)."""
        if self._flight is None:
            return None
        config = {"max_width": self.config.max_width, "buckets": list(self._buckets), "tenants": len(self._metrics)}
        path = self._flight.dump(reason, poisoned, config, tenant=tenant, poisoned_trace_ids=trace_ids)
        if path is not None:
            self._report.flight_dumps += 1
            _lineage.note_dump(trace_ids or [], path)
            if _trace.ENABLED:
                _trace.inc("flight.dumps", pipeline=self._label)
                _trace.event(
                    "engine.mux_flight_dump",
                    mux=self._label,
                    tenant=tenant,
                    reason=reason,
                    path=path,
                    poisoned=",".join(map(str, sorted(set(poisoned)))),
                    trace_ids=",".join(sorted(set(trace_ids or []))),
                )
        return path

    def _replay_rows(self, rows: List[tuple], reason: str = "group_replay") -> None:
        """Guarded per-tenant replays; the first raising tenant's error propagates only
        after every row has had its replay and every faulted tenant its dump."""
        errors: List[BaseException] = []
        replayed: List[str] = []
        replayed_ids: List[str] = []
        poisoned_by_tenant: Dict[str, List[int]] = {}
        poisoned_ids_by_tenant: Dict[str, List[str]] = {}
        for tenant, _, (r_args, r_kwargs), record, tid in rows:
            if tid is not None:
                replayed_ids.append(tid)
            before = self._tenant_robust_counts(tenant)
            try:
                with _lineage.trace(tid):
                    self._replay_row(tenant, r_args, r_kwargs)
            except BaseException as err:  # raise-policy tenants re-raise below
                if _is_device_fault(err):
                    raise
                errors.append(err)
                if record is not None:
                    record["path"] = "replay"
                    record["fault"] = "raised"
                    poisoned_by_tenant.setdefault(tenant, []).append(record["batch_index"])
                if tid is not None:
                    _lineage.get_index().update(tid, path="replay", outcome="raised")
                    poisoned_ids_by_tenant.setdefault(tenant, []).append(tid)
            else:
                fault = None
                quarantined, skipped = self._tenant_robust_counts(tenant)
                if quarantined > before[0]:
                    fault = "quarantined"
                elif skipped > before[1]:
                    fault = "skipped"
                if record is not None:
                    record["path"] = "replay"
                    record["fault"] = fault
                    if fault is not None:
                        poisoned_by_tenant.setdefault(tenant, []).append(record["batch_index"])
                if tid is not None:
                    _lineage.get_index().update(tid, path="replay", outcome=fault if fault is not None else "ok")
                    if fault is not None:
                        poisoned_ids_by_tenant.setdefault(tenant, []).append(tid)
            replayed.append(tenant)
        for tenant in sorted(set(poisoned_by_tenant) | set(poisoned_ids_by_tenant)):
            self._dump_flight(
                reason, tenant, poisoned_by_tenant.get(tenant, []), trace_ids=poisoned_ids_by_tenant.get(tenant)
            )
        self._maybe_checkpoint()
        self._evaluate_alerts(replayed, trace_ids=replayed_ids)
        if errors:
            raise errors[0]

    def _dispatch_rows(self, group: _MuxGroup, rows: List[tuple]) -> None:
        n = len(rows)
        width = self._width_bucket(n)
        pad = width - n
        padded = rows + [rows[-1]] * pad  # repeat-last padding, masked out
        traced_rows = tuple(tuple(row[1]) for row in padded)
        valid = self._valid_mask(width, n)
        states = [self._fused_state(self._metrics[row[0]]) for row in rows]
        states += [states[-1]] * pad
        fused = self._get_fused_fn(group.treedef, group.template)
        controller = self._admission()
        ledger_mark = _cost.get_ledger().mark() if controller is not None else None
        gid = self._group_seq
        self._group_seq += 1
        row_ids = [row[4] for row in rows if row[4] is not None]
        try:
            if _trace.ENABLED:
                span_attrs: Dict[str, Any] = {"pipeline": self._label, "path": "mux", "width": n}
                if row_ids:
                    span_attrs["trace_id"] = row_ids[0]
                    span_attrs["trace_ids"] = ",".join(row_ids)
                with _lineage.trace(row_ids[0] if row_ids else None):
                    with _trace.span("engine.dispatch", **span_attrs):
                        new_states = fused(tuple(states), traced_rows, valid, self._lower(width))
            else:
                new_states = fused(tuple(states), traced_rows, valid, self._lower(width))
        except Exception as err:
            if _is_device_fault(err):
                raise
            # state was never committed; every row replays through its own (guarded
            # or not) per-tenant update, isolating real failures
            if _trace.ENABLED:
                _trace.event("engine.mux_degraded", mux=self._label, reason=type(err).__name__, width=n)
            self._replay_rows(rows, reason="group_replay")
            return
        committed: List[str] = []
        for i, row in enumerate(rows):
            tenant = row[0]
            with _scope.session(tenant):
                self._commit(self._metrics[tenant], new_states[i])
            self._tenant_folded[tenant] = self._tenant_folded.get(tenant, 0) + 1
            committed.append(tenant)
            record = row[3]
            if record is not None:
                record["chunk_id"] = gid
                record["path"] = "mux"
            if _audit.ENABLED:
                # on the host, after the group's replay has returned
                _audit.note_fold(self, "mux", tenant, self._lineage_epoch, row[4])
            if row[4] is not None:
                _lineage.get_index().update(row[4], chunk_id=gid, path="mux", outcome="ok")
        self._report.dispatches += 1
        self._report.fused_updates += n
        self._report.padded_rows += pad
        self._report.max_width = max(self._report.max_width, n)
        self._report.last_width = n
        if _trace.ENABLED:
            _trace.inc("engine.mux_dispatches", mux=self._label)
            _trace.inc("engine.mux_fused_updates", n, mux=self._label)
            if pad:
                _trace.inc("engine.mux_padded_rows", pad, mux=self._label)
            _trace.set_gauge("engine.mux_width", n, mux=self._label)
            _trace.set_gauge("engine.mux_open_groups", len(self._groups), mux=self._label)
        if controller is not None:
            self._charge_rows(controller, committed, width, ledger_mark)
        self._maybe_checkpoint()
        self._evaluate_alerts(committed, trace_ids=row_ids)

    def _commit(self, target: Union[Metric, MetricCollection], state: Any) -> None:
        if self._is_collection:
            target._engine_commit({name: state[name] for name in self._fused_leaders}, 1)
        else:
            target._engine_commit_state(state, 1)
        for m in self._per_batch_metrics(target):
            m._check_buffer_overflow()

    def _charge_rows(self, controller: Any, tenants: List[str], width: int, ledger_mark: Optional[int]) -> None:
        """Bill the dispatch back per tenant: the executed width bucket's per-dispatch
        count split across its rows, plus fresh capture seconds split across the rows
        that forced them (shared graphs, shared bill)."""
        try:
            ledger = _cost.get_ledger()
            compile_delta = ledger.since(ledger_mark) if ledger_mark is not None else {}
            fresh = compile_delta.get("variants_compiled", 0)
            if fresh and width not in self._width_prices:
                # the first dispatch at this width captured exactly this width's
                # variant: the delta's estimate IS its price
                self._width_prices[width] = (compile_delta.get("estimated_flops"), compile_delta.get("estimated_bytes"))
            if width in self._width_prices:
                flops, bytes_accessed = self._width_prices[width]
            else:
                # an unpriced width: the cross-width ledger mean, until it is priced
                price = ledger.fn_estimate(f"{self._label}.mux_update")
                flops = price.get("flops_per_dispatch")
                bytes_accessed = price.get("bytes_per_dispatch")
            per_row_flops = (flops or 0.0) / max(1, width)
            per_row_bytes = (bytes_accessed or 0.0) / max(1, width)
            compile_share = float(compile_delta.get("compile_seconds", 0.0)) / len(tenants) if tenants else 0.0
            for tenant in tenants:
                controller.charge(
                    tenant, flops=per_row_flops, bytes_accessed=per_row_bytes, compile_seconds=compile_share
                )
        except Exception:  # pricing must never cost correctness
            pass

    # ------------------------------------------------------------- per-tenant paths

    def _mark_eager_fault(
        self, tenant: str, record: Optional[dict], before: Tuple[int, int], trace_id: Optional[str] = None
    ) -> None:
        """Stamp an eager-path record with its fault; quarantines dump directly (no
        replay step exists to do it — the pipeline's eager-path rule)."""
        if record is None and trace_id is None:
            return
        quarantined, skipped = self._tenant_robust_counts(tenant)
        fault = None
        if quarantined > before[0]:
            fault = "quarantined"
        elif skipped > before[1]:
            fault = "skipped"
        if record is not None:
            record["path"] = "eager"
            record["fault"] = fault
        if trace_id is not None:
            _lineage.get_index().update(trace_id, path="eager", outcome=fault if fault is not None else "ok")
        if fault == "quarantined":
            self._dump_flight(
                "quarantine",
                tenant,
                [record["batch_index"]] if record is not None else [],
                trace_ids=[trace_id] if trace_id is not None else None,
            )

    def _drive_eager(
        self, tenant: str, args: tuple, kwargs: dict, record: Optional[dict] = None, trace_id: Optional[str] = None
    ) -> None:
        """Whole-target per-tenant update (target unfusable)."""
        target = self._metrics[tenant]
        attributed = record is not None or trace_id is not None
        before = self._tenant_robust_counts(tenant) if attributed else (0, 0)
        with _scope.session(tenant):
            with _lineage.trace(trace_id):
                if _trace.ENABLED:
                    span_attrs: Dict[str, Any] = {"pipeline": self._label, "path": "eager"}
                    if trace_id is not None:
                        span_attrs["trace_id"] = trace_id
                    with _trace.span("engine.dispatch", **span_attrs):
                        target.update(*args, **kwargs)
                else:
                    target.update(*args, **kwargs)
        self._tenant_folded[tenant] = self._tenant_folded.get(tenant, 0) + 1
        self._report.eager_updates += 1
        self._report.eager_dispatches += 1
        if _audit.ENABLED:
            _audit.note_fold(self, "mux", tenant, self._lineage_epoch, trace_id)
        if _trace.ENABLED:
            _trace.inc("engine.mux_eager_updates", mux=self._label)
        self._mark_eager_fault(tenant, record, before, trace_id)
        self._maybe_checkpoint()
        self._evaluate_alerts([tenant], trace_ids=[trace_id] if trace_id is not None else ())

    def _drive_eager_leaders(self, tenant: str, args: tuple, kwargs: dict) -> None:
        target = self._metrics[tenant]
        with _scope.session(tenant):
            for name in self._eager_leaders:
                m = target._modules[name]
                m.update(*args, **m._filter_kwargs(**kwargs))
        self._report.eager_dispatches += len(self._eager_leaders)

    def _drive_fused_leaders_eagerly(
        self, tenant: str, args: tuple, kwargs: dict, record: Optional[dict] = None, trace_id: Optional[str] = None
    ) -> None:
        """Per-tenant fallback for a batch that cannot join a group."""
        target = self._metrics[tenant]
        attributed = record is not None or trace_id is not None
        before = self._tenant_robust_counts(tenant) if attributed else (0, 0)
        with _scope.session(tenant):
            with _lineage.trace(trace_id):
                self._replay_updates(target, args, kwargs)
        self._tenant_folded[tenant] = self._tenant_folded.get(tenant, 0) + 1
        self._report.eager_updates += 1
        self._report.eager_dispatches += max(1, len(self._per_batch_metrics(target)))
        if _audit.ENABLED:
            _audit.note_fold(self, "mux", tenant, self._lineage_epoch, trace_id)
        self._mark_eager_fault(tenant, record, before, trace_id)
        self._maybe_checkpoint()
        self._evaluate_alerts([tenant], trace_ids=[trace_id] if trace_id is not None else ())

    def _replay_row(self, tenant: str, args: tuple, kwargs: dict) -> None:
        """Guarded per-tenant replay of a poisoned/failed row: the tenant's own error
        policy decides (skip/quarantine/raise) — its cohort never sees it."""
        target = self._metrics[tenant]
        with _scope.session(tenant):
            if _trace.ENABLED:
                span_attrs: Dict[str, Any] = {"pipeline": self._label, "path": "replay"}
                trace_id = _lineage.current_trace()  # set by _replay_rows
                if trace_id is not None:
                    span_attrs["trace_id"] = trace_id
                with _trace.span("engine.dispatch", **span_attrs):
                    self._replay_updates(target, args, kwargs)
            else:
                self._replay_updates(target, args, kwargs)
        self._tenant_folded[tenant] = self._tenant_folded.get(tenant, 0) + 1
        self._report.replayed_updates += 1
        self._report.eager_dispatches += max(1, len(self._per_batch_metrics(target)))
        if _audit.ENABLED:
            # the ambient trace context is set by _replay_rows around this call
            _audit.note_fold(self, "mux", tenant, self._lineage_epoch, _lineage.current_trace())
        if _trace.ENABLED:
            _trace.inc("engine.mux_replayed_updates", mux=self._label, tenant=tenant)

    def _replay_updates(self, target: Any, args: tuple, kwargs: dict) -> None:
        for m in self._per_batch_metrics(target):
            filtered = m._filter_kwargs(**kwargs) if self._is_collection else kwargs
            m.update(*args, **filtered)
        if self._is_collection:
            target._sync_group_states()

    # ------------------------------------------------------------------ alert seam

    def _evaluate_alerts(self, tenants: Iterable[str], force: bool = False, trace_ids: Iterable[str] = ()) -> None:
        """Per-committed-group value-health evaluation (``config.alert_engine``):
        sample each committed tenant's values sync-free under its session, then run
        the rules. A broken engine warns once and the stream keeps flowing."""
        engine = self.config.alert_engine
        if engine is None:
            return
        self._alert_commits += 1
        if not force and self._alert_commits % self.config.alert_every:
            return
        try:
            log_hook = getattr(engine, "_log", None)
            log = log_hook() if callable(log_hook) else None
            for tenant in tenants:
                with _scope.session(tenant):
                    _values.sample_local(self._metrics[tenant], log=log)
            transitions = engine.evaluate()
            fired_rules = sorted(
                {t["rule"] for t in transitions if t["to"] == "firing" and t.get("source") == "values"}
            )
            if fired_rules:
                # link newly fired value watchdogs back to the rows whose commit
                # triggered this evaluation (the lineage alert join)
                _lineage.note_alert(list(trace_ids), fired_rules)
        except Exception as err:
            if not self._alert_warned:
                self._alert_warned = True
                rank_zero_warn(
                    f"Alert evaluation failed on the {self._label} multiplexer"
                    f" ({type(err).__name__}: {err}). The stream keeps flowing; further"
                    " failures are silent (this warning fires once) and value watchdogs"
                    " may be stale.",
                    RuntimeWarning,
                )
