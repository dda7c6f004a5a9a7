"""Streaming evaluation pipeline: prefetch, a bounded in-flight window, fused chunks.

Counterpart of ``torchmetrics_tpu/engine/pipeline.py``. The stateful ``Metric`` API
pays host dispatch for every ``update``: on the card the classification loops spend
most of their time issuing small kernels. :class:`MetricPipeline` sits between a
user's batch stream and a ``Metric`` or ``MetricCollection`` and turns the loop into
what the card wants:

- **Micro-batch fusion** — up to ``fuse`` same-signature batches are accumulated into
  a chunk, stacked along a leading step axis, and folded into the state by ONE call
  of a fused function that runs every fused leader's ``pure_update`` for each step
  (the same transitions the per-batch path uses, so results are bit-identical). The
  function goes through the capture cache (``core/jit.py``): on the card a chunk is
  one CUDA-graph replay, the kernels K1, K2 and K3 inside it. Chunk lengths are
  padded up to a small set of buckets (powers of two up to ``fuse``) with the padded
  tail masked out of the state (``torch.where(valid[i], new, old)``), so a flush of 5
  batches and one of 8 share a graph. A batch whose shapes or statics differ from the
  open chunk flushes it first, preserving stream order. With ``fuse=1`` each batch is
  one replay of the leaders' update, counted as a per-batch dispatch as in JAX.
- **Stacking** stacks each column of the chunk's batches into a fresh tensor along the
  step axis (``torch.stack``); the capture cache copies it into the graph's input
  buffers before the replay.
- **Prefetch** — :meth:`run` keeps ``prefetch`` upcoming batches on the target's
  device ahead of use (non-blocking copies; nothing to do for batches already there).
- **Bounded in-flight dispatch** — the pipeline never synchronises per step; it
  records a CUDA event after each replay and waits on the oldest only when
  ``max_in_flight`` are outstanding.
- **Fault isolation per chunk** — under an error policy (``robust/policy.py``) each
  chunk is screened once for non-finite inputs (one host sync per chunk); a poisoned
  chunk, or a replay that raises, degrades to a per-batch replay through the metrics'
  own guarded ``update``, so exactly the poisoned batches are skipped or quarantined.
- **Flight recorder** — a bounded ring of per-batch lineage records, dumped as JSONL
  (atomic, ``utils/fileio``) when a chunk degrades or a batch is quarantined.

Telemetry (``obs/trace.py``, off by default) keeps the JAX package's names:
``engine.dispatch`` spans, queue-depth / in-flight / fused-chunk-size gauges,
prefetch hit/miss, padded-step, degrade and flight-dump counters. :meth:`report`
returns the same accounting as plain ints.

The pipeline drives **update-only** accumulation (N updates, one ``compute``). It is
also a **session**, as in the JAX package:

- ``tenant`` makes it a tenant session (``obs/scope.py``): every public entry point
  runs under ``scope.session``, the driven metrics adopt the tenant, and the registry
  counts the session in ``active_pipelines``.
- ``alert_engine`` evaluates value watchdogs (``obs/alerts.py``) every
  ``alert_every``-th commit over a sync-free sample of the values
  (``obs/values.sample_local``) and dumps the flight ring when a value rule fires.
- ``checkpoint`` writes crash-consistent session bundles (``engine/migrate.py``) at
  chunk-commit boundaries; :meth:`drain` and :meth:`replay_tail` are the two halves
  of a live migration.
- every session holds a lease (``robust/fence.py``) minted under its lineage epoch,
  renewed at about ``lease_seconds / 4`` and released at :meth:`close`.

- ``admission`` (or the process-wide controller of ``obs/scope.py``) meters a tenant
  session per ingested batch: an over-quota batch is shed (dropped, counted) or
  deferred (held, drained in order when the tenant is back under quota, at
  :meth:`flush`, :meth:`poll_admission` or :meth:`close`); only updates are charged.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, fields, replace
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

import torchmetrics_tpu_torch.obs.audit as _audit
import torchmetrics_tpu_torch.obs.lineage as _lineage
import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as _trace
import torchmetrics_tpu_torch.obs.values as _values
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
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
from torchmetrics_tpu_torch.robust import faults as _faults
from torchmetrics_tpu_torch.robust import fence as _fence
from torchmetrics_tpu_torch.robust.policy import effective_policy, nonfinite_step_indices
from torchmetrics_tpu_torch.utils.fileio import atomic_write_text
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["FLIGHT_DIR_ENV", "FLIGHT_SCHEMA", "MetricPipeline", "PipelineConfig", "PipelineReport"]

# where flight-recorder dumps land when the config does not name a directory
FLIGHT_DIR_ENV = "TM_TPU_FLIGHT_DIR"
# wire format of a dump file (meta line `schema` field), the JAX package's
FLIGHT_SCHEMA = 1


@dataclass
class PipelineConfig:
    """Tuning knobs for :class:`MetricPipeline`.

    Args:
        fuse: max batches fused into one replay. ``1`` disables fusion (per-batch
            updates, still prefetched and in-flight-bounded).
        max_in_flight: max dispatched-but-unawaited chunks before the pipeline waits
            on the oldest.
        prefetch: how many upcoming batches :meth:`MetricPipeline.run` keeps on the
            device ahead of use.
        fuse_buckets: explicit chunk-length buckets (ascending). Default: powers of
            two up to ``fuse`` — a partial flush pads up to the next bucket with a
            masked tail so the variant count stays ``O(log fuse)`` per signature.
        device: device for prefetched batches (``None``: the target metric's).
        flight_records: flight-recorder ring capacity. ``0`` disables the recorder.
        flight_dump_dir: where fault dumps land. ``None``: the ``TM_TPU_FLIGHT_DIR``
            environment variable, else ``<tempdir>/tm_tpu_flight``.
        flight_max_dumps: hard cap on dump files one pipeline writes; suppressed
            dumps are counted (``flight.dumps_suppressed``).
        tenant: name this pipeline a **tenant session** (``obs/scope.py``): every
            dispatch, commit, flight record and value sample runs under the tenant's
            scope, the driven metrics adopt the tenant, and the registry tracks the
            session's liveness. ``None`` (default) keeps the untenanted session.
        alert_engine: an :class:`~torchmetrics_tpu_torch.obs.alerts.AlertEngine` to
            evaluate at commits: the values are sampled sync-free
            (``obs.values.sample_local``), the rules run, and a newly firing *value*
            watchdog dumps the flight ring. ``None`` (default) disables the seam.
        alert_every: evaluate the alert engine every Nth commit (``close()`` always
            runs a final evaluation).
        admission: an :class:`~torchmetrics_tpu_torch.obs.scope.AdmissionController`
            consulted per ingested batch when the pipeline is a **tenant session**:
            over-quota batches are shed (dropped, counted) or deferred (held, drained
            at ``close()`` or when the tenant falls back under quota), per the
            tenant's quota policy. ``None`` falls back to the process-wide controller
            (:func:`~torchmetrics_tpu_torch.obs.scope.get_admission`); untenanted
            pipelines never consult admission.
        max_deferred: cap on the deprioritized backlog (deferred batches hold real
            device tensors); past it, defer decisions degrade to shed.
        checkpoint: a :class:`~torchmetrics_tpu_torch.engine.migrate.CheckpointPolicy`
            — **continuous checkpointing**: bundles every N batches / T seconds at
            chunk-commit boundaries (no drain, chunk-consistent by construction),
            delta-encoded, compacted every ``full_every``-th write, swept, and found
            again by ``latest_valid_bundle`` after an unplanned death. ``None``
            (default) disables.
        lease_seconds: TTL of the session's renewable wall-clock **lease**
            (``robust/fence.py``), minted per session epoch, renewed on ingest and
            commit (at most every ~TTL/4) and stamped into every bundle, which makes
            the epoch a fencing token. Default 30 s.
    """

    fuse: int = 8
    max_in_flight: int = 4
    prefetch: int = 2
    fuse_buckets: Optional[Tuple[int, ...]] = None
    device: Any = None
    flight_records: int = 64
    flight_dump_dir: Optional[str] = None
    flight_max_dumps: int = 16
    tenant: Optional[str] = None
    alert_engine: Any = None
    alert_every: int = 1
    admission: Any = None
    max_deferred: int = 1024
    checkpoint: Any = None
    lease_seconds: float = 30.0

    def __post_init__(self) -> None:
        if self.tenant is not None:
            _scope.validate_tenant(self.tenant)
        if self.fuse < 1:
            raise ValueError(f"Expected `fuse` >= 1, got {self.fuse}")
        if self.lease_seconds <= 0:
            raise ValueError(f"Expected `lease_seconds` > 0, got {self.lease_seconds}")
        if self.max_in_flight < 1:
            raise ValueError(f"Expected `max_in_flight` >= 1, got {self.max_in_flight}")
        if self.prefetch < 0:
            raise ValueError(f"Expected `prefetch` >= 0, got {self.prefetch}")
        if self.flight_records < 0:
            raise ValueError(f"Expected `flight_records` >= 0, got {self.flight_records}")
        if self.flight_max_dumps < 0:
            raise ValueError(f"Expected `flight_max_dumps` >= 0, got {self.flight_max_dumps}")
        if self.alert_every < 1:
            raise ValueError(f"Expected `alert_every` >= 1, got {self.alert_every}")
        if self.max_deferred < 1:
            raise ValueError(f"Expected `max_deferred` >= 1, got {self.max_deferred}")
        if self.fuse_buckets is not None:
            buckets = tuple(sorted(set(int(b) for b in self.fuse_buckets)))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"Expected positive `fuse_buckets`, got {self.fuse_buckets}")
            if buckets[-1] < self.fuse:
                buckets = buckets + (self.fuse,)
            self.fuse_buckets = buckets

    def buckets(self) -> Tuple[int, ...]:
        if self.fuse_buckets is not None:
            return self.fuse_buckets
        return _warmup.pow2_buckets(self.fuse)


@dataclass
class PipelineReport:
    """Plain-int accounting of one pipeline's work (no obs tracing required)."""

    batches: int = 0  # batches ingested
    fused_batches: int = 0  # batches that landed via a fused chunk
    eager_batches: int = 0  # batches driven per batch
    replayed_batches: int = 0  # per-batch replays after a chunk degraded
    dispatches: int = 0  # fused chunk dispatches issued
    eager_dispatches: int = 0  # per-batch dispatches (incl. replays)
    chunks_replayed: int = 0  # chunks degraded to per-batch replay
    padded_steps: int = 0  # masked tail steps added by bucket padding
    shape_flushes: int = 0  # chunks flushed early by a signature change
    max_chunk: int = 0
    last_chunk: int = 0
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    inflight_waits: int = 0
    flight_dumps: int = 0  # flight-recorder fault dumps written
    shed_batches: int = 0  # admission: over-quota batches dropped (tenant sessions)
    deferred_batches: int = 0  # admission: batches deprioritized (held)
    deferred_replayed: int = 0  # deferred batches later ingested

    def host_dispatches(self) -> int:
        """Total host dispatches that advanced metric state."""
        return self.dispatches + self.eager_dispatches

    def dispatches_per_batch(self) -> Optional[float]:
        """Host dispatches per ingested batch (< 1.0 once fusion engages)."""
        if not self.batches:
            return None
        return self.host_dispatches() / self.batches

    def processed_batches(self) -> int:
        """Every batch that reached a dispatch."""
        return self.fused_batches + self.eager_batches + self.replayed_batches

    def asdict(self) -> Dict[str, Any]:
        out = {f.name: getattr(self, f.name) for f in fields(self)}
        out["host_dispatches"] = self.host_dispatches()
        out["dispatches_per_batch"] = self.dispatches_per_batch()
        out["processed_batches"] = self.processed_batches()
        return out


def _normalize_batch(batch: Any) -> Tuple[tuple, dict]:
    """Accept ``(args...)`` tuples, ``{kwarg: value}`` dicts, or a single tensor."""
    if isinstance(batch, tuple):
        return batch, {}
    if isinstance(batch, dict):
        return (), dict(batch)
    return (batch,), {}


def _masked(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """``new`` where ``ok`` (a 0-d bool tensor), else ``old``, leaf by leaf."""
    new_leaves, new_def = tree_flatten(new)
    old_leaves, _ = tree_flatten(old)
    return tree_unflatten(new_def, [torch.where(ok, n, o) for n, o in zip(new_leaves, old_leaves)])


class _Chunk:
    """One open fusion chunk: same-signature batches awaiting a fused dispatch."""

    __slots__ = ("sig", "treedef", "template", "traced", "originals", "records", "trace_ids", "first_index")

    def __init__(self, sig: tuple, treedef: Any, template: tuple, first_index: int) -> None:
        self.sig = sig
        self.treedef = treedef
        self.template = template
        self.traced: List[list] = []  # per batch: traced leaves, template order
        self.originals: List[Tuple[tuple, dict]] = []  # per batch: (args, kwargs)
        self.records: List[dict] = []  # per batch: flight-recorder record (flight on only)
        self.trace_ids: List[Optional[str]] = []  # per batch: lineage id (None when disabled)
        self.first_index = first_index  # ingest ordinal of the chunk's first batch

    def __len__(self) -> int:
        return len(self.traced)


class _FlightRecorder:
    """Bounded per-batch lineage ring with atomic JSONL dump-on-fault.

    One record per ingested batch (drop-oldest past ``capacity``): batch index, input
    signature, fused-chunk id, dispatch path, per-stage timings and, after a fault,
    which batch was poisoned. When a chunk degrades to replay or a batch is
    quarantined, the ring is dumped as JSONL. Dumping never raises into the pipeline:
    an unwritable dump directory warns once and the stream keeps flowing.
    """

    _STAGES = ("prefetch_wait", "device_put", "dispatch", "commit", "blocked_on_inflight")

    def __init__(self, pipeline: str, inst: str, capacity: int, dump_dir: str, max_dumps: int) -> None:
        self.pipeline = pipeline
        self.inst = inst
        self.dump_dir = dump_dir
        self.max_dumps = max_dumps
        self.tenant: Optional[str] = None
        self._ring: deque = deque(maxlen=capacity)
        self.dump_paths: List[str] = []
        self.dumps_suppressed = 0
        self._warned_unwritable = False

    def __len__(self) -> int:
        return len(self._ring)

    def open_record(
        self, batch_index: int, stages: Optional[Dict[str, float]] = None, trace_id: Optional[str] = None
    ) -> dict:
        record = {
            "batch_index": batch_index,
            "trace_id": trace_id,
            "chunk_id": None,
            "signature": None,
            "path": None,
            "fault": None,
            "stages": dict.fromkeys(self._STAGES),
        }
        if stages:
            record["stages"].update(stages)
        self._ring.append(record)
        return record

    def records(self) -> List[dict]:
        """Copies of the live ring, oldest first (safe to mutate/serialize)."""
        return [{**r, "stages": dict(r["stages"])} for r in self._ring]

    def restore_records(self, records: List[dict]) -> None:
        """Refill the ring from serialized records (oldest first, bounded): a restored
        session's first fault dump still carries the lineage from before the move."""
        for record in records or []:
            self._ring.append({**record, "stages": dict(record.get("stages") or {})})

    def dump(
        self,
        reason: str,
        poisoned: List[int],
        config: Dict[str, Any],
        tenant: Optional[str] = None,
        poisoned_trace_ids: Optional[List[str]] = None,
    ) -> Optional[str]:
        """Write the ring as JSONL (meta line first, then batches oldest-first), atomically.
        Returns the path, or ``None`` when suppressed (cap) or unwritable. ``tenant``
        overrides the recorder's tenant on the meta line: the multiplexer's ring is
        shared across tenants, but each fault dump names the ONE tenant whose
        tenant-local batch indices it attributes."""
        if len(self.dump_paths) >= self.max_dumps:
            self.dumps_suppressed += 1
            if _trace.ENABLED:
                _trace.inc("flight.dumps_suppressed", pipeline=self.pipeline)
            return None
        meta = {
            "type": "meta",
            "schema": FLIGHT_SCHEMA,
            "pipeline": self.pipeline,
            "inst": self.inst,
            "tenant": tenant if tenant is not None else self.tenant,
            "reason": reason,
            "poisoned_batches": sorted(set(poisoned)),
            "poisoned_trace_ids": sorted(set(poisoned_trace_ids or [])),
            "records": len(self._ring),
            "ts_unix": time.time(),
            "config": config,
        }
        lines = [json.dumps(meta, sort_keys=True, default=str)]
        for record in self.records():
            lines.append(json.dumps({"type": "batch", **record}, sort_keys=True, default=str))
        name = f"flight_{self.pipeline}_{os.getpid()}_{self.inst}_{len(self.dump_paths):03d}.jsonl"
        path = os.path.join(self.dump_dir, name)
        try:
            atomic_write_text(path, "\n".join(lines) + "\n")
        except OSError as err:
            if not self._warned_unwritable:
                self._warned_unwritable = True
                rank_zero_warn(
                    f"Flight-recorder dump could not be written to {path!r}:"
                    f" {type(err).__name__}: {err}. Faults keep their counters but lose"
                    " their batch-lineage dumps; point `PipelineConfig.flight_dump_dir`"
                    f" (or ${FLIGHT_DIR_ENV}) at a writable directory.",
                    RuntimeWarning,
                )
            return None
        self.dump_paths.append(path)
        return path


def _target_device(metric: Union[Metric, MetricCollection]) -> torch.device:
    if isinstance(metric, MetricCollection):
        for m in metric.values():
            return m.device
        return torch.device("cpu")
    return metric.device


class MetricPipeline:
    """Drive a ``Metric`` or ``MetricCollection`` from a batch stream with prefetch, a
    bounded in-flight window and fused chunks.

    Usage::

        pipe = MetricPipeline(metric, PipelineConfig(fuse=8, prefetch=2))
        pipe.warmup(example_preds, example_target)   # optional: capture before the loop
        report = pipe.run(batch_iterator)            # or pipe.feed(...) per batch
        value = metric.compute()                     # pipe.run/close flushed already

    Metrics with ragged list states (or ``jit_update=False``) cannot ride a fused
    chunk; the pipeline degrades them to per-batch updates (collections: per
    compute-group leader, so fusable groups still fuse).
    """

    _instance_seq = itertools.count()

    def __init__(
        self,
        metric: Union[Metric, MetricCollection],
        config: Optional[PipelineConfig] = None,
        **overrides: Any,
    ) -> None:
        if config is None:
            config = PipelineConfig(**overrides)
        elif overrides:
            config = replace(config, **overrides)
        if not isinstance(metric, (Metric, MetricCollection)):
            raise ValueError(f"MetricPipeline drives a Metric or MetricCollection, got {type(metric).__name__}")
        self.config = config
        self._target = metric
        self._is_collection = isinstance(metric, MetricCollection)
        self._label = type(metric).__name__
        self._instance = str(next(MetricPipeline._instance_seq))
        if self._is_collection:
            self._fused_leaders, self._eager_leaders = metric._engine_fusable_leaders()
        else:
            self._fused_leaders, self._eager_leaders = ([], [])
            if metric._engine_fusable():
                self._fused_leaders = [None]  # sentinel: the metric itself fuses
        self._fusable = bool(self._fused_leaders) and config.fuse > 1
        self._buckets = config.buckets()
        self._device = torch.device(config.device) if config.device is not None else _target_device(metric)
        # one CUDA graph memory pool for every variant of this pipeline
        self._pool = torch.cuda.graph_pool_handle() if self._device.type == "cuda" else None
        self._chunk: Optional[_Chunk] = None
        self._fused_fns: Dict[tuple, StaticLeafJit] = {}  # chunks, by (argument structure, template)
        self._step_fns: Dict[tuple, StaticLeafJit] = {}  # the per-batch path, likewise
        self._valid_masks: Dict[Tuple[int, int], torch.Tensor] = {}
        self._buffer_rows: Dict[tuple, Dict[Tuple[Any, str], int]] = {}  # rows a step appends, by signature
        self._inflight: deque = deque()
        self._ingested = 0
        self._chunk_seq = 0
        # batch lineage (obs/lineage.py): the session epoch + arrival counter minting
        # one stable trace id per fed batch (the counter never moves with lineage off)
        self._lineage_epoch = _lineage.new_epoch()
        self._lineage_seq = 0
        self._report = PipelineReport()
        self._warmup_manifest: Optional[Dict[str, Any]] = None
        if config.flight_records > 0:
            dump_dir = (
                config.flight_dump_dir
                or os.environ.get(FLIGHT_DIR_ENV)
                or os.path.join(tempfile.gettempdir(), "tm_tpu_flight")
            )
            self._flight: Optional[_FlightRecorder] = _FlightRecorder(
                self._label, self._instance, config.flight_records, dump_dir, config.flight_max_dumps
            )
        else:
            self._flight = None
        self._alert_engine = config.alert_engine
        self._alert_commits = 0
        self._alert_warned = False
        # admission-deprioritized batches as (args, kwargs, trace_id): the id was minted
        # at first arrival, so defer -> re-admission keeps the batch's identity
        self._deferred: List[Tuple[tuple, dict, Optional[str]]] = []
        self._shed_warned = False
        self._tenant: Optional[str] = None
        self._tenant_closed = False
        if config.tenant is not None:
            # a tenant pipeline IS a session: register liveness, and adopt the tenant
            # onto the driven metrics so their own paths stay attributed
            self._tenant = _scope.adopt(config.tenant)
            _scope.get_registry().pipeline_started(self._tenant)
            targets: List[Any] = [self._target]
            if self._is_collection:
                targets += list(self._target._modules.values())
            for m in targets:
                if getattr(m, "_obs_tenant", None) is None:
                    m._obs_tenant = self._tenant
            if self._flight is not None:
                self._flight.tenant = self._tenant
        self._checkpointer = None
        if config.checkpoint is not None:
            # lazy import: migrate.py imports this module at load time
            from torchmetrics_tpu_torch.engine.migrate import ContinuousCheckpointer

            self._checkpointer = ContinuousCheckpointer(config.checkpoint, tenant=self._tenant, label=self._label)
        # the session lease (robust/fence.py): minted per session epoch — the fencing
        # token — renewed on ingest and commit (at most every ~TTL/4) and stamped into
        # every bundle. A restore that adopts a bundled epoch re-mints under it.
        self._lease = _fence.mint_lease(self._tenant, epoch=self._lineage_epoch, ttl_seconds=config.lease_seconds)
        self._lease_renew_at = time.time() + config.lease_seconds / 4.0
        if _audit.ENABLED:
            _audit.track(self, "pipeline", self._label)

    # --------------------------------------------------------------------- session

    def _renew_lease(self, force: bool = False) -> None:
        """Renew the session lease, at most every ~TTL/4 unless forced."""
        now = time.time()
        if not force and now < self._lease_renew_at:
            return
        _fence.renew_lease(self._lease, self._tenant, now=now)
        self._lease_renew_at = now + self._lease["ttl_seconds"] / 4.0

    def lease_snapshot(self) -> Dict[str, Any]:
        """The lease stamp a checkpoint bundle carries, freshly renewed: every bundle
        write doubles as a lease renewal other hosts can see."""
        self._renew_lease(force=True)
        return {key: self._lease[key] for key in ("holder", "epoch", "ttl_seconds", "expires_unix", "renewed_unix")}

    def _maybe_checkpoint(self, force: bool = False) -> Optional[str]:
        """Continuous-checkpoint hook, called at chunk-commit boundaries only — so
        every periodic bundle is chunk-consistent without a drain."""
        self._renew_lease()
        if self._checkpointer is None:
            return None
        return self._checkpointer.maybe_pipeline(self, force=force)

    def checkpoint_now(self) -> Optional[str]:
        """Force one continuous-checkpoint bundle (cadence bypassed); returns its path,
        or ``None`` without a configured ``CheckpointPolicy``."""
        with self._tenant_ctx():
            return self._maybe_checkpoint(force=True)

    def _tenant_ctx(self):
        """The session scope every public entry point runs under (a no-op when the
        pipeline is untenanted): ``scope.session`` sets only the contextvar."""
        return _scope.session(self._tenant) if self._tenant is not None else nullcontext()

    # ------------------------------------------------------------------ public API

    @property
    def metric(self) -> Union[Metric, MetricCollection]:
        return self._target

    def report(self) -> PipelineReport:
        """Copy of the accounting so far (safe to keep across further feeds)."""
        return replace(self._report)

    @property
    def warmup_manifest(self) -> Optional[Dict[str, Any]]:
        return self._warmup_manifest

    @property
    def lineage_epoch(self) -> str:
        """The session epoch trace ids are minted under."""
        return self._lineage_epoch

    def trace_id_for(self, ordinal: int) -> str:
        """The (deterministic) trace id of this session's ``ordinal``-th fed batch."""
        return _lineage.mint(self._tenant, self._lineage_epoch, ordinal)

    def flight_records(self) -> List[dict]:
        """Copies of the flight-recorder ring (empty when ``flight_records=0``)."""
        return self._flight.records() if self._flight is not None else []

    @property
    def flight_dumps(self) -> List[str]:
        """Paths of the fault dumps this pipeline has written."""
        return list(self._flight.dump_paths) if self._flight is not None else []

    def flight_snapshot(self) -> Dict[str, Any]:
        """Serializable flight-recorder state (the session-bundle seam)."""
        if self._flight is None:
            return {"records": [], "dumps_written": 0, "dumps_suppressed": 0}
        return {
            "records": self._flight.records(),
            "dumps_written": len(self._flight.dump_paths),
            "dumps_suppressed": self._flight.dumps_suppressed,
        }

    def _restore_flight(self, snapshot: Dict[str, Any]) -> None:
        """Refill the flight ring from a session bundle: dump *files* stay on the
        origin host; the ring and the suppressed count move."""
        if self._flight is None or not snapshot:
            return
        self._flight.restore_records(snapshot.get("records") or [])
        self._flight.dumps_suppressed += int(snapshot.get("dumps_suppressed", 0) or 0)

    def _restore_report(self, totals: Dict[str, Any]) -> None:
        """Adopt a checkpointed session's accounting: the restored pipeline keeps
        counting from the origin's totals, and so does its ingest ordinal."""
        for f in fields(PipelineReport):
            if f.name in totals:
                setattr(self._report, f.name, int(totals[f.name]))
        self._ingested = max(self._ingested, int(totals.get("batches", 0) or 0))

    def _restore_lineage(self, cursor: Dict[str, Any], fresh_epoch: bool = False) -> None:
        """Adopt the bundled session's lineage identity and chunk ordinal.

        The epoch and arrival counter make post-restore mints continue the origin
        session's id space (a crash-recovery gap re-feed reproduces the lost batches'
        ids); ``chunk_seq`` continues too. ``fresh_epoch=True`` is the **failover**
        variant: the counter continues under a newly minted epoch, the new fencing
        token. Either way the lease is re-minted under the session's final epoch.
        """
        lineage_row = cursor.get("lineage") or {}
        if lineage_row.get("epoch"):
            if not fresh_epoch:
                self._lineage_epoch = str(lineage_row["epoch"])
            self._lineage_seq = max(self._lineage_seq, int(lineage_row.get("seq", 0) or 0))
        if cursor.get("chunk_seq") is not None:
            self._chunk_seq = max(self._chunk_seq, int(cursor["chunk_seq"]))
        if self._lease["epoch"] != self._lineage_epoch:
            self._lease = _fence.mint_lease(
                self._tenant, epoch=self._lineage_epoch, ttl_seconds=self.config.lease_seconds
            )
            self._lease_renew_at = time.time() + self.config.lease_seconds / 4.0

    def cache_info(self) -> List[Dict[str, Any]]:
        """The capture caches' accounting (``StaticLeafJit.cache_info``) of the fused
        and per-batch functions: their replays are the pipeline's graph launches."""
        return [fn.cache_info() for fn in (*self._fused_fns.values(), *self._step_fns.values())]

    def feed(self, *args: Any, **kwargs: Any) -> None:
        """Ingest one batch (positional/keyword update arguments)."""
        with self._tenant_ctx():
            self._ingest(args, kwargs)

    def run(self, batches: Iterable[Any]) -> PipelineReport:
        """Consume a stream of batches with device prefetch; flushes at the end.

        Each item is a tuple of positional update args, a dict of keyword args, or a
        single tensor. Returns the accumulated :class:`PipelineReport`.
        """
        with self._tenant_ctx():
            return self._run(batches)

    def _run(self, batches: Iterable[Any]) -> PipelineReport:
        lookahead = max(1, self.config.prefetch)
        it = iter(batches)
        pending: deque = deque()  # (args, kwargs, ingested-count at enqueue, stage timings)
        exhausted = False
        timed = self._flight is not None
        while pending or not exhausted:
            while not exhausted and len(pending) < lookahead:
                start = time.perf_counter() if timed else 0.0
                try:
                    raw = next(it)
                except StopIteration:
                    exhausted = True
                    break
                produced = time.perf_counter() if timed else 0.0
                args, kwargs = _normalize_batch(raw)
                args, kwargs = self._device_put(args, kwargs)
                stages = None
                if timed:
                    # prefetch_wait: host time the source iterator took to yield;
                    # device_put: transfer issue time
                    stages = {
                        "prefetch_wait": round(produced - start, 6),
                        "device_put": round(time.perf_counter() - produced, 6),
                    }
                pending.append((args, kwargs, self._ingested, stages))
            if pending:
                args, kwargs, stamp, stages = pending.popleft()
                if stamp < self._ingested:
                    # its transfer was issued before the previous batch was ingested:
                    # the copy overlapped compute
                    self._report.prefetch_hits += 1
                    if _trace.ENABLED:
                        _trace.inc("engine.prefetch_hit", pipeline=self._label)
                else:
                    self._report.prefetch_misses += 1
                    if _trace.ENABLED:
                        _trace.inc("engine.prefetch_miss", pipeline=self._label)
                self._ingest(args, kwargs, stages)
        self.flush()
        return self.report()

    def flush(self) -> None:
        """Dispatch the open partial chunk (padded up to its bucket).

        Also runs the wall-clock re-admission check: a deferred backlog whose tenant
        has fallen back under quota drains here too, so an idle-but-deferred tenant is
        not starved until ``close()``.
        """
        with self._tenant_ctx():
            self._maybe_readmit()
            if self._chunk is not None and len(self._chunk):
                self._dispatch_chunk()
            self._check_buffer_overflow()

    def poll_admission(self) -> int:
        """Wall-clock re-admission check for the deferred backlog.

        An idle tenant never feeds again, so its backlog would wait for ``close()``; an
        external ticker calls this instead. When the controller's read-only probe
        (:meth:`~torchmetrics_tpu_torch.obs.scope.AdmissionController.would_admit`) says
        the tenant is back under quota, the backlog drains in order (and is billed).
        Returns the number of batches drained.
        """
        with self._tenant_ctx():
            return self._maybe_readmit()

    def _admission(self) -> Any:
        return self.config.admission if self.config.admission is not None else _scope.get_admission()

    def _maybe_readmit(self) -> int:
        """Drain the deferred backlog if the tenant is back under quota."""
        if self._tenant is None or not self._deferred:
            return 0
        controller = self._admission()
        if controller is None:
            # the controller was uninstalled mid-stream: nothing meters this tenant
            # anymore, so the backlog drains unconditionally
            n = len(self._deferred)
            self._drain_deferred(None)
            return n
        probe = getattr(controller, "would_admit", None)
        if not callable(probe):
            # a controller without the read-only probe cannot be asked safely: the
            # backlog still drains at close()
            return 0
        if not probe(self._tenant):
            return 0
        n = len(self._deferred)
        self._drain_deferred(controller)
        return n

    def _drain_deferred(self, controller: Any) -> None:
        """Re-ingest the deprioritized backlog in order (admission decisions bypassed —
        the work executes regardless — but executed updates are still billed)."""
        while self._deferred:
            args, kwargs, trace_id = self._deferred.pop(0)
            self._report.deferred_replayed += 1
            if controller is not None:
                controller.charge(self._tenant, updates=1)
            self._ingest(args, kwargs, bypass_admission=True, trace_id=trace_id)

    def _wait_inflight(self) -> None:
        """Wait on every outstanding ticket: the state is then the fold of every
        dispatched batch, on the card as on the host."""
        while self._inflight:
            self._wait(self._inflight.popleft())
        if _trace.ENABLED:
            _trace.set_gauge("engine.in_flight", 0, pipeline=self._label, inst=self._instance)

    def drain(self) -> List[Tuple[tuple, dict, Optional[str]]]:
        """Quiesce the pipeline for a checkpoint; returns the **replay tail**.

        The first step of the drain → checkpoint → restore → replay-tail migration
        (:mod:`torchmetrics_tpu_torch.engine.migrate`): the open fusion chunk is
        dispatched and every in-flight ticket is waited on, after which the metric
        state is exactly the fold of every dispatched batch. The tail is the batches
        ingested but never folded — the admission-deferred backlog — handed back and
        cleared. Items are ``(args, kwargs, trace_id)``, as :meth:`replay_tail` takes
        them. The session stays open.
        """
        with self._tenant_ctx():
            if self._chunk is not None and len(self._chunk):
                self._dispatch_chunk()
            self._wait_inflight()
            tail, self._deferred = self._deferred, []
            if _audit.ENABLED:
                # drained tail batches leave with the bundle: conserved as
                # handed-off work, completed by the restoring session
                _audit.note_handed_off(self, "pipeline", self._tenant, len(tail))
            return tail

    def replay_tail(self, batches: Iterable[tuple], deferred: int = 0) -> int:
        """Re-ingest checkpointed tail batches on the restored host, in order.

        Each item is ``(args, kwargs)`` or ``(args, kwargs, trace_id)``; a trace id
        is re-adopted, so the batch keeps the identity it was fed under on the origin
        host. Admission *decisions* are bypassed (the origin accepted these batches),
        but the executed updates are billed to the restoring host's controller. The
        first ``deferred`` batches are the origin's admission-deferred backlog and
        count toward ``deferred_replayed``. Returns the number of batches replayed.
        """
        controller = self._admission() if self._tenant is not None else None
        n = 0
        with self._tenant_ctx():
            for item in batches:
                args, kwargs = item[0], item[1]
                trace_id = item[2] if len(item) > 2 else None
                if n < deferred:
                    self._report.deferred_replayed += 1
                if controller is not None:
                    controller.charge(self._tenant, updates=1)
                self._ingest(tuple(args), dict(kwargs), bypass_admission=True, trace_id=trace_id)
                n += 1
        return n

    def close(self) -> PipelineReport:
        """Flush (deferred backlog included), drain the in-flight window, write the
        closing bundle of a checkpointed session, run a last alert evaluation, end the
        session and release its lease; returns the final report."""
        try:
            with self._tenant_ctx():
                # admission-deprioritized batches land now, after in-quota traffic:
                # deprioritized, never silently lost
                if self._tenant is not None:
                    self._drain_deferred(self._admission())
                self.flush()
                self._wait_inflight()
                # the bundle stream ends complete (skipped when the cadence already
                # covered the final commit: no byte-identical duplicate on shutdown)
                if self._checkpointer is not None and self._report.batches:
                    self._checkpointer.maybe_pipeline(self, force=True, skip_if_covered=True)
                self._evaluate_alerts(force=True)
        finally:
            # the session ends exactly once, however many times close() runs, also
            # when a raise-policy flush propagates
            if self._tenant is not None and not self._tenant_closed:
                self._tenant_closed = True
                _scope.get_registry().pipeline_finished(self._tenant)
                if self._checkpointer is not None:
                    # a closed session promises no checkpoint freshness
                    _scope.note_checkpoint_closed(self._tenant)
            # a cleanly released lease is not a hung host: it must never age into the
            # watchdog's stale set
            key = self._tenant if self._tenant is not None else "__local__"
            if _scope.lease_status().get(key, {}).get("epoch") == self._lease["epoch"]:
                _scope.note_lease_released(self._tenant)
            if _audit.ENABLED:
                # freeze this generation's final ledger rows — they keep
                # feeding the per-tenant merge after the object dies
                _audit.note_close(self)
        return self.report()

    def compute(self) -> Any:
        """Flush then compute the target — the epoch-end convenience."""
        with self._tenant_ctx():
            self.flush()
            return self._target.compute()

    def __enter__(self) -> "MetricPipeline":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ---------------------------------------------------------------------- warmup

    def warmup(self, *args: Any, manifest_path: Optional[str] = None, **kwargs: Any) -> Dict[str, Any]:
        """Capture every (shape-bucket, static-config) variant for an example batch,
        before the loop runs.

        ``args``/``kwargs`` are one example batch — real tensors or abstract
        ``torch.empty(..., device="meta")`` specs. Captures the fused function for
        every chunk-length bucket (with ``fuse=1``: the per-batch function) and the
        metrics' own captured updates where ``jit_update=True``, so the hot loop's
        first steps are pure cache hits. Returns (and stores) the warmup manifest;
        ``manifest_path`` also writes it as JSON.
        """
        with self._tenant_ctx():
            return self._warmup_scoped(args, kwargs, manifest_path)

    def _warmup_scoped(self, args: tuple, kwargs: dict, manifest_path: Optional[str]) -> Dict[str, Any]:
        leaves, treedef = tree_flatten((args, kwargs))
        traced, template, unhashable = partition_static_leaves(leaves)
        if unhashable is not None:
            raise TypeError(
                "MetricPipeline.warmup received an unhashable static argument of type"
                f" {type(unhashable).__name__}; such batches dispatch per batch and cannot be captured."
            )
        specs = [torch.empty(tuple(t.shape), dtype=torch.as_tensor(t).dtype, device="meta") for t in traced]
        entries: List[Dict[str, Any]] = []
        shapes = [list(map(int, s.shape)) for s in specs]
        if self._fused_leaders:
            state = self._current_fused_state()
            if self._fusable:
                fused = self._get_fused_fn(treedef, tuple(template))
                for bucket in self._buckets:
                    stacked = [torch.empty((bucket, *s.shape), dtype=s.dtype, device="meta") for s in specs]
                    valid = torch.empty((bucket,), dtype=torch.bool, device="meta")
                    info = fused.warmup(state, stacked, valid)
                    entries.append({**info, "kind": "fused", "bucket": bucket, "shapes": shapes})
            else:
                info = self._get_step_fn(treedef, tuple(template)).warmup(state, specs)
                entries.append({**info, "kind": "per_batch", "bucket": None, "shapes": shapes})
        # the metrics' own captured updates (jit_update=True), which the replay path
        # and unfusable leaders use
        it = iter(specs)
        abstract = [next(it) if isinstance(t, _ArraySlot) else t for t in template]
        a_args, a_kwargs = tree_unflatten(treedef, abstract)
        per_batch = list(self._per_batch_metrics())
        if self._is_collection:
            per_batch += [self._target._modules[name] for name in self._eager_leaders]
        for m in per_batch:
            if not m._jit_enabled():
                continue
            if m._jitted_update is None:
                m._jitted_update = jit_with_static_leaves(m.pure_update)
            filtered = m._filter_kwargs(**a_kwargs) if self._is_collection else a_kwargs
            info = m._jitted_update.warmup(m._traced_state(), *a_args, **filtered)
            entries.append({**info, "kind": "per_batch", "bucket": None, "shapes": shapes})
        manifest = _warmup.build_manifest(entries, cache_dir=_warmup.configured_cache_dir())
        self._warmup_manifest = manifest
        if _trace.ENABLED:
            _trace.event(
                "engine.warmup",
                pipeline=self._label,
                variants=manifest["variants"],
                fresh=manifest["fresh_compiles"],
                seconds=manifest["total_compile_seconds"],
            )
        if manifest_path is not None:
            _warmup.save_manifest(manifest, manifest_path)
        return manifest

    # ------------------------------------------------------------------- ingestion

    def _device_put(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
        def _put(x: Any) -> Any:
            if isinstance(x, (torch.Tensor, np.ndarray)):
                return torch.as_tensor(x).to(self._device, non_blocking=True)
            return x

        return tuple(_put(a) for a in args), {k: _put(v) for k, v in kwargs.items()}

    def _ingest(
        self,
        args: tuple,
        kwargs: dict,
        stages: Optional[Dict[str, float]] = None,
        bypass_admission: bool = False,
        trace_id: Optional[str] = None,
    ) -> None:
        self._renew_lease()  # at most every ~TTL/4: a live stream keeps the lease warm
        if _lineage.ENABLED and trace_id is None:
            # identity is assigned at FIRST arrival, before the admission decision, so
            # a deferred batch re-admitted later keeps the id it arrived with
            ordinal = self._lineage_seq
            self._lineage_seq += 1
            trace_id = self.trace_id_for(ordinal)
            _lineage.get_index().open(trace_id, self._tenant, ordinal)
        elif trace_id is not None and _lineage.ENABLED:
            # a pre-minted id (deferred re-admission, tail replay): an idempotent re-open
            _lineage.get_index().open(trace_id, self._tenant, _lineage.ordinal_of(trace_id))
        if self._tenant is not None and not bypass_admission and not self._admit(args, kwargs, trace_id):
            return
        if _faults.update_faults_active():
            # injected faults apply ONCE per ingested batch, at the pipeline seam;
            # downstream metric.update calls are told not to re-apply
            args, kwargs = _faults.apply_update_fault(args, kwargs)
        batch_index = self._ingested
        self._ingested += 1
        self._report.batches += 1
        record = None
        if self._flight is not None:
            record = self._flight.open_record(batch_index, stages, trace_id=trace_id)
        if trace_id is not None and _trace.ENABLED:
            ingest_attrs: Dict[str, Any] = {"pipeline": self._label, "trace_id": trace_id}
            if stages:
                ingest_attrs.update({k: v for k, v in stages.items() if v is not None})
            with _trace.span("engine.ingest", **ingest_attrs):
                pass
        if _trace.ENABLED:
            _trace.inc("engine.batches", pipeline=self._label)
            if record is not None:
                _trace.set_gauge("flight.records", len(self._flight), pipeline=self._label, inst=self._instance)
        if not self._fusable:
            self._drive_per_batch(args, kwargs, record, trace_id)
            return
        if self._eager_leaders:
            # unfusable group leaders advance per batch, in stream order
            self._drive_eager_leaders(args, kwargs)
        leaves, treedef = tree_flatten((args, kwargs))
        traced, template, unhashable = partition_static_leaves(leaves)
        if unhashable is not None:
            # unhashable statics cannot key a chunk signature: flush and fall through
            # to the per-batch path for this batch
            if self._chunk is not None and len(self._chunk):
                self._dispatch_chunk()
            self._drive_fused_leaders_eagerly(args, kwargs, record, trace_id)
            return
        sig = (treedef, tuple(template), _aval_signature(traced))
        if record is not None or trace_id is not None:
            sig_str = signature_str(sig[2])
            if record is not None:
                record["signature"] = sig_str
            if trace_id is not None:
                _lineage.get_index().update(trace_id, signature=sig_str)
        if self._chunk is not None and self._chunk.sig != sig:
            self._report.shape_flushes += 1
            if _trace.ENABLED:
                _trace.inc("engine.shape_flush", pipeline=self._label)
            self._dispatch_chunk()
        if self._chunk is None:
            self._chunk = _Chunk(sig, treedef, tuple(template), batch_index)
        self._chunk.traced.append(traced)
        self._chunk.originals.append((args, kwargs))
        self._chunk.trace_ids.append(trace_id)
        if record is not None:
            self._chunk.records.append(record)
        if _trace.ENABLED:
            _trace.set_gauge("engine.queue_depth", len(self._chunk), pipeline=self._label, inst=self._instance)
        if len(self._chunk) >= self.config.fuse:
            self._dispatch_chunk()

    def _admit(self, args: tuple, kwargs: dict, trace_id: Optional[str]) -> bool:
        """Cost-aware admission of one batch of a tenant session (``obs/scope.py``):
        ``False`` when it was shed or deferred. Back under quota, the deferred backlog
        drains first, so that the tenant's stream order holds."""
        controller = self._admission()
        if controller is None:
            return True
        decision = controller.admit(self._tenant)
        if decision == _scope.DEFER and len(self._deferred) >= self.config.max_deferred:
            # a full backlog holds real device tensors: degrade to shed instead of
            # growing memory without bound, and tell the controller, whose admit()
            # counted this batch as deferred
            controller.note_degraded_shed(self._tenant)
            decision = _scope.SHED
        if decision == _scope.SHED:
            self._report.shed_batches += 1
            if trace_id is not None:
                _lineage.get_index().update(trace_id, outcome="shed")
            if not self._shed_warned:
                self._shed_warned = True
                rank_zero_warn(
                    f"Tenant {self._tenant!r} is over quota: this pipeline's batches are being SHED"
                    " (dropped, counted in tenant.quota_shed). This warning fires once per pipeline.",
                    RuntimeWarning,
                )
            if _trace.ENABLED:
                _trace.inc("engine.shed_batches", pipeline=self._label)
            return False
        if decision == _scope.DEFER:
            self._deferred.append((args, kwargs, trace_id))
            self._report.deferred_batches += 1
            if trace_id is not None:
                _lineage.get_index().update(trace_id, outcome="deferred")
            if _trace.ENABLED:
                _trace.inc("engine.deferred_batches", pipeline=self._label)
            return False
        self._drain_deferred(controller)
        controller.charge(self._tenant, updates=1)
        return True

    # ------------------------------------------------------------------ fused path

    def _per_batch_metrics(self) -> List[Metric]:
        """The metrics the per-batch (eager/replay) path drives directly."""
        if not self._is_collection:
            return [self._target]
        return [self._target._modules[name] for name in self._fused_leaders if name is not None]

    def _leaders(self) -> Optional[List[Tuple[str, Metric]]]:
        if not self._is_collection:
            return None
        return [(name, self._target._modules[name]) for name in self._fused_leaders]

    def _current_fused_state(self) -> Any:
        if not self._is_collection:
            return self._target._traced_state()
        return {name: self._target._modules[name]._traced_state() for name in self._fused_leaders}

    def _step(self, state: Any, step_leaves: list, treedef: Any, template: tuple, leaders) -> Any:
        """Every fused leader's ``pure_update`` on one batch."""
        it = iter(step_leaves)
        full = [next(it) if isinstance(t, _ArraySlot) else t for t in template]
        a, kw = tree_unflatten(treedef, full)
        if leaders is None:
            return self._target.pure_update(state, *a, **kw)
        return {name: m.pure_update(state[name], *a, **m._filter_kwargs(**kw)) for name, m in leaders}

    def _get_fused_fn(self, treedef: Any, template: tuple) -> StaticLeafJit:
        key = (treedef, template)
        fused = self._fused_fns.get(key)
        if fused is not None:
            return fused
        leaders, buckets, step = self._leaders(), self._buckets, self._step

        def fused_update(state, stacked, valid):
            steps = valid.shape[0]
            # a chunk padded to this bucket is longer than the bucket below: steps
            # before that length are always valid, the rest are masked
            lower = max((b for b in buckets if b < steps), default=0)
            for i in range(steps):
                new = step(state, [s[i] for s in stacked], treedef, template, leaders)
                # masked tail: padded steps pass the state through unchanged, so a
                # partial chunk stays bit-identical to the unpadded per-batch run
                state = _masked(valid[i], new, state) if i >= lower else new
            return state

        fused_update.__name__ = "fused_update"
        fused_update.__qualname__ = f"{self._label}.fused_update"
        fused = jit_with_static_leaves(fused_update, pool=self._pool)
        self._fused_fns[key] = fused
        return fused

    def _get_step_fn(self, treedef: Any, template: tuple) -> StaticLeafJit:
        key = (treedef, template)
        fn = self._step_fns.get(key)
        if fn is None:
            leaders, step = self._leaders(), self._step

            def step_update(state, traced):
                return step(state, traced, treedef, template, leaders)

            step_update.__name__ = "step_update"
            step_update.__qualname__ = f"{self._label}.step_update"
            fn = self._step_fns[key] = jit_with_static_leaves(step_update, pool=self._pool)
        return fn

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _valid_mask(self, bucket: int, n: int) -> torch.Tensor:
        mask = self._valid_masks.get((bucket, n))
        if mask is None:
            mask = self._valid_masks[(bucket, n)] = torch.arange(bucket, device=self._device) < n
        return mask

    def _chunk_policy(self):
        """The error policy guarding this chunk (any fused metric's, else global)."""
        for m in self._per_batch_metrics():
            policy = effective_policy(m.error_policy)
            if policy is not None:
                return policy
        return None

    @staticmethod
    def _stack_rows(rows: list) -> list:
        """Each column of the chunk's rows stacked along a new leading step axis."""
        return [torch.stack([row[i] for row in rows]) for i in range(len(rows[0]))]

    def _buffers(self) -> List[Tuple[Any, str, MaskedBuffer]]:
        """(leader, state name, buffer) of the fused leaders' ``MaskedBuffer`` states."""
        metrics = [(None, self._target)] if not self._is_collection else self._leaders()
        return [(name, key, v) for name, m in metrics for key, v in m._state_values.items()
                if isinstance(v, MaskedBuffer)]

    def _check_buffer_room(self, sig: tuple, n: int) -> None:
        """Raise before the replay when the chunk's appends would pass a buffer's
        capacity (the rows a step appends are known once a chunk of the signature ran)."""
        rows = self._buffer_rows.get(sig)
        if not rows:
            return
        for name, key, buf in self._buffers():
            step = rows.get((name, key), 0)
            if buf.count + step * n > buf.capacity:
                raise ValueError(
                    f"MaskedBuffer state {key!r} overflowed: capacity {buf.capacity}, count {buf.count},"
                    f" appending {step * n}. Construct the metric with a larger buffer capacity;"
                    " the state was not updated."
                )

    def _dispatch_chunk(self) -> None:
        chunk, self._chunk = self._chunk, None
        cid = self._chunk_seq
        self._chunk_seq += 1
        n = len(chunk.traced)
        bucket = self._bucket_for(n)
        pad = bucket - n
        rows = chunk.traced + [chunk.traced[-1]] * pad  # repeat-last padding, masked out
        stacked = self._stack_rows(rows)
        valid = self._valid_mask(bucket, n)
        policy = self._chunk_policy()
        if policy is not None:
            # one host sync per CHUNK (the guarded eager path pays one per batch)
            bad_steps = [i for i in nonfinite_step_indices(stacked) if i < n]
            if bad_steps:
                if _trace.ENABLED:
                    _trace.event(
                        "engine.chunk_degraded",
                        pipeline=self._label,
                        reason="nonfinite",
                        steps=",".join(map(str, bad_steps)),
                        chunk=n,
                        chunk_id=cid,
                    )
                self._replay_chunk(chunk, cid)
                return
        buffered = self._buffers()
        self._check_buffer_room(chunk.sig, n)
        counts_before = {(name, key): buf.count for name, key, buf in buffered}
        fused = self._get_fused_fn(chunk.treedef, chunk.template)
        state = self._current_fused_state()
        timed = bool(chunk.records)
        start = time.perf_counter() if timed else 0.0
        chunk_ids = [t for t in chunk.trace_ids if t is not None]
        try:
            if _trace.ENABLED:
                span_attrs: Dict[str, Any] = {
                    "pipeline": self._label,
                    "path": "fused",
                    "chunk_id": cid,
                    "batch_index": chunk.first_index,
                }
                if chunk_ids:
                    span_attrs["trace_id"] = chunk_ids[0]
                    span_attrs["trace_ids"] = ",".join(chunk_ids)
                with _lineage.trace(chunk_ids[0] if chunk_ids else None):
                    with _trace.span("engine.dispatch", **span_attrs):
                        new_state = fused(state, stacked, valid)
            else:
                new_state = fused(state, stacked, valid)
        except Exception as err:
            if policy is None:
                raise
            # state was never committed; the guarded per-batch replay isolates
            # exactly the failing batches
            if _trace.ENABLED:
                _trace.event(
                    "engine.chunk_degraded", pipeline=self._label, reason=f"{type(err).__name__}", chunk=n, chunk_id=cid
                )
            self._replay_chunk(chunk, cid)
            return
        dispatch_seconds = (time.perf_counter() - start) if timed else 0.0
        commit_start = time.perf_counter() if timed else 0.0
        self._commit(new_state, n)
        if buffered:
            self._buffer_rows[chunk.sig] = {
                (name, key): (buf.count - counts_before[(name, key)]) // n for name, key, buf in self._buffers()
            }
        commit_seconds = (time.perf_counter() - commit_start) if timed else 0.0
        self._report.dispatches += 1
        self._report.fused_batches += n
        self._report.padded_steps += pad
        self._report.max_chunk = max(self._report.max_chunk, n)
        self._report.last_chunk = n
        if _audit.ENABLED:
            # on the host, after the chunk's replay has returned
            for tid in chunk.trace_ids:
                _audit.note_fold(self, "pipeline", self._tenant, self._lineage_epoch, tid)
        if _trace.ENABLED:
            _trace.inc("engine.dispatches", pipeline=self._label)
            _trace.inc("engine.fused_batches", n, pipeline=self._label)
            if pad:
                _trace.inc("engine.padded_steps", pad, pipeline=self._label)
            _trace.set_gauge("engine.fused_chunk_size", n, pipeline=self._label, inst=self._instance)
            _trace.set_gauge("engine.queue_depth", 0, pipeline=self._label, inst=self._instance)
        waited = self._ticket()
        for record in chunk.records:
            record["chunk_id"] = cid
            record["path"] = "fused"
            record["stages"]["dispatch"] = round(dispatch_seconds, 6)
            record["stages"]["commit"] = round(commit_seconds, 6)
            record["stages"]["blocked_on_inflight"] = round(waited, 6)
        if chunk_ids:
            index = _lineage.get_index()
            for tid in chunk_ids:
                index.update(tid, chunk_id=cid, path="fused", outcome="ok")
        self._maybe_checkpoint()
        self._evaluate_alerts(trace_ids=chunk_ids)

    def _commit(self, new_state: Any, n: int) -> None:
        if self._is_collection:
            self._target._engine_commit({name: new_state[name] for name in self._fused_leaders}, n)
        else:
            self._target._engine_commit_state(new_state, n)

    # ------------------------------------------------------------- per-batch paths

    def _suppressing_refault(self, fn: Callable[[], Any]) -> Any:
        """Run a downstream ``update`` without re-applying an armed fault plan (the
        pipeline already applied it at ingestion)."""
        if not _faults.update_faults_active():
            return fn()
        metrics = self._all_metrics()
        previous = [m.__dict__.get("_fault_applied", False) for m in metrics]
        for m in metrics:
            m.__dict__["_fault_applied"] = True
        try:
            return fn()
        finally:
            for m, prev in zip(metrics, previous):
                m.__dict__["_fault_applied"] = prev

    def _all_metrics(self) -> List[Metric]:
        """Every metric the target holds (fault attribution walks them all)."""
        if self._is_collection:
            return list(self._target._modules.values())
        return [self._target]

    def _robust_counts(self) -> Tuple[int, int]:
        """(quarantined, skipped) totals across the driven metrics — diffed around an
        update to attribute a fault to the batch that caused it."""
        quarantined = skipped = 0
        for m in self._all_metrics():
            quarantined += int(m.updates_quarantined)
            skipped += int(m.updates_skipped)
        return quarantined, skipped

    def _mark_fault(self, record: Optional[dict], before: Tuple[int, int], trace_id: Optional[str] = None) -> Optional[str]:
        """Stamp a flight record (and the lineage record) with the fault its update
        triggered, if any."""
        if record is None and trace_id is None:
            return None
        quarantined, skipped = self._robust_counts()
        fault: Optional[str] = None
        if quarantined > before[0]:
            fault = "quarantined"
        elif skipped > before[1]:
            fault = "skipped"
        if record is not None:
            record["fault"] = fault
        if trace_id is not None and fault is not None:
            _lineage.get_index().update(trace_id, outcome=fault)
        return fault

    def _dump_flight(self, reason: str, poisoned: List[int], trace_ids: Optional[List[str]] = None) -> Optional[str]:
        """Dump the flight ring on a fault; telemetry rides along when tracing."""
        if self._flight is None:
            return None
        config = {
            "fuse": self.config.fuse,
            "max_in_flight": self.config.max_in_flight,
            "prefetch": self.config.prefetch,
            "buckets": list(self._buckets),
            "tenant": self._tenant,
        }
        path = self._flight.dump(reason, poisoned, config, poisoned_trace_ids=trace_ids)
        if path is not None:
            self._report.flight_dumps += 1
            _lineage.note_dump(trace_ids or [], path)
            if _trace.ENABLED:
                _trace.inc("flight.dumps", pipeline=self._label)
                _trace.event(
                    "engine.flight_dump",
                    pipeline=self._label,
                    reason=reason,
                    path=path,
                    poisoned=",".join(map(str, sorted(set(poisoned)))),
                    trace_ids=",".join(sorted(set(trace_ids or []))),
                )
        return path

    def _update_target(self, args: tuple, kwargs: dict) -> None:
        """One batch through the whole target: a replay of every fused leader's update
        (the per-batch capture) where no policy guards it, else the metrics' own
        (guarded) ``update``."""
        leaves, treedef = tree_flatten((args, kwargs))
        traced, template, unhashable = partition_static_leaves(leaves)
        if not self._fused_leaders or unhashable is not None or self._chunk_policy() is not None:
            self._suppressing_refault(lambda: self._target.update(*args, **kwargs))
            return
        if self._eager_leaders:
            self._suppressing_refault(lambda: self._drive_eager_leaders(args, kwargs, count=False))
        new_state = self._get_step_fn(treedef, tuple(template))(self._current_fused_state(), traced)
        self._commit(new_state, 1)

    def _drive_per_batch(
        self, args: tuple, kwargs: dict, record: Optional[dict] = None, trace_id: Optional[str] = None
    ) -> None:
        """Whole-target per-batch update (fusion off or target unfusable)."""
        attributed = record is not None or trace_id is not None
        before = self._robust_counts() if attributed else (0, 0)
        start = time.perf_counter() if record is not None else 0.0
        with _lineage.trace(trace_id):
            if _trace.ENABLED:
                span_attrs: Dict[str, Any] = {
                    "pipeline": self._label,
                    "path": "eager",
                    "batch_index": self._ingested - 1,
                }
                if trace_id is not None:
                    span_attrs["trace_id"] = trace_id
                with _trace.span("engine.dispatch", **span_attrs):
                    self._update_target(args, kwargs)
            else:
                self._update_target(args, kwargs)
        self._report.eager_batches += 1
        self._report.eager_dispatches += 1
        if _audit.ENABLED:
            _audit.note_fold(self, "pipeline", self._tenant, self._lineage_epoch, trace_id)
        if _trace.ENABLED:
            _trace.inc("engine.eager_batches", pipeline=self._label)
        waited = self._ticket()
        if attributed:
            if trace_id is not None:
                _lineage.get_index().update(trace_id, path="eager", outcome="ok")
            if record is not None:
                record["path"] = "eager"
                record["stages"]["dispatch"] = round(time.perf_counter() - start, 6)
                record["stages"]["blocked_on_inflight"] = round(waited, 6)
            if self._mark_fault(record, before, trace_id) == "quarantined":
                # the per-batch path has no replay step: the quarantine itself is the
                # fault event, so it dumps the lineage directly
                self._dump_flight(
                    "quarantine",
                    [record["batch_index"]] if record is not None else [],
                    trace_ids=[trace_id] if trace_id is not None else None,
                )
        self._maybe_checkpoint()
        self._evaluate_alerts(trace_ids=[trace_id] if trace_id is not None else ())

    def _drive_eager_leaders(self, args: tuple, kwargs: dict, count: bool = True) -> None:
        def _run() -> None:
            for name in self._eager_leaders:
                m = self._target._modules[name]
                m.update(*args, **m._filter_kwargs(**kwargs))

        self._suppressing_refault(_run)
        if count:
            self._report.eager_dispatches += len(self._eager_leaders)

    def _drive_fused_leaders_eagerly(
        self, args: tuple, kwargs: dict, record: Optional[dict] = None, trace_id: Optional[str] = None
    ) -> None:
        """Per-batch fallback for a batch that cannot join a chunk."""

        def _run() -> None:
            for m in self._per_batch_metrics():
                filtered = m._filter_kwargs(**kwargs) if self._is_collection else kwargs
                m.update(*args, **filtered)

        attributed = record is not None or trace_id is not None
        before = self._robust_counts() if attributed else (0, 0)
        start = time.perf_counter() if record is not None else 0.0
        with _lineage.trace(trace_id):
            if _trace.ENABLED:
                span_attrs: Dict[str, Any] = {
                    "pipeline": self._label,
                    "path": "eager",
                    "batch_index": self._ingested - 1,
                }
                if trace_id is not None:
                    span_attrs["trace_id"] = trace_id
                with _trace.span("engine.dispatch", **span_attrs):
                    self._suppressing_refault(_run)
            else:
                self._suppressing_refault(_run)
        if self._is_collection:
            self._target._sync_group_states()
        self._report.eager_batches += 1
        # one host dispatch per driven metric, matching _drive_eager_leaders' accounting
        self._report.eager_dispatches += max(1, len(self._per_batch_metrics()))
        if _audit.ENABLED:
            _audit.note_fold(self, "pipeline", self._tenant, self._lineage_epoch, trace_id)
        if attributed:
            if trace_id is not None:
                _lineage.get_index().update(trace_id, path="eager", outcome="ok")
            if record is not None:
                record["path"] = "eager"
                record["stages"]["dispatch"] = round(time.perf_counter() - start, 6)
            if self._mark_fault(record, before, trace_id) == "quarantined":
                self._dump_flight(
                    "quarantine",
                    [record["batch_index"]] if record is not None else [],
                    trace_ids=[trace_id] if trace_id is not None else None,
                )
        self._maybe_checkpoint()
        self._evaluate_alerts(trace_ids=[trace_id] if trace_id is not None else ())

    def _replay_chunk(self, chunk: _Chunk, cid: int) -> None:
        """Per-batch replay of a degraded chunk: the metrics' own guarded updates
        isolate (skip/quarantine) exactly the poisoned batches.

        The flight recorder dumps the ring exactly once per degraded chunk — after the
        replay has named the poisoned batches (or immediately when a ``raise`` policy
        propagates mid-replay).
        """
        self._report.chunks_replayed += 1
        if _trace.ENABLED:
            _trace.inc("engine.chunks_replayed", pipeline=self._label)
        poisoned: List[int] = []
        poisoned_ids: List[str] = []
        for step, (args, kwargs) in enumerate(chunk.originals):
            record = chunk.records[step] if step < len(chunk.records) else None
            tid = chunk.trace_ids[step] if step < len(chunk.trace_ids) else None
            attributed = record is not None or tid is not None
            before = self._robust_counts() if attributed else (0, 0)
            start = time.perf_counter() if record is not None else 0.0

            def _run(args=args, kwargs=kwargs) -> None:
                for m in self._per_batch_metrics():
                    filtered = m._filter_kwargs(**kwargs) if self._is_collection else kwargs
                    m.update(*args, **filtered)

            try:
                with _lineage.trace(tid):
                    if _trace.ENABLED:
                        span_attrs: Dict[str, Any] = {
                            "pipeline": self._label,
                            "path": "replay",
                            "chunk_id": cid,
                            "batch_index": chunk.first_index + step,
                        }
                        if tid is not None:
                            span_attrs["trace_id"] = tid
                        with _trace.span("engine.dispatch", **span_attrs):
                            self._suppressing_refault(_run)
                    else:
                        self._suppressing_refault(_run)
            except BaseException:
                # raise policy (or an unguarded failure): the faulting batch is named
                # and the lineage dumped BEFORE the exception propagates
                if tid is not None:
                    poisoned_ids.append(tid)
                    _lineage.get_index().update(tid, chunk_id=cid, path="replay", outcome="raised")
                if record is not None:
                    record["chunk_id"] = cid
                    record["path"] = "replay"
                    record["fault"] = "raised"
                    poisoned.append(record["batch_index"])
                if record is not None or tid is not None:
                    self._dump_flight("chunk_replay", poisoned, trace_ids=poisoned_ids)
                raise
            self._report.replayed_batches += 1
            self._report.eager_dispatches += max(1, len(self._per_batch_metrics()))
            if _audit.ENABLED:
                _audit.note_fold(self, "pipeline", self._tenant, self._lineage_epoch, tid)
            if _trace.ENABLED:
                _trace.inc("engine.replayed_batches", pipeline=self._label)
            if attributed:
                if tid is not None:
                    _lineage.get_index().update(tid, chunk_id=cid, path="replay", outcome="ok")
                if record is not None:
                    record["chunk_id"] = cid
                    record["path"] = "replay"
                    record["stages"]["dispatch"] = round(time.perf_counter() - start, 6)
                if self._mark_fault(record, before, tid) is not None:
                    if record is not None:
                        poisoned.append(record["batch_index"])
                    if tid is not None:
                        poisoned_ids.append(tid)
        if self._is_collection:
            self._target._sync_group_states()
        waited = self._ticket()
        for record in chunk.records:
            record["stages"]["blocked_on_inflight"] = round(waited, 6)
        self._dump_flight("chunk_replay", poisoned, trace_ids=poisoned_ids)
        self._maybe_checkpoint()
        self._evaluate_alerts(trace_ids=[t for t in chunk.trace_ids if t is not None])

    # ------------------------------------------------------------ alerting seam

    def _evaluate_alerts(self, force: bool = False, trace_ids: Iterable[str] = ()) -> None:
        """Value-health evaluation at a commit (``config.alert_engine``).

        Samples the target's values sync-free (no collective mid-stream, no compute
        cache touched; on the card, after the replay and outside any capture), runs
        the rules, and — when a *value* watchdog newly fires — dumps the flight ring
        so the bad value arrives with the batch lineage that produced it. A broken
        engine warns once and the stream keeps flowing.
        """
        engine = self._alert_engine
        if engine is None:
            return
        self._alert_commits += 1
        if not force and self._alert_commits % self.config.alert_every:
            return
        try:
            # sample into the ENGINE's value log, so mid-stream samples reach its rules
            log_hook = getattr(engine, "_log", None)
            _values.sample_local(self._target, log=log_hook() if callable(log_hook) else None)
            transitions = engine.evaluate()
        except Exception as err:
            if not self._alert_warned:
                self._alert_warned = True
                rank_zero_warn(
                    f"Alert evaluation failed on the {self._label} pipeline"
                    f" ({type(err).__name__}: {err}). The stream keeps flowing and"
                    " evaluation will keep being attempted per chunk, but further"
                    " failures are silent (this warning fires once) and value"
                    " watchdogs may be stale.",
                    RuntimeWarning,
                )
            return
        fired = [t for t in transitions if t["to"] == "firing" and t.get("source") == "values"]
        if not fired:
            return
        rules = sorted({t["rule"] for t in fired})
        _lineage.note_alert(list(trace_ids), rules)
        if _trace.ENABLED:
            _trace.inc("engine.value_alerts", len(fired), pipeline=self._label)
            _trace.event(
                "engine.value_alert",
                pipeline=self._label,
                rules=",".join(rules),
                series=",".join(sorted({t["series"] for t in fired})),
            )
        # a value watchdog firing mid-stream IS a fault: ship the last batches'
        # lineage with the alert names attached (the value broke, not an input)
        self._dump_flight("value_alert:" + ",".join(rules), [])

    # -------------------------------------------------------------------- plumbing

    def _ticket(self) -> float:
        """Bound the async window: a CUDA event recorded after each dispatch; wait on
        the oldest once more than ``max_in_flight`` are outstanding. Returns the
        seconds spent waiting (the flight recorder's ``blocked_on_inflight``). On the
        CPU the work is done when the call returns: the ticket is ``None``."""
        ticket = None
        if self._device.type == "cuda":
            ticket = torch.cuda.Event()
            ticket.record(torch.cuda.current_stream(self._device))
        waited = 0.0
        self._inflight.append(ticket)
        while len(self._inflight) > self.config.max_in_flight:
            oldest = self._inflight.popleft()
            if oldest is not None and not oldest.query():
                self._report.inflight_waits += 1
                if _trace.ENABLED:
                    _trace.inc("engine.inflight_waits", pipeline=self._label)
            start = time.perf_counter()
            self._wait(oldest)
            waited += time.perf_counter() - start
        if _trace.ENABLED:
            _trace.set_gauge("engine.in_flight", len(self._inflight), pipeline=self._label, inst=self._instance)
        return waited

    @staticmethod
    def _wait(ticket: Optional["torch.cuda.Event"]) -> None:
        if ticket is not None:
            ticket.synchronize()

    def _check_buffer_overflow(self) -> None:
        for m in self._per_batch_metrics():
            m._check_buffer_overflow()
        for name in self._eager_leaders:
            self._target._modules[name]._check_buffer_overflow()
