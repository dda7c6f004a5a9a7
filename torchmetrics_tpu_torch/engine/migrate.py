"""Live-session checkpoint/restore: a running pipeline as a migratable object.

Counterpart of ``torchmetrics_tpu/engine/migrate.py``, with its wire format letter
for letter: a session bundle that either package writes, the other verifies and
restores. A **session bundle** captures everything a running
:class:`~torchmetrics_tpu_torch.engine.pipeline.MetricPipeline` session *is* and
restores it in another process with nothing lost:

- **metric state**, mid-stream, through the ``__robust__``-aware ``state_dict``
  (update counts and quarantine counters ride along; ``sync_degraded`` too), as a
  plain ``state.npz`` payload + JSON skeleton — the layout both packages read
  without JAX (the JAX package leaves orbax out of it on purpose);
- the **replay tail**: the pipeline is drained to a cursor (:meth:`MetricPipeline.drain`
  dispatches the open chunk and waits on every in-flight ticket, so state is exactly
  the fold of every dispatched batch) and the batches behind the cursor that the
  caller buffered are persisted verbatim (tensors go to numpy) and re-fed after
  restore, onto the restoring target's own device;
- the **flight-recorder ring**, the **pipeline report** (accounting keeps counting),
  the **tenant registry row**, the session's **value timelines** (step anchors
  intact) and its **alert state machines** (``pending``/``firing`` resume with their
  dwell clocks).

The one-shot migration bundle is also a **periodic, crash-consistent checkpoint
stream**:

- **Delta bundles** — every ``state.npz`` entry (large leaves split into fixed-size
  segments) is content-hashed into the manifest; a delta bundle names its base and
  writes only the entries whose hash changed. :func:`verify_bundle` walks and
  verifies the **whole chain**; restores re-check every loaded entry's hash.
- **Continuous cadence** — a :class:`CheckpointPolicy` on
  ``PipelineConfig.checkpoint`` writes bundles every N batches / T seconds **at
  chunk-commit boundaries**: no drain, no stall, chunk-consistent by construction.
  Every ``full_every``-th bundle is full; a retention sweep (:func:`sweep_bundles`)
  never removes a link a kept chain depends on.
- **Unplanned-death recovery** — :func:`latest_valid_bundle` loudly skips mid-write
  temp dirs and corrupt links and returns the newest bundle whose whole chain
  verifies; restore from it, then re-feed the gap.
- **Fencing** — :func:`fence_epoch` durably fences a session epoch; a bundle that
  epoch writes afterwards raises :class:`FencedBundleError` in every recovery scan.

Durability is the atomic directory writer of ``utils/checkpoint.py``: the bundle is
materialized under a temp directory, digested file by file into ``INTEGRITY.json``,
and swapped into place. Restores verify the digest and the schema-versioned manifest
**before touching the target**. The cooperative protocol is **drain → checkpoint →
restore → replay-tail**, run under :func:`torchmetrics_tpu_torch.obs.scope.migration`.

Zero-loss contract: a session checkpointed mid-stream, restored elsewhere, tail
replayed, then fed the remainder of the stream computes values **bit-identical** to
an unmigrated control; a crash restore plus a re-feed of the gap does too.

What waits for later slices: a multiplexer tenant's slice (``_capture_mux_slice``,
``engine/mux.py``) and the admission-deferred backlog it and the JAX pipeline hand
over — a bundle that carries either (``mux_slice``, a non-default ``max_deferred``, a
deferred tail) raises ``NotImplementedError`` here; and the conservation audit's hooks
(``obs/audit.py``).

Operator CLI::

    python -m torchmetrics_tpu_torch.engine.migrate verify <bundle>

chain-aware verification; exit 0 = intact, 1 = corrupt, 2 = cannot run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import time
import uuid
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

import torchmetrics_tpu_torch.obs.lineage as _lineage
import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as _trace
import torchmetrics_tpu_torch.obs.values as _values
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.engine.pipeline import MetricPipeline, PipelineConfig, _normalize_batch, _target_device
from torchmetrics_tpu_torch.utils import checkpoint as _checkpoint
from torchmetrics_tpu_torch.utils.checkpoint import (
    DEFAULT_SEGMENT_BYTES,
    CheckpointIntegrityError,
    _decode_tree,
    _encode_tree,
)
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "SESSION_SCHEMA",
    "CheckpointPolicy",
    "ContinuousCheckpointer",
    "FencedBundleError",
    "SessionBundleError",
    "checkpoint_session",
    "checkpoint_staleness_rule",
    "compact_chain",
    "fence_epoch",
    "fenced_epochs",
    "latest_valid_bundle",
    "restore_session",
    "sweep_bundles",
    "verify_bundle",
]

# wire-format version of a session bundle; bump on any structural change —
# restores REJECT unknown versions (a silently reinterpreted session would
# break the bit-identity promise without saying so). 2: delta bundles
# (bundle_id / base linkage / per-entry content hashes / segmented leaves).
# 3: lease stamp (holder id, session epoch, expiry) in the manifest — the
# fencing token. Schema-2 bundles stay restorable: every field 3 adds is
# additive, and a pre-lease session simply mints its lease on restore.
SESSION_SCHEMA = 3
_COMPAT_SCHEMAS = (2, 3)
_BUNDLE_KIND = "tm_tpu_session"

_MANIFEST_NAME = "MANIFEST.json"
_INTEGRITY_NAME = "INTEGRITY.json"
_STATE_NAME = "state.npz"
_TAIL_NAME = "tail.npz"
# durable fence marker, sibling of the bundle stream: epoch -> fence record
# ({holder, by, target, fenced_unix, known}). `known` snapshots the bundle
# names present at fence time — the rejection rule is "fenced epoch AND not
# in known", so pre-fence bundles stay restorable and the zombie's later
# writes are dead on arrival, with no cross-host clock comparison anywhere.
_FENCE_NAME = "FENCED.json"

# leaves larger than DEFAULT_SEGMENT_BYTES are split into fixed segments, each
# content-hashed independently — an append-only MaskedBuffer's delta only
# rewrites the segments its appends touched (utils/checkpoint._encode_tree)

# PipelineConfig knobs that serialize into the manifest (everything except
# live objects: device handles, alert engines, admission controllers — those
# are the restoring host's to supply)
_CONFIG_FIELDS = (
    "fuse",
    "max_in_flight",
    "prefetch",
    "fuse_buckets",
    "flight_records",
    "flight_max_dumps",
    "alert_every",
    "max_deferred",
    "tenant",
    "lease_seconds",
)
# the JAX pipeline's admission knob, written at its default (the port has no
# admission until the multiplexer slice) and refused on restore otherwise
_MAX_DEFERRED_DEFAULT = 1024
# the report's admission counters, written as 0 for the same reason
_ADMISSION_COUNTERS = ("shed_batches", "deferred_batches", "deferred_replayed")


def _needs_mux(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the admission plane of the multiplexer slice (engine/mux.py), which is not ported yet."
    )


class SessionBundleError(CheckpointIntegrityError):
    """The session bundle on disk cannot be trusted (truncated, tampered,
    half-written, chain-broken, or written by an incompatible schema)."""


class FencedBundleError(SessionBundleError):
    """The bundle was written under a fenced-out session epoch *after* the
    fence landed — a zombie host's late write. Counted, never restored."""


@dataclass
class CheckpointPolicy:
    """Continuous-checkpointing cadence for a live session.

    Attach to ``PipelineConfig.checkpoint`` and the session writes crash-consistent bundles into ``directory`` every
    ``every_batches`` committed batches and/or ``every_seconds`` wall seconds,
    checked only at chunk-commit boundaries — so every bundle is
    chunk-consistent with zero drain. The replay gap an unplanned death pays
    is the batches committed since the last cadence trigger plus the open
    fusion chunk: worst case ``every_batches + fuse - 2`` (exactly the
    cadence when ``fuse <= 2``; size the cadence ≥ the fusion depth to keep
    the bound tight).

    Args:
        directory: where the bundle stream lands (``bundle-000000``,
            ``bundle-000001``, ...). One session per directory.
        every_batches: write after this many committed batches since the last
            bundle (``0`` disables the batch cadence).
        every_seconds: write when this much wall time elapsed since the last
            bundle, checked at commit boundaries (``0`` disables).
        full_every: every Nth bundle is a **full** compaction point; the
            bundles between are deltas against their predecessor (so a restore
            chain is at most ``full_every`` links).
        keep: retention — the sweep after each write keeps the newest ``keep``
            bundles plus every chain link they depend on, and removes the
            rest.
        stale_after_seconds: operator SLO on checkpoint freshness — a tenant
            session whose last successful bundle is older than this flips
            ``/healthz`` degraded with the tenant named (and feeds
            :func:`checkpoint_staleness_rule`). ``None`` disables.
        segment_bytes: leaves larger than this are split into fixed segments
            for per-segment delta hashing.
    """

    directory: str
    every_batches: int = 0
    every_seconds: float = 0.0
    full_every: int = 8
    keep: int = 4
    stale_after_seconds: Optional[float] = None
    segment_bytes: int = DEFAULT_SEGMENT_BYTES

    def __post_init__(self) -> None:
        if not self.directory or not isinstance(self.directory, str):
            raise ValueError(f"Expected a bundle `directory`, got {self.directory!r}")
        if self.every_batches < 0:
            raise ValueError(f"Expected `every_batches` >= 0, got {self.every_batches}")
        if self.every_seconds < 0:
            raise ValueError(f"Expected `every_seconds` >= 0, got {self.every_seconds}")
        if not self.every_batches and not self.every_seconds:
            raise ValueError(
                "CheckpointPolicy needs a cadence: set `every_batches` and/or"
                " `every_seconds`"
            )
        if self.full_every < 1:
            raise ValueError(f"Expected `full_every` >= 1, got {self.full_every}")
        if self.keep < 1:
            raise ValueError(f"Expected `keep` >= 1, got {self.keep}")
        if self.segment_bytes < 1024:
            raise ValueError(f"Expected `segment_bytes` >= 1024, got {self.segment_bytes}")
        if self.stale_after_seconds is not None and self.stale_after_seconds <= 0:
            raise ValueError(
                f"Expected positive `stale_after_seconds` (or None), got"
                f" {self.stale_after_seconds}"
            )


# ------------------------------------------------------------------ internals


def _entry_hash(arr: Any) -> str:
    """Content hash of one state entry: dtype + shape + bytes."""
    arr = np.asarray(arr)
    digest = hashlib.sha256()
    digest.update(str(arr.dtype).encode())
    digest.update(str(arr.shape).encode())
    digest.update(np.ascontiguousarray(arr).tobytes())
    return digest.hexdigest()


def _driven_metrics(target: Union[Metric, MetricCollection]) -> List[Tuple[str, Metric]]:
    """(label, metric) pairs the session drives — collections flatten by name."""
    if isinstance(target, MetricCollection):
        return list(target._modules.items())
    return [("", target)]


def _host_array(leaf: Any) -> np.ndarray:
    """A tail leaf as host numpy (a tensor on the card is copied back)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _serialize_tail(
    tail: List[tuple]
) -> Tuple[List[Dict[str, Any]], Dict[str, np.ndarray]]:
    """Split tail batches into a JSON structure + an array payload (npz keys).

    Items are ``(args, kwargs)`` or ``(args, kwargs, trace_id)`` — the batch's
    lineage id (:mod:`torchmetrics_tpu_torch.obs.lineage`) persists verbatim so the
    restoring host's ``replay_tail`` re-feeds it under the identity it was
    originally fed with.
    """
    structure: List[Dict[str, Any]] = []
    arrays: Dict[str, np.ndarray] = {}
    for bi, item in enumerate(tail):
        args, kwargs = item[0], item[1]
        trace_id = item[2] if len(item) > 2 else None
        a_desc: List[Dict[str, Any]] = []
        for ai, leaf in enumerate(args):
            if hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
                key = f"b{bi}_a{ai}"
                arrays[key] = _host_array(leaf)
                a_desc.append({"array": key})
            else:
                a_desc.append({"value": leaf})
        k_desc: Dict[str, Dict[str, Any]] = {}
        for name, leaf in kwargs.items():
            if hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
                key = f"b{bi}_k_{name}"
                arrays[key] = _host_array(leaf)
                k_desc[name] = {"array": key}
            else:
                k_desc[name] = {"value": leaf}
        entry: Dict[str, Any] = {"args": a_desc, "kwargs": k_desc}
        if trace_id is not None:
            entry["trace_id"] = str(trace_id)
        structure.append(entry)
    return structure, arrays


def _deserialize_tail(
    structure: List[Dict[str, Any]], arrays: Dict[str, np.ndarray], device: torch.device
) -> List[tuple]:
    """Tail batches back from a bundle, their arrays as tensors on ``device`` (the
    restoring target's own)."""

    def leaf(desc: Dict[str, Any]) -> Any:
        if "array" in desc:
            return torch.as_tensor(arrays[desc["array"]]).to(device)
        return desc.get("value")

    batches: List[tuple] = []
    for entry in structure or []:
        args = tuple(leaf(d) for d in entry.get("args") or [])
        kwargs = {name: leaf(d) for name, d in (entry.get("kwargs") or {}).items()}
        batches.append((args, kwargs, entry.get("trace_id")))
    return batches


def _session_values(
    log: Any, tenant: Optional[str], inst_pairs: set
) -> List[Dict[str, Any]]:
    """The value-timeline series belonging to this session: its tenant's
    series plus the driven metric instances' untenanted ones."""
    rows = []
    for row in log.series():
        owns = (tenant is not None and row.get("tenant") == tenant) or (
            (row.get("metric"), row.get("inst")) in inst_pairs
        )
        if owns:
            rows.append(row)
    return rows


def _resolve_value_log(value_log: Any, alert_engine: Any) -> Any:
    """The value log a session actually used: explicit > engine's > global."""
    if value_log is not None:
        return value_log
    log_hook = getattr(alert_engine, "_log", None)
    if callable(log_hook):
        return log_hook()
    return _values.get_log()


def _resolve_engine(explicit: Any, config_engine: Any) -> Any:
    if explicit is not None:
        return explicit
    if config_engine is not None:
        return config_engine
    import torchmetrics_tpu_torch.obs.alerts as _alerts

    return _alerts.get_engine()


def _registry_row(effective_tenant: Optional[str]) -> Optional[Dict[str, Any]]:
    if effective_tenant is None:
        return None
    for row in _scope.get_registry().rows():
        if row["tenant"] == effective_tenant:
            return row
    return None


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _dirnames, filenames in os.walk(path):
        for fname in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, fname))
            except OSError:
                pass
    return total


# ---------------------------------------------------------------- bundle write


def _write_bundle(
    path: str,
    core: Dict[str, Any],
    state_tree: Any,
    tail_batches: List[Tuple[tuple, dict]],
    delta_base: Optional[Tuple[str, str, Dict[str, str]]] = None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
) -> Dict[str, Any]:
    """Materialize + atomically install one bundle; returns its manifest.

    ``delta_base`` is ``(base_name, base_bundle_id, base_entries)``: entries
    whose content hash matches the base's resolvable set are omitted from this
    bundle's ``state.npz`` and resolved through the chain at restore time.
    """
    state_skeleton, state_arrays = _encode_tree(state_tree, segment_bytes)
    tail_structure, tail_arrays = _serialize_tail(tail_batches)
    entries = {key: _entry_hash(arr) for key, arr in state_arrays.items()}
    if delta_base is not None:
        base_name, base_id, base_entries = delta_base
        written = sorted(key for key, h in entries.items() if base_entries.get(key) != h)
        base_field: Optional[Dict[str, Any]] = {"name": base_name, "bundle_id": base_id}
    else:
        written = sorted(entries)
        base_field = None
    manifest = {
        **core,
        "kind": _BUNDLE_KIND,
        "schema_version": SESSION_SCHEMA,
        "bundle_id": uuid.uuid4().hex,
        "base": base_field,
        "entries": entries,
        "written": written,
        "state_skeleton": state_skeleton,
        "tail": tail_structure,
        "ts_unix": time.time(),
    }
    try:
        manifest_text = json.dumps(manifest, sort_keys=True, indent=2)
    except TypeError as err:
        raise TypeError(
            "Session state carries a non-JSON-serializable leaf (a tail batch's"
            f" static argument, most likely): {err}. Only plain scalars/strings"
            " may ride the tail outside arrays."
        ) from err

    _materialize_bundle(
        path, manifest_text, {key: state_arrays[key] for key in written}, tail_arrays
    )
    return manifest


def _materialize_bundle(
    path: str,
    manifest_text: str,
    state_arrays: Dict[str, np.ndarray],
    tail_arrays: Dict[str, np.ndarray],
) -> str:
    """The low-level bundle writer: temp dir → npz payloads → manifest →
    integrity digest → atomic install. Shared by :func:`_write_bundle` and
    :func:`compact_chain` so the durability discipline has one home."""
    path = os.path.abspath(path)
    tag = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
    tmp = f"{path}.tmp.{tag}"
    try:
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, _STATE_NAME), **state_arrays)
        if tail_arrays:
            np.savez(os.path.join(tmp, _TAIL_NAME), **tail_arrays)
        with open(os.path.join(tmp, _MANIFEST_NAME), "w", encoding="utf-8") as fh:
            fh.write(manifest_text)
        digest = _checkpoint.file_tree_digest(tmp, exclude=(_INTEGRITY_NAME,))
        with open(os.path.join(tmp, _INTEGRITY_NAME), "w", encoding="utf-8") as fh:
            json.dump({"version": 1, "schema": SESSION_SCHEMA, "sha256": digest}, fh)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return _checkpoint.atomic_install_dir(tmp, path, tag)


# ------------------------------------------------------------------ capture


def _capture_pipeline(
    pipe: MetricPipeline,
    path: str,
    drain: bool,
    tail: Iterable[Any] = (),
    alert_engine: Any = None,
    value_log: Any = None,
    delta_base: Optional[Tuple[str, str, Dict[str, str]]] = None,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
) -> Dict[str, Any]:
    """Capture one pipeline session into a bundle at ``path``.

    ``drain=True`` is the cooperative migration path (open chunk dispatched,
    in-flight window blocked, deferred backlog handed over as the tail).
    ``drain=False`` is the continuous path: the session keeps running — the
    bundle holds exactly the committed (chunk-consistent) state, the deferred
    backlog rides as a *copied* tail, and batches in the open fusion chunk are
    deliberately NOT captured (they are the bounded replay gap an unplanned
    death pays).
    """
    target = pipe.metric
    tenant = pipe.config.tenant
    engine = _resolve_engine(alert_engine, pipe.config.alert_engine)
    log = _resolve_value_log(value_log, engine)

    if drain:
        drained = pipe.drain()
        tail_batches = list(drained) + [_normalize_batch(b) for b in tail]
        deferred_tail = len(drained)
    else:
        # the port's pipeline defers nothing (admission waits for the mux slice)
        tail_batches = [_normalize_batch(b) for b in tail]
        deferred_tail = 0
    report = pipe.report()
    # the cursor is the PROCESSED count — batches the state (or its guarded
    # replay) actually consumed. The ingest counter would overcount: batches
    # in the open fusion chunk, and the batch mid-ingest when a signature
    # flush triggers this capture, are not folded yet — claiming them would
    # make the crash-recovery gap re-feed skip real data
    committed = report.fused_batches + report.eager_batches + report.replayed_batches
    report_dict = report.asdict()
    report_dict.update(dict.fromkeys(_ADMISSION_COUNTERS, 0))
    if report_dict["batches"] != committed:
        report_dict["batches"] = committed
    members = _driven_metrics(target)
    robust = {
        label: {"sync_degraded": bool(getattr(m, "sync_degraded", False))}
        for label, m in members
    }
    cursor = {
        "batches_ingested": committed,
        "tail_batches": len(tail_batches),
        # the first this-many tail batches are the origin's admission-
        # deferred backlog: the restore counts them toward deferred_replayed
        # so the accounting balances
        "deferred_tail": deferred_tail,
        "update_counts": {label: int(m.update_count) for label, m in members},
        # the fusion-chunk ordinal continues across a restore so post-restore
        # dispatch spans can never collide with restored flight records'
        # chunk ids (the trace id stays the canonical correlation key)
        "chunk_seq": int(pipe._chunk_seq),
        # batch-lineage identity (obs/lineage.py): restored mints continue the
        # origin's id space. A drained (cooperative) capture hands over the
        # arrival counter verbatim — the tail already carries its pre-minted
        # ids, and fresh batches must not collide with them. A continuous
        # (no-drain) capture hands over the PROCESSED count instead — the open
        # chunk's batches are the crash replay gap, and re-feeding them must
        # re-mint exactly the ordinals they originally carried — but ONLY on a
        # detour-free stream: once any batch was shed or deferred, arrival
        # ordinals and the processed count no longer line up, and a
        # processed-count seq would re-issue ids that already name OTHER
        # batches. Such sessions hand over the arrival counter instead:
        # collision-safety is the invariant, gap-id stability the
        # clean-stream optimization.
        "lineage": {
            "epoch": pipe._lineage_epoch,
            "seq": int(pipe._lineage_seq) if drain else committed,
        },
    }
    inst_pairs = {
        (type(m).__name__, str(getattr(m, "_obs_instance", "0"))) for _, m in members
    }
    config_fields = {
        name: getattr(pipe.config, name) if name != "max_deferred" else _MAX_DEFERRED_DEFAULT
        for name in _CONFIG_FIELDS
    }
    if config_fields["fuse_buckets"] is not None:
        config_fields["fuse_buckets"] = list(config_fields["fuse_buckets"])
    core = {
        "tenant": tenant,
        "metric_class": type(target).__name__,
        "collection": isinstance(target, MetricCollection),
        "members": [label for label, _ in members if label],
        "config": config_fields,
        "cursor": cursor,
        "report": report_dict,
        "robust": robust,
        "flight": pipe.flight_snapshot(),
        "values": _session_values(log, pipe._tenant, inst_pairs),
        "alerts": engine.export_state() if engine is not None else None,
        "registry": _registry_row(pipe._tenant),
        # the lease stamp: holder id, session epoch (the fencing token),
        # expiry. Every bundle write doubles as a cross-host lease renewal —
        # the snapshot refreshes the lease before stamping it.
        "lease": pipe.lease_snapshot(),
    }
    manifest = _write_bundle(
        path, core, _checkpoint._tree_of(target), tail_batches, delta_base, segment_bytes
    )
    if _trace.ENABLED:
        _trace.event(
            "engine.session_checkpoint",
            pipeline=type(target).__name__,
            tenant=tenant,
            batches=committed,
            tail=len(tail_batches),
            delta=manifest.get("base") is not None,
            path=os.path.abspath(path),
        )
    return manifest


# ---------------------------------------------------------------- checkpoint


def checkpoint_session(
    pipe: Any,
    path: str,
    tail: Iterable[Any] = (),
    alert_engine: Any = None,
    value_log: Any = None,
    tenant: Optional[str] = None,
    delta_base: Optional[str] = None,
) -> Dict[str, Any]:
    """Atomically checkpoint a *live* session to a bundle at ``path``.

    ``pipe`` is a :class:`MetricPipeline` — drained first (open chunk dispatched,
    every in-flight ticket waited on — the **cursor**: metric state is now exactly
    the fold of every dispatched batch). ``tenant`` names one tenant of a
    multiplexer, whose slices come with the multiplexer slice: it raises here.

    Persists the full session: metric state (the ``__robust__``-aware
    ``state_dict``), the replay tail (the drained admission-deferred backlog
    plus any ``tail`` batches the caller buffered while draining — each item a
    positional tuple, a kwargs dict, or a single array), the flight-recorder
    ring, the accounting report, the tenant registry row, the session's value
    timelines, and the alert engine's live state machines + history.

    ``delta_base`` names an existing bundle to delta against: unchanged state
    entries (per-leaf/per-segment content hash) are resolved through the chain
    instead of rewritten. ``alert_engine`` defaults to the session's
    configured engine, else the process-global one; ``value_log`` to the
    engine's log, else the global. Runs under ``scope.migration(tenant,
    "checkpoint")`` so ``/healthz`` names the tenant while the drain+write is
    in flight. Returns the manifest.
    """
    base: Optional[Tuple[str, str, Dict[str, str]]] = None
    if delta_base is not None:
        base_path = os.path.abspath(delta_base)
        # writer's view: a fenced session may keep spooling (its bundles land
        # and recovery rejects them), so the base verify skips the fence check
        base_manifest = verify_bundle(base_path, check_fence=False)
        if os.path.dirname(base_path) != os.path.dirname(os.path.abspath(path)):
            raise SessionBundleError(
                f"Delta base {base_path} must be a sibling of the new bundle"
                f" {os.path.abspath(path)} — chains resolve base links by sibling"
                " name so a bundle directory migrates as one unit."
            )
        base = (
            os.path.basename(base_path),
            base_manifest["bundle_id"],
            dict(base_manifest.get("entries") or {}),
        )

    if tenant is not None:
        raise _needs_mux("A tenant slice of a TenantMultiplexer (`tenant=`)")

    session_tenant = pipe.config.tenant
    ctx = _scope.migration(session_tenant, "checkpoint") if session_tenant is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        return _capture_pipeline(
            pipe,
            path,
            drain=True,
            tail=tail,
            alert_engine=alert_engine,
            value_log=value_log,
            delta_base=base,
        )
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


# ------------------------------------------------------------------ fencing


def _fence_path(directory: str) -> str:
    return os.path.join(os.path.abspath(directory), _FENCE_NAME)


def _bundle_epoch(manifest: Dict[str, Any]) -> Optional[str]:
    """The session epoch a bundle was written under — its fencing token.

    Schema-3 bundles carry it in the lease stamp; schema-2 bundles fall back
    to the lineage cursor's epoch, so even pre-lease sessions can be fenced.
    """
    lease = manifest.get("lease")
    if isinstance(lease, dict) and lease.get("epoch"):
        return str(lease["epoch"])
    lineage = (manifest.get("cursor") or {}).get("lineage") or {}
    epoch = lineage.get("epoch")
    return str(epoch) if epoch else None


def fenced_epochs(directory: str) -> Dict[str, Dict[str, Any]]:
    """Read the durable fence records under ``directory``: ``{epoch: record}``.

    Missing or unreadable markers read as "nothing fenced" — fencing must
    never make an intact, unfenced bundle stream unrestorable. Records found
    on disk are mirrored into the scope fence registry, so any process that
    scans the directory can name the fenced tenant on ``/healthz`` and
    attribute post-fence trace ids.
    """
    try:
        with open(_fence_path(directory), encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return {}
    records = payload.get("fences") if isinstance(payload, dict) else None
    if not isinstance(records, dict):
        return {}
    out: Dict[str, Dict[str, Any]] = {}
    for epoch, record in records.items():
        if not isinstance(record, dict):
            continue
        out[str(epoch)] = record
        _scope.note_fence(
            str(epoch),
            tenant=record.get("tenant"),
            holder=record.get("holder"),
            by=record.get("by"),
            target=record.get("target"),
            fenced_unix=record.get("fenced_unix"),
        )
    return out


def fence_epoch(
    directory: str,
    epoch: str,
    *,
    tenant: Optional[str] = None,
    holder: Optional[str] = None,
    by: Optional[str] = None,
    target: Optional[str] = None,
) -> Dict[str, Any]:
    """Durably fence session ``epoch`` out of ``directory``'s bundle stream.

    Writes (atomically) a fence record into ``FENCED.json`` next to the
    bundles. The record snapshots the bundle names present *now* (``known``):
    those stay restorable; any bundle the fenced holder writes later carries
    the fenced epoch but is not in ``known``, so every recovery-path verify
    rejects it (:class:`FencedBundleError`) — the failover must therefore
    fence FIRST and only then select its restore bundle. Idempotent per
    epoch: the first record (and its ``known`` snapshot) wins. Returns the
    record and mirrors it into the scope fence registry.
    """
    from torchmetrics_tpu_torch.utils.fileio import atomic_write_text

    directory = os.path.abspath(directory)
    existing = fenced_epochs(directory)
    if str(epoch) in existing:
        return existing[str(epoch)]
    known = sorted(
        name
        for name in (os.listdir(directory) if os.path.isdir(directory) else ())
        if os.path.isdir(os.path.join(directory, name))
        and ".tmp." not in name
        and ".old." not in name
    )
    record = {
        "epoch": str(epoch),
        "tenant": tenant,
        "holder": holder,
        "by": by,
        "target": target,
        "fenced_unix": time.time(),
        "known": known,
    }
    records = {**existing, str(epoch): record}
    os.makedirs(directory, exist_ok=True)
    atomic_write_text(
        _fence_path(directory),
        json.dumps({"version": 1, "fences": records}, sort_keys=True, indent=2),
    )
    _scope.note_fence(
        str(epoch),
        tenant=tenant,
        holder=holder,
        by=by,
        target=target,
        fenced_unix=record["fenced_unix"],
    )
    if _trace.ENABLED:
        _trace.event(
            "engine.fence",
            tenant=tenant,
            epoch=str(epoch),
            holder=holder,
            by=by,
            target=target,
            known=len(known),
        )
    return record


def _check_fence(path: str, manifest: Dict[str, Any]) -> None:
    """Reject ``path`` if it was written under a fenced epoch after the fence."""
    fences = fenced_epochs(os.path.dirname(os.path.abspath(path)))
    if not fences:
        return
    epoch = _bundle_epoch(manifest)
    record = fences.get(epoch) if epoch else None
    if record is None:
        return
    if os.path.basename(os.path.abspath(path)) in (record.get("known") or ()):
        return  # written before the fence: stays restorable
    raise FencedBundleError(
        f"Session bundle at {path} was written under fenced-out epoch {epoch}"
        f" (holder {record.get('holder')!r}, fenced by {record.get('by')!r}) AFTER"
        " the fence landed — a zombie host's late write; refusing to restore"
        " from it."
    )


# ------------------------------------------------------------------- verify


def _verify_one(path: str, check_fence: bool = True) -> Dict[str, Any]:
    """Verify ONE bundle directory (digest + schema + kind); returns its manifest."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise SessionBundleError(f"No session bundle at {path}")
    integrity_path = os.path.join(path, _INTEGRITY_NAME)
    if not os.path.isfile(integrity_path):
        raise SessionBundleError(
            f"Session bundle at {path} has no {_INTEGRITY_NAME} — bundles are always"
            " written with an integrity record, so this is a partial copy or a"
            " directory that is not a session bundle; refusing to restore from it."
        )
    try:
        with open(integrity_path, encoding="utf-8") as fh:
            recorded = json.load(fh)
    except (OSError, ValueError) as err:
        raise SessionBundleError(
            f"Session bundle at {path} has an unreadable {_INTEGRITY_NAME} ({err}) —"
            " the record itself is truncated or tampered; restore from another bundle."
        ) from err
    try:
        digest = _checkpoint.file_tree_digest(path, exclude=(_INTEGRITY_NAME,))
    except SessionBundleError:
        raise
    except CheckpointIntegrityError as err:
        # the path-traversal guard: symlinks / root-escaping entries
        raise SessionBundleError(str(err)) from err
    if digest != recorded.get("sha256"):
        raise SessionBundleError(
            f"Session bundle at {path} failed its integrity check (recorded"
            f" {str(recorded.get('sha256'))[:12]}…, recomputed {digest[:12]}…) —"
            " the bundle was corrupted after the checkpoint; restore from another one."
        )
    try:
        with open(os.path.join(path, _MANIFEST_NAME), encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as err:
        raise SessionBundleError(
            f"Session bundle at {path} has an unreadable {_MANIFEST_NAME} ({err})"
        ) from err
    if not isinstance(manifest, dict) or manifest.get("kind") != _BUNDLE_KIND:
        raise SessionBundleError(
            f"Directory at {path} verifies but is not a session bundle"
            f" (kind={manifest.get('kind') if isinstance(manifest, dict) else None!r})"
        )
    if manifest.get("schema_version") not in _COMPAT_SCHEMAS:
        raise SessionBundleError(
            f"Session bundle at {path} carries schema"
            f" {manifest.get('schema_version')!r} but this build speaks"
            f" {sorted(_COMPAT_SCHEMAS)} — re-checkpoint with a matching build (a"
            " silently reinterpreted session would break the zero-loss contract)."
        )
    if check_fence:
        _check_fence(path, manifest)
    return manifest


def _chain_manifests(
    path: str, manifest: Dict[str, Any], check_fence: bool = True
) -> List[Tuple[str, Dict[str, Any]]]:
    """Verify + return the whole delta chain, newest first.

    Each link is digest-verified, its ``bundle_id`` must match what the delta
    above it recorded (a *substituted* base — valid on its own but not the one
    the delta was written against — is rejected), and every state entry of the
    top manifest must resolve to some link that wrote it with the same content
    hash.
    """
    path = os.path.abspath(path)
    chain: List[Tuple[str, Dict[str, Any]]] = [(path, manifest)]
    seen = {path}
    current_path, current = path, manifest
    while current.get("base"):
        base = current["base"] or {}
        name = base.get("name")
        if (
            not isinstance(name, str)
            or not name
            or "/" in name
            or os.sep in name
            or name in (".", "..")
        ):
            raise SessionBundleError(
                f"Session bundle at {current_path} names an unusable delta base"
                f" {name!r} — base links are plain sibling directory names."
            )
        base_path = os.path.join(os.path.dirname(current_path), name)
        if base_path in seen:
            raise SessionBundleError(
                f"Session bundle chain at {path} is cyclic (revisits {base_path})."
            )
        base_manifest = _verify_one(base_path, check_fence=check_fence)
        if base_manifest.get("bundle_id") != base.get("bundle_id"):
            raise SessionBundleError(
                f"Session bundle at {current_path} was written against base"
                f" bundle_id {base.get('bundle_id')!r} but {base_path} carries"
                f" {base_manifest.get('bundle_id')!r} — the base was replaced after"
                " the delta was written; the chain cannot be trusted."
            )
        chain.append((base_path, base_manifest))
        seen.add(base_path)
        current_path, current = base_path, base_manifest
    needed = dict(chain[0][1].get("entries") or {})
    for _link_path, link_manifest in chain:
        link_entries = link_manifest.get("entries") or {}
        for key in link_manifest.get("written") or []:
            if key in needed and link_entries.get(key) == needed[key]:
                needed.pop(key)
        if not needed:
            break
    if needed:
        raise SessionBundleError(
            f"Session bundle at {path} cannot resolve state entries"
            f" {sorted(needed)} anywhere in its {len(chain)}-link chain — a link"
            " was removed or truncated; restore from another bundle."
        )
    return chain


def verify_bundle(path: str, chain: bool = True, check_fence: bool = True) -> Dict[str, Any]:
    """Verify a session bundle's integrity + schema; returns its manifest.

    Loud by design: a missing bundle, a missing/unreadable integrity record, a
    file-tree digest mismatch (truncation, tampering, a half-copied rsync), a
    symlinked or root-escaping entry, an unreadable manifest, or a schema/kind
    mismatch each raise :class:`SessionBundleError` **before any state is
    touched** — restoring from a bad bundle must never poison the restoring
    process. With ``chain=True`` (the default) a delta bundle's whole base
    chain is walked and verified the same way, including base-id linkage and
    full entry resolvability. With ``check_fence=True`` (the default) a bundle
    written under a fenced-out session epoch *after* the fence landed raises
    :class:`FencedBundleError` — recovery paths must never trust a zombie
    host's late writes. ``check_fence=False`` is the *writer's* view: a fenced
    session may keep spooling bundles locally (they land, and every recovery
    scan rejects them), so the fence guards restores, not writes.
    """
    manifest = _verify_one(path, check_fence=check_fence)
    if chain and manifest.get("base"):
        _chain_manifests(path, manifest, check_fence=check_fence)
    return manifest


def _load_state_arrays(
    path: str,
    manifest: Dict[str, Any],
    chain: Optional[List[Tuple[str, Dict[str, Any]]]] = None,
) -> Dict[str, np.ndarray]:
    """Resolve every state entry through the (verified) chain, hash-checked.

    ``chain`` reuses an already-verified :func:`_chain_manifests` walk so a
    caller that just verified the bundle does not re-digest every link."""
    if chain is None:
        chain = _chain_manifests(os.path.abspath(path), manifest)
    needed = dict(manifest.get("entries") or {})
    arrays: Dict[str, np.ndarray] = {}
    for link_path, link_manifest in chain:
        if not needed:
            break
        link_entries = link_manifest.get("entries") or {}
        want = [
            key
            for key in (link_manifest.get("written") or [])
            if key in needed and link_entries.get(key) == needed[key]
        ]
        if not want:
            continue
        state_path = os.path.join(link_path, _STATE_NAME)
        with np.load(state_path) as payload:
            for key in want:
                arr = payload[key]
                if _entry_hash(arr) != needed[key]:
                    raise SessionBundleError(
                        f"State entry {key!r} loaded from {link_path} does not match"
                        " the content hash the manifest recorded — the chain was"
                        " tampered with after verification; restore from another"
                        " bundle."
                    )
                arrays[key] = arr
                needed.pop(key)
    if needed:  # pragma: no cover - _chain_manifests already proved resolvability
        raise SessionBundleError(
            f"Session bundle at {path} is missing state entries {sorted(needed)}"
        )
    return arrays


# ------------------------------------------------------------------- recovery


def latest_valid_bundle(directory: str) -> Optional[str]:
    """Newest bundle under ``directory`` whose whole chain verifies, or None.

    The unplanned-death restore point: a SIGKILL'd host's bundle directory may
    end with a half-written ``.tmp.*`` sibling or a corrupted link — those are
    skipped **loudly** (one ``RuntimeWarning`` naming every skipped entry and
    why, plus the ``checkpoint.torn_bundles`` gauge counting every torn/corrupt
    skip) and the newest intact bundle wins. A bundle written under a
    fenced-out epoch after its fence landed (a zombie host's late write) is
    likewise never selected — rejected with its own warning and counted into
    ``fence.bundles_rejected``. Bundles are ordered by their manifest
    ``ts_unix`` (name as tie-break), not directory mtime — a restore must
    never prefer a stale bundle a copy touched last.
    """
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    candidates: List[Tuple[float, str, str]] = []
    skipped: List[Tuple[str, str]] = []
    torn = 0
    fenced: List[Tuple[str, str]] = []
    for name in sorted(os.listdir(directory)):
        full = os.path.join(directory, name)
        if not os.path.isdir(full):
            continue
        if ".tmp." in name or ".old." in name:
            skipped.append((name, "mid-write temp/displaced sibling"))
            continue
        try:
            manifest = verify_bundle(full)
        except FencedBundleError as err:
            fenced.append((name, str(err).split("\n")[0][:160]))
            continue
        except SessionBundleError as err:
            skipped.append((name, str(err).split("\n")[0][:160]))
            torn += 1
            continue
        candidates.append((float(manifest.get("ts_unix") or 0.0), name, full))
    if skipped:
        detail = "; ".join(f"{name}: {reason}" for name, reason in skipped)
        rank_zero_warn(
            f"Skipped {len(skipped)} invalid or mid-write bundle(s) under"
            f" {directory} while scanning for the latest restore point — {detail}",
            RuntimeWarning,
        )
    if torn:
        _scope.note_torn_bundles(torn)
    if fenced:
        _scope.note_fenced_bundle_rejected(len(fenced))
        detail = "; ".join(f"{name}: {reason}" for name, reason in fenced)
        rank_zero_warn(
            f"Rejected {len(fenced)} post-fence zombie bundle(s) under {directory}"
            f" — written under a fenced-out epoch after its fence landed; never"
            f" selected as a restore point — {detail}",
            RuntimeWarning,
        )
    if not candidates:
        return None
    candidates.sort()
    return candidates[-1][2]


def compact_chain(path: str, out_path: str) -> Dict[str, Any]:
    """Merge a delta chain into ONE standalone full bundle at ``out_path``.

    Restoring the compacted bundle is bit-equivalent to restoring the chain:
    the resolved entry set is re-written whole (same content hashes), the
    manifest's session payload (cursor, report, values, alerts, tail, ...) is
    the top link's, and the new bundle names no base. ``compacted_from``
    records the source ``bundle_id`` for provenance. Returns the new manifest.
    """
    path = os.path.abspath(path)
    manifest = _verify_one(path)
    arrays = _load_state_arrays(path, manifest, chain=_chain_manifests(path, manifest))
    tail_arrays: Dict[str, np.ndarray] = {}
    tail_path = os.path.join(os.path.abspath(path), _TAIL_NAME)
    if os.path.isfile(tail_path):
        with np.load(tail_path) as payload:
            tail_arrays = {key: payload[key] for key in payload.files}

    core = {
        key: value
        for key, value in manifest.items()
        if key
        not in (
            "kind",
            "schema_version",
            "bundle_id",
            "base",
            "entries",
            "written",
            "state_skeleton",
            "tail",
            "ts_unix",
        )
    }
    core["compacted_from"] = manifest["bundle_id"]
    new_manifest = {
        **core,
        "kind": _BUNDLE_KIND,
        "schema_version": SESSION_SCHEMA,
        "bundle_id": uuid.uuid4().hex,
        "base": None,
        "entries": dict(manifest.get("entries") or {}),
        "written": sorted(manifest.get("entries") or {}),
        "state_skeleton": manifest.get("state_skeleton"),
        "tail": manifest.get("tail"),
        "ts_unix": time.time(),
    }
    _materialize_bundle(
        out_path, json.dumps(new_manifest, sort_keys=True, indent=2), arrays, tail_arrays
    )
    return new_manifest


def sweep_bundles(directory: str, keep: int, gc_fenced: bool = True) -> List[str]:
    """Retention sweep: keep the newest ``keep`` bundles **plus every chain
    link they depend on**; remove the rest. Returns removed bundle paths.

    A delta bundle is only as durable as its chain, so the kept set is closed
    over base links — the sweep can never delete a link a live chain resolves
    through. Directories whose manifest cannot be read are left alone (they
    may be a concurrent writer's mid-install state; ``latest_valid_bundle``
    skips them loudly either way).

    ``gc_fenced`` adds the zombie-GC mode: a bundle whose epoch is fenced AND
    whose name is not in the fence-time ``known`` snapshot is a zombie host's
    post-fence write — every recovery scan already rejects it
    (:class:`FencedBundleError`), so retention garbage-collects it regardless
    of recency instead of letting rejected garbage crowd the ``keep`` window.
    Zombies never count toward the kept window, and a kept live chain's base
    closure is never touched even if a link looks fenced. Each zombie GC'd is
    counted into the ``fence.bundles_swept`` gauge.
    """
    if keep < 1:
        raise ValueError(f"Expected `keep` >= 1, got {keep}")
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    manifests: Dict[str, Dict[str, Any]] = {}
    for name in sorted(os.listdir(directory)):
        full = os.path.join(directory, name)
        if not os.path.isdir(full) or ".tmp." in name or ".old." in name:
            continue
        try:
            with open(os.path.join(full, _MANIFEST_NAME), encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(manifest, dict) and manifest.get("kind") == _BUNDLE_KIND:
            manifests[name] = manifest
    zombies: set = set()
    if gc_fenced:
        fences = fenced_epochs(directory)
        if fences:
            for name, manifest in manifests.items():
                epoch = _bundle_epoch(manifest)
                record = fences.get(epoch) if epoch else None
                if record is not None and name not in (record.get("known") or ()):
                    zombies.add(name)
    ordered = sorted(
        manifests, key=lambda name: (float(manifests[name].get("ts_unix") or 0.0), name)
    )
    # zombies are unrestorable garbage: they must not occupy the keep window
    # (a wedged host's late writes would otherwise evict the real stream)
    live_ordered = [name for name in ordered if name not in zombies]
    kept = set(live_ordered[-keep:])
    # close over chain dependencies: a kept delta keeps its whole base chain —
    # even through a link the fence ledger flags, the live chain wins
    frontier = list(kept)
    while frontier:
        name = frontier.pop()
        base = (manifests.get(name) or {}).get("base") or {}
        base_name = base.get("name")
        if base_name and base_name in manifests and base_name not in kept:
            kept.add(base_name)
            frontier.append(base_name)
    removed = []
    swept_zombies = 0
    for name in ordered:
        if name in kept:
            continue
        full = os.path.join(directory, name)
        shutil.rmtree(full, ignore_errors=True)
        removed.append(full)
        if name in zombies:
            swept_zombies += 1
    if swept_zombies:
        _scope.note_fenced_bundle_swept(swept_zombies)
        if _trace.ENABLED:
            _trace.event(
                "engine.fence_sweep", directory=directory, swept=swept_zombies
            )
    return removed


# --------------------------------------------------------------- continuous


class ContinuousCheckpointer:
    """One session's periodic bundle stream under a :class:`CheckpointPolicy`.

    Owned by a :class:`MetricPipeline` (``PipelineConfig.checkpoint``). Tracks the cadence, names the bundles
    (``bundle-%06d``), keeps the delta base (name + entry hashes) in memory so
    a delta write never re-reads its base, writes every ``full_every``-th
    bundle full (the compaction point), runs the retention sweep, feeds the
    ``checkpoint.*`` telemetry, and **never lets a failing write break the
    stream** (warn once, count, keep serving).
    """

    def __init__(
        self, policy: CheckpointPolicy, tenant: Optional[str] = None, label: str = "session"
    ) -> None:
        self.policy = policy
        self.tenant = tenant
        self.label = label
        self._seq = 0
        self._seq_seeded = False
        self._last_batches = 0
        self._last_time = time.monotonic()
        self._base: Optional[Tuple[str, str, Dict[str, str]]] = None
        self._warned_failure = False
        self.failures = 0
        self.last_path: Optional[str] = None
        self.stats = {
            "full": {"count": 0, "bytes": 0},
            "delta": {"count": 0, "bytes": 0},
        }

    def due(self, committed_batches: int) -> bool:
        policy = self.policy
        if policy.every_batches and committed_batches - self._last_batches >= policy.every_batches:
            return True
        if policy.every_seconds and time.monotonic() - self._last_time >= policy.every_seconds:
            return True
        return False

    def write(
        self,
        capture: Callable[[str, Optional[Tuple[str, str, Dict[str, str]]], int], Dict[str, Any]],
        committed_batches: int,
    ) -> Optional[str]:
        """Write one bundle via ``capture(path, delta_base, segment_bytes)``."""
        policy = self.policy
        if not self._seq_seeded:
            # a restored session continuing an existing directory (crash
            # recovery) must extend the stream, never overwrite a bundle an
            # existing chain still resolves through
            self._seq_seeded = True
            if os.path.isdir(policy.directory):
                taken = [
                    int(name[len("bundle-") :])
                    for name in os.listdir(policy.directory)
                    if name.startswith("bundle-") and name[len("bundle-") :].isdigit()
                ]
                if taken:
                    self._seq = max(taken) + 1
        name = f"bundle-{self._seq:06d}"
        path = os.path.join(policy.directory, name)
        delta_base = (
            self._base if (self._base is not None and self._seq % policy.full_every != 0) else None
        )
        start = time.perf_counter()
        try:
            os.makedirs(policy.directory, exist_ok=True)
            manifest = capture(path, delta_base, policy.segment_bytes)
        except Exception as err:
            self.failures += 1
            if self.tenant is not None:
                _scope.note_checkpoint_failure(self.tenant)
            if _trace.ENABLED:
                _trace.inc("checkpoint.failures", pipeline=self.label)
            if not self._warned_failure:
                self._warned_failure = True
                rank_zero_warn(
                    f"Continuous checkpoint of {self.label!r} could not be written to"
                    f" {path!r}: {type(err).__name__}: {err}. The stream keeps flowing"
                    " and further attempts continue on cadence, but the last-success"
                    " age is growing (checkpoint.last_success_age_seconds /"
                    " /healthz staleness); this warning fires once per session.",
                    RuntimeWarning,
                )
            return None
        seconds = time.perf_counter() - start
        kind = "delta" if manifest.get("base") else "full"
        nbytes = _dir_bytes(path)
        self.stats[kind]["count"] += 1
        self.stats[kind]["bytes"] += nbytes
        self._seq += 1
        self._last_batches = committed_batches
        self._last_time = time.monotonic()
        self._base = (name, manifest["bundle_id"], dict(manifest.get("entries") or {}))
        self.last_path = path
        if self.tenant is not None:
            _scope.note_checkpoint(
                self.tenant,
                path=path,
                nbytes=nbytes,
                kind=kind,
                seconds=seconds,
                stale_after_seconds=policy.stale_after_seconds,
            )
        # batch lineage: this bundle covers the session's first
        # `committed_batches` processed batches — a batch is joined against the
        # newest bundle whose cursor is past its ordinal. (The JAX package notes
        # only detour-free streams; without admission every port stream is one.)
        _lineage.note_checkpoint(self.tenant, path, committed_batches)
        if _trace.ENABLED:
            _trace.inc("checkpoint.bundles", pipeline=self.label, kind=kind)
            _trace.set_gauge("checkpoint.bundle_bytes", float(nbytes), pipeline=self.label, kind=kind)
            _trace.set_gauge("checkpoint.write_seconds", float(seconds), pipeline=self.label)
        try:
            # the writer's own cadence sweep is recency-only: a fenced writer
            # GC'ing its own just-landed bundle would erase the zombie-write
            # evidence recovery scans reject and count. Zombie GC belongs to
            # explicit sweeps — the survivor's failover cleanup, an operator's
            # retention pass — where gc_fenced defaults on.
            sweep_bundles(policy.directory, policy.keep, gc_fenced=False)
        except Exception:  # retention must never cost the stream
            pass
        return path

    def covered(self, committed_batches: int) -> bool:
        """True when the last successful bundle already covers this count —
        the clean-close path skips a byte-identical duplicate write."""
        return self._seq > 0 and committed_batches == self._last_batches

    def maybe_pipeline(
        self,
        pipe: MetricPipeline,
        force: bool = False,
        skip_if_covered: bool = False,
    ) -> Optional[str]:
        """The pipeline's commit-boundary hook: write if the cadence is due.

        ``committed`` counts only processed batches (fused + eager + replayed)
        — never the open fusion chunk or a batch mid-ingest — which is what
        makes every bundle chunk-consistent without a drain.
        """
        report = pipe._report
        committed = report.fused_batches + report.eager_batches + report.replayed_batches
        if skip_if_covered and self.covered(committed):
            return None
        if not force and not self.due(committed):
            return None

        def capture(path: str, delta_base: Any, segment_bytes: int) -> Dict[str, Any]:
            return _capture_pipeline(
                pipe, path, drain=False, delta_base=delta_base, segment_bytes=segment_bytes
            )

        return self.write(capture, committed)

def checkpoint_staleness_rule(
    max_age_seconds: float,
    tenant: str = "*",
    name: str = "checkpoint_stale",
    severity: str = "critical",
    for_seconds: float = 0.0,
) -> Any:
    """An absent-style watchdog over checkpoint freshness.

    A ``threshold`` rule on the ``checkpoint.last_success_age_seconds`` gauge
    (refreshed per ``/metrics`` scrape by :func:`obs.scope.record_gauges`):
    fires when a tenant session's last successful periodic bundle is older
    than ``max_age_seconds`` — the alert-engine twin of the ``/healthz``
    staleness reason, for fleets that page on alerts rather than probes.
    """
    from torchmetrics_tpu_torch.obs.alerts import AlertRule

    return AlertRule(
        name=name,
        kind="threshold",
        series="checkpoint.last_success_age_seconds",
        above=float(max_age_seconds),
        tenant=tenant,
        severity=severity,
        for_seconds=for_seconds,
    )


# ------------------------------------------------------------------- restore


def restore_session(
    metric: Union[Metric, MetricCollection],
    path: str,
    config: Optional[PipelineConfig] = None,
    alert_engine: Any = None,
    value_log: Any = None,
    replay: bool = True,
    restore_registry: bool = True,
    fresh_epoch: bool = False,
    **overrides: Any,
) -> Tuple[MetricPipeline, Dict[str, Any]]:
    """Restore a checkpointed session onto ``metric`` (freshly constructed with
    the same spec — the ``load_checkpoint`` contract); returns ``(pipeline,
    manifest)``.

    The second half of drain→checkpoint→restore→replay-tail (and the whole
    second half of crash recovery): the bundle is verified chain-aware
    (:func:`verify_bundle`, loud), state entries are resolved through the
    delta chain with their content hashes re-checked, metric state is restored
    (update counts, robust counters and ``sync_degraded`` included), a new
    :class:`MetricPipeline` is built from the bundled config (``config=`` or
    keyword ``overrides`` adjust host-local knobs: ``flight_dump_dir``,
    ``device``, ``checkpoint`` policy, ...; ``alert_engine`` attaches the
    restoring host's engine and receives the bundled alert machines with dwell
    clocks intact), the flight ring / report / value timelines / registry row
    are re-installed, and the replay tail is re-fed in order onto the target's
    device. The restored pipeline's captures are its own: its first dispatch (or
    its :meth:`~MetricPipeline.warmup`) captures anew around the restored state.

    Runs under ``scope.migration(tenant, "restore")`` — ``/healthz`` stays
    degraded-not-dead with the tenant named until the tail has replayed.
    """
    path = os.path.abspath(path)
    manifest = _verify_one(path)
    # one chain walk serves both verification and entry resolution — every
    # link is digest-checked exactly once per restore
    chain = _chain_manifests(path, manifest)

    if type(metric).__name__ != manifest.get("metric_class"):
        raise SessionBundleError(
            f"Session bundle at {path} was checkpointed from a"
            f" {manifest.get('metric_class')!r} but the restore target is a"
            f" {type(metric).__name__!r} — the target must be constructed with the"
            " checkpointed session's spec."
        )
    is_collection = isinstance(metric, MetricCollection)
    if bool(manifest.get("collection")) != is_collection:
        raise SessionBundleError(
            f"Session bundle at {path} and the restore target disagree on being a"
            " MetricCollection."
        )
    members = _driven_metrics(metric)
    if is_collection:
        want = set(manifest.get("members") or [])
        have = {label for label, _ in members}
        if want != have:
            raise SessionBundleError(
                f"Session bundle at {path} names members {sorted(want)} but the"
                f" restore target holds {sorted(have)} — same-spec restore only."
            )

    cursor = manifest.get("cursor") or {}
    if manifest.get("mux_slice"):
        raise _needs_mux(f"Session bundle at {path} is a multiplexer tenant's slice; restoring it")
    max_deferred = (manifest.get("config") or {}).get("max_deferred", _MAX_DEFERRED_DEFAULT)
    if max_deferred != _MAX_DEFERRED_DEFAULT:
        raise _needs_mux(f"Session bundle at {path} sets `max_deferred={max_deferred}`; restoring it")
    if int(cursor.get("deferred_tail", 0) or 0):
        raise _needs_mux(f"Session bundle at {path} carries an admission-deferred backlog; restoring it")

    try:
        state_arrays = _load_state_arrays(path, manifest, chain=chain)
        tree = _decode_tree(manifest.get("state_skeleton") or {}, state_arrays)
    except SessionBundleError:
        raise
    except Exception as err:
        raise SessionBundleError(
            f"Session bundle at {path} verifies but its state tree is unreadable:"
            f" {err}"
        ) from err

    tenant = manifest.get("tenant")
    ctx = _scope.migration(tenant, "restore") if tenant is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        if is_collection:
            for label, m in members:
                _checkpoint._restore_states(m, tree[label])
        else:
            _checkpoint._restore_states(metric, tree)
        robust = manifest.get("robust") or {}
        for label, m in members:
            flags = robust.get(label) or {}
            if flags.get("sync_degraded"):
                m.sync_degraded = True

        if config is None:
            cfg_kwargs = dict(manifest.get("config") or {})
            cfg_kwargs.pop("max_deferred", None)  # checked above: JAX's default
            if cfg_kwargs.get("fuse_buckets") is not None:
                cfg_kwargs["fuse_buckets"] = tuple(cfg_kwargs["fuse_buckets"])
            cfg_kwargs.update(overrides)
            if alert_engine is not None:
                cfg_kwargs["alert_engine"] = alert_engine
            config = PipelineConfig(**cfg_kwargs)
        else:
            if config.tenant is None and tenant is not None:
                overrides = {"tenant": tenant, **overrides}
            if alert_engine is not None:
                overrides = {**overrides, "alert_engine": alert_engine}
            if overrides:
                config = replace(config, **overrides)

        pipe = MetricPipeline(metric, config)
        pipe._restore_report(manifest.get("report") or {})
        pipe._restore_flight(manifest.get("flight") or {})
        # fresh_epoch=True is the FAILOVER restore: the session continues the
        # origin's id sequence but under a brand-new epoch — the new fencing
        # token — so the fenced origin's late writes stay distinguishable
        # from (and rejectable against) everything this session produces. The
        # lease is re-minted either way: a schema-2 (pre-lease) bundle simply
        # gets its first lease here.
        pipe._restore_lineage(manifest.get("cursor") or {}, fresh_epoch=fresh_epoch)

        engine = config.alert_engine
        if engine is None:
            import torchmetrics_tpu_torch.obs.alerts as _alerts

            engine = _alerts.get_engine()
        if engine is not None and manifest.get("alerts"):
            engine.restore_state(manifest["alerts"])
        log = _resolve_value_log(value_log, engine)
        log.restore_series(manifest.get("values") or [])

        row = manifest.get("registry")
        if restore_registry and row and pipe._tenant is not None:
            _scope.get_registry().restore_row(
                pipe._tenant,
                updates=row.get("updates", 0),
                computes=row.get("computes", 0),
                first_seen_unix=row.get("first_seen_unix"),
            )

        if replay:
            arrays: Dict[str, np.ndarray] = {}
            tail_path = os.path.join(path, _TAIL_NAME)
            if os.path.isfile(tail_path):
                with np.load(tail_path) as payload:
                    arrays = {key: payload[key] for key in payload.files}
            device = torch.device(config.device) if config.device is not None else _target_device(metric)
            batches = _deserialize_tail(manifest.get("tail") or [], arrays, device)
            pipe.replay_tail(batches)
        if _trace.ENABLED:
            _trace.event(
                "engine.session_restore",
                pipeline=type(metric).__name__,
                tenant=tenant,
                batches=(manifest.get("cursor") or {}).get("batches_ingested", 0),
                tail=(manifest.get("cursor") or {}).get("tail_batches", 0),
                path=path,
            )
        return pipe, manifest
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


# ------------------------------------------------------------------------ CLI


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m torchmetrics_tpu_torch.engine.migrate`` — the operator CLI.

    Mirrors the ``obs.regress`` CLI conventions: one-line verdicts on stdout,
    diagnostics on stderr, exit 0 = intact, 1 = corrupt, 2 = cannot run.
    """
    parser = argparse.ArgumentParser(
        prog="python -m torchmetrics_tpu_torch.engine.migrate",
        description=(
            "Operate on live-session bundles. `verify <bundle>` walks and verifies"
            " the bundle's whole delta chain (per-link file-tree digest, schema,"
            " base-id linkage, entry resolvability). Exit codes: 0 = intact,"
            " 1 = corrupt, 2 = cannot run."
        ),
    )
    sub = parser.add_subparsers(dest="command")
    verify_parser = sub.add_parser(
        "verify", help="chain-aware verification of one session bundle"
    )
    verify_parser.add_argument("bundle", help="path of the bundle directory")
    verify_parser.add_argument(
        "--quiet", action="store_true", help="suppress the summary line on success"
    )
    args = parser.parse_args(argv)
    if args.command != "verify":
        parser.print_usage(sys.stderr)
        return 2
    path = os.path.abspath(args.bundle)
    if not os.path.isdir(path):
        sys.stderr.write(f"cannot run: no directory at {path}\n")
        return 2
    try:
        manifest = verify_bundle(path)
        chain = _chain_manifests(path, manifest) if manifest.get("base") else [(path, manifest)]
    except SessionBundleError as err:
        sys.stderr.write(f"CORRUPT: {err}\n")
        return 1
    except Exception as err:  # unexpected environment failure, not a verdict
        sys.stderr.write(f"cannot run: {type(err).__name__}: {err}\n")
        return 2
    if not args.quiet:
        entries = manifest.get("entries") or {}
        written = manifest.get("written") or []
        print(
            f"OK: {path} — {'delta' if manifest.get('base') else 'full'} bundle,"
            f" chain depth {len(chain)}, tenant {manifest.get('tenant')!r},"
            f" {len(written)}/{len(entries)} entries written locally,"
            f" {(manifest.get('cursor') or {}).get('batches_ingested', 0)} batches"
            " folded"
        )
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess tests
    sys.exit(main())
