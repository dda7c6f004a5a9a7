"""Continuous host-path sampling profiler: the Python-floor attribution plane.

Counterpart of ``torchmetrics_tpu/obs/hostprof.py``, with the same seam vocabulary
and classification rules, but one: the **C boundary** (``dispatch-wait``). Spans
time whole *stages*, not the Python underneath them. This module is the instrument that says **which
seam** burns the microseconds: a daemon thread walks ``sys._current_frames()``
at a configurable rate (default ~200 Hz), folds every stack into a bounded
collapsed-stack table, and classifies each sample against the known runtime
seams by joining (a) the frame filenames/function names and (b) the ambient
span context registered cross-thread by :mod:`obs.trace` plus the ambient
tenant registered by :mod:`obs.scope`.

Seams (the fixed vocabulary — every consumer renders these):

- ``ingest``         — pipeline/mux ``feed`` path host work
- ``admission``      — tenant admission/quota checks (``obs/scope.py``)
- ``lineage``        — trace-id minting/stamping (``obs/lineage.py``)
- ``stack-unstack``  — host-side row stacking / pytree flatten-unflatten
- ``device_put``     — host→device transfer staging
- ``dispatch-wait``  — at the torch/CUDA C boundary. A torch op is a C function
  with no Python frame, so the sampled frame is the caller that entered native
  code: an innermost ``/torch/`` frame, a CUDA graph replay in ``core/jit.py``,
  a kernel launch through ctypes in ``ops/kernels.py``, the host readback of a
  captured buffer count (``core/metric.py``), or a function named
  ``synchronize``/``item``/``cpu``. (JAX takes an innermost ``/jax/`` or
  ``/jaxlib/`` frame, or a ``block_until_ready`` caller.)
- ``commit``         — folding new state back into the metric
- ``scrape``         — obs-server request serving

Samples that belong to no runtime seam land in counted *excluded* buckets
instead of polluting the attribution: ``serving`` (obs-server scrape threads —
never billed to a tenant seam unless a report explicitly opts in with
``include_serving``), ``idle`` (threads parked in ``threading``/``queue``
waits), and ``driver`` (the chaos replay / bench load generator). The
sampler's own thread is skipped entirely — its cost is measured directly and
exported as the self-overhead gauge instead of being sampled.

Everything is bounded (stack table, per-tenant/per-owner tables, the Perfetto
timeline ring) with drop counters; the disabled path is one ``None`` check at
every integration point (`get_profiler()`); pure stdlib — importing this
module never imports torch. The sampler thread reads frames only: it never
touches a tensor, so it cannot act inside a CUDA graph capture.

The **floor report** is the quantified "Python floor" the ROADMAP zero-copy
item will shrink: sampled host seconds per seam / tenant / metric, diffed
against the cost ledger's measured dispatch seconds and estimated flops. See
PERF.md ("Host-floor attribution methodology") for what it does and does not
claim.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as trace

__all__ = [
    "EXCLUDED_BUCKETS",
    "HostProfiler",
    "SEAMS",
    "get_profiler",
    "install",
    "sampling",
]

# the fixed seam vocabulary (order is render order in reports)
SEAMS = (
    "ingest",
    "admission",
    "lineage",
    "stack-unstack",
    "device_put",
    "dispatch-wait",
    "commit",
    "scrape",
)

# counted non-seam buckets: excluded from attribution and never tenant-billed
EXCLUDED_BUCKETS = ("serving", "idle", "driver")

# the "Python floor" side of the floor report: seams whose samples are host
# Python work our runtime could in principle shrink (dispatch-wait is the
# device-side denominator; scrape is serving, not runtime)
PYTHON_FLOOR_SEAMS = (
    "ingest",
    "admission",
    "lineage",
    "stack-unstack",
    "device_put",
    "commit",
)

# file suffixes identifying the obs-server serving path: request threads off
# ThreadingHTTPServer carry generic names ("Thread-N"), so serving is detected
# by stack CONTENT, not thread name — any of these frames means the sample is
# scrape serving and must never reach a tenant seam (see satellite bugfix)
_SERVING_FILES = ("socketserver.py", "http/server.py", "obs/server.py")

# innermost frames identifying a parked (not busy) thread
_IDLE_FILES = ("threading.py", "queue.py", "selectors.py")
_IDLE_FUNCS = ("wait", "_wait_for_tstate_lock", "join", "get", "select", "poll")

# the load generator, not the runtime under measurement
_DRIVER_FILES = ("chaos/replay.py", "chaos/schedule.py", "bench.py")

_ENGINE_FILES = ("engine/pipeline.py", "engine/mux.py")

# the port's C boundary (rule 3 of `classify`): the Python frames that stand where a
# torch op or a CUDA call entered native code, which leaves no frame of its own
_BOUNDARY_FRAMES = (
    ("core/jit.py", "replay"),  # a CUDA graph replay
    ("ops/kernels.py", "_launch"),  # a hand-written kernel's ctypes launch
    ("core/metric.py", "_host_buffers"),  # a captured buffer count read back
)
_BOUNDARY_FUNCS = ("synchronize", "item", "cpu")

# innermost-span-name → seam fallback, applied when no frame rule fired (the
# sample sits in code the fine rules don't know, but a live engine.* span says
# which stage owns the wall time)
_SPAN_SEAMS = (
    ("engine.ingest", "ingest"),
    ("engine.dispatch", "dispatch-wait"),
    ("engine.mux", "ingest"),
    ("metric.", "dispatch-wait"),
    ("server.", "scrape"),
)


def _norm(filename: str) -> str:
    return filename.replace("\\", "/")


def _extract(frame: Any, max_depth: int) -> List[Tuple[str, str]]:
    """Innermost-first ``(filename, funcname)`` pairs from a live frame.

    Tests may pass a pre-extracted list instead of a frame object — the
    classifier battery runs on synthetic stacks, no live threads needed.
    """
    if isinstance(frame, list):
        return frame[:max_depth]
    out: List[Tuple[str, str]] = []
    f = frame
    while f is not None and len(out) < max_depth:
        code = f.f_code
        out.append((code.co_filename, code.co_name))
        f = f.f_back
    return out


def classify(
    frames: List[Tuple[str, str]], spans: Optional[List[str]] = None
) -> str:
    """One sample's stack → a seam name or an excluded bucket name.

    ``frames`` is innermost-first; ``spans`` is the thread's live span-name
    stack (innermost last), used as a fallback when no frame rule matches.
    Rules run in priority order over the WHOLE stack (not frame-by-frame):
    serving detection first — a scrape handler refreshing tenant gauges
    touches ``obs/scope.py`` frames, and those must land in ``serving``, not
    ``admission`` — then the fine runtime seams, then the torch C-boundary
    check, then the span-context fallback, then idle/driver exclusion.
    """
    norm = [(_norm(fn), func) for fn, func in frames]
    # 1. serving: any obs-server/socketserver frame anywhere in the stack
    for fn, _func in norm:
        if fn.endswith(_SERVING_FILES):
            return "serving"
    has_engine = any(fn.endswith(_ENGINE_FILES) for fn, _ in norm)
    # 2. fine runtime seams, whole-stack scan per rule (priority order): the
    # innermost frames of a host-side stack are often pytree utilities,
    # so rule priority — not frame order — decides
    for _fn, func in norm:
        if "device_put" in func:
            return "device_put"
    for fn, func in norm:
        if fn.endswith(_ENGINE_FILES) and ("stack" in func or "unstack" in func):
            return "stack-unstack"
        if has_engine and func in ("tree_flatten", "tree_unflatten", "tree_map", "partition_static_leaves"):
            return "stack-unstack"
    for fn, func in norm:
        if fn.endswith("obs/scope.py") and (
            "admit" in func or func in ("charge", "would_admit")
        ):
            return "admission"
    for fn, _func in norm:
        if fn.endswith("obs/lineage.py"):
            return "lineage"
    for _fn, func in norm:
        if "commit" in func:
            return "commit"
    # remaining engine-file samples: dispatch machinery bills to the dispatch
    # seam (the span fallback does the same for engine.dispatch), everything
    # else on the feed path is ingest
    for fn, func in norm:
        if fn.endswith(_ENGINE_FILES):
            if "dispatch" in func or "flush" in func or "drain" in func or "replay" in func:
                return "dispatch-wait"
            return "ingest"
    # 3. the C boundary: an innermost torch frame, or a frame of the port's own
    # native call sites, means the thread is executing (or waiting on) native
    # code entered from that call site
    if norm and "/torch/" in norm[0][0]:
        return "dispatch-wait"
    for fn, func in norm:
        if func in _BOUNDARY_FUNCS or any(fn.endswith(f) and func == g for f, g in _BOUNDARY_FRAMES):
            return "dispatch-wait"
    # 4. span-context fallback: the ambient engine.*/metric.* span names the
    # stage even when the frames are unrecognized helper code
    if spans:
        innermost = spans[-1]
        for prefix, seam in _SPAN_SEAMS:
            if innermost.startswith(prefix):
                return seam
    # 5. parked threads are excluded, not "other": wall time blocked in a
    # lock/queue wait is not host CPU the floor report should count
    if norm and norm[0][0].endswith(_IDLE_FILES) and norm[0][1] in _IDLE_FUNCS:
        return "idle"
    # 6. the load generator (chaos replay / bench driver loop, including its
    # pacing sleeps — time.sleep is C, so the sampled frame IS the driver)
    for fn, _func in norm:
        if fn.endswith(_DRIVER_FILES):
            return "driver"
    return "other"


def _fold(frames: List[Tuple[str, str]]) -> str:
    """Collapsed-stack key: outermost-first ``mod:func`` joined with ``;``
    (the flamegraph.pl input format)."""
    parts = []
    for fn, func in reversed(frames):
        mod = _norm(fn).rsplit("/", 1)[-1]
        if mod.endswith(".py"):
            mod = mod[:-3]
        parts.append(f"{mod}:{func}")
    return ";".join(parts)


class HostProfiler:
    """Always-on-capable sampling profiler over ``sys._current_frames()``.

    One daemon thread, bounded state, injectable clock. ``sample_once`` is
    the testable unit: pass synthetic ``frames``/``tenants``/``spans`` dicts
    and the classifier, tables and timeline behave exactly as live.
    """

    def __init__(
        self,
        rate_hz: float = 200.0,
        max_stacks: int = 2048,
        max_depth: int = 64,
        max_cells: int = 8192,
        timeline_cap: int = 240,
        timeline_resolution: float = 0.25,
        recorder: Optional[trace.TraceRecorder] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if rate_hz <= 0:
            raise ValueError(f"Expected `rate_hz` to be positive, got {rate_hz}")
        self.rate_hz = float(rate_hz)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self.max_cells = int(max_cells)
        self.timeline_resolution = float(timeline_resolution)
        self._recorder = recorder
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # attribution tables (all bounded by max_cells / max_stacks)
        self._seam_totals: Dict[str, int] = {}
        self._seam_tenant: Dict[Tuple[str, str], int] = {}
        self._seam_owner: Dict[Tuple[str, str, Optional[str]], int] = {}
        self._stacks: Dict[str, int] = {}
        self._samples = 0
        self._serving_samples = 0
        self._dropped_stacks = 0
        self._dropped_cells = 0
        self._sample_errors = 0
        # self-overhead accounting: sampler busy seconds vs wall elapsed
        self._busy_seconds = 0.0
        self._elapsed_seconds = 0.0
        self._started_at: Optional[float] = None
        # bounded per-seam sample timeline for the Perfetto counter tracks
        self._timeline: deque = deque(maxlen=int(timeline_cap))
        self._bucket: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ lifecycle

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "HostProfiler":
        """Start the daemon sampler thread (idempotent while running)."""
        if self.running:
            return self
        self._stop.clear()
        self._started_at = self._clock()
        # thread→tenant tracking in obs/scope costs one branch when off; the
        # sampler flips it on only while live so per-feed session entry stays
        # free for unprofiled runs
        _scope.track_thread_tenants(True)
        self._thread = threading.Thread(
            target=self._run, name="tm-tpu-hostprof", daemon=True
        )
        self._thread.start()
        if trace.ENABLED:
            trace.event("hostprof.start", rate_hz=self.rate_hz)
        return self

    def stop(self) -> None:
        """Stop sampling; accumulated tables stay readable."""
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=5.0)
        self._thread = None
        _scope.track_thread_tenants(False)
        if self._started_at is not None:
            self._elapsed_seconds += self._clock() - self._started_at
            self._started_at = None
        if trace.ENABLED:
            trace.event("hostprof.stop", samples=self._samples)

    def _run(self) -> None:
        period = 1.0 / self.rate_hz
        next_tick = self._clock()
        while not self._stop.is_set():
            t0 = self._clock()
            try:
                self.sample_once()
            except Exception:
                with self._lock:
                    self._sample_errors += 1
            t1 = self._clock()
            with self._lock:
                self._busy_seconds += t1 - t0
            next_tick += period
            delay = next_tick - self._clock()
            if delay > 0:
                self._stop.wait(delay)
            else:
                # fell behind (a long stack walk or a descheduled host):
                # re-anchor instead of spinning to catch up
                next_tick = self._clock()

    # ------------------------------------------------------------------- sampling

    def sample_once(
        self,
        frames: Optional[Dict[int, Any]] = None,
        tenants: Optional[Dict[int, str]] = None,
        spans: Optional[Dict[int, List[Tuple[str, Dict[str, Any]]]]] = None,
        now: Optional[float] = None,
    ) -> None:
        """Walk every thread's stack once and fold the classified samples.

        All inputs are injectable for tests: ``frames`` maps thread id →
        frame (or a pre-extracted innermost-first ``(file, func)`` list),
        ``tenants`` maps thread id → ambient tenant, ``spans`` maps thread
        id → live span stack ``[(name, attrs)]`` innermost last.
        """
        own = threading.get_ident()
        if frames is None:
            frames = sys._current_frames()
        if tenants is None:
            tenants = _scope.thread_tenants()
        if spans is None:
            rec = self._recorder if self._recorder is not None else trace.get_recorder()
            spans = rec.thread_spans()
        if now is None:
            now = self._clock()
        counted: Dict[str, int] = {}
        folded: List[Tuple[str, str, Optional[str], Optional[str]]] = []
        for tid, frame in frames.items():
            if tid == own:
                # never sample the sampler: its cost is measured directly and
                # exported as hostprof.self_overhead_percent instead
                continue
            stack = _extract(frame, self.max_depth)
            if not stack:
                continue
            span_stack = spans.get(tid) or []
            span_names = [name for name, _attrs in span_stack]
            seam = classify(stack, span_names)
            counted[seam] = counted.get(seam, 0) + 1
            owner = None
            for name, attrs in reversed(span_stack):
                try:
                    owner = attrs.get("pipeline") or attrs.get("mux") or attrs.get("metric")
                except Exception:  # racy read of a mutating attr dict
                    owner = None
                if owner:
                    break
            path = None
            for fn, _func in stack:
                fn = _norm(fn)
                if fn.endswith("engine/mux.py"):
                    path = "mux"
                    break
                if fn.endswith("engine/pipeline.py"):
                    path = "pipeline"
            folded.append((_fold(stack), seam, tenants.get(tid), (owner, path)))
        with self._lock:
            for seam, n in counted.items():
                if seam == "serving":
                    self._serving_samples += n
                else:
                    self._samples += n
                self._seam_totals[seam] = self._seam_totals.get(seam, 0) + n
            for key, seam, tenant, (owner, path) in folded:
                if seam not in EXCLUDED_BUCKETS and tenant is not None:
                    self._cell(self._seam_tenant, (seam, tenant))
                if seam not in EXCLUDED_BUCKETS and (owner or path):
                    self._cell(self._seam_owner, (seam, owner or "?", path))
                if key in self._stacks:
                    self._stacks[key] += 1
                elif len(self._stacks) < self.max_stacks:
                    self._stacks[key] = 1
                else:
                    self._dropped_stacks += 1
            self._tick_timeline(counted, now)

    def _cell(self, table: Dict, key: Tuple) -> None:
        # caller holds the lock; bounded like the recorder's series cap
        if key in table:
            table[key] += 1
        elif len(table) < self.max_cells:
            table[key] = 1
        else:
            self._dropped_cells += 1

    def _tick_timeline(self, counted: Dict[str, int], now: float) -> None:
        # caller holds the lock. Buckets rotate on the injectable clock but
        # are STAMPED with wall time, so Perfetto can align the seam tracks
        # with span timestamps via the recorder's wall anchor
        bucket = self._bucket
        if bucket is None or now - bucket["t0"] >= self.timeline_resolution:
            bucket = self._bucket = {"t0": now, "wall": time.time(), "seams": {}}
            self._timeline.append(bucket)
        seams = bucket["seams"]
        for seam, n in counted.items():
            seams[seam] = seams.get(seam, 0) + n

    # -------------------------------------------------------------------- reports

    @property
    def period_seconds(self) -> float:
        return 1.0 / self.rate_hz

    def duration_seconds(self) -> float:
        elapsed = self._elapsed_seconds
        if self._started_at is not None:
            elapsed += self._clock() - self._started_at
        return elapsed

    def self_overhead_percent(self) -> float:
        elapsed = self.duration_seconds()
        if elapsed <= 0:
            return 0.0
        return 100.0 * self._busy_seconds / elapsed

    def breakdown(
        self, tenant: Optional[str] = None, include_serving: bool = False
    ) -> Dict[str, Dict[str, float]]:
        """Per-seam ``{samples, seconds, percent}`` over attributable samples.

        ``tenant`` narrows to one tenant's samples (excluded buckets carry no
        tenant by design — the satellite bugfix — so a tenant view never
        shows serving/idle/driver rows). ``include_serving`` folds the
        serving bucket back in as the ``scrape`` seam for whole-host views.
        """
        period = self.period_seconds
        with self._lock:
            if tenant is not None:
                counts: Dict[str, int] = {}
                for (seam, row_tenant), n in self._seam_tenant.items():
                    if row_tenant == tenant:
                        counts[seam] = counts.get(seam, 0) + n
            else:
                counts = {
                    seam: n
                    for seam, n in self._seam_totals.items()
                    if seam not in EXCLUDED_BUCKETS
                }
                if include_serving and self._seam_totals.get("serving"):
                    counts["scrape"] = counts.get("scrape", 0) + self._seam_totals["serving"]
        total = sum(counts.values())
        out: Dict[str, Dict[str, float]] = {}
        for seam in (*SEAMS, "other"):
            n = counts.get(seam, 0)
            if not n:
                continue
            out[seam] = {
                "samples": n,
                "seconds": round(n * period, 6),
                "percent": round(100.0 * n / total, 3) if total else 0.0,
            }
        return out

    def attributed_percent(self) -> float:
        """Share of attributable host samples that landed in a NAMED seam."""
        with self._lock:
            named = sum(
                n for seam, n in self._seam_totals.items() if seam in SEAMS
            )
            other = self._seam_totals.get("other", 0)
        total = named + other
        return 100.0 * named / total if total else 0.0

    def tenant_breakdown(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant per-seam sampled seconds."""
        period = self.period_seconds
        with self._lock:
            rows = list(self._seam_tenant.items())
        out: Dict[str, Dict[str, float]] = {}
        for (seam, tenant), n in rows:
            out.setdefault(tenant, {})[seam] = round(n * period, 6)
        return out

    def floor_report(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """The Python-floor report: sampled host seconds vs the cost ledger.

        ``python_floor_seconds`` sums the host-Python seams; the denominator
        pairs it with ``dispatch_wait_seconds`` (samples at the torch/CUDA C
        boundary). ``per_metric`` joins the sampled per-owner split with the
        ledger's measured dispatch-span seconds and estimated flops;
        ``paths`` gives the same host-vs-device split for the mux vs per-tenant
        pipeline dispatch paths. Sampling cannot distinguish interpreting
        Python from being blocked inside a C call — see PERF.md for the
        methodology and error bounds this report does (not) claim.
        """
        period = self.period_seconds
        breakdown = self.breakdown(tenant=tenant)
        floor = sum(
            row["seconds"] for seam, row in breakdown.items() if seam in PYTHON_FLOOR_SEAMS
        )
        wait = breakdown.get("dispatch-wait", {}).get("seconds", 0.0)
        report: Dict[str, Any] = {
            "python_floor_seconds": round(floor, 6),
            "dispatch_wait_seconds": round(wait, 6),
            "python_floor_fraction": round(floor / (floor + wait), 4)
            if (floor + wait) > 0
            else None,
            "seams": breakdown,
        }
        # per-path host-vs-device split (the mux-path number the high-tenant
        # chaos run record carries)
        with self._lock:
            owner_rows = list(self._seam_owner.items())
        paths: Dict[str, Dict[str, float]] = {}
        owners: Dict[str, Dict[str, float]] = {}
        for (seam, owner, path), n in owner_rows:
            seconds = n * period
            if path is not None:
                row = paths.setdefault(
                    path, {"host_python_seconds": 0.0, "dispatch_wait_seconds": 0.0}
                )
                if seam in PYTHON_FLOOR_SEAMS:
                    row["host_python_seconds"] += seconds
                elif seam == "dispatch-wait":
                    row["dispatch_wait_seconds"] += seconds
            if owner and owner != "?":
                orow = owners.setdefault(
                    owner, {"host_python_seconds": 0.0, "dispatch_wait_seconds": 0.0}
                )
                if seam in PYTHON_FLOOR_SEAMS:
                    orow["host_python_seconds"] += seconds
                elif seam == "dispatch-wait":
                    orow["dispatch_wait_seconds"] += seconds
        for row in paths.values():
            host, dwait = row["host_python_seconds"], row["dispatch_wait_seconds"]
            row["host_python_seconds"] = round(host, 6)
            row["dispatch_wait_seconds"] = round(dwait, 6)
            row["python_floor_fraction"] = (
                round(host / (host + dwait), 4) if (host + dwait) > 0 else None
            )
        report["paths"] = paths
        # join the ledger: measured span seconds + estimated flops per metric
        # class sit next to the sampled per-owner split. Guarded — the ledger
        # pulls in torch lazily and a pure-stdlib consumer must still get the
        # sampled half of the report
        try:
            from torchmetrics_tpu_torch.obs import cost as _cost

            rec = self._recorder if self._recorder is not None else trace.get_recorder()
            measured = _cost._measured_seconds_by_metric(rec)
            by_metric = _cost.get_ledger().by_metric()
        except Exception:
            measured, by_metric = {}, {}
        per_metric: Dict[str, Dict[str, Any]] = {}
        for name in set(owners) | set(measured) | set(by_metric):
            entry: Dict[str, Any] = {}
            if name in owners:
                entry["sampled_host_seconds"] = round(
                    owners[name]["host_python_seconds"], 6
                )
                entry["sampled_dispatch_wait_seconds"] = round(
                    owners[name]["dispatch_wait_seconds"], 6
                )
            if name in measured:
                entry["measured_span_seconds"] = round(measured[name], 6)
            if name in by_metric:
                entry["estimated_flops"] = by_metric[name].get("estimated_flops")
                entry["dispatches"] = by_metric[name].get("dispatches")
            per_metric[name] = entry
        report["per_metric"] = per_metric
        if tenant is None:
            report["per_tenant"] = self.tenant_breakdown()
        return report

    def collapsed(self, top: Optional[int] = None) -> str:
        """The collapsed-stack table as flamegraph.pl input text
        (``frame;frame;frame count`` per line, heaviest first)."""
        with self._lock:
            rows = sorted(self._stacks.items(), key=lambda kv: (-kv[1], kv[0]))
        if top is not None:
            rows = rows[:top]
        return "\n".join(f"{stack} {count}" for stack, count in rows) + (
            "\n" if rows else ""
        )

    def write_collapsed(self, path: str, top: Optional[int] = None) -> str:
        """Atomically write the collapsed-stack flamegraph file; returns path."""
        from torchmetrics_tpu_torch.utils.fileio import atomic_write_text

        atomic_write_text(path, self.collapsed(top=top))
        return path

    def timeline(self) -> List[Dict[str, Any]]:
        """The bounded per-seam sample timeline (oldest first), wall-stamped
        so Perfetto can align the counter tracks with span timestamps."""
        with self._lock:
            return [
                {"wall": bucket["wall"], "seams": dict(bucket["seams"])}
                for bucket in self._timeline
            ]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "samples": self._samples,
                "samples_serving": self._serving_samples,
                "dropped_stacks": self._dropped_stacks,
                "dropped_cells": self._dropped_cells,
                "sample_errors": self._sample_errors,
                "distinct_stacks": len(self._stacks),
            }

    def record_gauges(self, recorder: Optional[trace.TraceRecorder] = None) -> None:
        """Refresh the ``hostprof.*`` gauge families on the recorder (the
        per-scrape hook ``obs/server.render_metrics`` calls)."""
        rec = recorder
        if rec is None:
            rec = self._recorder if self._recorder is not None else trace.get_recorder()
        stats = self.stats()
        rec.set_gauge("hostprof.samples", float(stats["samples"]))
        rec.set_gauge("hostprof.samples_serving", float(stats["samples_serving"]))
        rec.set_gauge("hostprof.dropped_stacks", float(stats["dropped_stacks"]))
        rec.set_gauge("hostprof.sample_errors", float(stats["sample_errors"]))
        rec.set_gauge("hostprof.rate_hz", self.rate_hz)
        rec.set_gauge(
            "hostprof.self_overhead_percent", round(self.self_overhead_percent(), 4)
        )
        rec.set_gauge(
            "hostprof.attributed_percent", round(self.attributed_percent(), 4)
        )
        for seam, row in self.breakdown().items():
            rec.set_gauge("hostprof.seam_seconds", row["seconds"], seam=seam)

    def report(
        self,
        tenant: Optional[str] = None,
        top: int = 20,
        include_serving: bool = False,
    ) -> Dict[str, Any]:
        """The ``GET /profile`` payload: live breakdown + floor report."""
        stats = self.stats()
        payload: Dict[str, Any] = {
            "enabled": True,
            "running": self.running,
            "rate_hz": self.rate_hz,
            "period_seconds": self.period_seconds,
            "duration_seconds": round(self.duration_seconds(), 6),
            "self_overhead_percent": round(self.self_overhead_percent(), 4),
            "attributed_percent": round(self.attributed_percent(), 4),
            **stats,
            "breakdown": self.breakdown(tenant=tenant, include_serving=include_serving),
            "floor": self.floor_report(tenant=tenant),
        }
        if tenant is not None:
            payload["tenant"] = tenant
        else:
            payload["tenants"] = self.tenant_breakdown()
        with self._lock:
            rows = sorted(self._stacks.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
        payload["top_stacks"] = [
            {"stack": stack, "samples": count} for stack, count in rows
        ]
        return payload


# ------------------------------------------------------------- module singleton

_PROFILER: Optional[HostProfiler] = None


def install(profiler: Optional[HostProfiler]) -> Optional[HostProfiler]:
    """Install the process-wide profiler (``None`` uninstalls); returns the
    previously installed one so callers can restore it."""
    global _PROFILER
    previous = _PROFILER
    _PROFILER = profiler
    return previous


def get_profiler() -> Optional[HostProfiler]:
    """The installed profiler, or ``None`` — THE one-branch disabled check
    every integration point (server, perfetto, engine, chaos) guards on."""
    return _PROFILER


@contextmanager
def sampling(**kwargs: Any) -> Iterator[HostProfiler]:
    """Scoped capture: install + start a profiler, stop + restore on exit.

    The accumulated tables stay readable on the yielded object after exit.
    """
    profiler = HostProfiler(**kwargs)
    previous = install(profiler)
    profiler.start()
    try:
        yield profiler
    finally:
        profiler.stop()
        install(previous)
