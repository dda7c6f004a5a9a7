"""Cost ledger: per-variant counted cost and capture attribution for the capture cache.

Counterpart of ``torchmetrics_tpu/obs/cost.py``, plain Python as there: ``compiled``
objects are duck-typed, so importing this module never imports torch. The JAX
package records XLA's ``Compiled.cost_analysis()`` and ``memory_analysis()`` at every
AOT compile. A CUDA graph has no cost analysis, so the port's capture cache
(:class:`~torchmetrics_tpu_torch.core.jit.StaticLeafJit`) counts its own and hands the
ledger an object with the same two methods:

- ``flops`` and ``bytes accessed`` come from the warm run a variant makes before its
  capture (on the CPU: its first run), counted under a ``TorchDispatchMode``. Bytes
  are each aten op's tensor inputs and outputs, XLA's per-op definition, counted
  before any fusion, so the number is an upper bound of XLA's; flops follow
  ``torch.utils.flop_counter`` for matrix products and convolutions and count one per
  output element for every other op. The hand-written kernels launch through ctypes,
  where no dispatch mode sees them: each wrapper in ``ops/kernels.py`` adds its
  kernel's analytic count and hides its own ops, so an estimate is the same on the
  CPU and on the card.
- the memory analysis: argument bytes are the graph's static inputs, output bytes its
  outputs, temp bytes the growth of the capture pool across the capture, generated
  code 0.

The ledger keeps one bounded, process-wide row per variant (wrapped function, static
configuration, input signature) with those numbers, the wall-clock **capture
seconds** (0.0 on the CPU route, where nothing is captured) and a per-variant
**dispatch count** incremented at every run, which turns the static numbers into
per-metric per-step estimated cost. A counted object missing a field warns ONCE and
the field stays ``None``.

Egress: :func:`record_gauges` writes ``cost.*`` gauges into the
:class:`~torchmetrics_tpu_torch.obs.trace.TraceRecorder`; ``python -m
torchmetrics_tpu_torch.obs.cost`` prints the ledger as a table (exit 0 = printed,
2 = usage or load error). The admission plane (``obs/scope.py``) and the tenant
multiplexer (``engine/mux.py``) price tenants by :meth:`CostLedger.fn_estimate` and
:meth:`CostLedger.since`. The JAX module's ``GET /costs`` route comes with the obs
server.

Counting is **capture-time only**: the hot dispatch path pays one flag check and one
per-variant integer increment; :func:`disable` removes even that.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as trace

__all__ = [
    "ENABLED",
    "CostEntry",
    "CostLedger",
    "disable",
    "enable",
    "format_count",
    "get_ledger",
    "is_enabled",
    "main",
    "record_gauges",
    "report",
    "summary",
]

# Capture flag, checked by the jit layer before touching the ledger. ON by
# default: recording happens at compile time (milliseconds-to-seconds events),
# so keeping the ledger is effectively free — the only hot-path cost is the
# per-variant dispatch increment, and `disable()` removes that too.
ENABLED = True

# report()/CLI sort keys -> CostEntry attribute ranked by (descending)
SORT_KEYS = {
    "flops": "flops",
    "bytes": "bytes_accessed",
    "compile_seconds": "compile_seconds",
    "dispatches": "dispatches",
    "peak_bytes": "peak_bytes",
    "total_flops": "total_flops",
    "total_bytes": "total_bytes",
}

_MEMORY_FIELDS = (
    ("argument_size_in_bytes", "argument_bytes"),
    ("output_size_in_bytes", "output_bytes"),
    ("temp_size_in_bytes", "temp_bytes"),
    ("generated_code_size_in_bytes", "generated_code_bytes"),
)


def is_enabled() -> bool:
    return ENABLED


def enable() -> None:
    """Turn compile-cost capture (and per-variant dispatch counting) on."""
    global ENABLED
    ENABLED = True


def disable() -> None:
    """Turn capture off: later compiles/dispatches leave no trace in the ledger."""
    global ENABLED
    ENABLED = False


def _current_backend() -> Optional[str]:
    """The device kind a variant ran on when its counted object names none: ``cuda``
    once CUDA is initialized in this process, else ``cpu``; ``None`` where torch was
    never imported (the ledger stays importable and callable without it)."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return None
    try:
        if torch_mod.cuda.is_initialized():
            return "cuda"
    except Exception:  # a torch built without CUDA
        pass
    return "cpu"


def _cost_analysis(compiled: Any) -> Tuple[Optional[float], Optional[float]]:
    """(flops, bytes_accessed) from ``compiled.cost_analysis()``; Nones when absent.

    A dict or a one-element list of dicts (the two shapes JAX has returned) is
    accepted. Negative placeholder values (-1 for "unknown") degrade to ``None``.
    """
    fn = getattr(compiled, "cost_analysis", None)
    if fn is None:
        return None, None
    try:
        analysis = fn()
    except Exception:
        return None, None
    if isinstance(analysis, (list, tuple)):
        analysis = analysis[0] if analysis else None
    if not isinstance(analysis, dict):
        return None, None

    def _field(key: str) -> Optional[float]:
        value = analysis.get(key)
        if isinstance(value, (int, float)) and not isinstance(value, bool) and value >= 0:
            return float(value)
        return None

    return _field("flops"), _field("bytes accessed")


def _memory_analysis(compiled: Any) -> Dict[str, float]:
    """Buffer sizes from ``compiled.memory_analysis()``; empty dict when absent."""
    fn = getattr(compiled, "memory_analysis", None)
    if fn is None:
        return {}
    try:
        stats = fn()
    except Exception:
        return {}
    if stats is None:
        return {}
    out: Dict[str, float] = {}
    for attr, name in _MEMORY_FIELDS:
        value = getattr(stats, attr, None)
        if value is None and isinstance(stats, dict):
            value = stats.get(attr)
        if isinstance(value, (int, float)) and not isinstance(value, bool) and value >= 0:
            out[name] = float(value)
    return out


class CostEntry:
    """One captured (or, on the CPU route, counted) variant's ledger row.
    ``dispatches`` is mutated by the capture cache on every run (a benign unlocked
    int increment)."""

    __slots__ = (
        "seq",
        "fn",
        "inst",
        "metric",
        "tenant",
        "static_key",
        "input_signature",
        "source",
        "backend",
        "compile_seconds",
        "flops",
        "bytes_accessed",
        "argument_bytes",
        "output_bytes",
        "temp_bytes",
        "generated_code_bytes",
        "peak_bytes",
        "dispatches",
        "created_unix",
    )

    def __init__(self, **fields: Any) -> None:
        for name in self.__slots__:
            setattr(self, name, fields.get(name))
        if self.dispatches is None:
            self.dispatches = 0

    @property
    def total_flops(self) -> Optional[float]:
        """Dispatch-weighted flops: what running this variant cost so far."""
        return None if self.flops is None else self.flops * self.dispatches

    @property
    def total_bytes(self) -> Optional[float]:
        return None if self.bytes_accessed is None else self.bytes_accessed * self.dispatches

    def asdict(self) -> Dict[str, Any]:
        out = {name: getattr(self, name) for name in self.__slots__}
        out["total_flops"] = self.total_flops
        out["total_bytes"] = self.total_bytes
        return out


class CostLedger:
    """Bounded, thread-safe, process-wide registry of compiled-variant costs."""

    # a long-lived serving process that churns shapes/configs must not grow the
    # ledger without bound: drop-oldest past the cap, counted in `dropped`
    max_entries: int = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # monotonic across clear(): a mark() taken before a clear stays a valid
        # "everything after this point" cursor for since()
        self._next_seq = 0
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._entries: List[CostEntry] = []
            self.dropped = 0
            self._warned_partial = False

    # ------------------------------------------------------------------ recording

    def record(
        self,
        fn: str,
        inst: str,
        static_key: str,
        input_signature: str,
        compiled: Any,
        compile_seconds: float,
        source: str = "dispatch",
    ) -> Optional[CostEntry]:
        """Register one freshly compiled executable; returns its ledger entry.

        ``compiled`` is duck-typed (anything exposing ``cost_analysis`` /
        ``memory_analysis``); both analyses degrade gracefully per backend —
        the first fully/partially missing analysis warns once, later ones skip
        silently (a CPU-fallback host must not spam). The entry is recorded
        either way: compile seconds and the dispatch count are backend-independent.
        """
        if not ENABLED:
            return None
        flops, bytes_accessed = _cost_analysis(compiled)
        memory = _memory_analysis(compiled)
        backend = getattr(compiled, "backend", None) or _current_backend()
        if flops is None or bytes_accessed is None or not memory:
            self._warn_partial_once(backend, flops, bytes_accessed, memory)
        peak = None
        live = [memory.get(k) for k in ("argument_bytes", "output_bytes", "temp_bytes")]
        if any(v is not None for v in live):
            peak = sum(v for v in live if v is not None)
        entry = CostEntry(
            seq=-1,  # assigned under the lock below
            fn=fn,
            inst=inst,
            metric=fn.split(".", 1)[0],
            # tenant attribution (obs/scope.py): the ambient tenant at compile
            # time. Shared compiled variants (shape-bucket reuse) bill their
            # one-off compile cost to whichever tenant triggered it — the
            # honest attribution for a shared-executable serving design.
            tenant=_scope.current_tenant() if _scope.ENABLED else None,
            static_key=static_key,
            input_signature=input_signature,
            source=source,
            backend=backend,
            compile_seconds=float(compile_seconds),
            flops=flops,
            bytes_accessed=bytes_accessed,
            peak_bytes=peak,
            created_unix=time.time(),
            **memory,
        )
        with self._lock:
            entry.seq = self._next_seq
            self._next_seq += 1
            while len(self._entries) >= self.max_entries:
                self._entries.pop(0)
                self.dropped += 1
            self._entries.append(entry)
        if trace.ENABLED:
            trace.event(
                "cost.compile_recorded",
                fn=fn,
                source=source,
                signature=input_signature,
                seconds=round(float(compile_seconds), 6),
                flops=flops,
                bytes_accessed=bytes_accessed,
            )
        return entry

    def _warn_partial_once(
        self,
        backend: Optional[str],
        flops: Optional[float],
        bytes_accessed: Optional[float],
        memory: Dict[str, float],
    ) -> None:
        with self._lock:
            if self._warned_partial:
                return
            self._warned_partial = True
        missing = [
            label
            for label, present in (
                ("flops", flops is not None),
                ("bytes_accessed", bytes_accessed is not None),
                ("memory_analysis", bool(memory)),
            )
            if not present
        ]
        # deferred: utils.prints itself imports obs.trace, so a module-level
        # import here would cycle through the package __init__
        from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

        rank_zero_warn(
            f"The counted cost analysis is partial on backend {backend or 'unknown'!r}:"
            f" {', '.join(missing)} unavailable. The cost ledger still records capture"
            " seconds and dispatch counts, but estimated-cost gauges for the missing"
            " fields stay absent. This is reported once per process.",
            RuntimeWarning,
        )
        if trace.ENABLED:
            trace.event("cost.analysis_partial", backend=str(backend), missing=",".join(missing))

    # ----------------------------------------------------------------- inspection

    def entries(self) -> List[CostEntry]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def mark(self) -> int:
        """Position marker for :meth:`since` (bench per-config deltas)."""
        with self._lock:
            return self._next_seq

    def since(self, mark: int) -> Dict[str, Any]:
        """Summed costs of entries recorded at or after ``mark`` — the bench
        per-config summary: variants compiled, compile seconds, per-compile
        estimated flops/bytes totals."""
        selected = [e for e in self.entries() if isinstance(mark, int) and e.seq >= mark]
        return {
            "variants_compiled": len(selected),
            "compile_seconds": round(sum(e.compile_seconds or 0.0 for e in selected), 6),
            "estimated_flops": sum(e.flops for e in selected if e.flops is not None),
            "estimated_bytes": sum(e.bytes_accessed for e in selected if e.bytes_accessed is not None),
        }

    def forget_since(self, mark: int) -> int:
        """Drop the entries recorded at or after ``mark`` (a run's own variants, once
        :meth:`since` has summed them); returns how many went."""
        with self._lock:
            kept = [e for e in self._entries if e.seq < mark]
            dropped = len(self._entries) - len(kept)
            self._entries = kept
        return dropped

    def totals(self) -> Dict[str, Any]:
        """Whole-ledger rollup (entries, compile seconds, dispatch-weighted cost)."""
        entries = self.entries()
        return {
            "entries": len(entries),
            "dropped": self.dropped,
            "compile_seconds": round(sum(e.compile_seconds or 0.0 for e in entries), 6),
            "estimated_flops": sum(e.total_flops for e in entries if e.total_flops is not None),
            "estimated_bytes": sum(e.total_bytes for e in entries if e.total_bytes is not None),
            "dispatches": sum(e.dispatches for e in entries),
        }

    def by_metric(self) -> Dict[str, Dict[str, Any]]:
        """Per-metric-class rollup: the per-step estimated cost derivation.

        ``flops_per_dispatch`` / ``bytes_per_dispatch`` are dispatch-weighted
        means across the class's variants — the *per-metric per-step estimated
        cost* once the dispatch counters have seen real traffic (variants that
        never dispatched contribute nothing, so warmup-only noise drops out).
        """
        rollup: Dict[str, Dict[str, Any]] = {}
        for entry in self.entries():
            row = rollup.setdefault(
                entry.metric,
                {
                    "metric": entry.metric,
                    "variants": 0,
                    "compile_seconds": 0.0,
                    "dispatches": 0,
                    "estimated_flops": 0.0,
                    "estimated_bytes": 0.0,
                    "peak_bytes": None,
                    "_flops_known": False,
                    "_bytes_known": False,
                },
            )
            row["variants"] += 1
            row["compile_seconds"] += entry.compile_seconds or 0.0
            row["dispatches"] += entry.dispatches
            if entry.total_flops is not None:
                row["estimated_flops"] += entry.total_flops
                row["_flops_known"] = True
            if entry.total_bytes is not None:
                row["estimated_bytes"] += entry.total_bytes
                row["_bytes_known"] = True
            if entry.peak_bytes is not None:
                row["peak_bytes"] = max(row["peak_bytes"] or 0.0, entry.peak_bytes)
        for row in rollup.values():
            dispatched = row["dispatches"]
            row["compile_seconds"] = round(row["compile_seconds"], 6)
            if not row.pop("_flops_known"):
                row["estimated_flops"] = None
            if not row.pop("_bytes_known"):
                row["estimated_bytes"] = None
            row["flops_per_dispatch"] = (
                row["estimated_flops"] / dispatched
                if dispatched and row["estimated_flops"] is not None
                else None
            )
            row["bytes_per_dispatch"] = (
                row["estimated_bytes"] / dispatched
                if dispatched and row["estimated_bytes"] is not None
                else None
            )
        return rollup

    def by_tenant(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant rollup of **compile-time** attribution.

        Variants compiled under the tenant's scope, their summed compile
        seconds, and the summed per-dispatch cost estimates of those variants
        (``flops_per_dispatch``/``bytes_per_dispatch``: what one pass over the
        tenant's compiled programs is estimated to cost). Deliberately NOT
        dispatch-weighted: per-variant dispatch counters are tenant-blind —
        shared executables (the shape-bucket reuse design) serve every tenant
        — so runtime-usage totals cannot be honestly attributed per tenant
        without per-dispatch tenant accounting the hot path does not pay for.
        Only entries compiled under a tenant scope contribute (untenanted
        entries stay in :meth:`by_metric`/:meth:`totals` alone).
        """
        rollup: Dict[str, Dict[str, Any]] = {}
        for entry in self.entries():
            if entry.tenant is None:
                continue
            row = rollup.setdefault(
                entry.tenant,
                {
                    "tenant": entry.tenant,
                    "variants": 0,
                    "compile_seconds": 0.0,
                    "flops_per_dispatch": 0.0,
                    "bytes_per_dispatch": 0.0,
                    "_flops_known": False,
                    "_bytes_known": False,
                },
            )
            row["variants"] += 1
            row["compile_seconds"] += entry.compile_seconds or 0.0
            if entry.flops is not None:
                row["flops_per_dispatch"] += entry.flops
                row["_flops_known"] = True
            if entry.bytes_accessed is not None:
                row["bytes_per_dispatch"] += entry.bytes_accessed
                row["_bytes_known"] = True
        for row in rollup.values():
            row["compile_seconds"] = round(row["compile_seconds"], 6)
            if not row.pop("_flops_known"):
                row["flops_per_dispatch"] = None
            if not row.pop("_bytes_known"):
                row["bytes_per_dispatch"] = None
        return rollup

    def fn_estimate(self, fn: str) -> Dict[str, Optional[float]]:
        """Per-dispatch cost estimate for one wrapped-function label.

        The admission plane's pricing read
        (:class:`~torchmetrics_tpu_torch.obs.scope.AdmissionController`): the mean
        per-dispatch flops / bytes-accessed across the ledger entries whose
        ``fn`` matches (``None`` when the backend reported no analysis), plus
        the summed compile seconds those variants cost. Matching is exact on
        the ``fn`` label — the multiplexer's fused programs all share one
        label, so one read prices a whole dispatch family.
        """
        flops: List[float] = []
        bytes_accessed: List[float] = []
        compile_seconds = 0.0
        variants = 0
        for entry in self.entries():
            if entry.fn != fn:
                continue
            variants += 1
            compile_seconds += entry.compile_seconds or 0.0
            if entry.flops is not None:
                flops.append(entry.flops)
            if entry.bytes_accessed is not None:
                bytes_accessed.append(entry.bytes_accessed)
        return {
            "variants": variants,
            "compile_seconds": round(compile_seconds, 6),
            "flops_per_dispatch": sum(flops) / len(flops) if flops else None,
            "bytes_per_dispatch": sum(bytes_accessed) / len(bytes_accessed) if bytes_accessed else None,
        }

    def top(self, sort: str = "flops", top_k: int = 20) -> List[Dict[str, Any]]:
        """Top-K variant rows by ``sort`` (see :data:`SORT_KEYS`), largest first."""
        attr = SORT_KEYS.get(sort)
        if attr is None:
            raise ValueError(f"Unknown sort key {sort!r}; expected one of {sorted(SORT_KEYS)}")
        ranked = sorted(
            self.entries(),
            key=lambda e: (getattr(e, attr) if getattr(e, attr) is not None else -1.0),
            reverse=True,
        )
        return [entry.asdict() for entry in ranked[: max(0, int(top_k))]]


_LEDGER = CostLedger()


def get_ledger() -> CostLedger:
    """The process-wide ledger every :class:`StaticLeafJit` records into."""
    return _LEDGER


# ------------------------------------------------------------------------- egress


def _measured_seconds_by_metric(recorder: trace.TraceRecorder) -> Dict[str, float]:
    """Measured dispatch seconds per metric class, from the span histograms.

    ``metric.update`` spans are labeled by metric class; FUSED
    ``engine.dispatch`` spans by the pipeline's target class. Only these drive
    state forward without overlapping each other, so their summed durations are
    the measured denominator for achieved throughput. Nested spans that re-bill
    the same wall time are excluded: ``metric.forward`` wraps an update span,
    and eager/replay ``engine.dispatch`` spans wrap the metric's own ``update``
    (already counted via ``metric.update``) — only the ``path="fused"``
    dispatches run outside any ``metric.update`` span.
    """
    seconds: Dict[str, float] = {}
    for name, labels, total, _count in recorder.histogram_totals():
        if name == "metric.update":
            owner = labels.get("metric")
        elif name == "engine.dispatch" and labels.get("path") == "fused":
            owner = labels.get("pipeline")
        else:
            continue
        if owner:
            seconds[owner] = seconds.get(owner, 0.0) + total
    return seconds


def record_gauges(
    recorder: Optional[trace.TraceRecorder] = None,
    ledger: Optional[CostLedger] = None,
) -> Dict[str, Any]:
    """Record ``cost.*`` gauges into the recorder; returns the per-metric rollup.

    Families (dots become underscores under the ``tm_tpu_`` Prometheus prefix),
    all labeled ``{metric}`` — the per-class rollup, so cardinality is bounded
    by the number of metric classes, not compiled variants:

    - ``cost.compiled_variants`` — AOT executables in the ledger for the class;
    - ``cost.compile_seconds`` — summed XLA compile wall time those cost;
    - ``cost.flops_per_dispatch`` / ``cost.bytes_per_dispatch`` — per-step
      estimated cost (dispatch-weighted mean across variants);
    - ``cost.estimated_flops`` / ``cost.estimated_bytes`` — cumulative
      dispatch-weighted totals;
    - ``cost.peak_memory_bytes`` — max argument+output+temp bytes any variant
      holds live at once;
    - ``cost.achieved_flops_per_second`` — estimated flops ÷ measured span
      seconds (``metric.update`` + ``engine.dispatch`` histograms); absent
      until tracing has measured real dispatches.

    Like the memory-accounting gauges, writes go straight to the recorder so a
    scrape-time refresh works even while the hot-path tracing flag is off.
    """
    rec = recorder if recorder is not None else trace.get_recorder()
    led = ledger if ledger is not None else _LEDGER
    rollup = led.by_metric()
    measured = _measured_seconds_by_metric(rec)
    for metric, row in rollup.items():
        # per-CLASS rollups are deliberately cross-tenant: tenant=None is the
        # scope.tag opt-out so a scrape from inside a tenant scope cannot
        # split them into mis-attributed per-tenant variants
        rec.set_gauge("cost.compiled_variants", row["variants"], metric=metric, tenant=None)
        rec.set_gauge("cost.compile_seconds", row["compile_seconds"], metric=metric, tenant=None)
        for field in ("flops_per_dispatch", "bytes_per_dispatch"):
            if row[field] is not None:
                rec.set_gauge(f"cost.{field}", row[field], metric=metric, tenant=None)
        if row["estimated_flops"] is not None:
            rec.set_gauge("cost.estimated_flops", row["estimated_flops"], metric=metric, tenant=None)
        if row["estimated_bytes"] is not None:
            rec.set_gauge("cost.estimated_bytes", row["estimated_bytes"], metric=metric, tenant=None)
        if row["peak_bytes"] is not None:
            rec.set_gauge("cost.peak_memory_bytes", row["peak_bytes"], metric=metric, tenant=None)
        seconds = measured.get(metric)
        if seconds and row["estimated_flops"]:
            row["achieved_flops_per_second"] = row["estimated_flops"] / seconds
            rec.set_gauge(
                "cost.achieved_flops_per_second",
                row["achieved_flops_per_second"],
                metric=metric,
                tenant=None,
            )
        else:
            row["achieved_flops_per_second"] = None
    return rollup


def report(
    sort: str = "flops",
    top_k: int = 20,
    ledger: Optional[CostLedger] = None,
    recorder: Optional[trace.TraceRecorder] = None,
) -> Dict[str, Any]:
    """The ``GET /costs`` payload: totals, per-metric rollup, top-K variants.

    Raises ``ValueError`` on an unknown ``sort`` (the endpoint maps it to 400).
    """
    led = ledger if ledger is not None else _LEDGER
    rec = recorder if recorder is not None else trace.get_recorder()
    entries = led.top(sort=sort, top_k=top_k)  # validates sort before any work
    rollup = led.by_metric()
    measured = _measured_seconds_by_metric(rec)
    for metric, row in rollup.items():
        seconds = measured.get(metric)
        row["measured_seconds"] = round(seconds, 6) if seconds else None
        row["achieved_flops_per_second"] = (
            row["estimated_flops"] / seconds if seconds and row["estimated_flops"] else None
        )
    return {
        "enabled": ENABLED,
        "backend": _current_backend(),
        "sort": sort,
        "top_k": int(top_k),
        "totals": led.totals(),
        "by_metric": sorted(rollup.values(), key=lambda r: r["metric"]),
        "by_tenant": sorted(led.by_tenant().values(), key=lambda r: r["tenant"]),
        "entries": entries,
    }


def format_count(n: Optional[float], unit: str = "") -> str:
    """Human-readable SI count (``1.3G``, ``42.0M``); ``?`` for unknown."""
    if n is None:
        return "?"
    n = float(n)
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(n) >= scale:
            return f"{n / scale:.1f}{suffix}{unit}"
    return f"{n:g}{unit}"


def summary(
    sort: str = "flops",
    top_k: int = 20,
    ledger: Optional[CostLedger] = None,
    recorder: Optional[trace.TraceRecorder] = None,
) -> str:
    """Human-readable ledger table (the CLI's output)."""
    doc = report(sort=sort, top_k=top_k, ledger=ledger, recorder=recorder)
    totals = doc["totals"]
    lines = [
        f"== torchmetrics_tpu_torch cost ledger ({doc['backend'] or 'backend unknown'}) ==",
        f"  {totals['entries']} variant(s), {totals['dropped']} dropped,"
        f" compile {totals['compile_seconds']:.3f}s total,"
        f" {format_count(totals['estimated_flops'])}FLOP /"
        f" {format_count(totals['estimated_bytes'])}B dispatched"
        f" across {totals['dispatches']} dispatch(es)",
    ]
    if doc["by_metric"]:
        lines.append("-- per metric --")
        width = max(len(r["metric"]) for r in doc["by_metric"])
        for row in doc["by_metric"]:
            achieved = (
                f" achieved={format_count(row['achieved_flops_per_second'])}FLOP/s"
                if row.get("achieved_flops_per_second")
                else ""
            )
            lines.append(
                f"  {row['metric']:<{width}}  variants={row['variants']:<3}"
                f" compile={row['compile_seconds']:.3f}s"
                f" per-step={format_count(row['flops_per_dispatch'])}FLOP"
                f"/{format_count(row['bytes_per_dispatch'])}B"
                f" dispatched={row['dispatches']}{achieved}"
            )
    if doc["entries"]:
        lines.append(f"-- top {len(doc['entries'])} variants by {doc['sort']} --")
        for entry in doc["entries"]:
            lines.append(
                f"  {entry['fn']}[{entry['inst']}] {entry['input_signature']}"
                f"  flops={format_count(entry['flops'])} bytes={format_count(entry['bytes_accessed'])}"
                f" peak={format_count(entry['peak_bytes'])}B compile={entry['compile_seconds']:.3f}s"
                f" dispatches={entry['dispatches']} [{entry['source']}]"
            )
    else:
        lines.append("-- ledger is empty (nothing captured or counted yet) --")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------- CLI


def _demo_populate() -> None:
    """Run two small metrics through the capture cache (on the CPU: the count-only
    route) so the demo table has content."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy

    with trace.observe():
        acc = MulticlassAccuracy(num_classes=5, validate_args=False, jit_update=True, device="cpu")
        auroc = BinaryAUROC(thresholds=16, validate_args=False, jit_update=True, device="cpu")
        rng = np.random.RandomState(0)
        for _ in range(4):
            acc.update(torch.as_tensor(rng.rand(64, 5).astype("float32")), torch.as_tensor(rng.randint(0, 5, 64)))
            auroc.update(torch.as_tensor(rng.rand(64).astype("float32")), torch.as_tensor(rng.randint(0, 2, 64)))
        acc.compute(), auroc.compute()
        record_gauges()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchmetrics_tpu_torch.obs.cost",
        description=(
            "Print the process-wide cost ledger (per-variant flops/bytes/memory,"
            " capture seconds, dispatch counts) as a summary table."
            " Exit codes: 0 = printed, 2 = usage/load error."
        ),
    )
    parser.add_argument(
        "--sort", default="flops", choices=sorted(SORT_KEYS), help="variant ranking key"
    )
    parser.add_argument("--top", type=int, default=20, help="how many variants to list")
    parser.add_argument("--json", action="store_true", help="emit the report as JSON instead")
    parser.add_argument(
        "--demo",
        action="store_true",
        help="run two demo metrics through the capture cache first, so the table has content",
    )
    args = parser.parse_args(argv)

    if args.demo:
        try:
            _demo_populate()
        except Exception as err:
            sys.stderr.write(f"demo population failed: {err!r}\n")
            return 2
    if args.json:
        import json as _json

        print(_json.dumps(report(sort=args.sort, top_k=args.top), sort_keys=True, default=str))
    else:
        print(summary(sort=args.sort, top_k=args.top), end="")
    return 0


if __name__ == "__main__":
    # `python -m` executes this file as `__main__`, a SECOND module instance
    # with its own (empty) ledger — delegate to the canonical package module
    # so the CLI prints the ledger the rest of the runtime records into
    from torchmetrics_tpu_torch.obs import cost as _canonical

    raise SystemExit(_canonical.main())
