"""State-memory accounting: what a metric's accumulated state costs, in bytes.

Counterpart of ``torchmetrics_tpu/obs/memory.py``. On the card the scarce resource is
device memory, and a metrics runtime accumulates state *silently* — a
``MaskedBuffer`` preallocates its full capacity at construction, ``compute_on_cpu``
list states grow one host tensor per update with no bound, and wrappers keep hidden
extra copies of the base metric's state. This module makes that visible in three
layers:

- :func:`footprint` — walk one metric's state registry (the live ``_state_values``
  declared through ``add_state``) summing per-leaf bytes with shape/dtype, and
  classify each state **by its role**, as the JAX package's kinds name them: the
  metric's own state tensors are **device** states (on ``device="cpu"`` too — the
  role, not ``tensor.is_cuda``), list items that ``compute_on_cpu`` moved to the host
  are **host** items of a **ragged list**, and a **MaskedBuffer** reports capacity
  bytes against fill bytes. So a CPU-built metric reports JAX's rows, and the same
  metric on the card reports the same rows. A buffer's count is billed as JAX's int32
  scalar (4 bytes), whether the port holds it as a Python int or a 0-d tensor.
  Rollups recurse through ``MetricCollection`` via the ``_memory_children`` hook, and
  hidden copies (the sync cache, quarantined host batches, the reset defaults) are
  accounted explicitly. Aliased tensors (compute-group members share their leader's
  state) are deduplicated by object identity: ``total_bytes`` counts every
  reference, ``unique_bytes`` every distinct buffer. The caching allocator rounds
  each block up, so ``unique_bytes`` is the tensors' own bytes, not allocator growth.
- :func:`device_memory_stats` — ``torch.cuda.memory_stats(d)`` of every visible card:
  ``bytes_in_use`` ← ``allocated_bytes.all.current``, ``peak_bytes_in_use`` ←
  ``allocated_bytes.all.peak``; ``{}`` where no card is visible or CUDA is not
  initialised yet, as the JAX package returns on the CPU. Never initialises CUDA.
- :func:`record_gauges` — write the footprint totals and device stats as gauges into
  the :class:`~torchmetrics_tpu_torch.obs.trace.TraceRecorder` (``memory.*`` /
  ``state.*`` families). Unlike the hot-path instrumentation this writes regardless
  of ``trace.ENABLED`` — an explicit accounting call *is* the intent — while costing
  the runtime nothing when never called.

Pure stdlib at import time (like the rest of ``obs``): torch and numpy are consulted
lazily, and only when the objects being measured already forced them in. Nothing
here may run inside a CUDA graph capture (a buffer's fill count is read back).
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torchmetrics_tpu_torch.obs.trace as trace

__all__ = [
    "device_memory_stats",
    "footprint",
    "format_bytes",
    "peak_device_bytes",
    "record_gauges",
    "report",
    "state_rows",
]

# per-leaf classification kinds (the four state kinds plus bookkeeping)
KIND_DEVICE = "device_array"
KIND_HOST = "host_array"
KIND_LIST = "list_state"
KIND_BUFFER = "masked_buffer"
KIND_OTHER = "other"


def _modules():
    """(torch, numpy, MaskedBuffer) — whichever are already importable.

    Measuring a metric means torch is live anyway; the lazy probe only keeps
    ``import torchmetrics_tpu_torch.obs`` free of torch/numpy (the trace-module
    contract).
    """
    torch_mod = sys.modules.get("torch")
    np_mod = sys.modules.get("numpy")
    buffer_cls = None
    if torch_mod is not None:
        try:
            from torchmetrics_tpu_torch.core.buffer import MaskedBuffer as buffer_cls
        except Exception:  # pragma: no cover - partial installs
            buffer_cls = None
    return torch_mod, np_mod, buffer_cls


# JAX's MaskedBuffer count is an int32 scalar array; the port's is a Python int (or a
# 0-d tensor inside a capture). Either way it is billed as JAX's 4 bytes.
_BUFFER_COUNT_BYTES = 4


def _dtype_name(dtype: Any) -> str:
    """``float32`` for ``torch.float32`` — the JAX package's (numpy's) dtype name."""
    return str(dtype).removeprefix("torch.")


def _array_nbytes(value: Any) -> int:
    """Byte size of an array-like from shape/dtype — never touches device data."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None and isinstance(value, torch_mod.Tensor):
        return int(value.numel()) * int(value.element_size())
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    size = getattr(value, "size", None)
    itemsize = getattr(getattr(value, "dtype", None), "itemsize", None)
    if size is not None and itemsize is not None:
        return int(size) * int(itemsize)
    return 0


def _classify_array(value: Any, host: bool = False) -> Optional[str]:
    """The kind of one array by its role: a tensor is a device state unless ``host``
    (a list item that ``compute_on_cpu`` moved, a reset default); a numpy array is
    host memory."""
    torch_mod, np_mod, _ = _modules()
    if torch_mod is not None and isinstance(value, torch_mod.Tensor):
        return KIND_HOST if host else KIND_DEVICE
    if np_mod is not None and isinstance(value, np_mod.ndarray):
        return KIND_HOST
    return None


def _leaf_row(value: Any, host_lists: bool = False) -> Dict[str, Any]:
    """One classified row for a single state value (not recursing children);
    ``host_lists``: the metric moves list items to the host (``compute_on_cpu``)."""
    _, _, buffer_cls = _modules()
    if buffer_cls is not None and isinstance(value, buffer_cls):
        data_bytes = _array_nbytes(value.data)
        item_bytes = data_bytes // value.capacity if value.capacity else 0
        # The count is a Python int between updates. It is a 0-d tensor only while an
        # update of this metric traces or captures (``pure_update`` binds the traced
        # state), and a scrape thread that read it on the card then would synchronise
        # inside that capture and break it: mid-update the fill is billed full.
        count = value.count
        if isinstance(count, int) or not getattr(count, "is_cuda", False):
            fill_items = int(count)
        else:
            fill_items = value.capacity
        fill_bytes = min(fill_items, value.capacity) * item_bytes
        return {
            "kind": KIND_BUFFER,
            "nbytes": data_bytes + _BUFFER_COUNT_BYTES,
            "capacity": value.capacity,
            "capacity_bytes": data_bytes,
            "fill_items": fill_items,
            "fill_bytes": fill_bytes,
            "shape": tuple(value.data.shape),
            "dtype": _dtype_name(value.data.dtype),
        }
    if isinstance(value, list):
        item_bytes = 0
        device_items = 0
        host_items = 0
        for item in value:
            item_bytes += _array_nbytes(item)
            kind = _classify_array(item, host=host_lists)
            if kind == KIND_DEVICE:
                device_items += 1
            elif kind == KIND_HOST:
                host_items += 1
        return {
            "kind": KIND_LIST,
            "nbytes": item_bytes,
            "items": len(value),
            "device_items": device_items,
            "host_items": host_items,
        }
    kind = _classify_array(value)
    if kind is not None:
        return {
            "kind": kind,
            "nbytes": _array_nbytes(value),
            "shape": tuple(value.shape),
            "dtype": _dtype_name(value.dtype),
        }
    return {"kind": KIND_OTHER, "nbytes": int(sys.getsizeof(value, 0))}


def _leaf_buffer_parts(value: Any) -> List[Tuple[int, int]]:
    """``(identity, nbytes)`` per distinct array buffer behind one state value.

    Compute-group members hold *references* to their leader's immutable state
    arrays; the rollup dedups on these ids so an aliased collection is not
    double-billed.
    """
    _, _, buffer_cls = _modules()
    if buffer_cls is not None and isinstance(value, buffer_cls):
        # the count's identity is its buffer's: a Python int count is shared by
        # every buffer holding the same value
        return [(id(value.data), _array_nbytes(value.data)), (id(value), _BUFFER_COUNT_BYTES)]
    if isinstance(value, list):
        return [(id(item), _array_nbytes(item)) for item in value]
    nbytes = _array_nbytes(value)
    if nbytes == 0 and getattr(value, "dtype", None) is None:
        nbytes = int(sys.getsizeof(value, 0))
    return [(id(value), nbytes)]


def state_rows(metric: Any) -> List[Dict[str, Any]]:
    """Per-state classified rows for one metric (live states + hidden copies).

    Hidden copies accounted beyond the registered states: the eager-sync cache
    (``_cache`` holds the pre-sync local state while synced), quarantined host
    batches retained under the ``quarantine`` error policy, and the host-side
    reset defaults kept by ``add_state``.
    """
    rows: List[Dict[str, Any]] = []
    host_lists = bool(getattr(metric, "compute_on_cpu", False))
    state_values = getattr(metric, "_state_values", None)
    if isinstance(state_values, dict):
        for name, value in state_values.items():
            rows.append({"state": name, **_leaf_row(value, host_lists), "parts": _leaf_buffer_parts(value)})
    cache = getattr(metric, "_cache", None)
    if isinstance(cache, dict):
        for name, value in cache.items():
            rows.append(
                {
                    "state": f"__sync_cache__.{name}",
                    **_leaf_row(value, host_lists),
                    "parts": _leaf_buffer_parts(value),
                }
            )
    quarantine = getattr(metric, "_quarantine", None)
    if isinstance(quarantine, list) and quarantine:
        nbytes = 0
        for batch in quarantine:
            for part in (batch.get("args", ()), tuple(batch.get("kwargs", {}).values())):
                for leaf in _flatten_batch(part):
                    nbytes += _array_nbytes(leaf)
        rows.append(
            {
                "state": "__quarantine__",
                "kind": KIND_HOST,
                "nbytes": nbytes,
                "items": len(quarantine),
                "parts": [(id(quarantine), nbytes)],
            }
        )
    defaults = getattr(metric, "_defaults", None)
    if isinstance(defaults, dict):
        nbytes = sum(
            _array_nbytes(value)
            for value in defaults.values()
            if _classify_array(value) is not None
        )
        if nbytes:
            rows.append(
                {"state": "__defaults__", "kind": KIND_HOST, "nbytes": nbytes, "parts": [(id(defaults), nbytes)]}
            )
    return rows


def _flatten_batch(value: Any):
    if isinstance(value, (list, tuple)):
        for item in value:
            yield from _flatten_batch(item)
    elif isinstance(value, dict):
        for item in value.values():
            yield from _flatten_batch(item)
    else:
        yield value


def _children_of(obj: Any) -> List[Tuple[str, Any]]:
    hook = getattr(obj, "_memory_children", None)
    if callable(hook):
        try:
            return list(hook())
        except Exception:  # pragma: no cover - defensive: accounting never raises
            return []
    return []


def footprint(obj: Any, _seen: Optional[set] = None) -> Dict[str, Any]:
    """Full recursive state-memory footprint of a metric / collection / wrapper.

    Returns a plain JSON-able dict::

        {"name", "total_bytes", "unique_bytes", "device_bytes", "host_bytes",
         "list_items", "n_states", "states": [...], "children": [...]}

    ``total_bytes`` counts every state reference including aliased
    compute-group members; ``unique_bytes`` deduplicates shared buffers by
    object identity and is the number that corresponds to real memory.
    ``device_bytes``/``host_bytes`` split the *unique* total by residency
    (MaskedBuffer capacity counts as device).
    """
    if _seen is None:
        _seen = set()
    out: Dict[str, Any] = {
        "name": type(obj).__name__,
        "total_bytes": 0,
        "unique_bytes": 0,
        "device_bytes": 0,
        "host_bytes": 0,
        "list_items": 0,
        "n_states": 0,
        "states": [],
        "children": [],
    }
    if id(obj) in _seen:  # cycle / shared child: count once
        out["aliased"] = True
        return out
    _seen.add(id(obj))

    for row in state_rows(obj):
        parts = row.pop("parts", [])
        out["n_states"] += 1
        out["total_bytes"] += row["nbytes"]
        row["unique_bytes"] = sum(nbytes for ident, nbytes in parts if ident not in _seen)
        _seen.update(ident for ident, _ in parts)
        if row["kind"] == KIND_LIST:
            out["list_items"] += row["items"]
        out["unique_bytes"] += row["unique_bytes"]
        if row["kind"] in (KIND_DEVICE, KIND_BUFFER):
            out["device_bytes"] += row["unique_bytes"]
        elif row["kind"] == KIND_LIST:
            # split by residency of the items (device pre-move, host after
            # compute_on_cpu); mixed lists attribute proportionally by count
            if row["items"]:
                device_frac = row["device_items"] / row["items"]
            else:
                device_frac = 0.0
            out["device_bytes"] += int(row["unique_bytes"] * device_frac)
            out["host_bytes"] += row["unique_bytes"] - int(row["unique_bytes"] * device_frac)
        else:
            out["host_bytes"] += row["unique_bytes"]
        out["states"].append(row)

    for label, child in _children_of(obj):
        sub = footprint(child, _seen)
        sub["label"] = label
        out["children"].append(sub)
        for key in ("total_bytes", "unique_bytes", "device_bytes", "host_bytes", "list_items", "n_states"):
            out[key] += sub[key]
    return out


# ------------------------------------------------------------- device polling


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card ``{device: {bytes_in_use, peak_bytes_in_use}}`` from the caching
    allocator (``torch.cuda.memory_stats``).

    ``bytes_in_use`` is ``allocated_bytes.all.current`` and ``peak_bytes_in_use``
    ``allocated_bytes.all.peak``. Guarded: torch never imported, no card visible, or
    CUDA not initialised yet → ``{}`` (the JAX package's CPU and no-backend answers):
    accounting is never the thing that initialises CUDA.
    """
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return {}
    try:
        if not (torch_mod.cuda.is_available() and torch_mod.cuda.is_initialized()):
            return {}
        count = torch_mod.cuda.device_count()
    except Exception:
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for index in range(count):
        try:
            stats = torch_mod.cuda.memory_stats(index)
        except Exception:
            continue
        out[f"cuda:{index}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        }
    return out


def peak_device_bytes() -> Optional[int]:
    """Max ``peak_bytes_in_use`` across devices, or ``None`` when unavailable."""
    peaks = [
        stats["peak_bytes_in_use"]
        for stats in device_memory_stats().values()
        if "peak_bytes_in_use" in stats
    ]
    return max(peaks) if peaks else None


# ------------------------------------------------------------------- gauges


def record_gauges(
    metrics: Iterable[Any] = (),
    recorder: Optional[trace.TraceRecorder] = None,
    include_device: bool = True,
) -> Dict[str, Any]:
    """Record footprint + device-memory gauges into the recorder; returns them.

    Families (dots become underscores under the ``tm_tpu_`` Prometheus
    prefix):

    - ``memory.state_bytes{metric,inst}`` — unique accumulated state bytes
      per top-level metric (wrapper/collection children included in the
      owner's number);
    - ``memory.state_device_bytes`` / ``memory.state_host_bytes`` — residency
      split, same labels;
    - ``state.list_items{metric,inst}`` — total ragged list items held (same
      label scheme as the hot-path gauge the eager update records);
    - ``memory.device_bytes_in_use{device}`` /
      ``memory.device_peak_bytes_in_use{device}`` — backend ``memory_stats``
      when the platform reports them.

    ``inst`` is the metric's per-process construction ordinal (stable across
    registration changes — unregistering one metric never shifts another's
    series onto a stale label, and two same-class metrics never collide), with
    a registry-position fallback ``r<i>`` for containers that carry no
    ordinal.

    Writes go straight to the recorder (NOT gated on ``trace.ENABLED``): an
    explicit accounting call is its own opt-in, and the /metrics endpoint must
    show memory series even when span tracing is off. Hot paths never call
    this.
    """
    rec = recorder if recorder is not None else trace.get_recorder()
    out: Dict[str, Any] = {"metrics": [], "devices": {}}
    for index, metric in enumerate(metrics):
        fp = footprint(metric)
        inst = getattr(metric, "_obs_instance", None) or f"r{index}"
        labels = {"metric": fp["name"], "inst": str(inst)}
        tenant = getattr(metric, "_obs_tenant", None)
        if tenant:
            # tenant attribution (obs/scope.py): a metric registered under a
            # tenant bills its state bytes to that tenant's label
            labels["tenant"] = str(tenant)
            fp["tenant"] = str(tenant)
        else:
            # explicit opt-out (scope.tag strips None): an accounting call made
            # inside someone's scope must not mis-bill an untenanted metric
            labels["tenant"] = None
        rec.set_gauge("memory.state_bytes", float(fp["unique_bytes"]), **labels)
        rec.set_gauge("memory.state_device_bytes", float(fp["device_bytes"]), **labels)
        rec.set_gauge("memory.state_host_bytes", float(fp["host_bytes"]), **labels)
        rec.set_gauge("state.list_items", float(fp["list_items"]), **labels)
        out["metrics"].append({**labels, "footprint": fp})
    if include_device:
        stats = device_memory_stats()
        for device, row in stats.items():
            if "bytes_in_use" in row:
                rec.set_gauge("memory.device_bytes_in_use", float(row["bytes_in_use"]), device=device)
            if "peak_bytes_in_use" in row:
                rec.set_gauge(
                    "memory.device_peak_bytes_in_use", float(row["peak_bytes_in_use"]), device=device
                )
        out["devices"] = stats
    return out


# ------------------------------------------------------------------- report


def format_bytes(n: Optional[float]) -> str:
    """Human-readable byte count (binary units)."""
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"  # pragma: no cover - unreachable


def report(metrics: Iterable[Any] = (), top_k: int = 20, tenant: Optional[str] = None) -> Dict[str, Any]:
    """Top-K footprint report — the payload behind ``GET /memory``.

    Per-metric footprints sorted by ``unique_bytes`` (largest first), each
    metric's state rows likewise sorted and truncated to ``top_k``, plus
    fleet-relevant totals and the guarded device stats. ``tenant`` narrows the
    report to metrics registered under that tenant (the ``?tenant=`` view).
    """
    rows = []
    for index, metric in enumerate(metrics):
        metric_tenant = getattr(metric, "_obs_tenant", None)
        if tenant is not None and metric_tenant != tenant:
            continue
        fp = footprint(metric)
        fp["instance"] = index
        if metric_tenant:
            fp["tenant"] = str(metric_tenant)
        fp["states"] = sorted(fp["states"], key=lambda r: -r["nbytes"])[: max(0, top_k)]
        rows.append(fp)
    rows.sort(key=lambda fp: -fp["unique_bytes"])
    totals = {
        key: sum(fp[key] for fp in rows)
        for key in ("total_bytes", "unique_bytes", "device_bytes", "host_bytes", "list_items")
    }
    out = {
        "metrics": rows[: max(0, top_k)],
        "n_metrics": len(rows),
        "totals": totals,
        "totals_human": {k: format_bytes(v) for k, v in totals.items() if k != "list_items"},
        "device_memory_stats": device_memory_stats(),
    }
    if tenant is not None:
        out["tenant_filter"] = tenant
    return out
