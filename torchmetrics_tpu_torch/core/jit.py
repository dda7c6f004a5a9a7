"""Capture cache for metric update functions: one CUDA graph per static configuration.

Counterpart of ``torchmetrics_tpu/core/jit.py``. The JAX package routes an update
through a cached ``jax.jit`` of the pure transition, one compiled program per
(static configuration, input avals). The port keeps the keys and the accounting and
puts a ``torch.cuda.CUDAGraph`` where JAX puts an XLA executable:

- **Keys.** Arguments are flattened into leaves; tensors (and numpy arrays) are
  traced, everything else is static and selects a variant. One variant is one
  (argument structure, static template, input signature), the signature being each
  traced leaf's shape and dtype and the device the call runs on.
- **On the card**, a miss runs the function once on the cache's capture stream (so
  that every lazy allocation, kernel scratch and function attribute exists before
  the capture), then captures it into a CUDA graph whose inputs are static buffers.
  A call copies its state and inputs into those buffers, replays the graph on the
  capture stream and returns clones of the graph's outputs: a state a metric or a
  user holds is never a tensor that the next replay overwrites. A capture that
  fails raises; nothing falls back quietly.
- **On the CPU** the function runs as it is (the CPU route, as the kernels' plain
  versions are), and variants are keyed and counted all the same, so hits, misses,
  the recompile-storm warning, the eager fallback for an unhashable static (warned
  once, counted as ``jit.eager_fallback``), :meth:`StaticLeafJit.warmup` and
  :meth:`StaticLeafJit.cache_info` behave as in JAX on both devices.
- **Launch counts.** ``ops.kernels.LAUNCHES`` counts in Python where a wrapper
  launches, so a replay counts nothing by itself: each variant keeps the counts its
  capture recorded and adds them at every replay.

Telemetry keeps JAX's names: ``jit.cache_hit``, ``jit.cache_miss``,
``jit.cache_size``, the ``jit.compile`` span (the warm run and the capture) and the
``jit.first_run`` span (the first replay). A CUDA graph cannot be written to disk, so
there is no persistent cache (``engine/warmup.py``).
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import torchmetrics_tpu_torch.obs.trace as _trace
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _is_traced_leaf(x: Any) -> bool:
    """Leaves traced as inputs: tensors (``meta`` tensors stand for abstract specs in
    :meth:`StaticLeafJit.warmup`) and numpy arrays; Python values stay static."""
    return isinstance(x, (Tensor, np.ndarray))


class _ArraySlot:
    """Hashable placeholder marking a traced position in the static template."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "<array>"

    def __hash__(self) -> int:
        return 0

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _ArraySlot)


_SLOT = _ArraySlot()


def _hashable(x: Any) -> bool:
    try:
        hash(x)
        return True
    except TypeError:
        return False


# ----------------------------------------------------------------------- pytrees

_LEAF = "*"


def tree_flatten(tree: Any) -> Tuple[list, Any]:
    """Leaves and a hashable structure of nested tuples, lists, dicts and
    ``MaskedBuffer``s (a buffer's leaves are its data and its count)."""
    leaves: list = []

    def walk(node: Any) -> Any:
        if isinstance(node, (tuple, list)):
            return (type(node), tuple(walk(v) for v in node))
        if isinstance(node, dict):
            return (dict, tuple(node), tuple(walk(v) for v in node.values()))
        if isinstance(node, MaskedBuffer):
            return (MaskedBuffer, (walk(node.data), walk(node.count)))
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if node == _LEAF:
            return next(it)
        kind = node[0]
        if kind is dict:
            return dict(zip(node[1], (build(v) for v in node[2])))
        if kind is MaskedBuffer:
            data, count = (build(v) for v in node[1])
            return MaskedBuffer(data, count)
        return kind(build(v) for v in node[1])

    return build(treedef)


def partition_static_leaves(leaves) -> Tuple[list, list, Any]:
    """Split flattened leaves into (traced, template, first_unhashable_static).

    The single traced-vs-static partition rule shared by the dispatcher, its warmup
    and the streaming engine's chunk signatures: tensor and array leaves are traced
    (``_SLOT`` in the template), everything else is a static template entry. The first
    unhashable static encountered is returned (partition incomplete) — callers decide
    whether that means eager fallback, an error, or a per-batch dispatch.
    """
    traced, template = [], []
    for leaf in leaves:
        if _is_traced_leaf(leaf):
            traced.append(leaf)
            template.append(_SLOT)
        else:
            if not _hashable(leaf):
                return traced, template, leaf
            template.append(leaf)
    return traced, template, None


def _fn_label(fn: Callable) -> str:
    """Stable display label: owning class + method for bound methods."""
    owner = getattr(fn, "__self__", None)
    if owner is not None:
        return f"{type(owner).__name__}.{getattr(fn, '__name__', 'fn')}"
    return getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None) or repr(fn)


def _aval_signature(leaves) -> Tuple[tuple, ...]:
    """Hashable (shape, dtype, False) triple per leaf — a variant's input key.

    The third entry stands where JAX keeps a weak-type flag, so that a signature reads
    alike in both packages; torch has no weak types.
    """
    sig = []
    for leaf in leaves:
        if isinstance(leaf, np.ndarray):
            leaf = torch.as_tensor(leaf)
        sig.append((tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""), False))
    return tuple(sig)


def signature_str(sig: Tuple[tuple, ...]) -> str:
    """Compact human form of an :func:`_aval_signature`: ``float32[8,4],int32[8]``."""
    parts = []
    for shape, dtype, _weak in sig:
        dims = ",".join(str(d) for d in shape)
        parts.append(f"{dtype}[{dims}]")
    return ",".join(parts)


def _call_device(leaves: list) -> torch.device:
    """The device a call runs on: that of its first tensor not on ``meta`` (CPU if all
    are abstract specs or numpy arrays)."""
    for leaf in leaves:
        if isinstance(leaf, Tensor) and leaf.device.type != "meta":
            return leaf.device
    return torch.device("cpu")


# one capture stream per CUDA device: warm runs and captures of every cache run on it,
# so that the kernels' per-stream scratch exists before a capture reads it
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        from torchmetrics_tpu_torch.ops import kernels

        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
        kernels.GRAPH_STREAMS.add(stream.cuda_stream)
    return stream


def _launch_counts() -> Dict[str, int]:
    from torchmetrics_tpu_torch.ops import kernels

    return kernels.LAUNCHES


def _buffer_like(leaf: Any, device: torch.device) -> Tensor:
    """A static input buffer for ``leaf``: zeros for an abstract spec (valid labels
    and indices for a warm run), a copy of a real input."""
    if isinstance(leaf, np.ndarray):
        leaf = torch.as_tensor(leaf)
    if leaf.device.type == "meta":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    return leaf.to(device, copy=True)


class _Graph:
    """One captured variant: its graph, static input buffers (the state's leaves first,
    then the traced arguments), outputs and launches."""

    def __init__(self) -> None:
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.stream: Optional["torch.cuda.Stream"] = None  # the capture stream it replays on
        self.inputs: List[Tensor] = []
        self.out_def: Any = None
        self.out_leaves: List[Any] = []  # graph outputs (tensors) or constants
        self.launches: Dict[str, int] = {}
        self.seconds = 0.0
        self.replays = 0

    def copy_in(self, leaves: list) -> None:
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(torch.as_tensor(src) if isinstance(src, np.ndarray) else src)

    def replay(self) -> Any:
        # every graph of a device replays on the capture stream, in order with the warm
        # runs and the other graphs there: they all share that stream's kernel scratch
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        current.wait_stream(self.stream)
        self.replays += 1
        counts = _launch_counts()
        for name, n in self.launches.items():
            counts[name] += n
        return tree_unflatten(self.out_def, [t.clone() if isinstance(t, Tensor) else t for t in self.out_leaves])


# sentinel for a variant of the CPU route: nothing captured, the function runs as it is
_RUNS_AS_IS = object()


class StaticLeafJit:
    """Capture cache that partitions (args, kwargs) leaves into traced tensors and
    static Python values, keeping one variant per static configuration and input
    signature.

    ``fn`` must have signature ``fn(state, *args, **kwargs) -> state_or_value`` where
    ``state`` is a pytree of tensors (always traced). ``pool`` is a CUDA graph memory
    pool handle (``torch.cuda.graph_pool_handle()``) shared by every variant of the
    cache; by default each variant has its own.

    :meth:`warmup` captures a variant from abstract specs without replaying it, and
    :meth:`cache_info` reports variant/hit/miss/replay totals for warmup manifests
    and dispatch accounting.
    """

    # one loud warning once a single wrapper holds this many variants — a recapture
    # storm (per-step-varying static leaf OR unbounded input-shape churn) otherwise
    # goes unnoticed
    recompile_warn_threshold: int = 32

    # per-process ordinal distinguishing wrapper instances that share a label
    _instance_seq = itertools.count()

    def __init__(self, fn: Callable, pool: Any = None):
        self._fn = fn
        self._pool = pool
        self._cache: Dict[Any, bool] = {}  # static key -> seen
        self._compiled: Dict[Any, Any] = {}  # (static key, device, signature) -> _Graph or _RUNS_AS_IS
        self._label = _fn_label(fn)
        self._instance = str(next(StaticLeafJit._instance_seq))
        self._hits = 0
        self._misses = 0
        self._warned_unhashable = False
        self._warned_recompile_storm = False

    def _eager_fallback(self, leaf: Any, state: Any, args: tuple, kwargs: dict) -> Any:
        """Unhashable static leaf: eager dispatch, re-taken on EVERY call — warn once
        per wrapped function and count it, so a hot loop that never hits the cache is
        visible instead of silently slow."""
        if not self._warned_unhashable:
            self._warned_unhashable = True
            rank_zero_warn(
                f"{self._label} received an unhashable static argument of type"
                f" {type(leaf).__name__}; it cannot key the capture cache, so this call"
                " (and every later one like it) falls back to EAGER dispatch. Pass"
                " hashable statics (tuples, not lists) to keep the hot path captured.",
                RuntimeWarning,
            )
        if _trace.ENABLED:
            _trace.inc("jit.eager_fallback", fn=self._label)
            _trace.event("jit.eager_fallback", fn=self._label, leaf_type=type(leaf).__name__)
            # the enclosing metric.update span was labeled path="jit" by the
            # dispatcher, which could not know this call would fall back
            _trace.annotate_current_span(path="eager_fallback")
        return self._fn(state, *args, **kwargs)

    def _check_recompile_storm(self) -> None:
        """One loud warning when the variant count grows past the threshold, naming the
        static leaf positions whose churn caused it."""
        variants = max(len(self._cache), len(self._compiled))
        if self._warned_recompile_storm or variants <= self.recompile_warn_threshold:
            return
        self._warned_recompile_storm = True
        # positions are only comparable within one argument structure: group
        # templates by treedef and analyze the dominant group
        by_treedef: Dict[Any, list] = {}
        for treedef, template in self._cache:
            by_treedef.setdefault(treedef, []).append(template)
        templates = max(by_treedef.values(), key=len)
        offenders = []
        if len(by_treedef) > 1:
            offenders.append(f"{len(by_treedef)} distinct argument structures")
        for position in range(len(templates[0])):
            values = {t[position] for t in templates if not isinstance(t[position], _ArraySlot)}
            if len(values) > 1:
                sample = ", ".join(repr(v) for v in list(values)[:4])
                offenders.append(f"leaf {position}: {len(values)} distinct values (e.g. {sample})")
        if len(self._compiled) > len(self._cache):
            # more variants than static configs: the extra ones come from input-shape
            # churn (e.g. an unbucketed batch stream)
            shapes = {sig for (_, _, sig) in self._compiled}
            offenders.append(f"{len(shapes)} distinct input-shape signatures")
        detail = "; ".join(offenders) if offenders else "argument structure varies across calls"
        rank_zero_warn(
            f"{self._label} has compiled {variants} variants (threshold"
            f" {self.recompile_warn_threshold}) — a static leaf or input shape is changing"
            " across calls, so steps keep paying fresh captures. Offending leaves:"
            f" {detail}. Make the varying argument a tensor (traced), pin it to a fixed"
            " value, or bucket input shapes (the streaming engine's shape buckets do"
            " this for batch streams).",
            RuntimeWarning,
        )
        if _trace.ENABLED:
            _trace.event("jit.recompile_storm", fn=self._label, cache_size=variants, detail=detail)

    def _note_static(self, key: Any) -> None:
        if key not in self._cache:
            self._cache[key] = True
            self._check_recompile_storm()

    def _variant_key(self, state: Any, args: tuple, kwargs: dict):
        """(static key, call signature, state leaves, state structure, traced leaves,
        template, argument structure), or the first unhashable static."""
        leaves, treedef = tree_flatten((args, kwargs))
        traced, template, unhashable = partition_static_leaves(leaves)
        if unhashable is not None:
            return None, unhashable
        state_leaves, state_def = tree_flatten(state)
        key = (treedef, tuple(template))
        device = _call_device(state_leaves + traced)
        csig = (key, str(device), (state_def,) + _aval_signature(state_leaves) + _aval_signature(traced))
        return (key, csig, device, state_leaves, state_def, traced, tuple(template), treedef), None

    def _runner(self, state_def: Any, n_state: int, treedef: Any, template: tuple) -> Callable:
        fn = self._fn

        def run(leaves: list) -> Any:
            state = tree_unflatten(state_def, leaves[:n_state])
            it = iter(leaves[n_state:])
            full = [next(it) if isinstance(t, _ArraySlot) else t for t in template]
            r_args, r_kwargs = tree_unflatten(treedef, full)
            return fn(state, *r_args, **r_kwargs)

        return run

    def _capture(self, parts: tuple) -> "_Graph":
        """Warm once on the capture stream, then capture: the miss path on the card."""
        _, _, device, state_leaves, state_def, traced, template, treedef = parts
        if not all(isinstance(t, Tensor) for t in state_leaves):
            raise TypeError(
                f"{self._label}: a captured function's state must hold tensors only (a MaskedBuffer"
                " count as a 0-d tensor, `MaskedBuffer.traced`)"
            )
        run = self._runner(state_def, len(state_leaves), treedef, template)
        variant = _Graph()
        variant.inputs = [_buffer_like(t, device) for t in state_leaves + traced]
        stream = capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        start = time.perf_counter()
        with torch.cuda.stream(stream):
            run(variant.inputs)  # lazy allocations, kernel scratch and attributes happen here
        counts = _launch_counts()
        before = dict(counts)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected pipeline would destroy
        # its graphs there, a call the capture forbids and fails on
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                variant.out_leaves, variant.out_def = tree_flatten(run(variant.inputs))
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing: each replay adds what it recorded
            variant.launches = {k: counts[k] - before[k] for k in counts if counts[k] != before[k]}
            counts.update(before)
        torch.cuda.current_stream(device).wait_stream(stream)
        variant.graph, variant.stream = graph, stream
        variant.seconds = time.perf_counter() - start
        return variant

    def _compile(self, parts: tuple) -> Any:
        """A new variant under a ``jit.compile`` span: a capture on the card, nothing
        to make on the CPU."""
        make = self._capture if parts[2].type == "cuda" else lambda _: _RUNS_AS_IS
        if _trace.ENABLED:
            with _trace.span("jit.compile", fn=self._label, cache_size=len(self._compiled) + 1):
                return make(parts)
        return make(parts)

    def _run(self, variant: Any, parts: tuple, state: Any, args: tuple, kwargs: dict) -> Any:
        if variant is _RUNS_AS_IS:
            return self._fn(state, *args, **kwargs)
        variant.copy_in(parts[3] + parts[5])
        return variant.replay()

    def __call__(self, state: Any, *args: Any, **kwargs: Any) -> Any:
        parts, unhashable = self._variant_key(state, args, kwargs)
        if parts is None:
            return self._eager_fallback(unhashable, state, args, kwargs)
        key, csig = parts[0], parts[1]
        variant = self._compiled.get(csig)
        if variant is not None:
            self._hits += 1
            if _trace.ENABLED:
                _trace.inc("jit.cache_hit", fn=self._label)
            return self._run(variant, parts, state, args, kwargs)
        self._misses += 1
        self._note_static(key)
        if _trace.ENABLED:
            _trace.inc("jit.cache_miss", fn=self._label)
            # gauge is last-write-wins, so it needs the per-instance label
            _trace.set_gauge("jit.cache_size", len(self._cache), fn=self._label, inst=self._instance)
        variant = self._compile(parts)
        self._compiled[csig] = variant
        self._check_recompile_storm()
        if _trace.ENABLED:
            with _trace.span("jit.first_run", fn=self._label):
                return self._run(variant, parts, state, args, kwargs)
        return self._run(variant, parts, state, args, kwargs)

    # ------------------------------------------------------------------ warmup / info

    def warmup(self, state: Any, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Capture the variant selected by ``(state, args, kwargs)`` without replaying it.

        Tensor leaves may be real tensors or abstract ``torch.empty(..., device="meta")``
        specs (``state`` likewise); the call runs on the device of the first real tensor,
        on the CPU if there is none. Returns ``{"fresh": bool, "seconds": float, "fn":
        label}`` — ``fresh=False`` means the variant existed (zero cost). Raises on
        unhashable statics or a failing capture: a warmup pass must surface problems,
        not defer them to the hot loop.
        """
        parts, unhashable = self._variant_key(state, args, kwargs)
        if parts is None:
            raise TypeError(
                f"{self._label}.warmup received an unhashable static argument of type"
                f" {type(unhashable).__name__}; such calls dispatch eagerly and cannot be"
                " captured."
            )
        csig = parts[1]
        if csig in self._compiled:
            return {"fresh": False, "seconds": 0.0, "fn": self._label}
        self._note_static(parts[0])
        start = time.perf_counter()
        self._compiled[csig] = self._compile(parts)
        seconds = time.perf_counter() - start
        self._check_recompile_storm()
        return {"fresh": True, "seconds": seconds, "fn": self._label}

    def cache_info(self) -> Dict[str, Any]:
        """Dispatch-cache accounting: static variants, captured variants (the CPU
        route's count as such), hit/miss totals, graph replays and capture seconds
        since construction. Plain ints — available without obs tracing."""
        graphs = [v for v in self._compiled.values() if isinstance(v, _Graph)]
        return {
            "fn": self._label,
            "static_variants": len(self._cache),
            "compiled_variants": len(self._compiled),
            "hits": self._hits,
            "misses": self._misses,
            "replays": sum(v.replays for v in graphs),
            "capture_seconds": sum(v.seconds for v in graphs),
        }


def jit_with_static_leaves(fn: Callable, pool: Any = None) -> StaticLeafJit:
    return StaticLeafJit(fn, pool=pool)
