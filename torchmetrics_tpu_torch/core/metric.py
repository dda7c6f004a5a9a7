"""The stateful ``Metric`` runtime of the PyTorch port.

Counterpart of ``torchmetrics_tpu/core/metric.py``. The subclass API is the same —
``add_state`` plus an ``update`` that assigns to ``self.<state>`` and a ``compute``
that reads the states — and so are ``forward``'s two paths, ``reset``, ``clone``,
``state_dict``/``load_state_dict`` (same keys), the operator algebra and the pure
API (``init_state``/``pure_update``/``pure_compute``/``scan_update``).

PyTorch idiom inside:

- ``Metric`` is a ``torch.nn.Module``. States are int32/float32 tensors (or Python
  lists of tensors for ragged "cat" states) kept in a registry beside the module's
  parameters and buffers; ``.to(device)`` moves them.
- Every metric lives on one device, the card unless the caller passes
  ``device="cpu"``; ``update`` moves its tensor and numpy arguments there.
- Updates run eagerly and out of place (``self.tp = self.tp + tp``), so a state
  snapshot is a reference and ``forward`` never copies. The members of a
  ``MetricCollection``'s compute group hold the leader's state tensors for the same
  reason: no state is ever written in place.
- Cross-process sync runs on ``torch.distributed`` (``parallel/sync.py``) over the
  metric's ``process_group``: ``compute`` syncs once a process group is initialised,
  then restores the local state, as JAX's ``sync``/``unsync`` contract says.
- A "cat" state is a Python list of tensors or a ``MaskedBuffer`` (fixed capacity).

- ``update`` runs eagerly unless the metric is built with ``jit_update=True``: then
  it replays a CUDA graph of ``pure_update`` from the capture cache (``core/jit.py``),
  one per static configuration and input signature. The streaming engine
  (``engine/pipeline.py``) folds the updates of every metric without ragged list
  states through that cache, unless the metric says ``jit_update=False``.
- Error policies (``robust/policy.py``): with ``error_policy`` (or a global policy)
  an update screens its inputs for non-finite values and rolls its state back on
  any failure, then raises, skips or quarantines the batch; the counters
  ``updates_ok``/``updates_skipped``/``updates_quarantined`` and ``last_update_ok``
  track it, and ``state_dict`` carries them under ``__robust__`` once a guarded
  update has run. Fault injection (``robust/faults.py``) applies at ``update`` and
  ``forward``.
- The ``metric.update``/``metric.forward``/``metric.compute`` spans and the
  ``metric.reset``/``metric.compute_cached`` counters (``obs/trace.py``) cost one
  branch while tracing is off.
- Tenant attribution (``obs/scope.py``): the ambient tenant at construction sticks to
  the metric (``_obs_tenant``); each landed update and each fresh ``compute`` counts
  against the ambient tenant, else that one, in the tenant registry. A fresh
  ``compute`` also lands in the value timelines (``obs/values.py``) while they are
  on. Both cost one branch while unused.
- ``compute_on_cpu=True`` moves list states to the CPU after each update (after a
  captured replay returns, never inside the capture). List states past
  ``list_state_warn_threshold`` items warn once; with tracing on, the
  ``state.list_items`` gauge follows their growth.

Degrading a failed sync to local state (``sync_degraded`` stays ``False``) comes with
the robust plane.
"""

from __future__ import annotations

import inspect
import itertools
from abc import ABC, abstractmethod
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as _trace
import torchmetrics_tpu_torch.obs.values as _values
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.core.jit import jit_with_static_leaves
from torchmetrics_tpu_torch.parallel.reductions import Reduction, merge_states
from torchmetrics_tpu_torch.parallel.sync import distributed_available
from torchmetrics_tpu_torch.parallel.sync import sync_state as _sync_state_fn
from torchmetrics_tpu_torch.robust import faults as _faults
from torchmetrics_tpu_torch.robust.policy import (
    ErrorPolicy,
    UpdateGuardError,
    coerce_policy,
    effective_policy,
    first_nonfinite,
)
from torchmetrics_tpu_torch.utils.checks import _resolve_device
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

_METRIC_PROTECTED_ATTRS = ("is_differentiable", "higher_is_better", "full_state_update")
# the registry's marker for a MaskedBuffer default: (marker, capacity, item shape, dtype)
_MASKED_BUFFER = "__masked_buffer__"
# reserved state_dict key carrying the update-guard counters (the JAX package's);
# cannot collide with states, whose names must be identifiers
_ROBUST_STATE_KEY = "__robust__"


def _host_copy(value: Any) -> Any:
    """Host (numpy) copies of a quarantined batch's tensor leaves."""
    if isinstance(value, tuple) and hasattr(value, "_fields"):  # NamedTuple batches
        return type(value)(*(_host_copy(v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_host_copy(v) for v in value)
    if isinstance(value, dict):
        return {k: _host_copy(v) for k, v in value.items()}
    if isinstance(value, Tensor):
        return value.detach().cpu().numpy()
    return value


class Metric(torch.nn.Module, ABC):
    """Base class for all metrics of the port.

    Subclasses implement ``update(self, ...)`` (assigning to states registered with
    :meth:`add_state`) and ``compute(self)`` (reading states, returning the value).

    Args (keyword-only):
        device: where the states live and the updates run; ``"cuda"`` (the default)
            raises on a host without a card, ``"cpu"`` runs on the CPU.
        dist_sync_on_step: sync the states in every ``forward`` (its batch value then
            covers every rank's batch).
        process_group: the ``torch.distributed`` group to sync over (default: the
            whole world).
        dist_sync_fn: custom ``fn(state_dict, reductions) -> state_dict`` for sync.
        distributed_available_fn: predicate deciding whether sync runs (default: a
            process group is initialised).
        sync_on_compute: whether ``compute`` syncs across processes (default True).
        compute_with_cache: cache the computed value until the next update or reset.
        compute_on_cpu: move list states to the CPU after each update.
        jit_update: ``True`` routes ``update`` through the capture cache (a CUDA graph
            replay on the card); ``False`` keeps the metric out of the streaming
            engine's fused chunks. Default ``None``: ``update`` runs eagerly and the
            engine fuses the metric unless it holds ragged list states.
        error_policy: what to do with a batch that fails its update guards —
            ``"raise"`` | ``"warn_skip"`` | ``"quarantine"`` (``robust/policy.py``).
            ``None`` (default) defers to the process-global policy; with neither
            configured the update path is unguarded.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None

    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None

    # declared range of the computed value, e.g. ``(0.0, 1.0)`` for accuracy — read
    # by the out-of-bounds value watchdog (obs/alerts.py). ``None`` defers to the plot
    # bounds; either endpoint may be None for a half-open range.
    value_bounds: Optional[Sequence[Optional[float]]] = None

    _obs_instance_seq = itertools.count()

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._device = _resolve_device(kwargs.pop("device", "cuda"))
        self._dtype = torch.float32
        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or distributed_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        self._jit_update_flag = kwargs.pop("jit_update", None)
        self.error_policy = coerce_policy(kwargs.pop("error_policy", None))
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError("Expected keyword argument `compute_on_cpu` to be a `bool`")
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError("Expected keyword argument `dist_sync_on_step` to be a `bool`")
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError("Expected keyword argument `dist_sync_fn` to be callable or None")
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError("Expected keyword argument `sync_on_compute` to be a `bool`")

        # state registry: defaults stay on the host so reset never aliases live states
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Reduction] = {}
        self._custom_fx: Dict[str, Callable] = {}
        self._persistent: Dict[str, bool] = {}
        self._state_values: Dict[str, Any] = {}

        # lifecycle
        self._update_count = 0
        self._computed: Any = None
        self._cache: Optional[Dict[str, Any]] = None
        self._is_synced = False
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        # set where a failed sync degrades to local state: the robust plane's, not ported
        self.sync_degraded = False

        # update-guard counters (robust/policy.py): plain ints, free on the unguarded path
        self.updates_ok = 0
        self.updates_skipped = 0
        self.updates_quarantined = 0
        self.quarantine_dropped = 0
        self.last_update_ok = True
        self._quarantine: List[Dict[str, Any]] = []
        # True once a guarded update has run: gates the __robust__ state_dict key, so a
        # never-guarded metric writes the state_dict it always wrote
        self._guards_engaged = False
        # the capture cache of pure_update (jit_update=True), made at first use
        self._jitted_update = None
        # one-shot flag for the ragged list-state growth warning
        self._warned_list_growth = False
        self._obs_instance = str(next(Metric._obs_instance_seq))
        # tenant attribution (obs/scope.py): the ambient tenant at construction sticks
        # to the instance; an ambient scope at call time wins over it
        self._obs_tenant = _scope.current_tenant() if _scope.ENABLED else None

        self._wrap_methods()

    def _wrap_methods(self) -> None:
        self._update_signature = inspect.signature(self.update)
        self._update_impl = self.update
        self._compute_impl = self.compute
        self.__dict__["update"] = self._wrapped_update
        self.__dict__["compute"] = self._wrapped_compute

    # ------------------------------------------------------------------ state registry

    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Union[str, Callable, None] = None,
        persistent: bool = False,
    ) -> None:
        """Register a metric state: a tensor(-like) default, an empty list or an empty
        ``MaskedBuffer`` ("cat" states)."""
        if not name.isidentifier():
            raise ValueError(f"Argument `name` must be a valid python identifier, got {name!r}")
        is_list = isinstance(default, list)
        if is_list and len(default) != 0:
            raise ValueError("state defaults that are lists must be empty lists")
        if isinstance(default, MaskedBuffer):
            default = (_MASKED_BUFFER, default.capacity, tuple(default.data.shape[1:]), default.data.dtype)
        elif not is_list:
            try:
                default = torch.as_tensor(default).detach().to("cpu", copy=True)
            except Exception as err:
                raise ValueError(
                    "Invalid input to `add_state`. Expected tensor-like, MaskedBuffer or empty list"
                ) from err
        reduction = Reduction.from_arg(dist_reduce_fx)
        if callable(dist_reduce_fx):
            self._custom_fx[name] = dist_reduce_fx
        self._defaults[name] = [] if is_list else default
        self._reductions[name] = reduction
        self._persistent[name] = persistent
        self._state_values[name] = self._default_to_value(self._defaults[name])

    def _default_to_value(self, v: Any) -> Any:
        if isinstance(v, list):
            return []
        if isinstance(v, tuple):
            return MaskedBuffer.create(v[1], v[2], v[3], self._device)
        return v.to(self._device, copy=True)

    def _fresh_state(self) -> Dict[str, Any]:
        return {k: self._default_to_value(v) for k, v in self._defaults.items()}

    # attribute routing: registered states live in ``_state_values``
    def __getattr__(self, name: str) -> Any:
        sv = self.__dict__.get("_state_values")
        if sv is not None and name in sv:
            return sv[name]
        return super().__getattr__(name)

    def __setattr__(self, name: str, value: Any) -> None:
        d = self.__dict__
        defaults = d.get("_defaults")
        if defaults is not None and name in defaults:
            d["_state_values"][name] = value
            return
        if name in _METRIC_PROTECTED_ATTRS and hasattr(type(self), name) and defaults is not None:
            raise RuntimeError(f"Can't change const `{name}`.")
        super().__setattr__(name, value)

    def __delattr__(self, name: str) -> None:
        d = self.__dict__
        if name in d.get("_defaults", {}):
            del d["_state_values"][name]
            del d["_defaults"][name]
            del d["_reductions"][name]
            return
        super().__delattr__(name)

    # ------------------------------------------------------------------ compute groups

    def _compute_group_params(self) -> Optional[tuple]:
        """Hashable tuple of the constructor arguments that decide the update, or None
        when the metric cannot be grouped.

        Families whose metrics share an inherited ``update`` (stat scores, confusion
        matrices, threshold curves) override this. With the identity of the update
        function and the declared state spec it forms the static compute-group key.
        """
        return None

    def _compute_group_key(self) -> Optional[tuple]:
        """Static compute-group key: metrics with equal keys share their update."""
        params = self._compute_group_params()
        if params is None:
            return None
        fn = getattr(self._update_impl, "__func__", self._update_impl)
        spec = tuple(
            sorted(
                (
                    name,
                    "list" if isinstance(d, list) else d if isinstance(d, tuple) else (tuple(d.shape), str(d.dtype)),
                    str(self._reductions[name]),
                )
                for name, d in self._defaults.items()
            )
        )
        return (fn.__module__, fn.__qualname__, spec, params)

    @property
    def metric_state(self) -> Dict[str, Any]:
        """Current values of all registered states."""
        return dict(self._state_values)

    def _obs_labels(self) -> Dict[str, str]:
        """Tenant label for span/counter call sites (``obs/scope.py``): the ambient
        tenant, else the one captured at construction; ``{}`` while tenancy is idle."""
        if not _scope.ENABLED:
            return {}
        tenant = _scope.current_tenant() or self._obs_tenant
        return {"tenant": tenant} if tenant else {}

    def _resolved_value_bounds(self) -> Optional[tuple]:
        """Declared ``(lo, hi)`` range of the computed value, or ``None``: the explicit
        :attr:`value_bounds`, else the plot bounds. Read by the value timeline
        (``obs/values.py``) and the out-of-bounds watchdog (``obs/alerts.py``)."""
        bounds = self.value_bounds
        if bounds is None:
            lo, hi = self.plot_lower_bound, self.plot_upper_bound
            if lo is None and hi is None:
                return None
            return (lo, hi)
        lo, hi = bounds[0], bounds[1]
        return (None if lo is None else float(lo), None if hi is None else float(hi))

    @property
    def update_called(self) -> bool:
        return self._update_count > 0

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        """The floating-point dtype of the states, as :meth:`set_dtype` last set it."""
        return self._dtype

    def _apply(self, fn: Callable, recurse: bool = True) -> "Metric":
        """Apply ``fn`` (``.to``, ``.cuda``, ``.cpu``, ...) to the states as well."""
        super()._apply(fn, recurse)

        def _map(values):
            return {k: _map_state(v, fn) for k, v in values.items()}

        self._state_values = _map(self._state_values)
        self._device = fn(torch.zeros((), device=self._device)).device
        self._computed = None
        return self

    def _inputs_to_device(self, args: tuple, kwargs: dict):
        """Move tensor and numpy arguments of an update to the metric's device."""

        def _put(v):
            if isinstance(v, (Tensor, np.ndarray)):
                return torch.as_tensor(v, device=self._device)
            return v

        return tuple(_put(a) for a in args), {k: _put(v) for k, v in kwargs.items()}

    # ---------------------------------------------------------------- pure projections

    def init_state(self) -> Dict[str, Any]:
        """Fresh default state dict — entry point for the functional API."""
        return self._fresh_state()

    def state_reductions(self) -> Dict[str, Reduction]:
        return dict(self._reductions)

    def _bind_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        prev = self.__dict__["_state_values"]
        # copy list containers so an append never reaches the caller's state
        self.__dict__["_state_values"] = {k: list(v) if isinstance(v, list) else v for k, v in state.items()}
        return prev

    def pure_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure transition ``state' = update(state, batch)``; the bound state is left as it was."""
        prev = self._bind_state(state)
        try:
            args, kwargs = self._inputs_to_device(args, kwargs)
            self._update_impl(*args, **kwargs)
            return dict(self.__dict__["_state_values"])
        finally:
            self.__dict__["_state_values"] = prev

    def pure_compute(self, state: Dict[str, Any]) -> Any:
        """Pure ``value = compute(state)``."""
        prev = self._bind_state(state)
        try:
            return self._compute_impl()
        finally:
            self.__dict__["_state_values"] = prev

    def sync_state(self, state: Dict[str, Any], process_group: Optional[Any] = None) -> Dict[str, Any]:
        """Sync a state dict across the ranks of ``process_group`` (default: the metric's);
        a pure function (see ``parallel.sync_state``)."""
        return _sync_state_fn(state, self._reductions, process_group or self.process_group, device=self._device)

    def scan_update(self, state: Dict[str, Any], *batched_args: Any, **batched_kwargs: Any) -> Dict[str, Any]:
        """Fold a stream of batches into the state, one ``pure_update`` per leading index.

        Each argument carries a leading ``steps`` axis. Not available for metrics with
        ragged list states (use ``pure_update``).
        """
        if any(isinstance(v, list) for v in state.values()):
            raise TorchMetricsUserError("scan_update does not support ragged list states")
        steps = (list(batched_args) + list(batched_kwargs.values()))[0].shape[0]
        for i in range(steps):
            state = self.pure_update(
                state, *(a[i] for a in batched_args), **{k: v[i] for k, v in batched_kwargs.items()}
            )
        return state

    # ------------------------------------------------------------------------- update

    def _jit_enabled(self) -> bool:
        """Whether ``update`` replays the capture cache: only when asked for
        (``jit_update=True``); the hopper guide's rule keeps a plain update eager."""
        return bool(self._jit_update_flag)

    def _wrapped_update(self, *args: Any, **kwargs: Any) -> None:
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric has already been synced. HINT: call unsync() before modifying state."
            )
        if _faults.update_faults_active() and not self.__dict__.get("_fault_applied", False):
            args, kwargs = _faults.apply_update_fault(args, kwargs)
        self._computed = None
        policy = effective_policy(self.error_policy)
        if policy is None:
            # unguarded path: no input screening, exceptions propagate
            self._update_count += 1
            try:
                self._dispatch_update(*args, **kwargs)
            except Exception:
                self.last_update_ok = False
                raise
            self.updates_ok += 1
            self.last_update_ok = True
            if _scope.ENABLED:
                _scope.note_update(self._obs_tenant)
            return
        self._guards_engaged = True
        self._update_count += 1
        try:
            ok, err = self._guarded_dispatch(policy, args, kwargs)
        except Exception:
            self._update_count -= 1  # a failed batch never counts as an update
            raise
        if ok:
            self.updates_ok += 1
            self.last_update_ok = True
            if _scope.ENABLED:
                _scope.note_update(self._obs_tenant)
            return
        self._update_count -= 1  # a skipped batch never counts as an update
        self._record_update_failure(policy, err, args, kwargs)

    def _guarded_dispatch(self, policy: ErrorPolicy, args: tuple, kwargs: dict):
        """Run one update under guards: validate inputs, dispatch, roll back on failure.

        Returns ``(ok, error)``. Under the ``raise`` policy the failure (with state
        already rolled back) propagates instead.
        """
        # states are never written in place, so a snapshot is the references; list
        # states grow by append, so their containers are copied
        snapshot = {k: (list(v) if isinstance(v, list) else v) for k, v in self._state_values.items()}
        count_snapshot = self._update_count
        try:
            bad = first_nonfinite(args, kwargs)
            if bad is not None:
                raise UpdateGuardError(f"{type(self).__name__}.update received non-finite values in {bad}")
            self._dispatch_update(*args, **kwargs)
            return True, None
        except Exception as err:
            self.__dict__["_state_values"] = snapshot
            self._update_count = count_snapshot
            if policy is ErrorPolicy.RAISE:
                self.last_update_ok = False
                raise
            return False, err

    # retained quarantined batches are bounded: beyond this many, the oldest is
    # dropped (counted in `quarantine_dropped`)
    quarantine_max_batches: int = 16

    def _record_update_failure(self, policy: ErrorPolicy, err: Exception, args: tuple, kwargs: dict) -> None:
        """Book-keeping for a skipped/quarantined batch (state already rolled back)."""
        self.last_update_ok = False
        if policy is ErrorPolicy.QUARANTINE:
            self.updates_quarantined += 1
            self._quarantine.append(
                {
                    "args": _host_copy(args),
                    "kwargs": _host_copy(kwargs),
                    "reason": f"{type(err).__name__}: {err}",
                    # position in the guarded update stream (0-based), stable across
                    # both the update() and forward() entry points
                    "update_index": self.updates_ok + self.updates_skipped + self.updates_quarantined - 1,
                }
            )
            if len(self._quarantine) > self.quarantine_max_batches:
                self._quarantine.pop(0)
                self.quarantine_dropped += 1
            verb = "quarantined"
        else:
            self.updates_skipped += 1
            verb = "skipped"
        if _trace.ENABLED:
            _trace.inc(f"robust.update_{verb}", metric=type(self).__name__, **self._obs_labels())
        rank_zero_warn(
            f"{type(self).__name__}.update failed and the batch was {verb}"
            f" (policy={policy.value}): {err}. Accumulated state is unchanged;"
            " the `updates_ok`/`updates_skipped`/`updates_quarantined` counters"
            " track totals.",
            RuntimeWarning,
        )

    @property
    def quarantined_batches(self) -> List[Dict[str, Any]]:
        """Host copies of batches rejected under the ``quarantine`` policy."""
        return list(self._quarantine)

    def clear_quarantine(self) -> None:
        self._quarantine = []

    def _dispatch_update(self, *args: Any, **kwargs: Any) -> None:
        """Run one update against the currently-bound state (a graph replay with
        ``jit_update=True``). With tracing on, a ``metric.update`` span records the path."""
        if _trace.ENABLED:
            path = "jit" if self._jit_enabled() else "eager"
            with _trace.span("metric.update", metric=type(self).__name__, path=path, **self._obs_labels()):
                self._dispatch_update_inner(*args, **kwargs)
            return
        self._dispatch_update_inner(*args, **kwargs)

    def _dispatch_update_inner(self, *args: Any, **kwargs: Any) -> None:
        args, kwargs = self._inputs_to_device(args, kwargs)
        if self._jit_enabled():
            if self._jitted_update is None:
                self._jitted_update = jit_with_static_leaves(self.pure_update)
            new = self._jitted_update(self._traced_state(), *args, **kwargs)
            self._state_values = self._host_buffers(new)
            if self._has_list_defaults():
                # jit_update forced on a list-state metric: the replay has returned,
                # so the move to the CPU and the growth guard run outside the capture
                if self.compute_on_cpu:
                    self._move_list_states_to_cpu()
                self._check_list_state_growth()
            return
        self._update_impl(*args, **kwargs)
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        self._check_list_state_growth()

    def _has_list_defaults(self) -> bool:
        return any(isinstance(v, list) for v in self._defaults.values())

    def _move_list_states_to_cpu(self) -> None:
        """``compute_on_cpu``: list states' items as CPU tensors."""
        for key, value in self._state_values.items():
            if isinstance(value, list):
                self._state_values[key] = [v.detach().cpu() if isinstance(v, Tensor) else v for v in value]

    # ragged list states grow one tensor per update with no bound; past this many
    # items in all the metric warns ONCE (per class or per instance)
    list_state_warn_threshold: int = 10_000

    def _check_list_state_growth(self) -> None:
        """Surface unbounded ragged-list growth: the ``state.list_items`` gauge while
        tracing is on, and one warning per metric instance past the threshold."""
        items = 0
        per_state = None
        for key, value in self._state_values.items():
            if isinstance(value, list):
                items += len(value)
                if per_state is None:
                    per_state = []
                per_state.append((key, len(value)))
        if not items:
            return
        if _trace.ENABLED:
            # per-instance label: two metrics of one class keep their own curves
            _trace.set_gauge(
                "state.list_items", items, metric=type(self).__name__, inst=self._obs_instance, **self._obs_labels()
            )
        if items > self.list_state_warn_threshold and not self._warned_list_growth:
            self._warned_list_growth = True
            detail = ", ".join(f"{key}: {count} items" for key, count in per_state)
            if _trace.ENABLED:
                _trace.event("state.list_growth", metric=type(self).__name__, items=items, detail=detail)
            rank_zero_warn(
                f"{type(self).__name__} holds {items} ragged list-state items"
                f" (threshold {self.list_state_warn_threshold}): {detail}. List states"
                " grow one tensor per update with no bound — on a long run this is an"
                " OOM in waiting. Call compute()+reset() periodically, use a"
                " MaskedBuffer-backed binned variant, or raise"
                " `list_state_warn_threshold` if the growth is intended.",
                RuntimeWarning,
            )

    def _traced_state(self) -> Dict[str, Any]:
        """The bound state as a captured update takes it: ``MaskedBuffer`` counts as
        0-d device tensors (``MaskedBuffer.traced``)."""
        return {k: v.traced() if isinstance(v, MaskedBuffer) else v for k, v in self._state_values.items()}

    def _host_buffers(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """``state`` with the tensor counts of its ``MaskedBuffer``s read back as ints
        (one read for all of them); raises on a count past its capacity, before the
        state is bound."""
        traced = {k: v for k, v in state.items() if isinstance(v, MaskedBuffer) and isinstance(v.count, Tensor)}
        if not traced:
            return dict(state)
        counts = torch.stack([v.count for v in traced.values()]).tolist()
        out = dict(state)
        for (key, buf), count in zip(traced.items(), counts):
            if count > buf.capacity:
                raise ValueError(
                    f"MaskedBuffer state {key!r} overflowed: capacity {buf.capacity}, count {count}."
                    " Construct the metric with a larger buffer capacity; the state was not updated."
                )
            out[key] = MaskedBuffer(buf.data, count, device_count=buf.count)
        return out

    def _check_buffer_overflow(self) -> None:
        """Raise if a ``MaskedBuffer`` state's count exceeds its capacity (the eager
        append and the captured commit raise first; this is the JAX package's
        backstop, kept for its callers)."""
        for key, value in self._state_values.items():
            if isinstance(value, MaskedBuffer) and not isinstance(value.count, Tensor) and value.count > value.capacity:
                raise ValueError(
                    f"MaskedBuffer state {key!r} overflowed: capacity {value.capacity}, count {value.count}."
                )

    # ------------------------------------------------------------- engine integration

    def _engine_fusable(self) -> bool:
        """Whether the streaming engine may fold this metric's updates into a fused
        chunk: not ``jit_update=False``, and no ragged list states (a chunk's state
        needs a fixed structure across steps)."""
        return self._jit_update_flag is not False and not self._has_list_defaults()

    def _engine_commit_state(self, state: Dict[str, Any], n_batches: int) -> None:
        """Install a fused-chunk result as the accumulated state.

        The engine advanced ``n_batches`` updates in one replay; this does to the
        lifecycle counters what ``n_batches`` successful ``update`` calls would have
        done, so quarantine indices and ``update_count`` stay consistent with the
        per-batch path. A ``MaskedBuffer`` count past its capacity raises here, before
        anything is installed.
        """
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric has already been synced. HINT: call unsync() before modifying state."
            )
        state = self._host_buffers(state)
        self._computed = None
        self.__dict__["_state_values"] = state
        self._update_count += n_batches
        self.updates_ok += n_batches
        self.last_update_ok = True
        if _scope.ENABLED:
            # a fused chunk is n_batches tenant updates, as the per-batch path bills them
            _scope.note_update(self._obs_tenant, n_batches)

    # ------------------------------------------------------------------------ forward

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into global state AND return the metric on this batch alone.

        Reduce-state path: the batch runs on a fresh state that is then merged into
        the global state pairwise. Full-state path (``full_state_update=True`` or
        unknown, or ``dist_sync_on_step``): update the global state, then replay the
        batch on a fresh state for the batch value. The batch value syncs across
        processes only with ``dist_sync_on_step``. A batch that a guard skipped has
        no batch value (``None``).
        """
        if self._is_synced:
            raise TorchMetricsUserError("The Metric shouldn't be synced when performing `forward`.")
        if _faults.update_faults_active() and not self.__dict__.get("_fault_applied", False):
            # injected faults apply ONCE per forward call, at the outermost entry, so
            # the accumulate pass and the batch replay see the SAME arguments
            args, kwargs = _faults.apply_update_fault(args, kwargs)
            self.__dict__["_fault_applied"] = True
            try:
                return self._forward_dispatch(*args, **kwargs)
            finally:
                self.__dict__["_fault_applied"] = False
        return self._forward_dispatch(*args, **kwargs)

    def _forward_dispatch(self, *args: Any, **kwargs: Any) -> Any:
        full = self.full_state_update or self.full_state_update is None or self.dist_sync_on_step
        forward_fn = self._forward_full_state_update if full else self._forward_reduce_state_update
        if _trace.ENABLED:
            with _trace.span(
                "metric.forward", metric=type(self).__name__, path="full_state" if full else "reduce_state"
            ):
                return forward_fn(*args, **kwargs)
        return forward_fn(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        global_state = dict(self._state_values)
        global_count = self._update_count
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        self._state_values = self._fresh_state()
        self._update_count = 1
        try:
            batch_val = None
            if self.last_update_ok:
                # the guarded accumulate above succeeded, so this replay of the same
                # arguments is neither guarded nor counted again
                self._computed = None
                self._dispatch_update(*args, **kwargs)
                batch_val = self.compute()
        finally:
            self._restore_after_forward(global_state, global_count)
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        global_state = dict(self._state_values)
        global_count = self._update_count
        self._state_values = self._fresh_state()
        self._update_count = 1
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        self._computed = None
        try:
            batch_ok = self._update_once(*args, **kwargs)
            batch_val = self.compute() if batch_ok else None
        except Exception:
            self._restore_after_forward(global_state, global_count)
            raise
        if not batch_ok:  # a skipped batch contributes nothing to the global state
            self._restore_after_forward(global_state, global_count)
            return None
        merged = self._reduce_states(global_state, dict(self._state_values), global_count)
        self._restore_after_forward(merged, global_count + 1)
        return batch_val

    def _update_once(self, *args: Any, **kwargs: Any) -> bool:
        """One update against the bound (batch) state under the metric's policy;
        returns whether it landed (the guards skip and quarantine here too)."""
        policy = effective_policy(self.error_policy)
        if policy is None:
            self._dispatch_update(*args, **kwargs)
            ok, err = True, None
        else:
            self._guards_engaged = True
            ok, err = self._guarded_dispatch(policy, args, kwargs)
        if ok:
            self.updates_ok += 1
            self.last_update_ok = True
        else:
            self._record_update_failure(policy, err, args, kwargs)
        return ok

    def _restore_after_forward(self, state: Dict[str, Any], count: int) -> None:
        """Bind the global state again and leave the sync flags as ``compute`` wants them."""
        self._state_values = state
        self._update_count = count
        self._is_synced = False
        self._cache = None
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self._computed = None

    def _reduce_states(self, global_state: Dict[str, Any], batch_state: Dict[str, Any], global_count: int) -> Dict[str, Any]:
        """Merge the batch state into the global state."""
        return {
            name: merge_states(
                global_state[name], batch_state[name], reduction, global_count, 1,
                custom_fn=self._custom_fx.get(name),
            )
            for name, reduction in self._reductions.items()
        }

    # --------------------------------------------------------------------------- sync

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        fn = dist_sync_fn or self.dist_sync_fn
        if fn is None:
            synced = _sync_state_fn(
                dict(self._state_values), self._reductions, process_group or self.process_group, device=self._device
            )
        else:
            synced = fn(dict(self._state_values), self._reductions)
        # custom reduce functions run on the gathered tensor
        for name, custom in self._custom_fx.items():
            if name in synced and isinstance(synced[name], Tensor):
                synced[name] = custom(synced[name])
        self._state_values = synced

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Keep the local state aside and bind the state synced across processes.

        A no-op unless ``should_sync`` and a process group is available
        (``distributed_available``, default the metric's ``distributed_available_fn``).
        """
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        is_dist = (distributed_available or self.distributed_available_fn)()
        if not should_sync or not is_dist:
            return
        self._cache = dict(self._state_values)
        # the robust plane wraps this call: a failed collective degrades to the local
        # state and sets `sync_degraded`
        self._sync_dist(dist_sync_fn, process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Bind the local state kept aside by :meth:`sync` again."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TorchMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TorchMetricsUserError("The internal cache should exist to unsync the Metric.")
        self._state_values = self._cache
        self._cache = None
        self._is_synced = False

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ):
        """Synced state inside the block, the local state again after it."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        yield
        self.unsync(should_unsync=self._is_synced and should_unsync)

    # ------------------------------------------------------------------------ compute

    _warn_on_compute_before_update = True

    def _wrapped_compute(self) -> Any:
        if self._update_count == 0 and self._warn_on_compute_before_update:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the ``update``"
                " method which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
        if self.compute_with_cache and self._computed is not None:
            if _trace.ENABLED:
                _trace.inc("metric.compute_cached", metric=type(self).__name__)
            return self._computed
        if _trace.ENABLED:
            with _trace.span("metric.compute", metric=type(self).__name__, **self._obs_labels()):
                value = self._compute_synced_value()
        else:
            value = self._compute_synced_value()
        if self.compute_with_cache:
            self._computed = value
        if _scope.ENABLED:
            # fresh computes only (a cache hit above is the same evaluation)
            _scope.note_compute(self._obs_tenant)
        if _values.ENABLED:
            _values.record_compute(self, value)
        return value

    def _compute_synced_value(self) -> Any:
        with self.sync_context(
            dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
        ):
            return _squeeze_if_scalar(self._compute_impl())

    # ------------------------------------------------------------------------- others

    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate batch statistics into state."""

    @abstractmethod
    def compute(self) -> Any:
        """Compute the metric value from accumulated state."""

    def reset(self) -> None:
        """Reset state to defaults (and the update-guard counters)."""
        if _trace.ENABLED:
            _trace.inc("metric.reset", metric=type(self).__name__)
        self.updates_ok = 0
        self.updates_skipped = 0
        self.updates_quarantined = 0
        self.quarantine_dropped = 0
        self.last_update_ok = True
        self._quarantine = []
        self._guards_engaged = False
        self._update_count = 0
        self._computed = None
        self._cache = None
        self._is_synced = False
        self.sync_degraded = False
        self._state_values = self._fresh_state()

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return deepcopy(self)

    def persistent(self, mode: bool = False) -> None:
        """Toggle persistence for all states."""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(  # type: ignore[override]
        self,
        destination: Optional[dict] = None,
        prefix: str = "",
        persistent_only: bool = True,
        keep_vars: bool = False,
    ) -> Dict[str, Any]:
        """States by name, as tensors (lists of tensors for list states, a dict of
        ``data`` and ``count`` for a ``MaskedBuffer``, as the JAX package writes them).

        ``persistent_only=False`` includes every state, for checkpoints taken
        mid-epoch. ``keep_vars`` is accepted for ``torch.nn.Module`` callers.
        """
        destination = destination if destination is not None else {}
        for key, value in self._state_values.items():
            if persistent_only and not self._persistent.get(key, False):
                continue
            if isinstance(value, MaskedBuffer):
                destination[prefix + key] = {
                    "data": value.data.detach(), "count": torch.tensor(value.count, dtype=torch.int32)
                }
            else:
                destination[prefix + key] = _map_state(value, Tensor.detach)
        # the update-guard counters round-trip once a guarded update has run; a
        # never-guarded metric's state_dict is the one it always was
        if self._guards_engaged:
            destination[prefix + _ROBUST_STATE_KEY] = torch.tensor(
                [self.updates_ok, self.updates_skipped, self.updates_quarantined, int(self.last_update_ok),
                 self.quarantine_dropped],
                dtype=torch.int64,
            )
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:  # type: ignore[override]
        """Restore states saved by :meth:`state_dict` (tensors or numpy arrays).

        Each state is bound anew, never copied into: a compute-group member that loads
        a state leaves its leader's tensors as they were.
        """

        def _put(v):
            return torch.as_tensor(v, device=self._device)

        robust_key = prefix + _ROBUST_STATE_KEY
        if robust_key in state_dict:
            vals = [int(v) for v in torch.as_tensor(state_dict[robust_key]).reshape(-1).tolist()]
            vals += [0] * (5 - len(vals))
            self.updates_ok, self.updates_skipped, self.updates_quarantined = vals[0], vals[1], vals[2]
            self.last_update_ok = bool(vals[3])
            self.quarantine_dropped = vals[4]
            self._guards_engaged = True
        for key in self._defaults:
            full = prefix + key
            if full in state_dict:
                value = state_dict[full]
                if isinstance(value, list):
                    self._state_values[key] = [_put(v) for v in value]
                elif isinstance(value, dict) and set(value) == {"data", "count"}:
                    self._state_values[key] = MaskedBuffer(_put(value["data"]), int(value["count"]))
                else:
                    self._state_values[key] = _put(value)
                if self._update_count == 0:
                    self._update_count = 1  # loaded state counts as updated
            elif strict and self._persistent.get(key, False):
                raise KeyError(f"Missing key {full!r} in state_dict")
        # a live metric may hold results computed before the load — drop them
        self._computed = None
        self._cache = None
        self._is_synced = False

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast floating-point states to ``dst_type`` (recorded as :attr:`dtype`);
        drops the capture cache, whose variants were captured for the old types."""
        self._dtype = dst_type

        def _cast(v: Tensor) -> Tensor:
            return v.to(dst_type) if v.is_floating_point() else v

        for key, value in self._state_values.items():
            if isinstance(value, MaskedBuffer):
                self._state_values[key] = MaskedBuffer(_cast(value.data), value.count)
            else:
                self._state_values[key] = _map_state(value, _cast)
        self._jitted_update = None
        return self

    def to_device(self, device: Union[str, torch.device]) -> "Metric":
        """Move the states to ``device`` (the JAX package's name for ``.to``)."""
        return self.to(device)

    # ---------------------------------------------------------------- (de)serialization

    def __getstate__(self) -> Dict[str, Any]:
        # a CUDA graph can be neither pickled nor copied: a copy captures its own
        skip = {"update", "compute", "_update_impl", "_compute_impl", "_update_signature", "_jitted_update"}
        return {k: v for k, v in self.__dict__.items() if k not in skip}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self._jitted_update = None
        self._wrap_methods()

    def __deepcopy__(self, memo: dict) -> "Metric":
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        # a copy syncs over the same process group (a group cannot be copied)
        memo[id(self.process_group)] = self.process_group
        new.__setstate__(deepcopy(self.__getstate__(), memo))
        return new

    def __hash__(self) -> int:
        hash_vals = [type(self).__name__]
        for key in self._defaults:
            value = self._state_values.get(key)
            if isinstance(value, list):
                hash_vals.extend(id(v) for v in value)
            else:
                hash_vals.append(id(value))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    def __iter__(self):
        raise NotImplementedError("Metrics does not support iteration.")

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only kwargs the metric's ``update`` accepts."""
        params = self._update_signature.parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params}

    # --------------------------------------------------------------- operator algebra

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.logical_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)


def _map_state(value: Any, fn: Callable[[Tensor], Tensor]) -> Any:
    """``fn`` on every tensor of a state value (a tensor, a list of them or a buffer)."""
    if isinstance(value, list):
        return [fn(v) for v in value]
    if isinstance(value, MaskedBuffer):
        return value.map(fn)
    return fn(value)


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


def _squeeze_if_scalar(data: Any) -> Any:
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(v) for v in data)
    if isinstance(data, Tensor) and data.ndim == 1 and data.shape[0] == 1:
        return data.squeeze()
    return data


class CompositionalMetric(Metric):
    """Lazy arithmetic composition of metrics (and constants)."""

    full_state_update = True
    # children track their own update counts; suppress the composite-level warning
    _warn_on_compute_before_update = False

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Tensor, None],
        metric_b: Union[Metric, float, int, Tensor, None],
    ) -> None:
        children = [m for m in (metric_a, metric_b) if isinstance(m, Metric)]
        super().__init__(device=children[0].device)
        self.op = operator
        self.metric_a = _as_operand(metric_a)
        self.metric_b = _as_operand(metric_b)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # children sync themselves

    def _wrapped_compute(self) -> Any:
        # no cache and no sync at the composite's level: children run their own
        return self._compute_impl()

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            return None
        if val_b is None:
            if isinstance(self.metric_b, Metric):
                return None
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        name = getattr(self.op, "__name__", "op")
        return f"{type(self).__name__}(\n  {name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"


def _as_operand(x: Any) -> Any:
    """Constants become 0-d tensors (torch's binary ops want one tensor operand)."""
    if isinstance(x, (float, int)) and not isinstance(x, bool):
        return torch.as_tensor(x)
    return x
