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
  snapshot is a reference and ``forward`` never copies.
- Cross-process sync is not ported yet: ``sync``/``sync_state`` are a no-op in one
  process and raise once ``torch.distributed`` is initialised.

Error policies, quarantine, fault injection, the observability hooks, the streaming
engine's commit and ``MaskedBuffer`` states come with the slices that port them.
"""

from __future__ import annotations

import inspect
from abc import ABC, abstractmethod
from copy import deepcopy
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.parallel.reductions import Reduction, merge_states
from torchmetrics_tpu_torch.utils.checks import _resolve_device
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

_METRIC_PROTECTED_ATTRS = ("is_differentiable", "higher_is_better", "full_state_update")

_SYNC_NOT_PORTED = (
    "Cross-process sync of metric states is not ported yet: it arrives with the"
    " collection/sync slice (`collections.py` and `parallel/sync.py` on torch.distributed)."
)


def distributed_available() -> bool:
    """Whether a ``torch.distributed`` process group is initialised."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


class Metric(torch.nn.Module, ABC):
    """Base class for all metrics of the port.

    Subclasses implement ``update(self, ...)`` (assigning to states registered with
    :meth:`add_state`) and ``compute(self)`` (reading states, returning the value).

    Args (keyword-only):
        device: where the states live and the updates run; ``"cuda"`` (the default)
            raises on a host without a card, ``"cpu"`` runs on the CPU.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._device = _resolve_device(kwargs.pop("device", "cuda"))
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        # state registry: defaults stay on the host so reset never aliases live states
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Reduction] = {}
        self._custom_fx: Dict[str, Callable] = {}
        self._persistent: Dict[str, bool] = {}
        self._state_values: Dict[str, Any] = {}

        # lifecycle
        self._update_count = 0
        self._computed: Any = None

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
        """Register a metric state: a tensor(-like) default or an empty list ("cat" state)."""
        if not name.isidentifier():
            raise ValueError(f"Argument `name` must be a valid python identifier, got {name!r}")
        is_list = isinstance(default, list)
        if is_list and len(default) != 0:
            raise ValueError("state defaults that are lists must be empty lists")
        if not is_list:
            try:
                default = torch.as_tensor(default).detach().to("cpu", copy=True)
            except Exception as err:
                raise ValueError("Invalid input to `add_state`. Expected tensor-like or empty list") from err
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

    @property
    def update_called(self) -> bool:
        return self._update_count > 0

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def device(self) -> torch.device:
        return self._device

    def _apply(self, fn: Callable, recurse: bool = True) -> "Metric":
        """Apply ``fn`` (``.to``, ``.cuda``, ``.cpu``, ...) to the states as well."""
        super()._apply(fn, recurse)

        def _map(values):
            return {k: [fn(x) for x in v] if isinstance(v, list) else fn(v) for k, v in values.items()}

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

    def sync_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Sync a state dict across processes: the identity in one process."""
        if distributed_available():
            raise NotImplementedError(_SYNC_NOT_PORTED)
        return dict(state)

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

    def _wrapped_update(self, *args: Any, **kwargs: Any) -> None:
        self._computed = None
        self._update_count += 1
        self._dispatch_update(*args, **kwargs)

    def _dispatch_update(self, *args: Any, **kwargs: Any) -> None:
        """Run one update against the currently-bound state."""
        args, kwargs = self._inputs_to_device(args, kwargs)
        self._update_impl(*args, **kwargs)

    # ------------------------------------------------------------------------ forward

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate into global state AND return the metric on this batch alone.

        Reduce-state path: the batch runs on a fresh state that is then merged into
        the global state pairwise. Full-state path (``full_state_update=True`` or
        unknown): update the global state, then replay the batch on a fresh state for
        the batch value. The batch value is never synced across processes.
        """
        if self.full_state_update or self.full_state_update is None:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        global_state = dict(self._state_values)
        global_count = self._update_count
        self._state_values = self._fresh_state()
        self._update_count = 1
        try:
            self._dispatch_update(*args, **kwargs)
            batch_val = _squeeze_if_scalar(self._compute_impl())
        finally:
            self._update_count = global_count
            self._state_values = global_state
            self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        global_state = dict(self._state_values)
        global_count = self._update_count
        self._state_values = self._fresh_state()
        self._update_count = 1
        self._computed = None
        try:
            self._dispatch_update(*args, **kwargs)
            batch_val = _squeeze_if_scalar(self._compute_impl())
        except Exception:
            self._state_values = global_state
            self._update_count = global_count
            raise
        self._state_values = self._reduce_states(global_state, dict(self._state_values), global_count)
        self._update_count = global_count + 1
        return batch_val

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

    def sync(self) -> None:
        """Sync the states across processes: a no-op in one process."""
        if distributed_available():
            raise NotImplementedError(_SYNC_NOT_PORTED)

    # ------------------------------------------------------------------------ compute

    _warn_on_compute_before_update = True

    def _wrapped_compute(self) -> Any:
        if self._update_count == 0 and self._warn_on_compute_before_update:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the ``update``"
                " method which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
        if self._computed is not None:
            return self._computed
        self.sync()
        value = _squeeze_if_scalar(self._compute_impl())
        self._computed = value
        return value

    # ------------------------------------------------------------------------- others

    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate batch statistics into state."""

    @abstractmethod
    def compute(self) -> Any:
        """Compute the metric value from accumulated state."""

    def reset(self) -> None:
        """Reset state to defaults."""
        self._update_count = 0
        self._computed = None
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
        """States by name, as tensors (lists of tensors for "cat" states).

        ``persistent_only=False`` includes every state, for checkpoints taken
        mid-epoch. ``keep_vars`` is accepted for ``torch.nn.Module`` callers.
        """
        destination = destination if destination is not None else {}
        for key, value in self._state_values.items():
            if persistent_only and not self._persistent.get(key, False):
                continue
            destination[prefix + key] = [v.detach() for v in value] if isinstance(value, list) else value.detach()
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:  # type: ignore[override]
        """Restore states saved by :meth:`state_dict` (tensors or numpy arrays)."""
        for key in self._defaults:
            full = prefix + key
            if full in state_dict:
                value = state_dict[full]
                if isinstance(value, list):
                    self._state_values[key] = [torch.as_tensor(v, device=self._device) for v in value]
                else:
                    self._state_values[key] = torch.as_tensor(value, device=self._device)
                if self._update_count == 0:
                    self._update_count = 1  # loaded state counts as updated
            elif strict and self._persistent.get(key, False):
                raise KeyError(f"Missing key {full!r} in state_dict")
        # a live metric may hold results computed before the load — drop them
        self._computed = None

    # ---------------------------------------------------------------- (de)serialization

    def __getstate__(self) -> Dict[str, Any]:
        skip = {"update", "compute", "_update_impl", "_compute_impl", "_update_signature"}
        return {k: v for k, v in self.__dict__.items() if k not in skip}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self._wrap_methods()

    def __deepcopy__(self, memo: dict) -> "Metric":
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
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
