"""``MetricCollection``: many metrics, one call, one update per compute group.

Counterpart of ``torchmetrics_tpu/collections.py``. Compute groups are decided
statically at construction, as in the JAX package: metrics whose
``_compute_group_key`` is equal (the same inherited ``update``, the same declared
states, the same update-relevant constructor arguments) share one group, and only the
group's first metric, its leader, runs ``update``. The other members hold the
leader's state tensors.

That sharing is safe in PyTorch for the reason it is safe for JAX's immutable arrays:
no state of the port is written in place. Every update rebinds its states
(``self.tp = self.tp + tp``, a ``MaskedBuffer`` append returns a new buffer),
``load_state_dict`` binds new tensors, ``.to()`` binds the moved ones and ``reset``
binds fresh defaults. List states are the one mutable container, so members get a
shallow copy of the leader's lists.

``compute`` syncs each group's leader once over ``torch.distributed`` and computes
every member from the synced state. ``forward`` gives each member the value of its
own ``compute`` on the leader's batch state, made by one more ``pure_update`` of the
leader per group.

The streaming engine (``engine/pipeline.py``) folds a fused chunk through each group's
leader once and commits the result to the whole group (``_engine_fusable_leaders``,
``_engine_commit``). A collection built under a tenant scope (``obs/scope.py``) is
that tenant's: members without a tenant of their own take it. ``memory_footprint``
sums the members' state bytes, an aliased compute-group state once (``obs/memory.py``);
``plot`` draws each member on its own figure, or all of them on one axis
(``utils/plot.py``; matplotlib is optional).
"""

from __future__ import annotations

from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import torch

import torchmetrics_tpu_torch.obs.scope as _scope
from torchmetrics_tpu_torch.core.metric import Metric, _squeeze_if_scalar
from torchmetrics_tpu_torch.utils.data import _flatten_dict
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


class MetricCollection(torch.nn.ModuleDict):
    """Chain metrics with the same call pattern into one object.

    Args:
        metrics: a single ``Metric``, a list or tuple of metrics (keyed by class
            name), or a dict mapping names to metrics. ``MetricCollection`` values are
            flattened into this collection.
        additional_metrics: more metrics when ``metrics`` is a single one or a sequence.
        prefix: string prepended to every key of the output dict.
        postfix: string appended to every key of the output dict.
        compute_groups: ``True`` (default) groups metrics by their static key;
            ``False`` puts each metric in its own group; a list of lists of metric
            names sets the groups.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricCollection
        >>> from torchmetrics_tpu_torch.classification import (
        ...     MulticlassAccuracy, MulticlassPrecision, MulticlassRecall)
        >>> target = torch.tensor([0, 2, 0, 2, 0, 1, 0, 2])
        >>> preds = torch.tensor([2, 1, 2, 0, 1, 2, 2, 2])
        >>> metrics = MetricCollection([MulticlassAccuracy(3, average='micro', device='cpu'),
        ...                             MulticlassPrecision(3, average='macro', device='cpu'),
        ...                             MulticlassRecall(3, average='macro', device='cpu')])
        >>> metrics.update(preds, target)
        >>> sorted(metrics.compute())
        ['MulticlassAccuracy', 'MulticlassPrecision', 'MulticlassRecall']
    """

    def __init__(
        self,
        metrics: Union[Metric, "MetricCollection", Sequence[Any], Dict[str, Any]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups: Dict[int, List[str]] = {}
        # tenant attribution (obs/scope.py): a collection constructed under a tenant
        # scope is that tenant's session; members registered without their own
        # tenant inherit it (see add_metrics)
        self._obs_tenant = _scope.current_tenant() if _scope.ENABLED else None
        self.add_metrics(metrics, *additional_metrics)

    # ------------------------------------------------------------------- construction

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def add_metrics(
        self,
        metrics: Union[Metric, "MetricCollection", Sequence[Any], Dict[str, Any]],
        *additional_metrics: Metric,
    ) -> None:
        """Add new metrics to the collection."""
        if isinstance(metrics, (Metric, MetricCollection)):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, (str, bytes)):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                sel = metrics if isinstance(m, (Metric, MetricCollection)) else remain
                sel.append(m)
            if remain:
                rank_zero_warn(
                    f"You have passed extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        v._from_collection_prefix = metric.prefix
                        v._from_collection_postfix = metric.postfix
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = type(metric).__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        v._from_collection_prefix = metric.prefix
                        v._from_collection_postfix = metric.postfix
                        self._modules[k] = v
        else:
            raise ValueError(
                "Unknown input to MetricCollection. Expected `Metric`, `MetricCollection` or"
                f" `dict`/`sequence` of the previous, but got {metrics}"
            )

        if getattr(self, "_obs_tenant", None) is not None:
            # members constructed outside the scope inherit the collection's tenant
            for member in self._modules.values():
                if getattr(member, "_obs_tenant", None) is None:
                    member._obs_tenant = self._obs_tenant

        self._init_compute_groups()

    def _init_compute_groups(self) -> None:
        """Decide the compute groups from the declared state specs.

        Groups the user gives are checked and trusted; otherwise metrics with equal
        ``_compute_group_key`` share a group, and a metric without a key (or with
        accumulated history) stands alone.
        """
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for v in self._groups.values():
                for metric in v:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the"
                            f" collection. Please make sure that {self._enable_compute_groups} matches"
                            f" {list(self._modules)}"
                        )
            grouped = {name for members in self._groups.values() for name in members}
            next_idx = len(self._groups)
            for name in self._modules:
                if name not in grouped:
                    self._groups[next_idx] = [name]
                    next_idx += 1
            return

        if self._enable_compute_groups is False:
            self._groups = {i: [name] for i, name in enumerate(self._modules)}
            return

        by_key: Dict[tuple, List[str]] = {}
        singles: List[List[str]] = []
        for name, metric in self._modules.items():
            # a metric added (or cloned) mid-stream must not take a leader's state
            key = metric._compute_group_key() if metric._update_count == 0 else None
            if key is None:
                singles.append([name])
            else:
                by_key.setdefault(key, []).append(name)
        self._groups = dict(enumerate(list(by_key.values()) + singles))

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        """The current compute groups."""
        return self._groups

    # ------------------------------------------------------------------ update/compute

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every compute-group leader; members then hold the leader's state.

        Positional arguments go to every metric; keyword arguments are filtered by
        each metric's ``update`` signature.
        """
        for m in self._modules.values():
            m._computed = None
        for members in self._groups.values():
            m0 = self._modules[members[0]]
            m0.update(*args, **m0._filter_kwargs(**kwargs))
        self._sync_group_states()

    def _sync_group_states(self) -> None:
        """Bind the leader's state tensors to every member (lists as shallow copies, so
        that a direct ``update`` on a member appends to its own list only)."""
        for members in self._groups.values():
            m0 = self._modules[members[0]]
            for name in members[1:]:
                mi = self._modules[name]
                for state in m0._defaults:
                    v = m0._state_values[state]
                    mi._state_values[state] = list(v) if isinstance(v, list) else v
                mi._update_count = m0._update_count

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """``forward`` every leader (and every member that cannot share its leader's
        batch), returning the flat dict of batch values."""
        for m in self._modules.values():
            m._computed = None  # members that skip forward would keep a stale value
        res = self._compute_and_reduce("forward", *args, **kwargs)
        self._sync_group_states()
        return res

    def compute(self) -> Dict[str, Any]:
        """Compute every metric, returning the flat result dict."""
        return self._compute_and_reduce("compute")

    def _compute_and_reduce(self, method_name: str, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Run ``compute`` or ``forward`` per metric and flatten dict-valued results."""
        if method_name not in ("compute", "forward"):
            raise ValueError(f"method_name should be either 'compute' or 'forward', but got {method_name}")
        if method_name == "compute":
            return self._flatten_result_dict(self._compute_groupwise())
        result = {}
        for k, m in self._modules.items():
            if self._group_leaders_only_forward(k):
                continue
            result[k] = m(*args, **m._filter_kwargs(**kwargs))
        # members of a group compute their batch value from the leader's batch state
        return self._flatten_result_dict(self._fill_group_member_forward(result, *args, **kwargs))

    def _flatten_result_dict(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Flatten dict-valued per-metric results, dedupe keys, apply the affixes."""
        _, duplicates = _flatten_dict(result)

        flattened_results = {}
        for k, m in self._modules.items():
            res = result[k]
            if isinstance(res, dict):
                for key, v in res.items():
                    cp = getattr(m, "_from_collection_prefix", None)
                    cpost = getattr(m, "_from_collection_postfix", None)
                    if duplicates:
                        # strip the nested collection's own affixes from the module
                        # name so they are not applied twice below
                        stripped_k = k
                        if cp:
                            stripped_k = stripped_k.replace(cp, "")
                        if cpost:
                            stripped_k = stripped_k.replace(cpost, "")
                        key = f"{stripped_k}_{key}"
                    if cp:
                        key = f"{cp}{key}"
                    if cpost:
                        key = f"{key}{cpost}"
                    flattened_results[key] = v
            else:
                flattened_results[k] = res
        return {self._set_name(k): v for k, v in flattened_results.items()}

    # ------------------------------------------------------------- pure projections

    def init_state(self) -> Dict[str, Any]:
        """A fresh state per compute-group leader, keyed by the leader's name.

        The groups are static, so the collection's whole state is one state dict per
        leader; members compute from their leader's state at ``pure_compute``.
        """
        return {members[0]: self._modules[members[0]].init_state() for members in self._groups.values()}

    def pure_update(self, states: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """The pure transition of every group leader."""
        out: Dict[str, Any] = {}
        for members in self._groups.values():
            leader = self._modules[members[0]]
            out[members[0]] = leader.pure_update(states[members[0]], *args, **leader._filter_kwargs(**kwargs))
        return out

    def sync_state(self, states: Dict[str, Any], process_group: Optional[Any] = None) -> Dict[str, Any]:
        """Sync every leader's state across processes (one sync per group)."""
        return {
            name: self._modules[name].sync_state(state, process_group=process_group)
            for name, state in states.items()
        }

    def pure_compute(self, states: Dict[str, Any]) -> Dict[str, Any]:
        """Every metric's value from the leaders' states (the flat result dict)."""
        result: Dict[str, Any] = {}
        for members in self._groups.values():
            leader_state = states[members[0]]
            for name in members:
                result[name] = self._modules[name].pure_compute(leader_state)
        return self._flatten_result_dict({k: result[k] for k in self._modules})

    def _compute_groupwise(self) -> Dict[str, Any]:
        """Compute every metric, syncing each group's shared state once.

        The leader syncs; every member computes from the leader's synced state with its
        own sync off; then the leader unsyncs and the members get the local state back.
        """
        result: Dict[str, Any] = {}
        for members in self._groups.values():
            m0 = self._modules[members[0]]
            if len(members) == 1:
                result[members[0]] = m0.compute()
                continue
            m0.sync(dist_sync_fn=m0.dist_sync_fn, should_sync=m0._to_sync)
            synced = m0._is_synced
            try:
                self._sync_group_states()  # members see the leader's (synced) state
                for name in members:
                    mi = self._modules[name]
                    saved = mi._to_sync, mi._should_unsync
                    # the leader stays synced until every member has computed
                    mi._to_sync, mi._should_unsync = False, False
                    try:
                        result[name] = mi.compute()
                    finally:
                        mi._to_sync, mi._should_unsync = saved
            finally:
                if m0._is_synced:
                    m0.unsync()
                if synced:
                    self._sync_group_states()  # members hold the local state again
        return {k: result[k] for k in self._modules}

    def _group_leaders_only_forward(self, name: str) -> bool:
        """Whether ``name``'s batch value can come from its leader's batch state.

        Only for reduce-state metrics: with ``full_state_update`` or
        ``dist_sync_on_step`` the batch value depends on more than the batch state, so
        such members run their own ``forward``.
        """
        for members in self._groups.values():
            if len(members) > 1 and name in members[1:]:
                m = self._modules[name]
                return not (m.full_state_update or m.full_state_update is None or m.dist_sync_on_step)
        return False

    def _fill_group_member_forward(self, result: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Batch values of the members that skipped ``forward``: each member's
        ``compute`` on its group's batch-only state, one leader ``pure_update`` on a
        fresh state per group."""
        ordered: Dict[str, Any] = {}
        batch_states: Dict[int, Any] = {}
        group_of = {name: gid for gid, members in self._groups.items() for name in members}
        for k in self._modules:
            if k in result:
                ordered[k] = result[k]
                continue
            gid = group_of[k]
            if gid not in batch_states:
                m0 = self._modules[self._groups[gid][0]]
                batch_states[gid] = m0.pure_update(m0.init_state(), *args, **m0._filter_kwargs(**kwargs))
            ordered[k] = _squeeze_if_scalar(self._modules[k].pure_compute(batch_states[gid]))
        return ordered

    def _memory_children(self) -> List[Tuple[str, Metric]]:
        """Member metrics, for state-memory accounting (``obs/memory.py``).

        Compute-group members alias their leader's state tensors; the accounting
        dedups shared buffers by identity, so a collection's ``unique_bytes`` reflects
        what the grouping actually saves.
        """
        return list(self._modules.items())

    def memory_footprint(self) -> Dict[str, Any]:
        """Recursive state-memory footprint of the collection (see ``obs.memory``)."""
        from torchmetrics_tpu_torch.obs import memory as _memory

        return _memory.footprint(self)

    def plot(self, val: Any = None, ax: Any = None, together: bool = False) -> Any:
        """Plot each metric (or, with ``together``, all of them on one axis)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        if together:
            return plot_single_or_multi_val(val if val is not None else self.compute(), ax=ax)
        vals = val if val is not None else self.compute()
        return [m.plot(vals.get(self._set_name(k)), ax=ax) for k, m in self._modules.items()]

    # ------------------------------------------------------------------- dict protocol

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_ordered_dict(self) -> "OrderedDict[str, Metric]":
        od: "OrderedDict[str, Metric]" = OrderedDict()
        for k, v in self._modules.items():
            od[self._set_name(k)] = v
        return od

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._modules)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._to_renamed_ordered_dict()

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        """Keys, with prefix and postfix applied unless ``keep_base``."""
        if keep_base:
            return self._modules.keys()
        return self._to_renamed_ordered_dict().keys()

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        """(key, metric) pairs. ``copy_state`` is accepted as the JAX package accepts it
        and ignored: no state is written in place, so sharing is safe."""
        if keep_base:
            return self._modules.items()
        return self._to_renamed_ordered_dict().items()

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        """The metrics. ``copy_state`` is accepted and ignored, as in :meth:`items`."""
        return self._modules.values()

    def __getitem__(self, key: str, copy_state: bool = True) -> Metric:
        if self.prefix and key.startswith(self.prefix):
            key = key[len(self.prefix):]
        if self.postfix and key.endswith(self.postfix):
            key = key[: -len(self.postfix)]
        return self._modules[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        if not isinstance(value, Metric):
            raise ValueError(f"Value {value} is not an instance of `Metric`")
        self._modules[key] = value
        self._init_compute_groups()

    # ---------------------------------------------------------------------- lifecycle

    def reset(self) -> None:
        """Reset every metric."""
        for m in self._modules.values():
            m.reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """Deep copy, optionally with another prefix or postfix."""
        mc = deepcopy(self)
        if prefix is not None:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix is not None:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        """Toggle state persistence on every metric."""
        for m in self._modules.values():
            m.persistent(mode)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "",  # type: ignore[override]
                   persistent_only: bool = True, keep_vars: bool = False) -> Dict[str, Any]:
        """The states of every metric, keyed ``"<metric name>.<state>"`` as the JAX
        package keys them."""
        destination = destination if destination is not None else {}
        for name, m in self._modules.items():
            m.state_dict(destination, prefix=f"{prefix}{name}.", persistent_only=persistent_only)
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:  # type: ignore[override]
        """Restore states saved by :meth:`state_dict`."""
        for name, m in self._modules.items():
            m.load_state_dict(state_dict, prefix=f"{name}.", strict=strict)

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        """Cast the floating states of every metric."""
        for m in self._modules.values():
            m.set_dtype(dst_type)
        self._sync_group_states()
        return self

    def to_device(self, device: Union[str, torch.device]) -> "MetricCollection":
        """Move every metric's states to ``device`` (``.to(device)``)."""
        return self.to(device)

    # ------------------------------------------------------------- engine integration

    def _engine_fusable_leaders(self) -> Tuple[List[str], List[str]]:
        """Partition the compute-group leaders for the streaming engine: fusable leaders
        ride the fused chunk (one replay advances them all), the rest take per-batch
        updates. Members hold their leader's state either way, as in :meth:`update`."""
        fused, eager = [], []
        for members in self._groups.values():
            name = members[0]
            (fused if self._modules[name]._engine_fusable() else eager).append(name)
        return fused, eager

    def _engine_commit(self, new_states: Dict[str, Dict[str, Any]], n_batches: int) -> None:
        """Install fused-chunk results for the given leaders and bind them to the members.

        Does what ``n_batches`` :meth:`update` calls would have done: every metric's
        compute cache is dropped and every member holds its leader's new state.
        """
        for name, state in new_states.items():
            self._modules[name]._engine_commit_state(state, n_batches)
        for m in self._modules.values():
            m._computed = None
        self._sync_group_states()

    def __repr__(self) -> str:
        repr_str = type(self).__name__ + "("
        if self.prefix:
            repr_str += f"\n  prefix={self.prefix},"
        if self.postfix:
            repr_str += f"\n  postfix={self.postfix},"
        for name, m in self._modules.items():
            repr_str += f"\n  {name}: {type(m).__name__}"
        return repr_str + "\n)"
