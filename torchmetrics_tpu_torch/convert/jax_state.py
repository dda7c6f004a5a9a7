"""Carry a JAX metric's or collection's accumulated state into the port.

A metric of the JAX package that has seen some batches gives its states with
``state_dict()``: numpy arrays, lists of arrays for list states, and a dict of
``data`` and ``count`` for a ``MaskedBuffer``. A JAX ``MetricCollection`` gives the
same, keyed ``"<metric name>.<state>"``. ``jax_state_to_torch`` turns that dict into
the port's state tensors on a device, keeping keys and dtypes (int32 counts, float32
values), and ``load_jax_state`` loads it into the port's counterpart, a ``Metric`` or
a ``MetricCollection``, which then goes on from there. Nothing here imports JAX: the
dict holds plain numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.utils.checks import _resolve_device

# the JAX package's error-policy counters, a plane the port has not taken over yet
_ROBUST_STATE_KEY = "__robust__"


def _to_tensor(value: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(device)


def jax_state_to_torch(
    state_dict: Mapping[str, Any], device: Union[str, torch.device] = "cuda"
) -> Dict[str, Any]:
    """The port's state tensors on ``device`` from a JAX metric's or collection's
    ``state_dict()``; a ``MaskedBuffer`` stays a dict of ``data`` and ``count``."""
    device = _resolve_device(device)
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        if key.endswith(_ROBUST_STATE_KEY):
            continue
        if isinstance(value, dict):
            if set(value) != {"data", "count"}:
                raise ValueError(f"State {key!r} is a dict but not a MaskedBuffer's data and count")
            out[key] = {"data": _to_tensor(value["data"], device), "count": _to_tensor(value["count"], device)}
        elif isinstance(value, list):
            out[key] = [_to_tensor(v, device) for v in value]
        else:
            out[key] = _to_tensor(value, device)
    return out


def load_jax_state(
    target: Union[Metric, MetricCollection], state_dict: Mapping[str, Any], strict: bool = True
) -> Union[Metric, MetricCollection]:
    """Load a JAX ``state_dict()`` into its port counterpart ``target``, a metric or a
    collection (each member takes its states to its own device)."""
    device = target.device if isinstance(target, Metric) else "cpu"
    target.load_state_dict(jax_state_to_torch(state_dict, device), strict=strict)
    return target
