"""Carry a JAX metric's accumulated state into the port.

A metric of the JAX package that has seen some batches gives its states with
``state_dict()`` (numpy arrays, lists of arrays for "cat" states). ``jax_state_to_torch``
turns that dict into the port's state tensors on a device, keeping keys and dtypes
(int32 counts, float32 values), and ``load_jax_state`` loads it into the port's
counterpart, which then goes on from there. Nothing here imports JAX: the dict holds
plain numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.utils.checks import _resolve_device

# the JAX package's error-policy counters, a plane the port has not taken over yet
_ROBUST_STATE_KEY = "__robust__"


def _to_tensor(value: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(device)


def jax_state_to_torch(
    state_dict: Mapping[str, Any], device: Union[str, torch.device] = "cuda"
) -> Dict[str, Any]:
    """The port's state tensors on ``device`` from a JAX metric's ``state_dict()``."""
    device = _resolve_device(device)
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        if key.endswith(_ROBUST_STATE_KEY):
            continue
        if isinstance(value, dict):
            raise ValueError(f"State {key!r} is a MaskedBuffer, which the port does not hold yet")
        if isinstance(value, list):
            out[key] = [_to_tensor(v, device) for v in value]
        else:
            out[key] = _to_tensor(value, device)
    return out


def load_jax_state(metric: Metric, state_dict: Mapping[str, Any], strict: bool = True) -> Metric:
    """Load a JAX metric's ``state_dict()`` into its port counterpart ``metric``."""
    metric.load_state_dict(jax_state_to_torch(state_dict, metric.device), strict=strict)
    return metric
