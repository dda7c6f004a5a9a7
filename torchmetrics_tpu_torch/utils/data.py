"""Tensor utilities: dim-zero concatenation, dict flattening, one-hot, top-k selection,
safe division.

Counterpart of ``torchmetrics_tpu/utils/data.py``. The JAX package's ``first_argmax``
works around a slow minor-axis reduce of XLA on the CPU; here it is ``torch.argmax``,
which also returns the first maximum on ties. ``_bincount`` counts with the
hand-written bincount kernel on the card at every size: the JAX package's size gate
is a TPU VMEM budget and has no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.ops import kernels

Tensor = torch.Tensor


def dim_zero_cat(x: Union[Tensor, List[Tensor], tuple]) -> Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, Tensor):
        return x
    if not isinstance(x, (list, tuple)):
        raise ValueError("`dim_zero_cat` expects a tensor or a list of tensors")
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(v) for v in x], dim=0)


def _flatten_dict(x: dict) -> tuple[dict, bool]:
    """Flatten a dict of dicts one level; returns (flat, whether a key came twice)."""
    new_dict = {}
    duplicates = False
    for key, value in x.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k in new_dict:
                    duplicates = True
                new_dict[k] = v
        else:
            if key in new_dict:
                duplicates = True
            new_dict[key] = value
    return new_dict, duplicates


def first_argmax(x: Tensor, dim: int = -1) -> Tensor:
    """Index of the first maximum along ``dim``."""
    return torch.argmax(x, dim=dim)


def one_hot(x: Tensor, num_classes: int, dim: int = -1, dtype: torch.dtype = torch.int32) -> Tensor:
    """One-hot encoding along a new axis ``dim``.

    Like ``jax.nn.one_hot`` an index outside ``[0, num_classes)``, negative ones
    included, gives an all-zero row (``torch.nn.functional.one_hot`` raises instead).
    """
    if dim < 0:
        dim += x.ndim + 1
    classes = torch.arange(num_classes, device=x.device).view((-1,) + (1,) * (x.ndim - dim))
    return (x.unsqueeze(dim) == classes).to(dtype)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Int32 mask of the ``topk`` highest entries along ``dim``."""
    if topk == 1:  # argmax keeps the first maximum on ties
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    mask = torch.zeros_like(prob_tensor, dtype=torch.int32)
    return mask.scatter_(dim, idx, 1)


def safe_divide(num: Tensor, denom: Tensor, zero_division: float = 0.0) -> Tensor:
    """Elementwise division returning ``zero_division`` where ``denom == 0``."""
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom, device=num.device)
    dtype = num.dtype if num.is_floating_point() else torch.float32
    num = num.to(dtype)
    denom = denom.to(dtype)
    zero_mask = denom == 0
    out = num / torch.where(zero_mask, torch.ones_like(denom), denom)
    return torch.where(zero_mask, torch.full_like(out, zero_division), out)


def _bincount(x: Tensor, minlength: Optional[int] = None) -> Tensor:
    """int32 [minlength] counts of each value of the int tensor ``x``; values outside
    ``[0, minlength)`` count nowhere."""
    if minlength is None:
        raise ValueError("`minlength` must be given")
    return kernels.bincount(x.reshape(-1), None, minlength)


def _flexible_bincount(x: Tensor) -> Tensor:
    """Counts of each observed value of ``x``, in ascending order of the values.

    Eager by nature: the output length (the number of distinct values) and the bin
    range depend on the data, so it synchronises with the host for both.
    """
    x = x - x.min()
    unique_ids = torch.unique(x)
    return _bincount(x, minlength=int(x.max()) + 1)[unique_ids]


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """Linear interpolation on an ascending ``xp``, the arithmetic of ``jnp.interp``."""
    xp = xp.contiguous()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # the threshold under which jnp.interp treats a segment as flat
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
