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


def _sort_key(x: Tensor) -> Tensor:
    """Integer keys that order floats as XLA's sort comparator does: ``-0.0`` as
    ``0.0``, every NaN as one NaN after ``+inf``. The bits of a non-negative float order
    as integers; a negative float's are flipped below zero."""
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[x.dtype]
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    key = x.view(bits)
    return torch.where(key < 0, key ^ torch.iinfo(bits).max, key)


def searchsorted_right(xp: Tensor, x: Tensor) -> Tensor:
    """int32 ``jnp.searchsorted(xp, x, side="right")`` on any 1-D ``xp``, sorted or not.

    JAX searches by a bisection of fixed depth: from ``low = 0, high = n`` it runs
    ``ceil(log2(n + 1))`` rounds of ``mid = (low + high) // 2``, each going left iff
    ``x < xp[mid]`` in its sort order, and returns ``high``. On a sorted ``xp`` that is
    every binary search's answer; on an unsorted one (a precision curve) the answer
    depends on the path, and ``torch.searchsorted`` takes another. This repeats JAX's
    path, comparing sort keys: one gather and compare a round, no host sync.
    """
    n = xp.shape[0]
    xp_key, x_key = _sort_key(xp), _sort_key(x)
    low = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    high = torch.full(x.shape, n, dtype=torch.int32, device=x.device)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) >> 1
        go_left = x_key < xp_key[mid.clamp(0, n - 1)]  # clamped as XLA's gather clamps
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp)`` bit for bit, on any 1-D ``xp``: JAX's bracket
    (``searchsorted_right``, also where ``xp`` is not ascending, as a precision curve
    is not), then its arithmetic, with ``fp[0]`` left of ``xp[0]`` and ``fp[-1]`` right
    of ``xp[-1]``."""
    i = torch.clamp(searchsorted_right(xp, x), 1, xp.shape[0] - 1)
    below = i - 1
    fp_below, xp_below = fp[below], xp[below]
    df = fp[i] - fp_below
    dx = xp[i] - xp_below
    delta = x - xp_below
    # the threshold under which jnp.interp treats a segment as flat
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    slope = delta / torch.where(dx0, torch.ones_like(dx), dx)
    # XLA contracts ``fp[i-1] + slope * df`` into one fused multiply-add: the float32
    # product is exact in float64, so the sum rounds there and then to float32
    fused = (fp_below.double() + slope.double() * df.double()).to(fp.dtype)
    f = torch.where(dx0, fp_below, fused)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
