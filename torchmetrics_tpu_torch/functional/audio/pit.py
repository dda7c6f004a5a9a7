"""Permutation-invariant training (PIT).

Counterpart of ``torchmetrics_tpu/functional/audio/pit.py``. The exhaustive search is
one gather over the table of every speaker permutation, cached on the host and per
device, then a mean and an arg-max. For three or more speakers scipy's
``linear_sum_assignment`` runs on the host, as in the JAX package, except while a CUDA
graph capture records (``jit_update=True``): a capture must never read back to the
host, so it takes the exhaustive search, as JAX does under a tracer.
"""

from __future__ import annotations

from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _is_traced

Tensor = torch.Tensor

_ps_dict: Dict[int, np.ndarray] = {}  # spk_num -> int32 permutation table
_ps_device: Dict[Tuple[int, torch.device], Tensor] = {}  # (spk_num, device) -> its copy there
# the most speakers whose table the eager Hungarian path also puts on the card, for a
# later capture of the same update (8! rows of 8 int32)
_CAPTURED_SPEAKERS = 8


def _gen_permutations(spk_num: int, device: torch.device) -> Tensor:
    """Every permutation of ``spk_num`` speakers, ``[spk_num!, spk_num]`` int32 on
    ``device``; the copy there is made at the first call outside a capture."""
    if spk_num not in _ps_dict:
        _ps_dict[spk_num] = np.asarray(list(permutations(range(spk_num))), dtype=np.int32)
    key = (spk_num, torch.device(device))
    if key not in _ps_device:
        _ps_device[key] = torch.from_numpy(_ps_dict[spk_num]).to(device)
    return _ps_device[key]


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Hungarian assignment on the host (scipy) for larger speaker counts."""
    from scipy.optimize import linear_sum_assignment

    mmtx = metric_mtx.detach().cpu().numpy()
    best_perm = torch.from_numpy(
        np.stack([linear_sum_assignment(pwm, eval_func == "max")[1] for pwm in mmtx]).astype(np.int32)
    ).to(metric_mtx.device)
    best_metric = torch.gather(metric_mtx, 2, best_perm[:, :, None].long()).mean(dim=(-1, -2))
    return best_metric, best_perm


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Gather of every permutation's pairs, their mean and the best one."""
    batch_size, spk_num = metric_mtx.shape[:2]
    ps = _gen_permutations(spk_num, metric_mtx.device)  # [perm_num, spk_num]
    perm_num = ps.shape[0]
    bps = ps.T[None].expand(batch_size, spk_num, perm_num).long()
    metric_of_ps = torch.gather(metric_mtx, 2, bps).mean(dim=1)  # [batch, perm_num]
    best_metric, best_indexes = _best_of(metric_of_ps, eval_func)
    return best_metric, ps[best_indexes]


def _best_of(metric_of_ps: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """The best value of each row and the index of its first occurrence."""
    if eval_func == "max":
        return torch.max(metric_of_ps, dim=1)
    return torch.min(metric_of_ps, dim=1)


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """Compute a metric under the best speaker permutation per sample.

    Returns the best metric ``[batch]`` and the permutation ``[batch, spk]`` (int32)
    that maps each target position to its prediction index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import (
        ...     permutation_invariant_training, scale_invariant_signal_distortion_ratio)
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(4, 2, 100, generator=g), torch.randn(4, 2, 100, generator=g)
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio)
        >>> best_perm.shape
        torch.Size([4, 2])
    """
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target).to(preds.device)
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )
    batch_size, spk_num = target.shape[0:2]

    if mode == "permutation-wise":
        perms = _gen_permutations(spk_num, preds.device)  # [perm_num, spk_num]
        perm_num = perms.shape[0]
        ppreds = torch.index_select(preds, 1, perms.reshape(-1).long()).reshape(
            batch_size * perm_num, *preds.shape[1:]
        )
        ptarget = torch.repeat_interleave(target, repeats=perm_num, dim=0)
        metric_of_ps = metric_func(ppreds, ptarget, **kwargs)
        metric_of_ps = torch.mean(metric_of_ps.reshape(batch_size, perm_num, -1), dim=-1)
        best_metric, best_indexes = _best_of(metric_of_ps, eval_func)
        return best_metric, perms[best_indexes]

    # speaker-wise: the pairwise metric matrix [batch, spk_target, spk_preds], target
    # rows, so that the permutation maps a target position to a prediction index
    metric_mtx = torch.stack(
        [
            torch.stack([metric_func(preds[:, e, ...], target[:, t, ...], **kwargs) for e in range(spk_num)], dim=-1)
            for t in range(spk_num)
        ],
        dim=1,
    )

    # the Hungarian path reads the matrix on the host: a capture takes the exhaustive
    # search whatever the speaker count
    if spk_num < 3 or _is_traced(metric_mtx):
        return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)
    if metric_mtx.is_cuda and spk_num <= _CAPTURED_SPEAKERS:
        # a capture of this update (its warm run is this call) cannot copy the table from
        # the host: it is put on the card here
        _gen_permutations(spk_num, metric_mtx.device)
    try:
        return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_func)
    except ModuleNotFoundError:
        return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder speaker estimates by the PIT-optimal permutations.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import pit_permutate
        >>> preds = torch.arange(4.0).reshape(2, 2)
        >>> perm = torch.tensor([[1, 0], [0, 1]])
        >>> pit_permutate(preds[:, :, None], perm)[:, :, 0]
        tensor([[1., 0.],
                [2., 3.]])
    """
    preds = torch.as_tensor(preds)
    perm = torch.as_tensor(perm, device=preds.device).long()
    index = perm[(...,) + (None,) * (preds.ndim - 2)].expand(*perm.shape, *preds.shape[2:])
    return torch.gather(preds, 1, index)
