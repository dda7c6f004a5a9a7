"""Stat-scores core: tp/fp/tn/fn counting for binary, multiclass and multilabel tasks.

Counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py``, with the
same decomposition (``_arg_validation`` → ``_tensor_validation`` → ``_format`` →
``_update`` → ``_compute``) and the same three multiclass update paths:

- micro, top_k=1, global: scalar counts from one equality compare;
- samplewise or top_k>1: broadcast-compare one-hots;
- global, top_k=1: the confusion matrix, counted by the hand-written CUDA kernel
  on the card (``ops.kernels.confusion_matrix``).

``ignore_index`` removal is a validity mask, as in the JAX package. Value checks run
eagerly whenever ``validate_args`` is set (the JAX package skips them under jit).
Multilabel counts are plain sums over the thresholded ``[N, L, X]`` inputs, as in
the JAX package. All counting in int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utils.data import first_argmax, one_hot, select_topk
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _maybe_apply_sigmoid(preds: Tensor) -> Tensor:
    """Apply sigmoid iff values fall outside [0, 1] (a select, no host sync)."""
    needs = (preds.min() < 0) | (preds.max() > 1)
    return torch.where(needs, torch.sigmoid(preds), preds)


def _unique_values(x: Tensor) -> set:
    return set(torch.unique(x).tolist())


def _is_traced(*xs: Tensor) -> bool:
    """Whether a CUDA graph capture is recording these tensors' work: the value checks
    (which read values back to the host) are skipped then, as JAX skips them under jit."""
    return any(x.is_cuda for x in xs) and torch.cuda.is_current_stream_capturing()


# --------------------------------------------------------------------------- binary


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "The `preds` and `target` should have the same shape,"
            f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
        )
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")
    if _is_traced(preds, target):
        return
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if not preds.is_floating_point():
        unique_p = _unique_values(preds)
        if not unique_p.issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {sorted(unique_p)} but expected only"
                " the following values [0,1] since preds is a label tensor."
            )


def _binary_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns int ``preds``/``target`` of shape [N, X] plus a validity mask [N, X]."""
    if preds.is_floating_point():
        preds = (_maybe_apply_sigmoid(preds) > threshold).to(torch.int32)
    else:
        preds = preds.to(torch.int32)
    n = preds.shape[0] if preds.ndim > 0 else 1
    preds = preds.reshape(n, -1)
    target = target.reshape(n, -1)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn from formatted [N, X] inputs; scalars (global) or [N] (samplewise)."""
    def _count(x: Tensor) -> Tensor:
        return x.sum(dtype=torch.int32) if multidim_average == "global" else x.sum(dim=1, dtype=torch.int32)

    agree = preds == target
    pos = target == 1
    tp = _count(agree & pos & valid)
    fn = _count(~agree & pos & valid)
    fp = _count(~agree & ~pos & valid)
    tn = _count(agree & ~pos & valid)
    return tp, fp, tn, fn


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    stack = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return stack.squeeze() if multidim_average == "global" else stack


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """[tp, fp, tn, fn, support] for binary classification."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, valid, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# ------------------------------------------------------------------------ multiclass


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not (isinstance(top_k, int) and top_k >= 1):
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                " equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should "
                " at least 3D when multidim_average is set to `samplewise`"
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError(
                "When `preds` and `target` have the same shape, the shape of `preds` should "
                " at least 2D when multidim_average is set to `samplewise`"
            )
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    if _is_traced(preds, target):
        return
    check_value = num_classes if ignore_index is None else num_classes + 1
    to_check = [(target, "target")]
    if not preds.is_floating_point():
        to_check.append((preds, "preds"))
    for t, name in to_check:
        num_unique = len(torch.unique(t))
        if num_unique > check_value:
            raise RuntimeError(
                f"Detected more unique values in `{name}` than expected. Expected only {check_value} but found"
                f" {num_unique} in `{name}`."
            )


def _multiclass_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    top_k: int = 1,
) -> Tuple[Tensor, Tensor]:
    """Argmax score inputs (top_k=1) and flatten extra dims: preds [N,X] or [N,C,X]."""
    if preds.ndim == target.ndim + 1 and top_k == 1:
        preds = first_argmax(preds, dim=1)
    if top_k != 1:
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        preds = preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    return preds, target


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class tp/fp/tn/fn: [C] (global) or [N, C] (samplewise)."""
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target_safe = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)

    if average == "micro" and top_k == 1 and multidim_average == "global":
        # micro fast path: scalar counts from one equality compare, no per-class counts
        agree = (preds == target_safe) & valid
        disagree = (preds != target_safe) & valid
        tp = agree.sum(dtype=torch.int32)
        fp = disagree.sum(dtype=torch.int32)
        fn = fp
        n_valid = valid.sum(dtype=torch.int32)
        tn = num_classes * n_valid - (tp + fp + fn)
        return tp, fp, tn, fn

    if multidim_average == "samplewise" or top_k != 1:
        if top_k > 1:
            preds_oh = select_topk(preds, topk=top_k, dim=1)  # [N, C, X]
        else:
            preds_oh = one_hot(preds, num_classes, dim=1)  # [N, C, X]
        target_oh = one_hot(target_safe, num_classes, dim=1)  # [N, C, X]
        v = valid[:, None, :]
        p = preds_oh == 1
        t = target_oh == 1
        sum_dims = (0, 2) if multidim_average == "global" else (2,)
        tp = (p & t & v).sum(dim=sum_dims, dtype=torch.int32)
        fn = (~p & t & v).sum(dim=sum_dims, dtype=torch.int32)
        fp = (p & ~t & v).sum(dim=sum_dims, dtype=torch.int32)
        tn = (~p & ~t & v).sum(dim=sum_dims, dtype=torch.int32)
        return tp, fp, tn, fn

    # global, top_k == 1: the confusion matrix (the CUDA kernel on the card)
    from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _masked_confmat

    confmat = _masked_confmat(preds.reshape(-1), target_safe.reshape(-1), valid.reshape(-1), num_classes)
    tp = torch.diagonal(confmat)
    fp = confmat.sum(dim=0, dtype=torch.int32) - tp
    fn = confmat.sum(dim=1, dtype=torch.int32) - tp
    tn = confmat.sum(dtype=torch.int32) - (fp + fn + tp)
    return tp, fp, tn, fn


def _multiclass_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return res.sum(dim=-2, dtype=torch.int32) if res.ndim > 1 else res
    return res


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """[tp, fp, tn, fn, support] for multiclass classification."""
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ------------------------------------------------------------------------ multilabel


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    allowed_multidim_average = ("global", "samplewise")
    if multidim_average not in allowed_multidim_average:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {allowed_multidim_average}, but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "The `preds` and `target` should have the same shape,"
            f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
        )
    if preds.ndim < 2 or preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
        )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")
    if _is_traced(preds, target):
        return
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _multilabel_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns int ``preds``/``target`` of shape [N, L, X] plus a validity mask [N, L, X]."""
    if preds.is_floating_point():
        preds = (_maybe_apply_sigmoid(preds) > threshold).to(torch.int32)
    else:
        preds = preds.to(torch.int32)
    preds = preds.reshape(preds.shape[0], num_labels, -1)
    target = target.reshape(target.shape[0], num_labels, -1)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid


def _multilabel_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-label tp/fp/tn/fn: [L] (global) or [N, L] (samplewise)."""
    sum_dims = (0, 2) if multidim_average == "global" else (2,)
    p = preds == 1
    t = target == 1
    tp = (p & t & valid).sum(dim=sum_dims, dtype=torch.int32)
    fn = (~p & t & valid).sum(dim=sum_dims, dtype=torch.int32)
    fp = (p & ~t & valid).sum(dim=sum_dims, dtype=torch.int32)
    tn = (~p & ~t & valid).sum(dim=sum_dims, dtype=torch.int32)
    return tp, fp, tn, fn


def _multilabel_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        return res.sum(dim=-2, dtype=torch.int32) if res.ndim > 1 else res
    return res


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """[tp, fp, tn, fn, support] for multilabel classification."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, valid, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# -------------------------------------------------------------------------- dispatch


def stat_scores(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching stat scores."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_stat_scores(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
