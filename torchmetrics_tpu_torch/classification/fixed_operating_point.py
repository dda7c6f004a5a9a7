"""Operating-point module classes: Recall@FixedPrecision, Precision@FixedRecall,
Specificity@Sensitivity, Sensitivity@Specificity.

Counterpart of ``torchmetrics_tpu/classification/fixed_operating_point.py``. Each
subclasses its task's PR-curve class and shares its curve state (and so its compute
group); ``compute`` gives the (value, threshold) pair. The multiclass and multilabel
classes select over a ``[C, T]`` binned curve at once; the JAX package selects class by
class, with the same result.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_state,
)
from torchmetrics_tpu_torch.functional.classification.fixed_operating_point import (
    _best_subject_to,
    _binary_recall_at_fixed_precision_compute,
    _multi_curve_best,
    _spec_at_sens_from_roc,
    _validate_floor,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_compute,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


# ------------------------------------------------------------ recall @ precision


class BinaryRecallAtFixedPrecision(BinaryPrecisionRecallCurve):
    """Highest recall subject to precision >= ``min_precision``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        min_precision: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_floor("min_precision", min_precision)
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best recall, threshold)."""
        return _binary_recall_at_fixed_precision_compute(
            _curve_state(self), self.thresholds, self.min_precision
        )


class MulticlassRecallAtFixedPrecision(MulticlassPrecisionRecallCurve):
    """Per-class highest recall subject to precision >= ``min_precision``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_precision", min_precision)
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best recalls [C], thresholds [C])."""
        precision, recall, thres = _multiclass_precision_recall_curve_compute(
            _curve_state(self), self.num_classes, self.thresholds
        )
        return _multi_curve_best(precision, recall, thres, self.min_precision)


class MultilabelRecallAtFixedPrecision(MultilabelPrecisionRecallCurve):
    """Per-label highest recall subject to precision >= ``min_precision``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        min_precision: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_precision", min_precision)
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best recalls [L], thresholds [L])."""
        precision, recall, thres = _multilabel_precision_recall_curve_compute(
            _curve_state(self), self.num_labels, self.thresholds, self.ignore_index
        )
        return _multi_curve_best(precision, recall, thres, self.min_precision)


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for recall@fixed-precision."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_precision: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryRecallAtFixedPrecision(min_precision, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassRecallAtFixedPrecision(num_classes, min_precision, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelRecallAtFixedPrecision(num_labels, min_precision, **kwargs)
        raise ValueError(f"Task {task} not supported!")


# ------------------------------------------------------------ precision @ recall


class BinaryPrecisionAtFixedRecall(BinaryPrecisionRecallCurve):
    """Highest precision subject to recall >= ``min_recall``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        min_recall: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_floor("min_recall", min_recall)
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best precision, threshold)."""
        precision, recall, thres = _binary_precision_recall_curve_compute(_curve_state(self), self.thresholds)
        return _best_subject_to(precision, recall, self.min_recall, thres)


class MulticlassPrecisionAtFixedRecall(MulticlassPrecisionRecallCurve):
    """Per-class highest precision subject to recall >= ``min_recall``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        min_recall: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_recall", min_recall)
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best precisions [C], thresholds [C])."""
        precision, recall, thres = _multiclass_precision_recall_curve_compute(
            _curve_state(self), self.num_classes, self.thresholds
        )
        return _multi_curve_best(precision, recall, thres, self.min_recall, swap=True)


class MultilabelPrecisionAtFixedRecall(MultilabelPrecisionRecallCurve):
    """Per-label highest precision subject to recall >= ``min_recall``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        min_recall: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_recall", min_recall)
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best precisions [L], thresholds [L])."""
        precision, recall, thres = _multilabel_precision_recall_curve_compute(
            _curve_state(self), self.num_labels, self.thresholds, self.ignore_index
        )
        return _multi_curve_best(precision, recall, thres, self.min_recall, swap=True)


class PrecisionAtFixedRecall(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for precision@fixed-recall."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_recall: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionAtFixedRecall(min_recall, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassPrecisionAtFixedRecall(num_classes, min_recall, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelPrecisionAtFixedRecall(num_labels, min_recall, **kwargs)
        raise ValueError(f"Task {task} not supported!")


# ----------------------------------------------------- specificity @ sensitivity


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """Highest specificity subject to sensitivity >= ``min_sensitivity``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        min_sensitivity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_floor("min_sensitivity", min_sensitivity)
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best specificity, threshold)."""
        fpr, tpr, thres = _binary_roc_compute(_curve_state(self), self.thresholds)
        return _spec_at_sens_from_roc(fpr, tpr, thres, self.min_sensitivity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """Per-class highest specificity subject to sensitivity >= ``min_sensitivity``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        min_sensitivity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_sensitivity", min_sensitivity)
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best specificities [C], thresholds [C])."""
        fpr, tpr, thres = _multiclass_roc_compute(_curve_state(self), self.num_classes, self.thresholds)
        if isinstance(fpr, Tensor) and fpr.ndim == 2:
            return _best_subject_to(1.0 - fpr, tpr, self.min_sensitivity, thres)
        return _multi_curve_best([1.0 - f for f in fpr], tpr, thres, self.min_sensitivity, swap=True)


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """Per-label highest specificity subject to sensitivity >= ``min_sensitivity``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        min_sensitivity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_sensitivity", min_sensitivity)
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best specificities [L], thresholds [L])."""
        fpr, tpr, thres = _multilabel_roc_compute(
            _curve_state(self), self.num_labels, self.thresholds, self.ignore_index
        )
        if isinstance(fpr, Tensor) and fpr.ndim == 2:
            return _best_subject_to(1.0 - fpr, tpr, self.min_sensitivity, thres)
        return _multi_curve_best([1.0 - f for f in fpr], tpr, thres, self.min_sensitivity, swap=True)


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for specificity@sensitivity."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_sensitivity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinarySpecificityAtSensitivity(min_sensitivity, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassSpecificityAtSensitivity(num_classes, min_sensitivity, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelSpecificityAtSensitivity(num_labels, min_sensitivity, **kwargs)
        raise ValueError(f"Task {task} not supported!")


# ----------------------------------------------------- sensitivity @ specificity


class BinarySensitivityAtSpecificity(BinaryPrecisionRecallCurve):
    """Highest sensitivity subject to specificity >= ``min_specificity``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        min_specificity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_floor("min_specificity", min_specificity)
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best sensitivity, threshold)."""
        fpr, tpr, thres = _binary_roc_compute(_curve_state(self), self.thresholds)
        return _best_subject_to(tpr, 1.0 - fpr, self.min_specificity, thres)


class MulticlassSensitivityAtSpecificity(MulticlassPrecisionRecallCurve):
    """Per-class highest sensitivity subject to specificity >= ``min_specificity``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        min_specificity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_specificity", min_specificity)
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best sensitivities [C], thresholds [C])."""
        fpr, tpr, thres = _multiclass_roc_compute(_curve_state(self), self.num_classes, self.thresholds)
        if isinstance(fpr, Tensor) and fpr.ndim == 2:
            return _best_subject_to(tpr, 1.0 - fpr, self.min_specificity, thres)
        return _multi_curve_best(tpr, [1.0 - f for f in fpr], thres, self.min_specificity, swap=True)


class MultilabelSensitivityAtSpecificity(MultilabelPrecisionRecallCurve):
    """Per-label highest sensitivity subject to specificity >= ``min_specificity``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        min_specificity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )
        if validate_args:
            _validate_floor("min_specificity", min_specificity)
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best sensitivities [L], thresholds [L])."""
        fpr, tpr, thres = _multilabel_roc_compute(
            _curve_state(self), self.num_labels, self.thresholds, self.ignore_index
        )
        if isinstance(fpr, Tensor) and fpr.ndim == 2:
            return _best_subject_to(tpr, 1.0 - fpr, self.min_specificity, thres)
        return _multi_curve_best(tpr, [1.0 - f for f in fpr], thres, self.min_specificity, swap=True)


class SensitivityAtSpecificity(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for sensitivity@specificity."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_specificity: float,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinarySensitivityAtSpecificity(min_specificity, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassSensitivityAtSpecificity(num_classes, min_specificity, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelSensitivityAtSpecificity(num_labels, min_specificity, **kwargs)
        raise ValueError(f"Task {task} not supported!")


def _plot_value_only(self, val=None, ax=None):
    """Plot the operating-point *value*, not the (value, threshold) tuple: the
    threshold is an operating point on its own scale, not a metric value."""
    val = val if val is not None else self.compute()[0]
    return self._plot(val, ax)


# These classes inherit the curve plot from the PR-curve state machinery but compute
# (value, threshold) pairs; they plot the value alone, as the JAX package's do.
for _cls in (
    BinaryRecallAtFixedPrecision,
    MulticlassRecallAtFixedPrecision,
    MultilabelRecallAtFixedPrecision,
    BinaryPrecisionAtFixedRecall,
    MulticlassPrecisionAtFixedRecall,
    MultilabelPrecisionAtFixedRecall,
    BinarySpecificityAtSensitivity,
    MulticlassSpecificityAtSensitivity,
    MultilabelSpecificityAtSensitivity,
    BinarySensitivityAtSpecificity,
    MulticlassSensitivityAtSpecificity,
    MultilabelSensitivityAtSpecificity,
):
    _cls.plot = _plot_value_only
del _cls
