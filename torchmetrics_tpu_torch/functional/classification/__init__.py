"""Functional classification metrics of the port (binary and multiclass)."""

from torchmetrics_tpu_torch.functional.classification.accuracy import accuracy, binary_accuracy, multiclass_accuracy
from torchmetrics_tpu_torch.functional.classification.auroc import auroc, binary_auroc, multiclass_auroc
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
)
from torchmetrics_tpu_torch.functional.classification.f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    f1_score,
    fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    precision_recall_curve,
)
from torchmetrics_tpu_torch.functional.classification.roc import binary_roc, multiclass_roc, roc
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    multiclass_stat_scores,
    stat_scores,
)

__all__ = [
    "accuracy",
    "auroc",
    "binary_accuracy",
    "binary_auroc",
    "binary_confusion_matrix",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_precision_recall_curve",
    "binary_roc",
    "binary_stat_scores",
    "confusion_matrix",
    "f1_score",
    "fbeta_score",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision_recall_curve",
    "multiclass_roc",
    "multiclass_stat_scores",
    "precision_recall_curve",
    "roc",
    "stat_scores",
]
