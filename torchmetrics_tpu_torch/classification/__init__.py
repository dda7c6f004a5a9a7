"""Classification metric classes of the port (binary and multiclass)."""

from torchmetrics_tpu_torch.classification.accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy
from torchmetrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
)
from torchmetrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
)
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from torchmetrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, StatScores

__all__ = [
    "AUROC",
    "Accuracy",
    "BinaryAUROC",
    "BinaryAccuracy",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryPrecisionRecallCurve",
    "BinaryStatScores",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
    "PrecisionRecallCurve",
    "StatScores",
]
