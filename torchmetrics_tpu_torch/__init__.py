"""torchmetrics_tpu_torch — the PyTorch/CUDA port of ``torchmetrics_tpu``.

It runs on an NVIDIA H100 (Hopper, ``sm_90a``) with hand-written CUDA kernels for the
confusion matrix, the binned-curve counts, the weighted bincount and the bincount, and
on the CPU with their plain PyTorch versions when a metric is built with
``device="cpu"``. It imports ``torch`` and numpy, never JAX and never the JAX package.

It holds the metric runtime and the binary and multiclass classification metrics:
stat scores, accuracy, precision and recall, F-beta/F1, confusion matrix, Jaccard
index, Matthews correlation, Cohen's kappa, calibration error, precision-recall curve,
average precision, ROC (functional) and AUROC.
"""

from torchmetrics_tpu_torch import functional
from torchmetrics_tpu_torch.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.core.metric import CompositionalMetric, Metric

__version__ = "0.1.0.dev0"

__all__ = ["CompositionalMetric", "Metric", "functional", *_classification_all]
