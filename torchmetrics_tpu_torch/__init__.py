"""torchmetrics_tpu_torch — the PyTorch/CUDA port of ``torchmetrics_tpu``.

It runs on an NVIDIA H100 (Hopper, ``sm_90a``) with hand-written CUDA kernels for the
confusion matrix, the binned-curve counts, the weighted bincount, the bincount and the
SSIM window moments, and on the CPU with their plain PyTorch versions when a metric
is built with ``device="cpu"``. It imports ``torch`` and numpy, never JAX and never
the JAX package.

It holds the metric runtime, ``MetricCollection`` with static compute groups, and
cross-process sync on ``torch.distributed`` (``parallel``); the capture cache of CUDA
graphs (``core/jit.py``), the error policies and fault injection (``robust``), the
telemetry recorder and batch lineage (``obs``) and the streaming pipeline
(``engine``, imported on its own); the binary and multiclass classification metrics: stat
scores, accuracy, precision and recall, F-beta/F1, confusion matrix, Jaccard index,
Matthews correlation, Cohen's kappa, calibration error, precision-recall curve,
average precision, ROC (functional) and AUROC; and the image-restoration metrics:
SSIM, MS-SSIM, PSNR, PSNR-B, UQI, sliding-window RMSE and total variation.
"""

from torchmetrics_tpu_torch import functional, obs, robust
from torchmetrics_tpu_torch.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.core.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.image import __all__ as _image_all

__version__ = "0.1.0.dev0"

__all__ = [
    "CompositionalMetric", "MaskedBuffer", "Metric", "MetricCollection", "functional", "obs", "robust", *_classification_all,
    *_image_all,
]
