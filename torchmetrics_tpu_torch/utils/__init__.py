"""Utilities of the PyTorch port."""

from torchmetrics_tpu_torch.utils.data import dim_zero_cat, first_argmax, safe_divide, select_topk
from torchmetrics_tpu_torch.utils.enums import ClassificationTask, ClassificationTaskNoMultilabel
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "ClassificationTask",
    "ClassificationTaskNoMultilabel",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "dim_zero_cat",
    "first_argmax",
    "rank_zero_warn",
    "safe_divide",
    "select_topk",
]
