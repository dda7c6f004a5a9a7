"""Metric runtime of the PyTorch port."""

from torchmetrics_tpu_torch.core.metric import CompositionalMetric, Metric

__all__ = ["CompositionalMetric", "Metric"]
