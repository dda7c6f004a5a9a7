"""State reductions of the PyTorch port (cross-process sync arrives with ``parallel/sync.py``)."""

from torchmetrics_tpu_torch.parallel.reductions import Reduction, merge_states

__all__ = ["Reduction", "merge_states"]
