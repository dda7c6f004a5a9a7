"""State reductions and cross-process sync of metric states on ``torch.distributed``."""

from torchmetrics_tpu_torch.parallel.reductions import Reduction, merge_states
from torchmetrics_tpu_torch.parallel.sync import (
    allgather_host_payloads,
    allgather_ragged_arrays,
    distributed_available,
    gather_all_tensors,
    pad_dim0,
    sync_state,
    world_size,
)

__all__ = [
    "Reduction",
    "merge_states",
    "allgather_host_payloads",
    "allgather_ragged_arrays",
    "distributed_available",
    "gather_all_tensors",
    "pad_dim0",
    "sync_state",
    "world_size",
]
