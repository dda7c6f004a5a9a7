"""Fixed-capacity masked append buffer: the static-shape "cat" state.

Counterpart of ``torchmetrics_tpu/core/buffer.py``. A ``MaskedBuffer`` is a
``(capacity, *item)`` tensor plus a count of valid items. An append writes the next
rows out of place and returns a new buffer, so a buffer shared by two metrics (the
members of a compute group) never changes under either. The mask is
``arange < count``; a cross-process sync gathers every rank's buffer and compacts the
valid prefixes, in rank order, with one stable sort.

In eager PyTorch the count is a Python int, always concrete, so an append past the
capacity raises at once (the JAX package can only check after a jitted step).

Inside a captured update (``core/jit.py``, the streaming engine) the count is a 0-d
int64 tensor instead, as JAX's is an array: the write offset then rides into the CUDA
graph as data, not as a constant of the capture. Such an append writes at ``count +
arange(n)``, clamped to the last row (a write past the capacity cannot leave the
buffer), and the host raises on the count read back after the call, before the state
is committed (``Metric._host_buffers``). The tensor count of the last commit is kept
as ``device_count``, so that the next captured call finds it again.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor


class MaskedBuffer:
    """Append-only value buffer with a static capacity and a validity count."""

    def __init__(self, data: Tensor, count: Union[int, Tensor], device_count: Optional[Tensor] = None) -> None:
        self.data = data
        self.count = count if isinstance(count, Tensor) else int(count)
        self.device_count = device_count

    @classmethod
    def create(
        cls,
        capacity: int,
        item_shape: Tuple[int, ...] = (),
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cpu",
    ) -> "MaskedBuffer":
        """An empty buffer of ``capacity`` items of ``item_shape``."""
        return cls(torch.zeros((capacity, *item_shape), dtype=dtype, device=device), 0)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def append(self, batch: Tensor) -> "MaskedBuffer":
        """Append an ``(n, *item)`` batch (or one item); returns a new buffer."""
        batch = torch.as_tensor(batch, dtype=self.data.dtype, device=self.data.device)
        if batch.ndim == self.data.ndim - 1:
            batch = batch[None]
        n = batch.shape[0]
        if isinstance(self.count, Tensor):  # inside a captured update
            rows = (self.count + torch.arange(n, device=self.data.device)).clamp(max=self.capacity - 1)
            return MaskedBuffer(self.data.index_copy(0, rows, batch), self.count + n)
        if self.count + n > self.capacity:
            raise ValueError(
                f"MaskedBuffer overflow: capacity {self.capacity}, have {self.count}, appending {n}."
                " Construct the metric with a larger buffer capacity."
            )
        data = torch.cat((self.data[: self.count], batch, self.data[self.count + n:]))
        return MaskedBuffer(data, self.count + n)

    @property
    def mask(self) -> Tensor:
        """Validity mask over the capacity axis."""
        return torch.arange(self.capacity, device=self.data.device) < self.count

    def values(self) -> Tensor:
        """The valid prefix."""
        return self.data[: self.count]

    def concat_gathered(self, gathered_data: Tensor, gathered_counts: Sequence[int]) -> "MaskedBuffer":
        """Compact per-rank buffers ``[S, cap, *item]`` into one ``[S*cap, *item]`` buffer.

        A stable sort on invalidity moves every rank's valid prefix to the front, in
        rank order.
        """
        num_ranks, cap = gathered_data.shape[:2]
        counts = [int(c) for c in gathered_counts]
        if max(counts, default=0) > cap:
            raise ValueError(
                f"MaskedBuffer rank overflowed before sync: capacity {cap}, per-rank counts {counts}."
                " Construct the metric with a larger buffer capacity."
            )
        flat = gathered_data.reshape((num_ranks * cap,) + tuple(gathered_data.shape[2:]))
        counts_t = torch.tensor(counts, device=gathered_data.device)
        item_valid = (torch.arange(cap, device=gathered_data.device)[None, :] < counts_t[:, None]).reshape(-1)
        order = torch.argsort((~item_valid).to(torch.int8), stable=True)
        return MaskedBuffer(flat[order], sum(counts))

    def map(self, fn: Callable[[Tensor], Tensor]) -> "MaskedBuffer":
        """The same buffer with ``fn`` applied to its data (``.to(device)``, a detach)."""
        return MaskedBuffer(fn(self.data), self.count)

    def traced(self) -> "MaskedBuffer":
        """This buffer with its count as a 0-d int64 tensor on the data's device (the
        last commit's ``device_count`` when it still holds the count)."""
        if isinstance(self.count, Tensor):
            return self
        count = self.device_count
        if count is None:
            count = torch.full((), self.count, dtype=torch.int64, device=self.data.device)
        return MaskedBuffer(self.data, count)

    def __repr__(self) -> str:
        return f"MaskedBuffer(capacity={self.capacity}, count={self.count}, item={tuple(self.data.shape[1:])})"
