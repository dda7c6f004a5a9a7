"""Cross-process synchronisation of metric states on ``torch.distributed``.

Counterpart of ``torchmetrics_tpu/parallel/sync.py``. The JAX package reduces a state
over a mesh axis inside SPMD (``psum``, ``all_gather``) or, eagerly across hosts, with
``process_allgather`` followed by the reduction. The port has the eager form only, on
a ``torch.distributed`` process group: the caller's ``process_group`` (the default
group when ``None``) stands in for JAX's ``axis_name``.

- Every collective is an ``all_gather``; the reduction then runs over the gathered
  ranks in rank order, as JAX's eager path does. No ``all_reduce``: a float sum keeps
  one order on every rank and in every run, and integer states stay exact.
- Ragged dim-0 states ("cat") first exchange a descriptor (rows, trailing shape,
  dtype), pad to the world's longest, gather and trim. A rank with no rows still
  enters both collectives and takes the world's trailing shape and dtype.
- ``MaskedBuffer`` states gather data and counts and compact the valid prefixes.
- Gloo runs ``all_gather`` on CPU tensors only. A gloo group's collective therefore
  stages a CUDA tensor through host memory and puts the result back on its device
  (``stages_through_host``); NCCL takes CUDA tensors as they are.
- Outside an initialised process group ``sync_state`` returns the state as it is (a
  list state concatenated).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.parallel.reductions import Reduction
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


def distributed_available() -> bool:
    """Whether a ``torch.distributed`` process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world_size(process_group: Optional[Any] = None) -> int:
    """Ranks in ``process_group`` (the default group when ``None``); 1 outside one."""
    return dist.get_world_size(process_group) if distributed_available() else 1


def stages_through_host(tensor: Tensor, process_group: Optional[Any] = None) -> bool:
    """Whether a collective on ``tensor`` goes through host memory: a CUDA tensor in a
    gloo group, whose ``all_gather`` takes CPU tensors only."""
    return tensor.is_cuda and dist.get_backend(process_group) == dist.Backend.GLOO


def _all_gather(x: Tensor, process_group: Optional[Any]) -> Tensor:
    """``[world, *x.shape]``: every rank's ``x``, in rank order (equal shapes on every rank).

    Every collective of this module goes through here. The JAX package routes each
    eager collective through the robust sync guard (timeout, bounded retries, degrade
    to local state) and counts it, with its bytes and seconds, in its trace plane; both
    come to the port with those planes, at this call.
    """
    staged = stages_through_host(x, process_group)
    payload = (x.detach().cpu() if staged else x.detach()).contiguous()
    parts = [torch.empty_like(payload) for _ in range(dist.get_world_size(process_group))]
    dist.all_gather(parts, payload, group=process_group)
    gathered = torch.stack(parts)
    return gathered.to(x.device) if staged else gathered


def _group_device(process_group: Optional[Any] = None) -> torch.device:
    """Where a collective of host data runs: the current card for NCCL, else the CPU."""
    if dist.get_backend(process_group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_host_payloads(payload: bytes, process_group: Optional[Any] = None) -> List[bytes]:
    """Gather one variable-length byte payload from every rank, in rank order.

    Two collectives: an int32 length exchange, then the padded uint8 payloads. One
    process, or no process group, returns ``[payload]`` without a collective.
    """
    if not distributed_available():
        return [bytes(payload)]
    device = _group_device(process_group)
    data = torch.frombuffer(bytearray(payload), dtype=torch.uint8) if payload else torch.zeros(0, dtype=torch.uint8)
    size = torch.tensor([data.numel()], dtype=torch.int32, device=device)
    sizes = _all_gather(size, process_group).reshape(-1).tolist()
    max_size = max(sizes, default=0)
    if max_size == 0:
        # every rank saw the same sizes, so every rank skips the payload collective
        return [b"" for _ in sizes]
    padded = torch.zeros(max_size, dtype=torch.uint8, device=device)
    padded[: data.numel()] = data.to(device)
    gathered = _all_gather(padded, process_group).cpu()
    return [gathered[i, :size].numpy().tobytes() for i, size in enumerate(sizes)]


def pad_dim0(x: Tensor, capacity: int, fill_value: Union[int, float] = 0) -> tuple[Tensor, Tensor]:
    """Pad ``x`` along dim 0 to ``capacity``; returns (padded, validity mask)."""
    n = x.shape[0]
    if n > capacity:
        raise ValueError(f"Cannot pad dim0 of length {n} to smaller capacity {capacity}")
    pad = x.new_full((capacity - n, *x.shape[1:]), fill_value)
    mask = torch.arange(capacity, device=x.device) < n
    return torch.cat((x, pad)), mask


# The ragged gather's descriptor: int32 [n_rows, n_trailing_dims, trail_0..trail_{MAX-1},
# dtype name], so that a rank holding no rows can take the world's trailing shape and
# dtype before the payload collective. The dtype travels as its name ("float32",
# ASCII, zero-padded), as in the JAX package.
_MAX_TRAILING_DIMS = 14  # payload rank <= 15
_DTYPE_NAME_BYTES = 24
_DESC_LEN = 2 + _MAX_TRAILING_DIMS + _DTYPE_NAME_BYTES // 4


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _encode_descriptor(n_rows: int, trail: tuple, dtype: torch.dtype) -> np.ndarray:
    if len(trail) > _MAX_TRAILING_DIMS:
        raise ValueError(
            f"Ragged gather wire format supports rank <= {_MAX_TRAILING_DIMS + 1}, got {len(trail) + 1}"
        )
    name = _dtype_name(dtype).encode("ascii")
    if len(name) > _DTYPE_NAME_BYTES:
        raise ValueError(f"dtype name {name!r} exceeds the {_DTYPE_NAME_BYTES}-byte wire field")
    desc = np.zeros((_DESC_LEN,), dtype=np.int32)
    desc[0] = n_rows
    desc[1] = len(trail)
    desc[2: 2 + len(trail)] = trail
    desc[2 + _MAX_TRAILING_DIMS:] = np.frombuffer(name.ljust(_DTYPE_NAME_BYTES, b"\0"), dtype="<i4")
    return desc


def _decode_descriptor(desc: np.ndarray) -> tuple:
    """Inverse of :func:`_encode_descriptor` -> (n_rows, trail, torch dtype)."""
    n_trail = int(desc[1])
    trail = tuple(int(v) for v in desc[2: 2 + n_trail])
    name = np.asarray(desc[2 + _MAX_TRAILING_DIMS:], dtype="<i4").tobytes().rstrip(b"\0").decode("ascii")
    return int(desc[0]), trail, getattr(torch, name)


def _allgather_ragged_dim0(x: Tensor, process_group: Optional[Any]) -> Tensor:
    """Concatenate every rank's dim-0-ragged tensor, in rank order.

    Ranks exchange descriptors, pad dim 0 to the world's longest, gather and trim each
    rank's rows. A rank with zero rows still enters both collectives and takes the
    world's trailing shape and dtype; ranks with rows must agree on both.
    """
    trail = tuple(x.shape[1:])
    desc = torch.from_numpy(_encode_descriptor(x.shape[0], trail, x.dtype)).to(x.device)
    g_desc = _all_gather(desc, process_group).cpu().numpy()
    sizes = g_desc[:, 0]
    max_size = int(sizes.max()) if sizes.size else 0
    # rows win; with zero rows everywhere, a typed empty tensor (trailing dims or another
    # dtype than the placeholder's) still defines the spec, so every rank leaves with the
    # same empty state
    placeholder = _encode_descriptor(0, (), torch.float32)
    if max_size > 0:
        spec_bearing = g_desc[sizes > 0]
    else:
        spec_bearing = g_desc[(g_desc[:, 1:] != placeholder[1:]).any(axis=1)]
    if len(spec_bearing) == 0:
        return x  # every rank holds the 1-D float32 placeholder: nothing to gather
    ref_desc = spec_bearing[0]
    if not (spec_bearing[:, 1:] == ref_desc[1:]).all():
        raise ValueError(
            "Ragged gather: ranks disagree on trailing shape or dtype: "
            f"{[tuple(int(v) for v in row[1:]) for row in spec_bearing]}"
        )
    _, world_trail, world_dtype = _decode_descriptor(ref_desc)
    if x.shape[0] == 0 and (trail != world_trail or x.dtype != world_dtype):
        x = torch.zeros((0, *world_trail), dtype=world_dtype, device=x.device)  # take the world's spec
    if max_size == 0:
        return x
    padded = torch.cat((x, x.new_zeros((max_size - x.shape[0], *x.shape[1:]))))
    gathered = _all_gather(padded, process_group)  # [world, max, ...]
    return torch.cat([gathered[i, : int(size)] for i, size in enumerate(sizes)])


def allgather_ragged_arrays(
    arrays: List[Tensor],
    ndim: int,
    dtype: torch.dtype = torch.float32,
    process_group: Optional[Any] = None,
) -> List[Tensor]:
    """Gather every rank's list of same-rank, arbitrarily shaped tensors, in rank order.

    Each rank ships a ``[K, ndim]`` shape table and a flat value buffer through the
    ragged gather, then the world's list is split again at each tensor's boundary.
    """
    device = arrays[0].device if arrays else _group_device(process_group)
    shapes = torch.tensor([list(a.shape) for a in arrays], dtype=torch.int32, device=device).reshape(len(arrays), ndim)
    flat = (
        torch.cat([torch.as_tensor(a, dtype=dtype, device=device).reshape(-1) for a in arrays])
        if arrays
        else torch.zeros((0,), dtype=dtype, device=device)
    )
    g_shapes = _allgather_ragged_dim0(shapes, process_group).tolist()
    g_flat = _allgather_ragged_dim0(flat, process_group)
    out: List[Tensor] = []
    offset = 0
    for shape in g_shapes:
        size = int(np.prod(shape))
        out.append(g_flat[offset: offset + size].reshape(tuple(int(s) for s in shape)))
        offset += size
    return out


def _sync_leaf(x: Tensor, reduction: Reduction, process_group: Optional[Any]) -> Tensor:
    """Gather, then reduce over the ranks in rank order."""
    if reduction == Reduction.CAT:
        return _allgather_ragged_dim0(x, process_group)
    if reduction == Reduction.NONE:
        return x
    gathered = _all_gather(x, process_group)  # [world, ...]
    if reduction == Reduction.SUM:
        return gathered.sum(dim=0, dtype=x.dtype)
    if reduction == Reduction.MEAN:
        # an integer state's mean is float32, as jnp.mean gives it
        return gathered.to(x.dtype if x.is_floating_point() else torch.float32).mean(dim=0)
    if reduction == Reduction.MAX:
        return gathered.amax(dim=0)
    if reduction == Reduction.MIN:
        return gathered.amin(dim=0)
    if reduction == Reduction.GATHER:
        return gathered
    raise ValueError(f"Unknown reduction {reduction}")


def sync_state(
    state: Mapping[str, Any],
    reductions: Mapping[str, Reduction],
    process_group: Optional[Any] = None,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Any]:
    """Synchronise a metric-state dict across the ranks of ``process_group``.

    A pure function: it never mutates ``state`` or a tensor in it, so the caller keeps
    its local state. Outside an initialised process group it returns the same values,
    a non-empty list state concatenated, as the JAX package does.

    Args:
        state: state name -> tensor, ``MaskedBuffer`` or list of tensors (a list is
            concatenated along dim 0 before the collective).
        reductions: state name -> :class:`Reduction`.
        process_group: the ``torch.distributed`` group to sync over (the default
            group when ``None``).
        device: where the placeholder of a never-updated list state lives (default:
            the device of the state's first tensor, else the group's).
    """
    available = distributed_available()
    if available and device is None:
        device = _state_device(state, process_group)
    out: Dict[str, Any] = {}
    for name, value in state.items():
        red = Reduction(reductions.get(name, Reduction.NONE))
        if isinstance(value, MaskedBuffer):
            if available:
                data = _all_gather(value.data, process_group)
                counts = _all_gather(torch.tensor(value.count, dtype=torch.int32, device=value.data.device),
                                     process_group)
                value = value.concat_gathered(data, counts.tolist())
            out[name] = value
            continue
        if isinstance(value, list):
            if value:
                value = dim_zero_cat(value)
            elif available:
                # a rank that saw no data still enters the collective, with a zero-length
                # placeholder whose shape and dtype the descriptor exchange corrects
                value = torch.zeros((0,), dtype=torch.float32, device=device)
        out[name] = _sync_leaf(value, red, process_group) if available else value
    return out


def _state_device(state: Mapping[str, Any], process_group: Optional[Any]) -> torch.device:
    for value in state.values():
        if isinstance(value, MaskedBuffer):
            return value.data.device
        if isinstance(value, Tensor):
            return value.device
        if isinstance(value, list) and value:
            return value[0].device
    return _group_device(process_group)


def gather_all_tensors(x: Tensor, process_group: Optional[Any] = None) -> List[Tensor]:
    """Every rank's ``x`` (equal shapes on every rank), in rank order; ``[x]`` outside a
    process group. Ragged data is padded and masked by the caller (:func:`pad_dim0`)."""
    if not distributed_available():
        return [x]
    return list(_all_gather(x, process_group).unbind(0))
