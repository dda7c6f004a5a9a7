"""ONNX graph -> PyTorch: convert parsed graphs to npz+json directories and run them.

Counterpart of ``torchmetrics_tpu/convert/onnx_flax.py``. A converted directory holds
``graph.json`` (nodes, inputs, outputs, name), ``params.npz`` (initializers and
tensor-valued attributes) and a ``MANIFEST.json`` entry of kind ``onnx-flax``: the
JAX package's format, so a directory converted by either package loads in the other.

:class:`OnnxGraph` is an ``nn.Module`` that holds a graph's initializers as buffers and
runs its nodes in ``forward``, over JAX's op table with its attributes and shape
plumbing: an op whose inputs are all host values (numpy arrays: initializers,
``Shape`` outputs, constants) evaluates in numpy, as JAX's executor keeps them
concrete under ``jit``, so reshape targets and axes are known on the host; tensor math
runs in torch on the device of the inputs. An op outside the table raises and names it.

Precision: ``Conv``, ``Gemm`` and ``MatMul`` compute in full float32 without writing a
process-wide flag. A convolution is ``utils.compute._conv2d_full_float32``: an
explicit ``im2col`` (``F.pad`` then ``F.unfold``; none for a 1x1 kernel) and one
grouped product through ``_matmul_full_float32``, so it never reaches cuDNN, whose algorithms may take TF32 under the default
``torch.backends.cudnn.allow_tf32``. As in JAX (64-bit types off), a float64 value on
the device is float32.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.convert.onnx_reader import parse_onnx
from torchmetrics_tpu_torch.utils.compute import _conv2d_full_float32, _matmul_full_float32

Tensor = torch.Tensor

GRAPH_NAME = "graph.json"
PARAMS_NAME = "params.npz"

# ONNX TensorProto data types of ``Cast`` (float64 stays float32 on the device, as in JAX)
_CAST_HOST = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}
_CAST_DEVICE = {1: torch.float32, 6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16,
                11: torch.float32}


def convert_onnx_flax(onnx_path: str, out_dir: str) -> str:
    """Convert an ONNX file to a ``graph.json`` + ``params.npz`` directory (the format
    the JAX package names ``onnx-flax``)."""
    from torchmetrics_tpu_torch.convert import _record_manifest, sha256_file

    graph = parse_onnx(onnx_path)
    os.makedirs(out_dir, exist_ok=True)
    params_path = os.path.join(out_dir, PARAMS_NAME)
    spec = {k: graph[k] for k in ("nodes", "inputs", "outputs", "name")}
    # tensor-valued attributes (Constant nodes) move into the params file
    consts = {}
    for i, node in enumerate(spec["nodes"]):
        for k, v in list(node["attrs"].items()):
            if isinstance(v, np.ndarray):
                key = f"__attr_{i}_{k}"
                consts[key] = v
                node["attrs"][k] = {"__tensor__": key}
    np.savez(params_path, **graph["initializers"], **consts)
    graph_path = os.path.join(out_dir, GRAPH_NAME)
    with open(graph_path, "w") as fh:
        json.dump(spec, fh)
    _record_manifest(
        os.path.join(out_dir, PARAMS_NAME),
        {
            "kind": "onnx-flax",
            "source": os.path.abspath(onnx_path),
            "source_sha256": sha256_file(onnx_path),
            "output_sha256": sha256_file(params_path),
            "ops": sorted({n["op"] for n in spec["nodes"]}),
        },
    )
    return out_dir


def load_onnx_graph(model_dir: str):
    """Load a converted directory -> (spec dict, params dict of numpy arrays)."""
    with open(os.path.join(model_dir, GRAPH_NAME)) as fh:
        spec = json.load(fh)
    with np.load(os.path.join(model_dir, PARAMS_NAME)) as z:
        params = {k: z[k] for k in z.files}
    for node in spec["nodes"]:
        for k, v in list(node["attrs"].items()):
            if isinstance(v, dict) and "__tensor__" in v:
                node["attrs"][k] = params.pop(v["__tensor__"])
    return spec, params


def _all_host(values) -> bool:
    """True when every *present* input is host-concrete (numpy or scalar); ``None``
    entries are absent optional inputs and do not force the device path."""
    return all(v is None or isinstance(v, np.ndarray) or np.isscalar(v) for v in values)


def _device_dtype(arr: np.ndarray) -> Optional[torch.dtype]:
    """The device dtype of a host array: float64 becomes float32 (JAX's 64-bit types off)."""
    return torch.float32 if arr.dtype == np.float64 else None


def _to_host(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, Tensor) else np.asarray(v)


def _padding(attrs: Dict[str, Any], spatial, kernel, strides, dilations):
    """Per spatial dim (begin, end) padding of a convolution, as JAX's executor sets it."""
    rank = len(kernel)
    pads = attrs.get("pads")
    auto_pad = attrs.get("auto_pad") or "NOTSET"
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(rank):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            total = max(0, (-(-spatial[i] // strides[i]) - 1) * strides[i] + eff_k - spatial[i])
            small, big = total // 2, total - total // 2
            out.append((small, big) if auto_pad == "SAME_UPPER" else (big, small))
        return out
    if pads:
        return [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]
    return [(0, 0)] * rank


def _conv(x: Tensor, w: Tensor, b: Optional[Tensor], attrs: Dict[str, Any]) -> Tensor:
    """ONNX ``Conv`` (1-D or 2-D, NCHW/OIHW) as an explicit im2col and one grouped
    full-float32 product."""
    rank = w.ndim - 2
    strides = list(attrs.get("strides") or [1] * rank)
    dilations = list(attrs.get("dilations") or [1] * rank)
    group = int(attrs.get("group") or 1)
    padding = _padding(attrs, x.shape[2:], w.shape[2:], strides, dilations)
    if rank == 1:
        x, w = x[:, :, None, :], w[:, :, None, :]
        strides, dilations, padding = [1, *strides], [1, *dilations], [(0, 0), *padding]
    out = _conv2d_full_float32(x, w, b, strides, padding, dilations, group)
    return out[:, :, 0, :] if rank == 1 else out


def _pool(x: Tensor, attrs: Dict[str, Any], op: str) -> Tensor:
    """ONNX ``MaxPool``/``AveragePool`` (1-D or 2-D) with explicit pads
    ``[d1_begin, d2_begin, d1_end, d2_end]``, as JAX's ``reduce_window``."""
    kernel = list(attrs["kernel_shape"])
    rank = len(kernel)
    pads = attrs.get("pads") or [0] * (2 * rank)
    strides = list(attrs.get("strides") or [1] * rank)
    padding = [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]
    if rank == 1:
        x = x[:, :, None, :]
        kernel, strides, padding = [1, *kernel], [1, *strides], [(0, 0), *padding]
    flat_pad = (padding[1][0], padding[1][1], padding[0][0], padding[0][1])
    if op == "MaxPool":
        out = F.max_pool2d(F.pad(x, flat_pad, value=float("-inf")), kernel, strides)
    else:
        total = F.avg_pool2d(F.pad(x, flat_pad), kernel, strides, divisor_override=1)
        if attrs.get("count_include_pad"):
            out = total / float(np.prod(kernel))
        else:
            ones = F.pad(torch.ones_like(x[:1, :1]), flat_pad)
            out = total / F.avg_pool2d(ones, kernel, strides, divisor_override=1)
    return out[:, :, 0, :] if rank == 1 else out


def _slice(x, ins: List[Any], attrs: Dict[str, Any], host: bool):
    if len(ins) > 1:  # opset >= 10: starts/ends/axes/steps are inputs
        starts = _to_host(ins[1]).tolist()
        ends = _to_host(ins[2]).tolist()
        axes = _to_host(ins[3]).tolist() if len(ins) > 3 and ins[3] is not None else list(range(len(starts)))
        steps = _to_host(ins[4]).tolist() if len(ins) > 4 and ins[4] is not None else [1] * len(starts)
    else:  # opset 1: attributes
        starts = attrs["starts"]
        ends = attrs["ends"]
        axes = attrs.get("axes") or list(range(len(starts)))
        steps = [1] * len(starts)
    slices = [slice(None)] * x.ndim
    for s, e, ax, st in zip(starts, ends, axes, steps):
        dim = x.shape[ax]
        e = min(e, dim) if e >= 0 else e  # ONNX clamps INT64_MAX-style ends
        slices[int(ax)] = slice(int(s), int(e), int(st))
    if host:
        return x[tuple(slices)]
    out = x
    for ax, sl in enumerate(slices):  # torch slices take no negative step: index the axis
        if sl != slice(None):
            index = torch.arange(*sl.indices(out.shape[ax]), device=out.device)
            out = out.index_select(ax, index)
    return out


def _gather(x: Tensor, index: Any, axis: int) -> Tensor:
    """``jnp.take`` along ``axis`` (a negative index counts from the end)."""
    index = torch.as_tensor(index, device=x.device).to(torch.int64)
    axis = axis % x.ndim
    index = torch.where(index < 0, index + x.shape[axis], index)
    out = x.index_select(axis, index.reshape(-1))
    return out.reshape(*x.shape[:axis], *index.shape, *x.shape[axis + 1:])


class OnnxGraph(torch.nn.Module):
    """A converted ONNX graph as a module: initializers are buffers, ``forward`` runs
    the nodes in order and returns the graph's outputs (a list)."""

    def __init__(self, spec: Dict[str, Any], params: Dict[str, np.ndarray], device: Any = "cuda") -> None:
        super().__init__()
        self.spec = spec
        self.input_names = list(spec["inputs"])
        self._host_params = dict(params)
        self._buffer_of: Dict[str, str] = {}
        for i, (name, arr) in enumerate(params.items()):
            arr = np.asarray(arr)
            tensor = torch.as_tensor(arr, device=device)
            dtype = _device_dtype(arr)
            self.register_buffer(f"initializer_{i}", tensor.to(dtype) if dtype else tensor)
            self._buffer_of[name] = f"initializer_{i}"

    @classmethod
    def from_dir(cls, model_dir: str, device: Any = "cuda") -> "OnnxGraph":
        """The module of a converted directory (either package's)."""
        spec, params = load_onnx_graph(model_dir)
        return cls(spec, params, device)

    def _dev(self, name: str, value: Any, device: torch.device) -> Any:
        """The device tensor of an input: its buffer where it is an initializer."""
        if value is None or isinstance(value, Tensor):
            return value
        if name in self._buffer_of:
            return getattr(self, self._buffer_of[name])
        arr = np.asarray(value)
        tensor = torch.as_tensor(arr, device=device)
        dtype = _device_dtype(arr)
        return tensor.to(dtype) if dtype else tensor

    def forward(self, *args: Tensor, op_times: Optional[Dict[str, float]] = None, **inputs: Tensor) -> List[Any]:
        """Run the graph on its inputs (positional in graph order, or by name).

        ``op_times``, where given, gets each op type's milliseconds added: CUDA events
        around each node on the card (read after one synchronise), the host clock on
        the CPU."""
        inputs = {**dict(zip(self.input_names, args)), **inputs}
        device = next((v.device for v in inputs.values() if isinstance(v, Tensor)), None)
        if device is None:
            device = next((b.device for b in self.buffers()), torch.device("cpu"))
        env: Dict[str, Any] = {"": None}
        env.update(self._host_params)
        env.update(inputs)
        timed = [] if op_times is not None else None
        for node in self.spec["nodes"]:
            if timed is not None:
                start = _Stamp(device)
            outs = self._run_node(node, env, device)
            if timed is not None:
                timed.append((node["op"], start, _Stamp(device)))
            env[node["outputs"][0]] = outs
            for extra in node["outputs"][1:]:  # e.g. Dropout's mask output, never consumed here
                env[extra] = None
        if timed is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            for op, start, end in timed:
                op_times[op] = op_times.get(op, 0.0) + start.elapsed_ms(end)
        return [env[name] for name in self.spec["outputs"]]

    def _run_node(self, node: Dict[str, Any], env: Dict[str, Any], device: torch.device) -> Any:
        op = node["op"]
        attrs = node["attrs"]
        names = node["inputs"]
        ins = [env[name] for name in names]
        host = _all_host(ins)
        if host:
            return _run_host(node, ins)

        def dv(i: int) -> Any:
            return self._dev(names[i], ins[i], device) if i < len(ins) else None

        x = dv(0)
        if op == "Relu":
            return torch.clamp(x, min=0)
        if op == "Sigmoid":
            return 1.0 / (1.0 + torch.exp(-x))
        if op == "Tanh":
            return torch.tanh(x)
        if op == "Softmax":
            ax = int(attrs.get("axis", -1))
            e = torch.exp(x - torch.amax(x, dim=ax, keepdim=True))
            return e / torch.sum(e, dim=ax, keepdim=True)
        if op == "LeakyRelu":
            return torch.where(x >= 0, x, x * attrs.get("alpha", 0.01))
        if op == "Exp":
            return torch.exp(x)
        if op == "Sqrt":
            return torch.sqrt(x)
        if op == "Pow":
            return torch.pow(x, dv(1))
        if op == "Clip":
            lo = dv(1) if len(ins) > 1 and ins[1] is not None else attrs.get("min")
            hi = dv(2) if len(ins) > 2 and ins[2] is not None else attrs.get("max")
            if lo is None and hi is None:  # boundless Clip is identity
                return x
            return torch.clamp(x, min=lo, max=hi)
        if op == "Add":
            return x + dv(1)
        if op == "Sub":
            return x - dv(1)
        if op == "Mul":
            return x * dv(1)
        if op == "Div":
            return x / dv(1)
        if op == "MatMul":
            return _matmul_full_float32(x, dv(1))
        if op == "Gemm":
            a, b = x, dv(1)
            c = dv(2) if len(ins) > 2 else None
            alpha, beta = attrs.get("alpha"), attrs.get("beta")
            alpha = 1.0 if alpha is None else alpha  # an explicit 0.0 must stay 0.0
            beta = 1.0 if beta is None else beta
            if attrs.get("transA"):
                a = a.T
            if attrs.get("transB"):
                b = b.T
            out = alpha * _matmul_full_float32(a, b)
            return out + beta * c if c is not None else out
        if op == "Conv":
            return _conv(x, dv(1), dv(2) if len(ins) > 2 else None, attrs)
        if op in ("MaxPool", "AveragePool"):
            if attrs.get("ceil_mode") or (attrs.get("auto_pad") or "NOTSET") not in ("NOTSET", "VALID"):
                raise NotImplementedError(
                    f"ONNX {op} with ceil_mode/auto_pad (node {node['name']!r}) is not"
                    " supported — extend OnnxGraph in torchmetrics_tpu_torch/convert/onnx_torch.py"
                )
            return _pool(x, attrs, op)
        if op == "GlobalAveragePool":
            return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)
        if op == "GlobalMaxPool":
            return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)
        if op == "BatchNormalization":
            scale, bias, mean, var = dv(1), dv(2), dv(3), dv(4)
            eps = attrs.get("epsilon", 1e-5)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            return out * scale.reshape(shape) + bias.reshape(shape)
        if op == "Reshape":
            target = [int(v) for v in _to_host(ins[1]).tolist()]
            target = [x.shape[i] if v == 0 else v for i, v in enumerate(target)]
            return x.reshape(target)
        if op == "Transpose":
            perm = attrs.get("perm") or list(range(x.ndim))[::-1]
            return x.permute(*perm)
        if op == "Flatten":
            ax = int(attrs.get("axis", 1))
            return x.reshape((int(np.prod(x.shape[:ax])) or 1, -1))
        if op == "Squeeze":
            axes = attrs.get("axes") or (_to_host(ins[1]).tolist() if len(ins) > 1 else None)
            return x.squeeze(tuple(int(a) for a in axes)) if axes else x.squeeze()
        if op == "Unsqueeze":
            axes = attrs.get("axes") or _to_host(ins[1]).tolist()
            for a in sorted(int(v) for v in axes):
                x = x.unsqueeze(a)
            return x
        if op == "Concat":
            return torch.cat([dv(i) for i in range(len(ins))], dim=int(attrs.get("axis", 0)))
        if op == "Slice":
            return _slice(x, ins, attrs, host=False)
        if op == "Gather":
            return _gather(x, ins[1], int(attrs.get("axis", 0)))
        if op == "Shape":
            return np.asarray(x.shape, dtype=np.int64)
        if op == "Cast":
            return x.to(_CAST_DEVICE.get(int(attrs["to"]), torch.float32))
        if op == "ReduceMean":
            axes = attrs.get("axes")
            dims = tuple(int(a) for a in axes) if axes else tuple(range(x.ndim))
            return torch.mean(x, dim=dims, keepdim=bool(attrs.get("keepdims", 1)))
        if op == "Pad":
            mode = attrs.get("mode") or "constant"
            if mode != "constant":
                raise NotImplementedError(
                    f"ONNX Pad mode {mode!r} (node {node['name']!r}) is not supported"
                    " — extend OnnxGraph in torchmetrics_tpu_torch/convert/onnx_torch.py"
                )
            pads = attrs.get("pads") or _to_host(ins[1]).tolist()
            fill = attrs.get("value", 0.0)
            if len(ins) > 2 and ins[2] is not None:
                fill = float(_to_host(ins[2]).reshape(-1)[0])
            rank = x.ndim
            flat = []
            for i in reversed(range(rank)):
                flat += [int(pads[i]), int(pads[i + rank])]
            return F.pad(x, flat, value=fill)
        if op in ("Identity", "Dropout"):
            return x
        if op == "Expand":
            return torch.broadcast_to(x, [int(v) for v in _to_host(ins[1]).tolist()])
        if op in ("Constant", "ConstantOfShape"):
            return _run_host(node, ins)
        raise NotImplementedError(
            f"ONNX op {op!r} (node {node['name']!r}) is not in the converter's op"
            " table — extend OnnxGraph in torchmetrics_tpu_torch/convert/onnx_torch.py"
        )


class _Stamp:
    """A point in time on the device's stream (a CUDA event) or the host clock."""

    def __init__(self, device: torch.device) -> None:
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.t = time.perf_counter()

    def elapsed_ms(self, end: "_Stamp") -> float:
        if self.event is not None:
            return self.event.elapsed_time(end.event)
        return (end.t - self.t) * 1e3


def _run_host(node: Dict[str, Any], ins: List[Any]) -> Any:
    """A node whose inputs are all host values, in numpy (JAX's host path)."""
    op = node["op"]
    attrs = node["attrs"]
    x = ins[0] if ins else None
    if op == "Relu":
        return np.maximum(x, 0)
    if op == "Sigmoid":
        return 1.0 / (1.0 + np.exp(-x))
    if op == "Tanh":
        return np.tanh(x)
    if op == "Softmax":
        ax = int(attrs.get("axis", -1))
        e = np.exp(x - np.max(x, axis=ax, keepdims=True))
        return e / np.sum(e, axis=ax, keepdims=True)
    if op == "LeakyRelu":
        return np.where(x >= 0, x, x * attrs.get("alpha", 0.01))
    if op == "Exp":
        return np.exp(x)
    if op == "Sqrt":
        return np.sqrt(x)
    if op == "Pow":
        return x ** ins[1]
    if op == "Clip":
        lo = ins[1] if len(ins) > 1 and ins[1] is not None else attrs.get("min")
        hi = ins[2] if len(ins) > 2 and ins[2] is not None else attrs.get("max")
        return x if lo is None and hi is None else np.clip(x, lo, hi)
    if op == "Add":
        return x + ins[1]
    if op == "Sub":
        return x - ins[1]
    if op == "Mul":
        return x * ins[1]
    if op == "Div":
        return x / ins[1]
    if op == "MatMul":
        return x @ ins[1]
    if op == "Reshape":
        target = [int(v) for v in np.asarray(ins[1]).tolist()]
        target = [x.shape[i] if v == 0 else v for i, v in enumerate(target)]
        return x.reshape(target)
    if op == "Transpose":
        perm = attrs.get("perm") or list(range(x.ndim))[::-1]
        return np.transpose(x, perm)
    if op == "Flatten":
        ax = int(attrs.get("axis", 1))
        return x.reshape((int(np.prod(x.shape[:ax])) or 1, -1))
    if op == "Squeeze":
        axes = attrs.get("axes") or (np.asarray(ins[1]).tolist() if len(ins) > 1 else None)
        return np.squeeze(x, axis=tuple(int(a) for a in axes) if axes else None)
    if op == "Unsqueeze":
        axes = attrs.get("axes") or np.asarray(ins[1]).tolist()
        for a in sorted(int(v) for v in axes):
            x = np.expand_dims(x, a)
        return x
    if op == "Concat":
        return np.concatenate(ins, axis=int(attrs.get("axis", 0)))
    if op == "Slice":
        return _slice(x, ins, attrs, host=True)
    if op == "Gather":
        return np.take(x, np.asarray(ins[1]), axis=int(attrs.get("axis", 0)))
    if op == "Shape":
        return np.asarray(x.shape, dtype=np.int64)
    if op == "Cast":
        return x.astype(_CAST_HOST.get(int(attrs["to"]), np.float32))
    if op == "ReduceMean":
        axes = attrs.get("axes")
        return np.mean(x, axis=tuple(int(a) for a in axes) if axes else None, keepdims=bool(attrs.get("keepdims", 1)))
    if op in ("Identity", "Dropout"):
        return x
    if op == "Constant":
        return np.asarray(attrs.get("value"))
    if op == "ConstantOfShape":
        val = attrs.get("value")
        fill = float(np.asarray(val).reshape(-1)[0]) if val is not None else 0.0
        return np.full([int(v) for v in np.asarray(x).tolist()], fill, dtype=np.float32)
    if op == "Expand":
        return np.broadcast_to(x, [int(v) for v in np.asarray(ins[1]).tolist()])
    if op == "Pad":
        mode = attrs.get("mode") or "constant"
        if mode != "constant":
            raise NotImplementedError(
                f"ONNX Pad mode {mode!r} (node {node['name']!r}) is not supported"
                " — extend OnnxGraph in torchmetrics_tpu_torch/convert/onnx_torch.py"
            )
        pads = attrs.get("pads") or np.asarray(ins[1]).tolist()
        fill = attrs.get("value", 0.0)
        if len(ins) > 2 and ins[2] is not None:
            fill = float(np.asarray(ins[2]).reshape(-1)[0])
        rank = x.ndim
        return np.pad(x, [(int(pads[i]), int(pads[i + rank])) for i in range(rank)], constant_values=fill)
    if op == "BatchNormalization":
        scale, bias, mean, var = ins[1], ins[2], ins[3], ins[4]
        eps = attrs.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        out = (x - mean.reshape(shape)) / np.sqrt(var.reshape(shape) + eps)
        return out * scale.reshape(shape) + bias.reshape(shape)
    if op == "Gemm":
        a, b = x, ins[1]
        c = ins[2] if len(ins) > 2 else None
        alpha, beta = attrs.get("alpha"), attrs.get("beta")
        alpha = 1.0 if alpha is None else alpha
        beta = 1.0 if beta is None else beta
        if attrs.get("transA"):
            a = a.T
        if attrs.get("transB"):
            b = b.T
        out = alpha * (a @ b)
        return out + beta * c if c is not None else out
    if op in ("Conv", "MaxPool", "AveragePool", "GlobalAveragePool", "GlobalMaxPool"):
        # a window op over host values (weights only): the same torch op on the CPU
        return _run_on_cpu(node, ins)
    raise NotImplementedError(
        f"ONNX op {op!r} (node {node['name']!r}) is not in the converter's op"
        " table — extend OnnxGraph in torchmetrics_tpu_torch/convert/onnx_torch.py"
    )


def _run_on_cpu(node: Dict[str, Any], ins: List[Any]) -> np.ndarray:
    graph = OnnxGraph({"nodes": [], "inputs": [], "outputs": []}, {}, device="cpu")
    env = {f"in{i}": (None if v is None else torch.as_tensor(np.asarray(v))) for i, v in enumerate(ins)}
    return graph._run_node({**node, "inputs": list(env)}, env, torch.device("cpu")).numpy()


def run_graph(
    spec: Dict[str, Any], params: Dict[str, np.ndarray], inputs: Dict[str, Any], device: Any = None
) -> List[Any]:
    """Execute the graph on ``inputs`` (tensors) on their device; returns the list of
    graph outputs (JAX's ``run_graph``)."""
    if device is None:
        device = next((v.device for v in inputs.values() if isinstance(v, Tensor)), torch.device("cpu"))
    return OnnxGraph(spec, params, device)(**inputs)
