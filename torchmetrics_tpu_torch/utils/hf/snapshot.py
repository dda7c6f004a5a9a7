"""A reader of local Hugging Face snapshot directories, with no ``transformers``.

A snapshot is a directory holding ``config.json``, the tokenizer or processor files,
and weights in one of the formats ``transformers`` writes. Weights are read in the
order the JAX package's Flax loader takes them (``transformers``'
``FlaxPreTrainedModel.from_pretrained``): ``flax_model.msgpack`` (or its sharded
index), ``model.safetensors``, ``pytorch_model.bin`` (through
``torch.load(weights_only=True)``), then their sharded indexes. Every format comes back
as one ``{name: tensor}`` dict in the PyTorch layout of ``transformers`` (``Linear``
weights ``[out, in]``, convolutions OIHW); a Flax tree is carried across by
:func:`flax_tree_to_torch`.

``safetensors`` and msgpack are parsed here by hand: safetensors is an 8-byte
little-endian header length, a JSON header and the raw buffers; flax's msgpack is a
map tree whose leaves are extension type 1 (an ndarray: a msgpack array of shape,
dtype name and raw bytes), with arrays above 1 GiB split into ``__msgpack_chunked_array__``
maps. :func:`msgpack_dumps` writes the same format, so a tree written here loads in
flax.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

CONFIG_NAME = "config.json"
FLAX_WEIGHTS_NAME = "flax_model.msgpack"
SAFE_WEIGHTS_NAME = "model.safetensors"
WEIGHTS_NAME = "pytorch_model.bin"
# flax's limit for one msgpack array leaf; larger arrays are chunked
MAX_CHUNK_SIZE = 2**30

_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
    "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def require_local_snapshot(model_name_or_path: str, what: str = "model") -> str:
    """``model_name_or_path`` if it is a local directory, else the JAX package's
    ``OSError``: no hub cache is read and nothing is downloaded."""
    if not (isinstance(model_name_or_path, str) and os.path.isdir(model_name_or_path)):
        raise OSError(
            f"Could not load {what} `{model_name_or_path}` from the local transformers cache and this"
            " environment has no network access. Provide a locally available model path."
        )
    return model_name_or_path


def read_json(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def read_config(model_dir: str) -> Dict[str, Any]:
    """``config.json`` of a snapshot directory."""
    path = os.path.join(model_dir, CONFIG_NAME)
    if not os.path.isfile(path):
        raise OSError(f"`{model_dir}` holds no `{CONFIG_NAME}`.")
    return read_json(path)


# --------------------------------------------------------------------------- msgpack


class _Reader:
    """A cursor over a msgpack buffer that decodes flax's subset of the format."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self, raw: bool = False) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(self.unpack(">b"), {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            return [self.value(raw) for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def string(self, n: int, raw: bool) -> Any:
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code in (1, 3):  # flax's ndarray and numpy scalar
            shape, dtype, buffer = _Reader(payload).value(raw=True)
            dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
            if dtype == "bfloat16":
                raise NotImplementedError("bfloat16 msgpack leaves are not read by the port (save the checkpoint"
                                          " in float32); ROADMAP Queue 1 lists what the port does not read yet.")
            return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape).copy()
        raise ValueError(f"unsupported msgpack extension type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_loads(data: bytes) -> Any:
    """A flax ``serialization.to_bytes`` buffer as a nested dict of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def _pack_len(out: List[bytes], n: int, fix: Optional[int], fix_max: int, codes: Tuple[int, int, int]) -> None:
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
    elif n < 1 << 8 and codes[0]:
        out.append(bytes([codes[0], n]))
    elif n < 1 << 16:
        out.append(bytes([codes[1]]) + struct.pack(">H", n))
    else:
        out.append(bytes([codes[2]]) + struct.pack(">I", n))


def _pack(value: Any, out: List[bytes]) -> None:
    if isinstance(value, dict):
        _pack_len(out, len(value), 0x80, 15, (0, 0xDE, 0xDF))
        for key, item in value.items():
            _pack(key, out)
            _pack(item, out)
    elif isinstance(value, (list, tuple)):
        _pack_len(out, len(value), 0x90, 15, (0, 0xDC, 0xDD))
        for item in value:
            _pack(item, out)
    elif isinstance(value, str):
        data = value.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(value, bytes):
        _pack_len(out, len(value), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(value)
    elif isinstance(value, bool) or value is None:
        out.append(bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[value]]))
    elif isinstance(value, int):
        if 0 <= value <= 0x7F:
            out.append(bytes([value]))
        elif -32 <= value < 0:
            out.append(struct.pack(">b", value))
        elif value >= 0:
            out.append(b"\xcf" + struct.pack(">Q", value))
        else:
            out.append(b"\xd3" + struct.pack(">q", value))
    elif isinstance(value, float):
        out.append(b"\xcb" + struct.pack(">d", value))
    elif isinstance(value, (np.ndarray, np.generic)):
        arr = np.array(value, order="C")
        inner: List[bytes] = []
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], inner)
        payload = b"".join(inner)
        code = 1 if isinstance(value, np.ndarray) else 3
        _pack_len(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
        out.append(payload)
    else:
        raise TypeError(f"cannot pack {type(value)} into msgpack")


def _chunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        step = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {"__msgpack_chunked_array__": True, "shape": {str(i): n for i, n in enumerate(tree.shape)},
                "chunks": {str(i): flat[s : s + step] for i, s in enumerate(range(0, flat.size, step))}}
    return tree


def msgpack_dumps(tree: Dict[str, Any]) -> bytes:
    """A nested dict of numpy arrays as flax's ``serialization.to_bytes`` writes it."""
    out: List[bytes] = []
    _pack(_chunk(tree), out)
    return b"".join(out)


# --------------------------------------------------------------------------- weights


def read_safetensors(path: str) -> Dict[str, Tensor]:
    """Every tensor of a ``.safetensors`` file, parsed by hand."""
    with open(path, "rb") as fh:
        (header_len,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(header_len))
        data = fh.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise NotImplementedError(f"{path}: tensor `{name}` has dtype {info['dtype']}, which the port does not"
                                      " read; ROADMAP Queue 1 lists what the port does not read yet.")
        start, end = info["data_offsets"]
        arr = np.frombuffer(data[start:end], dtype=_SAFETENSORS_DTYPES[info["dtype"]]).reshape(info["shape"])
        out[name] = torch.from_numpy(arr.copy())
    return out


def write_safetensors(path: str, tensors: Dict[str, Tensor]) -> str:
    """Write ``tensors`` (copied to the host) as a ``.safetensors`` file with ``pt`` metadata."""
    names = {np.dtype(v).name: k for k, v in _SAFETENSORS_DTYPES.items()}
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    buffers, offset = [], 0
    for name, tensor in tensors.items():
        arr = np.array(tensor.detach().cpu().numpy(), order="C")
        raw = arr.tobytes()
        header[name] = {"dtype": names[arr.dtype.name], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        buffers.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for raw in buffers:
            fh.write(raw)
    return path


def flatten_flax(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_flax(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_flax(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def flax_tree_to_torch(tree: Dict[str, Any]) -> Dict[str, Tensor]:
    """A Flax parameter tree of ``transformers`` in its PyTorch names and layouts.

    Flax's ``Dense`` kernels are ``[in, out]`` (``Linear.weight`` is ``[out, in]``), its
    ``Conv`` kernels HWIO (OIHW), its ``Embed`` tables ``embedding`` and its
    ``LayerNorm`` gains ``scale`` (both ``weight``); every other leaf keeps its name."""
    out = {}
    for path, value in flatten_flax(tree).items():
        parts = path.split("/")
        leaf = parts[-1]
        arr = np.asarray(value)
        if leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        out[".".join(parts[:-1] + [leaf])] = torch.from_numpy(np.array(arr, order="C"))
    return out


def _flax_kind(module: str, ndim: int) -> str:
    """What kind of Flax module holds a ``transformers`` PyTorch ``weight``, from its
    module's name and rank: ``Conv`` (rank 4), ``LayerNorm``, ``Embed`` or ``Dense``."""
    last = module.rpartition(".")[2].lower()
    if ndim == 4:
        return "conv"
    if "norm" in last:
        return "layer_norm"
    if last.endswith(("embeddings", "embedding")):
        return "embedding"
    return "linear"


def torch_to_flax_tree(state: Dict[str, Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`flax_tree_to_torch`: ``transformers``' PyTorch names and
    layouts as its Flax tree."""
    flat = {}
    for name, tensor in state.items():
        module, _, leaf = name.rpartition(".")
        arr = tensor.detach().cpu().numpy()
        if leaf == "weight":
            kind = _flax_kind(module, arr.ndim)
            leaf = {"conv": "kernel", "linear": "kernel", "layer_norm": "scale", "embedding": "embedding"}[kind]
            arr = arr.transpose(2, 3, 1, 0) if kind == "conv" else arr.T if kind == "linear" else arr
        flat["/".join(module.split(".") + [leaf]) if module else leaf] = np.array(arr, order="C")
    return unflatten_flax(flat)


def _shards(model_dir: str, index_name: str) -> List[str]:
    index = read_json(os.path.join(model_dir, index_name))
    return [os.path.join(model_dir, f) for f in sorted(set(index["weight_map"].values()))]


def _rename_legacy(state: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Old checkpoints name a LayerNorm's parameters ``gamma``/``beta``."""
    out = {}
    for name, tensor in state.items():
        if name.endswith(".gamma"):
            name = name[: -len("gamma")] + "weight"
        elif name.endswith(".beta"):
            name = name[: -len("beta")] + "bias"
        out[name] = tensor
    return out


def weight_files(model_dir: str) -> Tuple[str, List[str]]:
    """The weight format a snapshot is read from and its files, in the order the JAX
    package's Flax loader looks for them."""
    candidates = (
        ("flax", FLAX_WEIGHTS_NAME, None), ("flax", FLAX_WEIGHTS_NAME + ".index.json", True),
        ("safetensors", SAFE_WEIGHTS_NAME, None), ("torch", WEIGHTS_NAME, None),
        ("torch", WEIGHTS_NAME + ".index.json", True), ("safetensors", SAFE_WEIGHTS_NAME + ".index.json", True),
    )
    for kind, name, sharded in candidates:
        if os.path.isfile(os.path.join(model_dir, name)):
            return kind, _shards(model_dir, name) if sharded else [os.path.join(model_dir, name)]
    raise OSError(
        f"`{model_dir}` holds no weights: expected one of {FLAX_WEIGHTS_NAME}, {SAFE_WEIGHTS_NAME} or"
        f" {WEIGHTS_NAME} (or their sharded indexes)."
    )


def load_state_dict(model_dir: str) -> Dict[str, Tensor]:
    """The snapshot's weights as one ``{torch name: tensor}`` dict on the CPU."""
    kind, files = weight_files(model_dir)
    state: Dict[str, Tensor] = {}
    for path in files:
        if kind == "flax":
            with open(path, "rb") as fh:
                state.update(flax_tree_to_torch(msgpack_loads(fh.read())))
        elif kind == "safetensors":
            state.update(read_safetensors(path))
        else:
            state.update(torch.load(path, map_location="cpu", weights_only=True))
    return _rename_legacy(state)

