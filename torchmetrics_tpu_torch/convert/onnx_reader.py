"""Minimal ONNX model reader — a protobuf wire-format parser, no ``onnx`` package.

The DNSMOS checkpoints (reference ``functional/audio/dnsmos.py:41-95``) ship as
ONNX protobufs and the reference executes them with ``onnxruntime``. Neither
package exists in this image, and an ONNX *file* is just protobuf wire data: a
sequence of (tag varint, payload) records. This module parses exactly the message
subset a converted inference graph needs — ModelProto → GraphProto → NodeProto /
AttributeProto / TensorProto — into plain dicts + numpy arrays, from the published
`onnx.proto` field numbers. Anything it does not understand is skipped (unknown
fields are forward-compatible by protobuf design) or raises with a clear name.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# TensorProto.DataType -> numpy dtype (the subset inference graphs use)
_TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
# TensorProto repeated-field number -> numpy dtype for non-raw storage
_FIELD_DTYPES = {4: np.float32, 5: np.int32, 7: np.int64, 10: np.float64, 11: np.uint64}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) records; LEN values are bytes."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _I64:
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wire == _I32:
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"Unsupported protobuf wire type {wire} (field {field})")
        yield field, wire, val


def _packed_or_single(wire: int, val, out: List[int]) -> None:
    """Repeated varint fields arrive packed (LEN) or one-per-record."""
    if wire == _LEN:
        pos = 0
        while pos < len(val):
            v, pos = _read_varint(val, pos)
            out.append(v)
    else:
        out.append(val)


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, typed data=4/5/6/7/10/11, name=8, raw_data=9."""
    dims: List[int] = []
    data_type = 1
    name = ""
    raw = None
    typed: List[Any] = []
    typed_dtype = None
    for field, wire, val in _fields(buf):
        if field == 1:
            _packed_or_single(wire, val, dims)
        elif field == 2:
            data_type = val
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field in _FIELD_DTYPES:
            typed_dtype = _FIELD_DTYPES[field]
            if wire == _LEN and field in (5, 7, 11):  # packed varints
                raw_vals: List[int] = []
                _packed_or_single(wire, val, raw_vals)
                # int32_data/int64_data varints are two's-complement in 64 bits
                typed.extend(raw_vals if field == 11 else [_signed_int(v) for v in raw_vals])
            elif wire == _LEN:  # packed floats/doubles
                typed.extend(np.frombuffer(val, dtype=typed_dtype).tolist())
            elif wire == _I32:
                typed.append(np.frombuffer(val, dtype=np.float32)[0])
            elif wire == _I64:
                typed.append(np.frombuffer(val, dtype=np.float64)[0])
            else:
                typed.append(val if field == 11 else _signed_int(val))
        elif field == 6:  # string_data
            raise ValueError(f"String tensors are not supported (tensor {name!r})")
    dtype = _TENSOR_DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"Unsupported tensor data_type {data_type} (tensor {name!r})")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<")).astype(dtype)
    elif data_type == 10:
        # float16 in int32_data ships as uint16 BIT PATTERNS, not values (onnx spec)
        arr = np.asarray(typed, dtype=np.uint16).view(np.float16)
    else:
        arr = np.asarray(typed, dtype=typed_dtype or dtype).astype(dtype)
    return name, arr.reshape([int(d) for d in dims]) if dims else arr.reshape(())


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, strings=9, type=20."""
    name = ""
    single: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[str] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:
            single = float(np.frombuffer(val, dtype=np.float32)[0])
        elif field == 3:
            single = _signed(val)
        elif field == 4:
            single = val.decode("utf-8", errors="replace")
        elif field == 5:
            single = _parse_tensor(val)[1]
        elif field == 7:
            if wire == _LEN:
                floats.extend(np.frombuffer(val, dtype=np.float32).tolist())
            else:
                floats.append(float(np.frombuffer(val, dtype=np.float32)[0]))
        elif field == 8:
            raw_ints: List[int] = []
            _packed_or_single(wire, val, raw_ints)
            ints.extend(_signed_int(v) for v in raw_ints)
        elif field == 9:
            strings.append(val.decode("utf-8", errors="replace"))
    if single is not None:
        return name, single
    if floats:
        return name, floats
    if ints:
        return name, ints
    if strings:
        return name, strings
    return name, None


def _signed_int(v: int) -> int:
    """Protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed(v: int) -> int:
    return _signed_int(v)


def _parse_node(buf: bytes) -> Dict[str, Any]:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    node: Dict[str, Any] = {"inputs": [], "outputs": [], "name": "", "op": "", "attrs": {}}
    for field, _wire, val in _fields(buf):
        if field == 1:
            node["inputs"].append(val.decode("utf-8"))
        elif field == 2:
            node["outputs"].append(val.decode("utf-8"))
        elif field == 3:
            node["name"] = val.decode("utf-8")
        elif field == 4:
            node["op"] = val.decode("utf-8")
        elif field == 5:
            k, v = _parse_attribute(val)
            node["attrs"][k] = v
    return node


def _value_info_name(buf: bytes) -> str:
    for field, _wire, val in _fields(buf):
        if field == 1:
            return val.decode("utf-8")
    return ""


def _parse_graph(buf: bytes) -> Dict[str, Any]:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    graph: Dict[str, Any] = {"nodes": [], "initializers": {}, "inputs": [], "outputs": [], "name": ""}
    for field, _wire, val in _fields(buf):
        if field == 1:
            graph["nodes"].append(_parse_node(val))
        elif field == 2:
            graph["name"] = val.decode("utf-8")
        elif field == 5:
            name, arr = _parse_tensor(val)
            graph["initializers"][name] = arr
        elif field == 11:
            graph["inputs"].append(_value_info_name(val))
        elif field == 12:
            graph["outputs"].append(_value_info_name(val))
    # graph inputs include initializers in older opsets; real runtime inputs are the rest
    graph["inputs"] = [n for n in graph["inputs"] if n not in graph["initializers"]]
    return graph


def parse_onnx(path_or_bytes) -> Dict[str, Any]:
    """Parse an ONNX file into {nodes, initializers, inputs, outputs, name}.

    ``nodes`` are dicts {op, name, inputs, outputs, attrs}; ``initializers`` maps
    names to numpy arrays; ``inputs``/``outputs`` are the graph boundary names
    (initializers excluded from inputs).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            buf = fh.read()
    for field, _wire, val in _fields(buf):  # ModelProto: graph = 7
        if field == 7:
            return _parse_graph(val)
    raise ValueError("No graph found: not an ONNX ModelProto?")
