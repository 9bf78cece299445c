"""Minimal ONNX model parser (protobuf wire format, no onnx/protobuf deps).

The port's own copy of dl_speech_enhancement_tpu/eval/onnx_graph.py (the
port imports nothing of the JAX package). The DNSMOS evaluation models ship
as ONNX graphs (reference DNSMOS/dnsmos_local.py:24-25 runs them with
onnxruntime, which the port does not need). This module decodes just enough
of the ONNX protobuf schema (ModelProto / GraphProto / NodeProto /
AttributeProto / TensorProto) to rebuild the graph for the interpreter in
eval/onnx_torch.py. Pure Python and numpy.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a protobuf message.

    value: int for varint/fixed, memoryview for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_no, wire = tag >> 3, tag & 0x7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field_no, wire, val


def _packed_varints(val) -> list[int]:
    out, pos = [], 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    """Interpret a 64-bit varint as a signed int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class Tensor:
    name: str = ""
    dims: tuple = ()
    dtype: int = 1
    data: np.ndarray | None = None


# ONNX TensorProto.DataType -> numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
           7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def parse_tensor(buf) -> Tensor:
    t = Tensor()
    dims, float_data, int32_data, int64_data, raw = [], [], [], [], None
    double_data = []
    for fno, wire, val in iter_fields(buf):
        if fno == 1:
            dims.append(_signed(val) if wire == 0 else 0)
        elif fno == 2:
            t.dtype = val
        elif fno == 4:
            if wire == 2:  # packed floats
                float_data.extend(np.frombuffer(bytes(val), "<f4"))
            else:
                float_data.append(struct.unpack("<f", bytes(val))[0])
        elif fno == 5:
            if wire == 2:
                int32_data.extend(_packed_varints(val))
            else:
                int32_data.append(val)
        elif fno == 7:
            if wire == 2:
                int64_data.extend(_packed_varints(val))
            else:
                int64_data.append(val)
        elif fno == 8:
            t.name = bytes(val).decode()
        elif fno == 9:
            raw = bytes(val)
        elif fno == 10:
            if wire == 2:
                double_data.extend(np.frombuffer(bytes(val), "<f8"))
    t.dims = tuple(dims)
    np_dtype = _DTYPES.get(t.dtype, np.float32)
    if raw is not None:
        t.data = np.frombuffer(raw, np_dtype).reshape(t.dims)
    elif float_data:
        t.data = np.asarray(float_data, np.float32).reshape(t.dims)
    elif int64_data:
        t.data = np.asarray([_signed(v) for v in int64_data], np.int64).reshape(t.dims)
    elif int32_data:
        # int32/int16/int8 varints carry negatives as 64-bit two's
        # complement — sign-decode before narrowing or np overflows
        t.data = (np.asarray([_signed(v) for v in int32_data], np.int64)
                  .astype(np_dtype).reshape(t.dims))
    elif double_data:
        t.data = np.asarray(double_data, np.float64).reshape(t.dims)
    else:
        t.data = np.zeros(t.dims, np_dtype)
    return t


@dataclass
class Attribute:
    name: str = ""
    type: int = 0  # AttributeProto.AttributeType (field 20)
    f: float | None = None
    i: int | None = None
    s: bytes | None = None
    t: Tensor | None = None
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)

    @property
    def value(self):
        for v in (self.t, self.s, self.f, self.i):
            if v is not None:
                return v
        if self.ints:
            return self.ints
        if self.floats:
            return self.floats
        # proto3 omits zero-valued scalar fields from the wire, so an
        # attribute that IS present but holds the default (axis=0,
        # ceil_mode=0, alpha=0.0, an empty ints list) arrives with only
        # name+type set — synthesize the typed zero instead of returning
        # None (which callers would treat as "attribute absent").
        return {1: 0.0, 2: 0, 3: b"", 6: [], 7: []}.get(self.type)


def parse_attribute(buf) -> Attribute:
    a = Attribute()
    for fno, wire, val in iter_fields(buf):
        if fno == 1:
            a.name = bytes(val).decode()
        elif fno == 2:
            a.f = struct.unpack("<f", bytes(val))[0]
        elif fno == 3:
            a.i = _signed(val)
        elif fno == 4:
            a.s = bytes(val)
        elif fno == 5:
            a.t = parse_tensor(val)
        elif fno == 7:
            if wire == 2:
                a.floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
            else:
                a.floats.append(struct.unpack("<f", bytes(val))[0])
        elif fno == 8:
            if wire == 2:
                a.ints.extend(_signed(v) for v in _packed_varints(val))
            else:
                a.ints.append(_signed(val))
        elif fno == 20:
            a.type = val
    return a


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


def parse_node(buf) -> Node:
    n = Node()
    for fno, wire, val in iter_fields(buf):
        if fno == 1:
            n.inputs.append(bytes(val).decode())
        elif fno == 2:
            n.outputs.append(bytes(val).decode())
        elif fno == 3:
            n.name = bytes(val).decode()
        elif fno == 4:
            n.op_type = bytes(val).decode()
        elif fno == 5:
            a = parse_attribute(val)
            n.attrs[a.name] = a
    return n


def _parse_value_info_name(buf) -> str:
    for fno, wire, val in iter_fields(buf):
        if fno == 1:
            return bytes(val).decode()
    return ""


@dataclass
class Graph:
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    name: str = ""


def parse_graph(buf) -> Graph:
    g = Graph()
    for fno, wire, val in iter_fields(buf):
        if fno == 1:
            g.nodes.append(parse_node(val))
        elif fno == 2:
            g.name = bytes(val).decode()
        elif fno == 5:
            t = parse_tensor(val)
            g.initializers[t.name] = t.data
        elif fno == 11:
            g.inputs.append(_parse_value_info_name(val))
        elif fno == 12:
            g.outputs.append(_parse_value_info_name(val))
    return g


def load_model(path: str) -> Graph:
    """Parse an .onnx file into a Graph."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    for fno, wire, val in iter_fields(data):
        if fno == 7:  # ModelProto.graph
            return parse_graph(val)
    raise ValueError(f"no graph found in {path}")
