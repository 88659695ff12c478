"""Minimal pure-Python ONNX protobuf reader/writer (the port's copy of
fangyan_tts_tpu/data/onnx_proto.py).

The reference's feature frontend ships as two ONNX artifacts
(campplus.onnx, speech_tokenizer_v3.onnx — cosyvoice/cli/frontend.py:45-48)
whose weights models/convert.py maps into the JAX package's parameter
layout, which models/from_jax.py carries into the port's modules. Neither
the `onnx` package nor onnxruntime is needed: this parses the
protobuf wire format directly — the subset needed to recover the graph:
initializers (name/dims/dtype/raw bytes), nodes (op_type/inputs/outputs/
attributes), and model inputs/outputs.

Field numbers from the public onnx.proto3 schema:
  ModelProto:   graph=7
  GraphProto:   node=1 name=2 initializer=5 input=11 output=12
  NodeProto:    input=1 output=2 name=3 op_type=4 attribute=5
  TensorProto:  dims=1 data_type=2 float_data=4 int32_data=5 int64_data=7
                name=8 raw_data=9
  AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 type=20
  ValueInfoProto: name=1

The writer emits just enough to synthesize test graphs (same subset).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# TensorProto.DataType -> numpy
DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


# ---------------------------------------------------------------- wire format

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} at {pos}")
        yield fnum, wtype, val


def _zigzag_ok(v: int) -> int:
    # protobuf int64 varints are two's-complement; wrap negatives
    return v - (1 << 64) if v >= (1 << 63) else v


# ------------------------------------------------------------------- reading


@dataclass
class Tensor:
    name: str = ""
    dims: tuple = ()
    dtype: int = 1
    raw: bytes = b""
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)

    def to_numpy(self) -> np.ndarray:
        np_dt = DTYPES.get(self.dtype)
        if np_dt is None:
            raise ValueError(f"tensor {self.name}: unsupported data_type {self.dtype}")
        if self.raw:
            arr = np.frombuffer(self.raw, dtype=np_dt)
        elif self.floats:
            arr = np.asarray(self.floats, np.float32).astype(np_dt)
        else:
            arr = np.asarray(self.ints, np.int64).astype(np_dt)
        return arr.reshape(self.dims)


@dataclass
class Attribute:
    name: str = ""
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Tensor | None = None
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)

    @property
    def value(self):
        if self.ints:
            return list(self.ints)
        if self.floats:
            return list(self.floats)
        if self.t is not None:
            return self.t
        if self.s:
            return self.s
        if self.f:
            return self.f
        return self.i


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


@dataclass
class Graph:
    name: str = ""
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)  # name -> Tensor
    inputs: list = field(default_factory=list)  # names
    outputs: list = field(default_factory=list)

    def weights(self) -> dict:
        """name -> np.ndarray for every initializer (the exported state dict)."""
        return {n: t.to_numpy() for n, t in self.initializers.items()}


def _parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    dims = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            if wtype == 0:
                dims.append(_zigzag_ok(val))
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(_zigzag_ok(v))
        elif fnum == 2:
            t.dtype = val
        elif fnum == 4:
            if wtype == 5:
                t.floats.append(struct.unpack("<f", val)[0])
            else:  # packed
                t.floats.extend(np.frombuffer(val, "<f4").tolist())
        elif fnum in (5, 7):
            if wtype == 0:
                t.ints.append(_zigzag_ok(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    t.ints.append(_zigzag_ok(v))
        elif fnum == 8:
            t.name = val.decode()
        elif fnum == 9:
            t.raw = val
    t.dims = tuple(dims)
    return t


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            a.name = val.decode()
        elif fnum == 2:
            a.f = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a.i = _zigzag_ok(val)
        elif fnum == 4:
            a.s = val
        elif fnum == 5:
            a.t = _parse_tensor(val)
        elif fnum == 7:
            if wtype == 5:
                a.floats.append(struct.unpack("<f", val)[0])
            else:
                a.floats.extend(np.frombuffer(val, "<f4").tolist())
        elif fnum == 8:
            if wtype == 0:
                a.ints.append(_zigzag_ok(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    a.ints.append(_zigzag_ok(v))
    return a


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            n.inputs.append(val.decode())
        elif fnum == 2:
            n.outputs.append(val.decode())
        elif fnum == 3:
            n.name = val.decode()
        elif fnum == 4:
            n.op_type = val.decode()
        elif fnum == 5:
            a = _parse_attribute(val)
            n.attrs[a.name] = a
    return n


def _value_info_name(buf: bytes) -> str:
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            t = _parse_tensor(val)
            g.initializers[t.name] = t
        elif fnum == 11:
            g.inputs.append(_value_info_name(val))
        elif fnum == 12:
            g.outputs.append(_value_info_name(val))
    return g


def load_graph(path_or_bytes) -> Graph:
    """Parse an .onnx file (or raw bytes) into a Graph."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 7:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError("no graph found — not an ONNX ModelProto?")


# ------------------------------------------------------------------- writing
# (test-support: synthesize graphs with a given node/initializer layout)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    if wtype == 2:
        return _varint((fnum << 3) | 2) + _varint(len(payload)) + payload
    return _varint((fnum << 3) | wtype) + payload


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    out = b""
    for d in arr.shape:
        out += _field(1, 0, _varint(d))
    out += _field(2, 0, _varint(DTYPE_CODES[arr.dtype]))
    out += _field(8, 2, name.encode())
    out += _field(9, 2, np.ascontiguousarray(arr).tobytes())
    return out


def _enc_attr(name: str, value) -> bytes:
    out = _field(1, 2, name.encode())
    if isinstance(value, (list, tuple)) and all(isinstance(v, (int, np.integer)) for v in value):
        for v in value:
            out += _field(8, 0, _varint(int(v) & ((1 << 64) - 1)))
        out += _field(20, 0, _varint(7))  # INTS
    elif isinstance(value, (int, np.integer)):
        out += _field(3, 0, _varint(int(value) & ((1 << 64) - 1)))
        out += _field(20, 0, _varint(2))  # INT
    elif isinstance(value, float):
        out += _field(2, 5, struct.pack("<f", value))
        out += _field(20, 0, _varint(1))  # FLOAT
    elif isinstance(value, bytes):
        out += _field(4, 2, value)
        out += _field(20, 0, _varint(3))  # STRING
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return out


def _enc_node(op_type: str, inputs, outputs, attrs=None, name="") -> bytes:
    out = b""
    for i in inputs:
        out += _field(1, 2, i.encode())
    for o in outputs:
        out += _field(2, 2, o.encode())
    if name:
        out += _field(3, 2, name.encode())
    out += _field(4, 2, op_type.encode())
    for k, v in (attrs or {}).items():
        out += _field(5, 2, _enc_attr(k, v))
    return out


def save_model(
    path: str,
    nodes: list,  # (op_type, inputs, outputs, attrs) tuples
    initializers: dict,  # name -> np.ndarray
    inputs: list,
    outputs: list,
    graph_name: str = "g",
) -> None:
    g = b""
    for spec in nodes:
        op, ins, outs, attrs = (list(spec) + [None])[:4]
        g += _field(1, 2, _enc_node(op, ins, outs, attrs))
    g += _field(2, 2, graph_name.encode())
    for nm, arr in initializers.items():
        g += _field(5, 2, _enc_tensor(nm, np.asarray(arr)))
    for nm in inputs:
        g += _field(11, 2, _field(1, 2, nm.encode()))
    for nm in outputs:
        g += _field(12, 2, _field(1, 2, nm.encode()))
    model = _field(1, 0, _varint(8))  # ir_version
    model += _field(7, 2, g)
    with open(path, "wb") as f:
        f.write(model)
