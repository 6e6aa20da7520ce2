"""ONNX graph structure: read nodes + initializers, write model files.

A copy of the JAX package's ``weights/onnx_graph.py``. :mod:`.importer`
reads only initializer tensors; mapping them onto flax trees when tensor
NAMES are meaningless (torch exports commonly emit ``onnx::Conv_123``-style
names) requires the graph TOPOLOGY: which op consumes which initializer, in
execution order. This module parses exactly that from the protobuf wire
format, with no ``onnx`` package.

It also WRITES spec-correct ONNX files (:class:`OnnxGraphBuilder`), which
:mod:`.graph_export` uses to export a native model directory; for the same
graph it writes the same bytes as the JAX package's builder.

Wire schema used (onnx.proto3 field numbers):

    ModelProto:  ir_version=1  opset_import=8 (OperatorSetIdProto: version=2)
                 graph=7
    GraphProto:  node=1  name=2  initializer=5  input=11  output=12
    NodeProto:   input=1  output=2  name=3  op_type=4  attribute=5
    AttributeProto: name=1  f=2  i=3  s=4  floats=7  ints=8  type=20
                    (type codes: FLOAT=1 INT=2 STRING=3 FLOATS=6 INTS=7)
    ValueInfoProto: name=1  type=2; TypeProto.tensor_type=1
                    (elem_type=1, shape=2; TensorShapeProto.dim=1,
                     Dimension.dim_value=1)
    TensorProto: dims=1 data_type=2 float_data=4 name=8 raw_data=9
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.weights.importer import (
    _iter_fields, _parse_tensor, _read_varint, _to_signed64,
)

# ------------------------------ reading ------------------------------


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict = dataclasses.field(default_factory=dict)


def _parse_attribute(buf: bytes) -> tuple[str, object]:
    name = ""
    value = None
    ints: list[int] = []
    floats: list[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:  # f (float)
            value = struct.unpack("<f", val)[0]
        elif field == 3:  # i (int64)
            value = _to_signed64(val)
        elif field == 4:  # s (bytes)
            value = val.decode("utf-8", errors="replace")
        elif field == 7:  # floats
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:  # ints
            if wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_to_signed64(v))
            else:
                ints.append(_to_signed64(val))
    if ints:
        value = ints
    elif floats:
        value = floats
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            node.inputs.append(val.decode("utf-8"))
        elif field == 2:
            node.outputs.append(val.decode("utf-8"))
        elif field == 3:
            node.name = val.decode("utf-8")
        elif field == 4:
            node.op_type = val.decode("utf-8")
        elif field == 5:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]
    outputs: list[str]
    name: str = ""


def _value_info_name(buf: bytes) -> str:
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            return val.decode("utf-8")
    return ""


def read_onnx_graph(path: str | Path) -> OnnxGraph:
    """Parse nodes (execution order), initializers, and graph IO names."""
    data = Path(path).read_bytes()
    graph = OnnxGraph([], {}, [], [])
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == 1 and gwire == 2:
                    graph.nodes.append(_parse_node(gval))
                elif gfield == 2 and gwire == 2:
                    graph.name = gval.decode("utf-8")
                elif gfield == 5 and gwire == 2:
                    name, arr = _parse_tensor(gval)
                    graph.initializers[name] = arr
                elif gfield == 11 and gwire == 2:
                    graph.inputs.append(_value_info_name(gval))
                elif gfield == 12 and gwire == 2:
                    graph.outputs.append(_value_info_name(gval))
    # Graph inputs may repeat initializer names (pre-IR4 exports); the true
    # runtime inputs are those without initializer entries.
    graph.inputs = [n for n in graph.inputs if n not in graph.initializers]
    return graph


# ------------------------------ writing ------------------------------


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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return _tag(field, 2) + _varint(len(payload)) + payload

def _vint(field: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement int64
    return _tag(field, 0) + _varint(v)


_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.int32): 6, np.dtype(np.int64): 7, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11, np.dtype(np.bool_): 9,
}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += _vint(1, d)
    out += _vint(2, _NP_TO_ONNX[arr.dtype])
    out += _ld(8, name.encode("utf-8"))
    out += _ld(9, arr.tobytes())
    return out


def _attr_proto(name: str, value) -> bytes:
    out = _ld(1, name.encode("utf-8"))
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        out += _vint(3, value) + _vint(20, 2)  # INT
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) + _vint(20, 1)  # FLOAT
    elif isinstance(value, str):
        out += _ld(4, value.encode("utf-8")) + _vint(20, 3)  # STRING
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        payload = b"".join(struct.pack("<f", v) for v in value)
        out += _ld(7, payload) + _vint(20, 6)  # FLOATS
    elif isinstance(value, (list, tuple)):
        payload = b"".join(_varint(int(v) + (1 << 64 if v < 0 else 0))
                           for v in value)
        out += _ld(8, payload) + _vint(20, 7)  # INTS
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def _node_proto(node: OnnxNode) -> bytes:
    out = b""
    for i in node.inputs:
        out += _ld(1, i.encode("utf-8"))
    for o in node.outputs:
        out += _ld(2, o.encode("utf-8"))
    if node.name:
        out += _ld(3, node.name.encode("utf-8"))
    out += _ld(4, node.op_type.encode("utf-8"))
    for k, v in node.attrs.items():
        out += _ld(5, _attr_proto(k, v))
    return out


def _value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):  # symbolic dim (dim_param), e.g. batch "B"
            dims += _ld(1, _ld(2, d.encode("utf-8")))
        else:
            dims += _ld(1, _vint(1, int(d)))
    tensor_type = _vint(1, elem_type) + _ld(2, dims)
    return _ld(1, name.encode("utf-8")) + _ld(2, _ld(1, tensor_type))


class OnnxGraphBuilder:
    """Minimal spec-correct ONNX writer."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: list[OnnxNode] = []
        self.inits: dict[str, np.ndarray] = {}
        self.graph_inputs: list[tuple[str, tuple, int]] = []
        self.graph_outputs: list[tuple[str, tuple, int]] = []
        self._n = 0

    def add_input(self, name: str, shape, elem_type: int = 1):
        self.graph_inputs.append((name, tuple(shape), elem_type))

    def add_output(self, name: str, shape, elem_type: int = 1):
        self.graph_outputs.append((name, tuple(shape), elem_type))

    def add_init(self, arr: np.ndarray, name: str | None = None) -> str:
        if name is None:
            name = f"param_{self._n}"
            self._n += 1
        self.inits[name] = np.asarray(arr)
        return name

    def add_node(self, op_type: str, inputs, outputs=None, **attrs):
        if outputs is None:
            outputs = [f"t_{self._n}"]
            self._n += 1
        self.nodes.append(OnnxNode(op_type, list(inputs), list(outputs),
                                   attrs=attrs))
        return self.nodes[-1].outputs[0]

    def to_bytes(self, ir_version: int = 8, opset: int = 17) -> bytes:
        g = b""
        for node in self.nodes:
            g += _ld(1, _node_proto(node))
        g += _ld(2, self.name.encode("utf-8"))
        for name, arr in self.inits.items():
            g += _ld(5, _tensor_proto(name, arr))
        for name, shape, et in self.graph_inputs:
            g += _ld(11, _value_info(name, shape, et))
        for name, shape, et in self.graph_outputs:
            g += _ld(12, _value_info(name, shape, et))
        model = _vint(1, ir_version)
        model += _ld(7, g)
        model += _ld(8, _vint(2, opset))  # OperatorSetIdProto.version
        return model

    def save(self, path: str | Path, opset: int = 17) -> None:
        Path(path).write_bytes(self.to_bytes(opset=opset))
