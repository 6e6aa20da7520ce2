"""ONNX initializer tensors and the torch -> flax layout converters.

A copy of the JAX package's ``weights/importer.py``, without its use of the
``onnx`` package: :func:`read_onnx_initializers` always parses the protobuf
wire format itself, which needs three message types:

    ModelProto.graph          = field 7 (GraphProto, length-delimited)
    GraphProto.initializer    = field 5 (repeated TensorProto)
    TensorProto.dims          = field 1 (repeated int64)
               .data_type     = field 2 (varint; 1=f32 6=i32 7=i64 10=f16 11=f64)
               .float_data    = field 4 (packed floats)
               .int32_data    = field 5
               .int64_data    = field 7
               .name          = field 8 (string)
               .raw_data      = field 9 (bytes, little-endian)
               .double_data   = field 10

The layout converters (:func:`torch_conv_to_flax` etc.) translate
torch-exported tensor layouts to flax's: conv (cout, cin, kh, kw) -> (kh,
kw, cin, cout); linear (out, in) -> (in, out); the LSTM's packed (4*hidden,
in) gate blocks i, f, g, o -> flax ``LSTMCell``'s per-gate Dense kernels.
The port's ``from_flax_*`` (:mod:`stroke_derenderer_tpu_torch.weights`)
take the trees from there.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _to_signed64(v: int) -> int:
    """Protobuf varints carry int64 as two's complement (10-byte encoding
    for negatives, NO zigzag for plain int64/int32 fields)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = np.float32
    name = ""
    raw = None
    floats: list[float] = []
    int32s: list[int] = []
    int64s: list[int] = []
    doubles: list[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2 and wire == 0:
            dtype = _DTYPES.get(val, np.float32)
        elif field == 4:
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 5:
            if wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int32s.append(_to_signed64(v))
            else:
                int32s.append(_to_signed64(val))
        elif field == 7:
            if wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64s.append(_to_signed64(v))
            else:
                int64s.append(_to_signed64(val))
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 10:
            if wire == 2:
                doubles.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                doubles.append(struct.unpack("<d", val)[0])
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    elif floats:
        arr = np.asarray(floats, np.float32).reshape(shape)
    elif int64s:
        arr = np.asarray(int64s, np.int64).reshape(shape)
    elif int32s:
        arr = np.asarray(int32s, np.int32).reshape(shape)
    elif doubles:
        arr = np.asarray(doubles, np.float64).reshape(shape)
    else:
        arr = np.zeros(shape, dtype)
    return name, arr


def read_onnx_initializers(path: str | Path) -> dict[str, np.ndarray]:
    """Named initializer tensors of an ONNX model file."""
    data = Path(path).read_bytes()
    out: dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


# ------------------------- layout converters -------------------------

def torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    """(cout, cin, kh, kw) -> (kh, kw, cin, cout)."""
    return np.transpose(w, (2, 3, 1, 0))


def torch_linear_to_flax(w: np.ndarray) -> np.ndarray:
    """(out, in) -> (in, out)."""
    return np.transpose(w, (1, 0))


def torch_lstm_to_flax(w_ih: np.ndarray, w_hh: np.ndarray,
                       b_ih: np.ndarray, b_hh: np.ndarray) -> dict:
    """torch LSTMCell packed weights -> flax nn.LSTMCell param dict.

    torch packs gates (i, f, g, o) along dim 0 of (4H, in)/(4H, H) matrices
    with two bias vectors; flax LSTMCell uses per-gate Dense modules named
    ii/if/ig/io (input side, bias-free) and hi/hf/hg/ho (hidden side, which
    carries the bias) — the two torch biases sum onto the hidden-side Dense.
    """
    h = w_hh.shape[1]
    gates = ("i", "f", "g", "o")
    out: dict = {}
    for k, g in enumerate(gates):
        sl = slice(k * h, (k + 1) * h)
        out[f"i{g}"] = {"kernel": torch_linear_to_flax(w_ih[sl])}
        out[f"h{g}"] = {"kernel": torch_linear_to_flax(w_hh[sl]),
                        "bias": b_ih[sl] + b_hh[sl]}
    return out
