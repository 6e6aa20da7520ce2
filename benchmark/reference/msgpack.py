"""flax msgpack files: a reader for the weight files of a model directory,
and a writer for the weights that the benchmark draws itself.

A file holds the msgpack map that ``flax.serialization.to_bytes`` writes:
str keys, nested maps, and arrays as msgpack ext type 1 whose payload is
itself the msgpack triple (shape, dtype name, raw C-order bytes).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
          0xca: ">f", 0xcb: ">d"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
        0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if t <= 0x8f:
            return self.map(t & 0x0f)
        if t <= 0x9f:
            return [self.obj() for _ in range(t & 0x0f)]
        if t <= 0xbf:
            return str(self.take(t & 0x1f), "utf-8")
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in _FIXED:
            return self.num(_FIXED[t])
        if t in (0xc4, 0xc5, 0xc6):
            return self.take(self.num(_LEN[t]))
        if t in (0xd9, 0xda, 0xdb):
            return str(self.take(self.num(_LEN[t])), "utf-8")
        if t in (0xdc, 0xdd):
            return [self.obj() for _ in range(self.num(_LEN[t]))]
        if t in (0xde, 0xdf):
            return self.map(self.num(_LEN[t]))
        if t in (0xc7, 0xc8, 0xc9):
            n = self.num(_LEN[t])
            return self.ext(self.num(">b"), self.take(n))
        if 0xd4 <= t <= 0xd8:
            code = self.num(">b")
            return self.ext(code, self.take(1 << (t - 0xd4)))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        return {self.obj(): self.obj() for _ in range(n)}

    @staticmethod
    def ext(code: int, data: memoryview):
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, raw = _Reader(data).obj()
        name = name if isinstance(name, str) else str(name, "utf-8")
        arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == 3 else arr


def read(path) -> dict:
    """A flax msgpack file -> nested dict of numpy arrays."""
    buf = memoryview(Path(path).read_bytes())
    reader = _Reader(buf)
    tree = reader.obj()
    if reader.pos != len(buf):
        raise ValueError(f"{path}: {len(buf) - reader.pos} trailing bytes")
    return tree


def _pack(obj, out: list) -> None:
    if isinstance(obj, dict):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n <= 15 else struct.pack(">BH", 0xde, n))
        for k in sorted(obj):
            _pack(str(k), out)
            _pack(obj[k], out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(bytes([0xa0 | len(b)]) if len(b) <= 31
                   else struct.pack(">BB", 0xd9, len(b)))
        out.append(b)
    elif isinstance(obj, (bytes, memoryview)):
        out.append(struct.pack(">BI", 0xc6, len(obj)))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(bytes([0x90 | len(obj)]))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, int):
        out.append(struct.pack(">Bq", 0xd3, obj))
    elif isinstance(obj, np.ndarray):
        inner: list = []
        _pack((list(obj.shape), obj.dtype.name,
               np.ascontiguousarray(obj).tobytes()), inner)
        data = b"".join(inner)
        out.append(struct.pack(">BIb", 0xc9, len(data), 1))
        out.append(data)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


def write(tree: dict, path) -> None:
    """A nested dict of numpy arrays -> a flax msgpack file."""
    out: list = []
    _pack(tree, out)
    Path(path).write_bytes(b"".join(out))
