"""PNG files of 8-bit samples, non-interlaced: a reader for the traffic's
crops and a writer for request bodies. The benchmark reads its inputs
itself, so that the program and the reference get the same arrays."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row filters. Rows with Sub, Up or None filters are
    vectorized along the row; Average and Paeth go pixel by pixel, since
    each byte depends on its left neighbour's result."""
    stride = w * c
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h + 1, stride + c), np.int32)  # a zero row above, zero pixel left
    for r in range(h):
        f, line = rows[r, 0], rows[r, 1:].astype(np.int32)
        up = out[r, c:]
        if f == 0:
            out[r + 1, c:] = line
        elif f == 1:
            px = line.reshape(w, c)
            out[r + 1, c:] = (np.cumsum(px, axis=0) & 255).reshape(-1)
        elif f == 2:
            out[r + 1, c:] = (line + up) & 255
        elif f in (3, 4):
            cur, prev = out[r + 1], out[r]
            for x in range(c, stride + c):
                a, b, d = cur[x - c], prev[x], prev[x - c]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - d
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - d)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else d)
                cur[x] = (line[x - c] + pred) & 255
        else:
            raise ValueError(f"unknown PNG filter {f}")
    return out[1:, c:].astype(np.uint8).reshape(h, w, c)


def decode(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1, 2, 3 or 4."""
    if blob[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w, _CHANNELS[ctype])


def read(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())

