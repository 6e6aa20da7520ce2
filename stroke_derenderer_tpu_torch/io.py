"""Host-side image, JSON, YAML, pickle and SVG I/O: a PNG reader and writer
on ``zlib`` + numpy, the SVG export of strokes and the JAX package's serial
helpers.

Counterpart of the JAX package's ``io/images.py`` (which uses PIL),
``io/serial.py`` and ``io/svg.py``. PNG files and PNG bytes (a request
body) share one parser, :func:`decode_png`, and one writer,
:func:`encode_png`. The reader takes every PNG the standard defines: colour
types 0 (grey, 1/2/4/8/16 bits), 2 (RGB, 8/16), 3 (palette, 1/2/4/8), 4
(grey + alpha, 8/16) and 6 (RGBA, 8/16), plain or Adam7-interlaced, with
all five row filters; it raises on a file that is not one. ``load_image``
returns RGB exactly as PIL's ``convert("RGB")`` does: low-depth grey is
scaled to 0..255, 16-bit grey is clipped at 255, other 16-bit samples keep
their high byte, grey is replicated, alpha is dropped and a palette is
looked up. The writer writes L or RGB with filter 0.
"""

from __future__ import annotations

import json
import pickle
import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, bit depths the PNG standard allows)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, h: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> (h, row_bytes) uint8. ``bpp`` is the
    filters' byte distance to the left neighbour: the bytes per pixel,
    rounded up to 1 for depths below 8.

    Byte (r, x) depends on (r, x-bpp), (r-1, x) and (r-1, x-bpp), so every
    anti-diagonal r + x = d of the (h, row_bytes / bpp) pixel grid depends
    only on earlier ones: the rows are decoded together, one anti-diagonal
    at a time, each row with its own filter type. That keeps the Average
    and Paeth filters vectorized."""
    w = row_bytes // bpp
    data = data.reshape(h, row_bytes + 1)
    ftype = data[:, 0].astype(np.int16)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    filt = data[:, 1:].reshape(h, w, bpp).astype(np.int16)
    if not np.any(ftype >= 3):
        # None/Sub/Up only: row by row, each row vectorized.
        out = np.zeros((h, w, bpp), np.int16)
        prev = np.zeros((w, bpp), np.int16)
        for r in range(h):
            row = filt[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[r] == 2:
                row = row + prev
            out[r] = row & 255
            prev = out[r]
        return out.astype(np.uint8).reshape(h, row_bytes)
    # Zero-padded on the top and left: pixel (r, x) lives at [r + 1, x + 1].
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(d, h - 1) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(h, row_bytes)


def _decode_image(data: np.ndarray, h: int, w: int, depth: int,
                  channels: int) -> tuple[np.ndarray, int]:
    """One (sub-)image's filtered rows at the start of ``data`` -> its
    (h, w, channels) samples (uint16 for depth 16, else uint8) and the
    bytes it used."""
    bits = depth * channels
    row_bytes = (w * bits + 7) // 8
    n = h * (row_bytes + 1)
    if data.size < n:
        raise ValueError(f"PNG data ends after {data.size} bytes, expected "
                         f"at least {n}")
    rows = _unfilter(data[:n], h, row_bytes, max(1, bits // 8))
    if depth == 16:
        pix = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        pix = rows
    else:  # 1, 2 or 4 bits: one sample per pixel, packed from the high bit
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        pix = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :w]
    return pix.reshape(h, w, channels), n


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 (grey), 2 (grey + alpha), 3 (RGB
    and palette) or 4 (RGBA), with samples brought to 8 bits the way PIL's
    ``convert("RGB")`` brings them: grey of 1, 2 or 4 bits scaled to 0..255,
    16-bit grey clipped at 255 (PIL's ``I;16``), every other 16-bit sample
    cut to its high byte, a palette looked up (indices past its end give
    black). Raises ValueError on bytes that are not such a PNG."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(blob):
        if pos + 12 > len(blob):
            raise ValueError("truncated PNG chunk")
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if pos > len(blob):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if kind == b"IHDR":
            if n != 13:
                raise ValueError(f"IHDR chunk of {n} bytes, expected 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    channels, depths = _COLOUR_TYPES.get(ctype, (0, ()))
    if depth not in depths or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    try:
        data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise ValueError(f"corrupt PNG data: {exc}") from None
    if interlace == 0:
        pix, _ = _decode_image(data, h, w, depth, channels)
    else:  # Adam7: seven sub-images, each filtered on its own
        pix = np.zeros((h, w, channels),
                       np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                sub, used = _decode_image(data[pos:], ph, pw, depth, channels)
                pix[y0::dy, x0::dx] = sub
                pos += used
    if ctype == 3:
        if palette is None:
            raise ValueError("palette image without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[pix[:, :, 0]]
    if depth == 16:
        if ctype == 0:
            return np.minimum(pix, 255).astype(np.uint8)
        return (pix >> 8).astype(np.uint8)
    if depth < 8:
        return pix * np.uint8(255 // ((1 << depth) - 1))
    return pix


def read_png(path) -> np.ndarray:
    """PNG file -> :func:`decode_png` of its bytes; errors name the file."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        return decode_png(blob)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1) uint8 -> L; (H, W, 3) uint8 -> RGB: the bytes of
    a PNG file, filter 0 on every row."""
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.ndim == 2:
        ctype, arr3 = 0, arr[:, :, None]
    elif arr.ndim == 3 and arr.shape[2] == 3:
        ctype, arr3 = 2, arr
    else:
        raise ValueError(f"cannot write an image of shape {arr.shape}")
    h, w, c = arr3.shape
    rows = np.zeros((h, w * c + 1), np.uint8)  # filter byte 0 on every row
    rows[:, 1:] = arr3.reshape(h, w * c)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """:func:`encode_png` of ``img`` into a file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def to_rgb(pix: np.ndarray) -> np.ndarray:
    """:func:`decode_png`'s (H, W, C) samples -> (H, W, 3) RGB uint8, as
    PIL's ``convert("RGB")``: grey replicated, alpha dropped."""
    if pix.shape[2] <= 2:
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])


def load_image(img_filepath, grayscale: bool = False) -> np.ndarray:
    """PNG -> (H, W, 3) RGB uint8, or (H, W, 1) luma with ``grayscale``."""
    arr = to_rgb(read_png(img_filepath))
    if grayscale:
        # cv2.cvtColor(BGR2GRAY) rounding: y = 0.299 R + 0.587 G + 0.114 B.
        y = arr.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                              np.float32)
        return np.clip(np.rint(y), 0, 255).astype(np.uint8)[:, :, None]
    return arr


def save_image(img: np.ndarray, save_filepath, grayscale: bool = False) -> None:
    arr = np.asarray(img)
    if grayscale and arr.ndim == 3 and arr.shape[2] != 1:
        raise ValueError("grayscale=True needs an (H, W) or (H, W, 1) image")
    write_png(save_filepath, arr)


def load_json(json_path):
    with open(json_path) as f:
        return json.load(f)


def save_json(obj, save_path) -> None:
    with open(save_path, "w") as out:
        json.dump(obj, out)


def load_yaml(filepath):
    """A YAML file's content; needs PyYAML, imported here (ImportError
    without it, as the JAX function raises)."""
    import yaml
    with open(filepath) as stream:
        return yaml.safe_load(stream)


def save_metrics(metrics, filename) -> None:
    """Pickle ``metrics`` to ``filename``."""
    with open(filename, "wb") as fid:
        pickle.dump(metrics, fid)


def load_metrics(filename):
    """Unpickle a file that :func:`save_metrics` wrote (unpickling runs
    code: read only files this program wrote)."""
    with open(filename, "rb") as f:
        return pickle.load(f)


_SVG_HEADER = ('<svg xmlns="http://www.w3.org/2000/svg" '
               'width="{w:.10g}" height="{h:.10g}" '
               'viewBox="0 0 {w:.10g} {h:.10g}">\n')


def _fmt(v: float) -> str:
    return f"{float(v):.10g}"


def strokes_to_svg(strokes, size: tuple[float, float] | None = None,
                   scale: float = 1.0, stroke_width: float = 2.0,
                   color: str = "#000") -> str:
    """``[(X, Y), ...]`` polylines -> an SVG document: image coordinates, y
    pointing down, one polyline per stroke (a dot for a single vertex).
    ``size`` is the canvas (width, height), inferred from the strokes'
    extent plus a stroke width when omitted; ``scale`` multiplies the
    coordinates as ``strokes_to_json``'s does."""
    polys = []
    for x, y in strokes:
        x = np.asarray(x, dtype=np.float64) * scale
        y = np.asarray(y, dtype=np.float64) * scale
        n = min(x.size, y.size)
        if n:
            polys.append((x[:n], y[:n]))
    if size is None:
        if polys:
            size = (max(float(p[0].max()) for p in polys) + stroke_width,
                    max(float(p[1].max()) for p in polys) + stroke_width)
        else:
            size = (stroke_width, stroke_width)
    parts = [_SVG_HEADER.format(w=size[0], h=size[1])]
    for x, y in polys:
        if x.size == 1:  # a zero-length polyline would not show
            parts.append(f'  <circle cx="{_fmt(x[0])}" cy="{_fmt(y[0])}" '
                         f'r="{_fmt(stroke_width / 2)}" fill="{color}"/>\n')
        else:
            pts = " ".join(f"{_fmt(a)},{_fmt(b)}" for a, b in zip(x, y))
            parts.append(f'  <polyline points="{pts}" fill="none" '
                         f'stroke="{color}" '
                         f'stroke-width="{_fmt(stroke_width)}" '
                         f'stroke-linecap="round" stroke-linejoin="round"/>\n')
    parts.append("</svg>\n")
    return "".join(parts)


def save_svg(strokes, filepath, size: tuple[float, float] | None = None,
             scale: float = 1.0, stroke_width: float = 2.0,
             color: str = "#000") -> None:
    Path(filepath).write_text(
        strokes_to_svg(strokes, size=size, scale=scale,
                       stroke_width=stroke_width, color=color))


def json_strokes_to_svg(stroke_json: list, **kwargs) -> str:
    """A ``_STROKES.json`` structure ([[X list, Y list], ...]) -> SVG."""
    return strokes_to_svg([(np.asarray(x), np.asarray(y))
                           for x, y in stroke_json], **kwargs)
