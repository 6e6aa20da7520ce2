"""Bilinear resize with OpenCV semantics (half-pixel centres, edge clamp),
on the host: the host path of the JAX ``ops/resize.py``.

As in the JAX package, uint8 images take the native C++ resize
(``native/resize.cpp``, built with g++ at first use; a failed build raises)
by default: bit for bit this module's numpy gather + lerp, several times
faster, and a ctypes call releases the GIL, so the two-stage pipeline's
threads overlap. ``backend="numpy"`` asks for the numpy version, which
other dtypes always take.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=256)
def _interp_coords(src: int, dst: int):
    """Per output texel: first and second source index and the second's
    weight, with OpenCV's clamp at both edges."""
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    f = x - x0
    f = np.where(x0 < 0, 0.0, f)
    x0 = np.clip(x0, 0, src - 1)
    f = np.where(x0 >= src - 1, 0.0, f)
    x1 = np.clip(x0 + 1, 0, src - 1)
    return x0, x1, f.astype(np.float32)


def resize_bilinear_np(img: np.ndarray, dst_h: int, dst_w: int,
                       backend: str = "native") -> np.ndarray:
    """cv2.resize(img, (dst_w, dst_h)) equivalent. uint8 stays uint8
    (rounded to nearest, clipped) and runs natively unless ``backend`` is
    ``"numpy"``; other dtypes come back float32."""
    if backend not in ("native", "numpy"):
        raise ValueError(f"backend must be 'native' or 'numpy', got "
                         f"{backend!r}")
    if img.dtype == np.uint8 and backend == "native":
        from stroke_derenderer_tpu_torch.native import resize_native
        return resize_native.resize_u8(img, dst_h, dst_w)
    h, w = img.shape[0], img.shape[1]
    y0, y1, fy = _interp_coords(h, dst_h)
    x0, x1, fx = _interp_coords(w, dst_w)
    x = img.astype(np.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    # lerp as a + f * (b - a), rows then columns.
    top = x[y0]
    d = x[y1]
    np.subtract(d, top, out=d)
    np.multiply(d, fy[:, None, None], out=d)
    np.add(top, d, out=top)
    left = top[:, x0]
    d = top[:, x1]
    np.subtract(d, left, out=d)
    np.multiply(d, fx[None, :, None], out=d)
    np.add(left, d, out=left)
    x = left[:, :, 0] if squeeze else left
    if img.dtype == np.uint8:
        x = np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return x


def resize_to_height_np(img: np.ndarray, height: int,
                        backend: str = "native") -> np.ndarray:
    """Aspect-preserving resize; the width truncates like
    ``int(w * ratio)``."""
    h, w = img.shape[0], img.shape[1]
    return resize_bilinear_np(img, height, int(w * (height / h)), backend)
