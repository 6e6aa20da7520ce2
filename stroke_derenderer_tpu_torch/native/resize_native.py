"""``ctypes`` binding of ``resize.cpp``: the uint8 bilinear resize, bit for
bit ``ops.resize.resize_bilinear_np(..., backend="numpy")`` (counterpart of
the JAX ``native/resize_native.py``; a failed build raises)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from stroke_derenderer_tpu_torch import native

_U8P = ctypes.POINTER(ctypes.c_uint8)
# Calls of sd_resize_u8 made by this process (tests read it).
call_count = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    # No FMA contraction: every float32 step rounds as numpy's does.
    lib = native.load("resize", ("-ffp-contract=off",))
    lib.sd_resize_u8.restype = ctypes.c_int32
    lib.sd_resize_u8.argtypes = [_U8P, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int32, _U8P, ctypes.c_int32,
                                 ctypes.c_int32]
    return lib


def resize_u8(img: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    """(H, W[, C]) uint8 -> (dst_h, dst_w[, C]) uint8, cv2 bilinear
    semantics (half-pixel centres, edge clamp)."""
    global call_count
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    img = np.ascontiguousarray(img)
    out = np.empty((dst_h, dst_w, c), dtype=np.uint8)
    rc = _lib().sd_resize_u8(img.ctypes.data_as(_U8P), h, w, c,
                             out.ctypes.data_as(_U8P), dst_h, dst_w)
    call_count += 1
    if rc != 0:
        raise RuntimeError(f"native resize failed ({rc}) for {img.shape} -> "
                           f"({dst_h}, {dst_w})")
    return out[:, :, 0] if squeeze else out
