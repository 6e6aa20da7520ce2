"""``ctypes`` binding of ``cc.cpp``: 8-connected components of a uint8
mask with cv2-style stats (counterpart of the JAX ``native/cc_native.py``;
a failed build raises)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from stroke_derenderer_tpu_torch import native

_I32P = ctypes.POINTER(ctypes.c_int32)
# Calls of sd_cc_label made by this process (tests read it).
call_count = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("cc")
    lib.sd_cc_label.restype = ctypes.c_int32
    lib.sd_cc_label.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                                ctypes.c_int32, _I32P, _I32P, ctypes.c_int32]
    return lib


def label_with_stats(img_u8: np.ndarray):
    """(H, W) uint8, nonzero = foreground -> (labels int32, num, stats
    (num, 5) int32 rows [left, top, width, height, area]); labels 1..num in
    raster first-encounter order, background 0."""
    global call_count
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img_u8.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got {img_u8.shape}")
    h, w = img_u8.shape
    labels = np.empty((h, w), dtype=np.int32)
    # At most one component per 2 x 2 cell under 8-connectivity.
    max_comp = max(1, -(-h // 2) * -(-w // 2))
    stats = np.empty((max_comp, 5), dtype=np.int32)
    num = _lib().sd_cc_label(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        labels.ctypes.data_as(_I32P), stats.ctypes.data_as(_I32P), max_comp)
    call_count += 1
    if num < 0:
        raise RuntimeError("component count exceeded its buffer")
    return labels, int(num), stats[:num].copy()


def label(img_u8: np.ndarray) -> tuple[np.ndarray, int]:
    """(H, W) uint8 mask -> (labels int32, num)."""
    labels, num, _ = label_with_stats(img_u8)
    return labels, num
