"""Intensity normalization: the numpy half of the JAX ``ops/normalize.py``."""

from __future__ import annotations

import numpy as np


def minmax_normalize_np(img: np.ndarray, lo: float = 0.0,
                        hi: float = 255.0) -> np.ndarray:
    """Rescale to [lo, hi]; a constant image maps to lo. uint8 in -> uint8
    out, rounded (cv2.normalize NORM_MINMAX)."""
    x = img.astype(np.float32)
    mn, mx = x.min(), x.max()
    scale = ((hi - lo) / max(mx - mn, 1e-12)) if mx > mn else 0.0
    out = (x - mn) * scale + lo
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def imagenet_normalize_np(img_u8: np.ndarray, mean, std) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3) float32 model input: ``(x / 255 - mean) /
    std`` per channel, NHWC."""
    x = img_u8.astype(np.float32) / 255.0
    return ((x[..., None] - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)
