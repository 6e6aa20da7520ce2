"""Connected components (8-connectivity) with cv2-style bounding boxes.

Counterpart of the JAX ``ops/connected.py``. Labels are int32, background
0, components numbered 1..N in raster first-encounter order; boxes are
(x, y, w, h) = (left, top, width, height). Backends:

- ``"native"`` (the default): the port's copy of the JAX package's C++
  union-find (``native/cc.cpp``) through ctypes, as the JAX package runs it
  wherever g++ is present; a failed build raises.
- ``"scipy"``: ``scipy.ndimage.label``, the plain version (the same
  numbering), taken only when asked for.
- :func:`connected_components_device`: the same labels from torch ops on
  the tensor's device (the JAX ``connected_components_jnp``, on no CLI
  path).
"""

from __future__ import annotations

import numpy as np
import torch

_EIGHT = np.ones((3, 3), dtype=np.int32)
BACKENDS = ("native", "scipy")


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _scipy_label(img: np.ndarray) -> tuple[np.ndarray, int]:
    from scipy import ndimage
    labels, num = ndimage.label(np.asarray(img) != 0, structure=_EIGHT)
    return labels.astype(np.int32), int(num)


def _mask_u8(img) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(img) != 0, dtype=np.uint8)


def connected_components(img: np.ndarray, backend: str = "native"
                         ) -> tuple[np.ndarray, int]:
    """(H, W), nonzero = foreground -> (labels int32, number of components)."""
    _check(backend)
    if backend == "scipy":
        return _scipy_label(img)
    from stroke_derenderer_tpu_torch.native import cc_native
    return cc_native.label(_mask_u8(img))


def bounding_boxes(labels: np.ndarray, num: int) -> np.ndarray:
    """(N, 4) cv2-style (x, y, w, h) for components 1..N, vectorized."""
    if num == 0:
        return np.zeros((0, 4), np.int64)
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    order = np.argsort(lab, kind="stable")
    lab, ys, xs = lab[order], ys[order], xs[order]
    # Each label's run in the sorted pixels (labels 1..N, all present).
    counts = np.bincount(lab, minlength=num + 1)[1:]
    starts = np.cumsum(counts) - counts
    x0 = np.minimum.reduceat(xs, starts)
    y0 = np.minimum.reduceat(ys, starts)
    x1 = np.maximum.reduceat(xs, starts)
    y1 = np.maximum.reduceat(ys, starts)
    return np.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], axis=1)


def connected_components_with_boxes(img: np.ndarray, with_area: bool = False,
                                    backend: str = "native"):
    """-> (labels, boxes (N, 4) int64[, areas (N,) pixel counts])."""
    _check(backend)
    if backend == "native":
        from stroke_derenderer_tpu_torch.native import cc_native
        labels, _, stats = cc_native.label_with_stats(_mask_u8(img))
        boxes = stats[:, :4].astype(np.int64)
        if with_area:
            return labels, boxes, stats[:, 4].astype(np.int64)
        return labels, boxes
    labels, num = _scipy_label(img)
    boxes = bounding_boxes(labels, num)
    if with_area:
        return labels, boxes, np.bincount(labels.ravel(),
                                          minlength=num + 1)[1:]
    return labels, boxes


def connected_components_device(img: torch.Tensor
                                ) -> tuple[torch.Tensor, int]:
    """(H, W) tensor, nonzero = foreground -> (labels int32 on its device,
    num), the numbering of :func:`connected_components`.

    Every foreground pixel starts with its linear index + 1. Each round
    takes the minimum over the 3 x 3 neighbourhood (a max-pool of the
    negated labels), then jumps every label to the label of the pixel it
    names (a label is always the index + 1 of a pixel of the same
    component), until nothing changes: each component then carries the
    index + 1 of its first raster pixel, its root. Roots ranked in raster
    order give the compact labels, as the JAX version ranks them."""
    h, w = img.shape
    fg = img != 0
    n = h * w
    big = float(n + 1)
    idx = torch.arange(1, n + 1, dtype=torch.float64,
                       device=img.device).reshape(h, w)
    lab = torch.where(fg, idx, big)
    while True:
        pooled = -torch.nn.functional.max_pool2d(
            -lab[None, None], 3, stride=1, padding=1)[0, 0]
        new = torch.where(fg, pooled, big)
        flat = new.reshape(-1)
        jumped = flat[(torch.clamp(flat, max=n) - 1).long()]
        new = torch.where(fg, torch.minimum(new, jumped.reshape(h, w)), big)
        if torch.equal(new, lab):
            break
        lab = new
    flat = torch.where(fg, lab, 0.0).reshape(-1).long()
    is_root = flat == torch.arange(1, n + 1, device=img.device)
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32)
    out = torch.where(flat > 0, rank[torch.clamp(flat - 1, min=0)], 0)
    num = int(rank[-1]) if n else 0
    return out.reshape(h, w).to(torch.int32), num
