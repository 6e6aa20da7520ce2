"""Glyph-island extraction and grouping: host geometry, copied from the
JAX ``ops/grouping.py`` with the reference's quirks kept on purpose:

  * the bounding-box margin is +margin on the top/left and +margin+1 on the
    bottom/right;
  * only intervals strictly wider than the target absorb the intervals they
    contain, and the containment scan stops at the first interval that
    starts past the absorber;
  * greedy packing measures the first group's width from column 0, and its
    first group may be empty (dropped afterwards);
  * a group's crops are added onto one canvas and re-binarized (> 0).
"""

from __future__ import annotations

import numpy as np

from stroke_derenderer_tpu_torch.ops.connected import (
    connected_components_with_boxes,
)
from stroke_derenderer_tpu_torch.ops.resize import resize_bilinear_np

# (crop, (top, left))
Island = tuple[np.ndarray, tuple[int, int]]


def get_binarized_islands(img_bin: np.ndarray, margin: int = 2) -> list[Island]:
    """Crop each connected component with an expanded bounding box."""
    h, w = img_bin.shape[:2]
    labels, boxes = connected_components_with_boxes(img_bin)
    islands: list[Island] = []
    for n, (x, y, bw, bh) in enumerate(boxes, start=1):
        xs, ys = max(x - margin, 0), max(y - margin, 0)
        xf, yf = min(x + bw + margin + 1, w), min(y + bh + margin + 1, h)
        islands.append(((labels[ys:yf, xs:xf] == n).astype(np.uint8),
                        (ys, xs)))
    return islands


def sort_islands(islands: list[Island]) -> list[Island]:
    """Left to right by the crop's left column (a stable sort)."""
    lefts = np.asarray([isl[1][1] for isl in islands])
    return [islands[i] for i in np.argsort(lefts, kind="stable")]


def group_intervals(intervals: list[tuple[int, int]],
                    width: int) -> list[list[int]]:
    """Group intervals sorted by left end to fit a target width. Phase 1:
    each interval wider than ``width`` absorbs the intervals it contains
    (containment edges, transitively closed). Phase 2: the rest pack
    greedily while ``max(b - left, w)`` stays within ``width``."""
    n = len(intervals)
    edges: dict[int, list[int]] = {i: [] for i in range(n)}
    contained = [False] * n
    for i in range(n):
        a_o, b_o = intervals[i]
        if (b_o - a_o) <= width:
            continue
        for k in range(n):
            if k == i:
                continue
            a_i, b_i = intervals[k]
            if a_i > b_o:
                break
            if a_o <= a_i and b_o >= b_i:
                edges[i].append(k)
                edges[k].append(i)
                contained[i] = contained[k] = True
    groups_long = _transitive_groups({i: v for i, v in edges.items() if v})

    groups_short: list[list[int]] = []
    group: list[int] = []
    w_run, left = 0, 0
    for i, (a, b) in enumerate(intervals):
        if contained[i]:
            continue
        new_w = max(b - left, w_run)
        if new_w > width:
            groups_short.append(group)
            group, w_run, left = [i], b - a, a
        else:
            group.append(i)
            w_run = new_w
    groups_short.append(group)
    return [g for g in groups_long + groups_short if g]


def _transitive_groups(edges: dict[int, list[int]]) -> list[list[int]]:
    """Transitive closure of the containment edges, members in depth-first
    first-visit order."""
    groups: list[list[int]] = []
    done = {f: False for f in edges}
    for f in edges:
        if done[f]:
            continue
        group: list[int] = []
        stack = [(f, 0)]
        while stack:
            node, i = stack.pop()
            conns = edges[node]
            while i < len(conns):
                nxt = conns[i]
                i += 1
                if nxt not in group:
                    group.append(nxt)
                    stack.append((node, i))
                    stack.append((nxt, 0))
                    break
        for m in group:
            done[m] = True
        done[f] = True
        groups.append(group)
    return groups


def group_islands(islands: list[Island],
                  target_shape: tuple[int, int]) -> list[Island]:
    """Islands sorted left to right, grouped by :func:`group_intervals` to
    ``target_shape``'s width, each group composited onto one canvas (the
    crops added, then re-binarized)."""
    islands = sort_islands(islands)
    intervals = [(left, left + crop.shape[1]) for crop, (_, left) in islands]
    out: list[Island] = []
    for inds in group_intervals(intervals, target_shape[1]):
        subs = [islands[k] for k in inds]
        top = int(min(t for _, (t, _) in subs))
        left = int(min(l for _, (_, l) in subs))
        bottom = int(max(t + c.shape[0] for c, (t, _) in subs))
        right = int(max(l + c.shape[1] for c, (_, l) in subs))
        canvas = np.zeros((bottom - top, right - left), dtype=np.uint8)
        for crop, (t, l) in subs:
            ch, cw = crop.shape[:2]
            canvas[t - top:t - top + ch, l - left:l - left + cw] += \
                crop.astype(np.uint8)
        out.append(((canvas > 0).astype(np.uint8), (top, left)))
    return out


def get_pad_edges(n: int) -> tuple[int, int]:
    """Split padding over two edges, the odd pixel on the far side."""
    return (n // 2, n // 2) if n % 2 == 0 else (n // 2, n // 2 + 1)


def resize_and_pad_np(image: np.ndarray, new_dims: tuple[int, int],
                      margin: int = 0, pad_value: int = 0):
    """Proportional resize into ``new_dims`` minus margins, then pad evenly.
    Returns (padded, ratio, (x_off, y_off)); the ratio is the mean of the
    achieved h and w ratios, as the inverse transform expects."""
    height, width = image.shape[:2]
    new_h = new_dims[0] - 2 * margin
    new_w = new_dims[1] - 2 * margin
    scale = min(new_h / height, new_w / width)
    rs_w = int(min(np.rint(scale * width), new_w))
    rs_h = int(min(np.rint(scale * height), new_h))
    image_rs = resize_bilinear_np(image, rs_h, rs_w)
    ratio = (rs_w / width + rs_h / height) / 2
    pad_h = get_pad_edges(max(new_dims[0] - rs_h, 0))
    pad_w = get_pad_edges(max(new_dims[1] - rs_w, 0))
    pad_spec = [pad_h, pad_w] + ([(0, 0)] if image_rs.ndim == 3 else [])
    image_pad = np.pad(image_rs, pad_spec, constant_values=pad_value)
    x_off = (image_pad.shape[1] - rs_w) / 2
    y_off = (image_pad.shape[0] - rs_h) / 2
    return image_pad, ratio, (x_off, y_off)
