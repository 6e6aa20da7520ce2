"""Host arithmetic of the upstream pipeline, in numpy: the line's resize and
tiles, the glyph partition (connected components, interval grouping, the
crop's resize and pad) and the inverse transform of the decoder's tokens
into sorted polylines.

Frozen copies of the upstream project's functions (``common.py``,
``split.py``, ``partition.py``, ``strokes.py``), with their quirks kept on
purpose where named: the benchmark judges the program against what the
upstream pipeline computes, not against what would be tidier.
"""

from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2


# ------------------------------------------------------------------ resize

def _coords(src: int, dst: int):
    """cv2.INTER_LINEAR's source indices and weights: half-pixel centres,
    clamped at both edges."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x).astype(np.int64)
    f = x - x0
    f = np.where(x0 < 0, 0.0, f)
    x0 = np.clip(x0, 0, src - 1)
    f = np.where(x0 >= src - 1, 0.0, f)
    return x0, np.clip(x0 + 1, 0, src - 1), f.astype(np.float32)


def resize_bilinear(img: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    """cv2.resize(img, (dst_w, dst_h)): rows then columns, each a float32
    lerp a + f * (b - a); uint8 in -> uint8 out, rounded half to even."""
    y0, y1, fy = _coords(img.shape[0], dst_h)
    x0, x1, fx = _coords(img.shape[1], dst_w)
    x = img.astype(np.float32)
    if x.ndim == 2:
        x = x[:, :, None]
    top = x[y0]
    top = top + (x[y1] - top) * fy[:, None, None]
    left = top[:, x0]
    out = left + (top[:, x1] - left) * fx[None, :, None]
    out = out[:, :, 0] if img.ndim == 2 else out
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def resize_to_height(img: np.ndarray, height: int) -> np.ndarray:
    """Aspect-preserving; the width truncates as ``int(w * ratio)``."""
    return resize_bilinear(img, height, int(img.shape[1] * (height / img.shape[0])))


# ------------------------------------------------------------------- tiles

def tile_plan(width: int, tile: int, overlap: int):
    """(starts, widths) of the tiles of a line ``width`` columns wide:
    ``width // (tile - overlap) + 1`` tiles of ``width // n`` columns plus
    the overlap (one right-padded tile below ``tile``)."""
    if width < tile:
        return [0], [width]
    n = width // (tile - overlap) + 1
    step = width // n
    starts = [i * step for i in range(n)]
    return starts, [min((i + 1) * step + overlap, width) - s
                    for i, s in enumerate(starts)]


def cut_tiles(img: np.ndarray, tile: int, overlap: int) -> np.ndarray:
    """(H, W, C) -> (n, H, tile, C), zero past each tile's width."""
    starts, widths = tile_plan(img.shape[1], tile, overlap)
    out = np.zeros((len(starts), img.shape[0], tile, img.shape[2]), img.dtype)
    for i, (s, w) in enumerate(zip(starts, widths)):
        out[i, :, :w] = img[:, s:s + w]
    return out


def stitch_tiles(tiles: np.ndarray, width: int, overlap: int) -> np.ndarray:
    """(n, H, tile, C) -> (H, width, C): each tile's own columns pasted at
    the running sum of (width - overlap), the maximum where they overlap."""
    _, widths = tile_plan(width, tiles.shape[2], overlap)
    canvas = np.zeros((tiles.shape[1], width, tiles.shape[3]), tiles.dtype)
    pos = 0
    for i, w in enumerate(widths):
        canvas[:, pos:pos + w] = np.maximum(canvas[:, pos:pos + w],
                                            tiles[i, :, :w])
        pos += w - overlap
    return canvas


# --------------------------------------------------------------- partition

def islands(mask: np.ndarray, margin: int):
    """8-connected components in raster order of first pixel, each cut
    with its box grown by ``margin`` on the top and left and ``margin + 1``
    on the bottom and right (the upstream quirk) -> [(crop, (top, left))],
    sorted by left column, stably."""
    from scipy import ndimage  # here: the check runs after the timed window
    labels, n = ndimage.label(mask != 0, structure=np.ones((3, 3), bool))
    h, w = mask.shape
    out = []
    for k, sl in enumerate(ndimage.find_objects(labels), start=1):
        y, x = sl[0].start, sl[1].start
        bh, bw = sl[0].stop - y, sl[1].stop - x
        ys, xs = max(y - margin, 0), max(x - margin, 0)
        yf, xf = min(y + bh + margin + 1, h), min(x + bw + margin + 1, w)
        out.append(((labels[ys:yf, xs:xf] == k).astype(np.uint8), (ys, xs)))
    order = np.argsort([t[1][1] for t in out], kind="stable")
    return [out[i] for i in order]


def group_intervals(intervals, width: int):
    """Upstream's grouping of left-sorted column intervals into groups that
    fit ``width``: an interval wider than ``width`` absorbs those it
    contains (the scan stopping at the first that starts past its end),
    transitively; the rest pack greedily, the first group measured from
    column 0."""
    n = len(intervals)
    edges = {i: [] for i in range(n)}
    contained = [False] * n
    for i, (a, b) in enumerate(intervals):
        if b - a <= width:
            continue
        for k, (c, d) in enumerate(intervals):
            if k == i:
                continue
            if c > b:
                break
            if a <= c and b >= d:
                edges[i].append(k)
                edges[k].append(i)
                contained[i] = contained[k] = True
    groups = []
    live = {i: v for i, v in edges.items() if v}
    done = {i: False for i in live}
    for f in live:
        if done[f]:
            continue
        group, stack = [], [(f, 0)]
        while stack:  # depth first, members in first-visit order
            node, j = stack.pop()
            while j < len(live[node]):
                nxt = live[node][j]
                j += 1
                if nxt not in group:
                    group.append(nxt)
                    stack += [(node, j), (nxt, 0)]
                    break
        for m in group:
            done[m] = True
        done[f] = True
        groups.append(group)
    short, group, run, left = [], [], 0, 0
    for i, (a, b) in enumerate(intervals):
        if contained[i]:
            continue
        if max(b - left, run) > width:
            short.append(group)
            group, run, left = [i], b - a, a
        else:
            group.append(i)
            run = max(b - left, run)
    short.append(group)
    return [g for g in groups + short if g]


def _pad_edges(n: int):
    return (n // 2, n // 2) if n % 2 == 0 else (n // 2, n // 2 + 1)


def partition(mask: np.ndarray, margin: int, size: int):
    """A binarized (H, W) line -> its glyph groups, in the order the
    decoder's rows take them: [(crop (size, size) uint8, (left, top),
    ratio, (x_off, y_off))]. A group is its islands added onto one canvas
    of the line's height in width, re-binarized, min-max stretched to
    0..255, resized into the crop less a 1 px margin and padded evenly."""
    isl = islands(mask, margin)
    out = []
    for inds in group_intervals([(l, l + c.shape[1]) for c, (_, l) in isl],
                                mask.shape[0]):
        subs = [isl[k] for k in inds]
        top = min(t for _, (t, _) in subs)
        left = min(l for _, (_, l) in subs)
        bottom = max(t + c.shape[0] for c, (t, _) in subs)
        right = max(l + c.shape[1] for c, (_, l) in subs)
        canvas = np.zeros((bottom - top, right - left), np.uint8)
        for c, (t, l) in subs:
            canvas[t - top:t - top + c.shape[0], l - left:l - left + c.shape[1]] += c
        canvas = (canvas > 0).astype(np.float32)
        lo, hi = canvas.min(), canvas.max()
        canvas = np.clip(np.rint((canvas - lo) * (255.0 / max(hi - lo, 1e-12))
                                 if hi > lo else canvas * 0), 0, 255
                         ).astype(np.uint8)
        gh, gw = canvas.shape
        inner = size - 2
        scale = min(inner / gh, inner / gw)
        rs_w = int(min(np.rint(scale * gw), inner))
        rs_h = int(min(np.rint(scale * gh), inner))
        crop = np.pad(resize_bilinear(canvas, rs_h, rs_w),
                      [_pad_edges(size - rs_h), _pad_edges(size - rs_w)])
        out.append((crop, (left, top), (rs_w / gw + rs_h / gh) / 2,
                    ((size - rs_w) / 2, (size - rs_h) / 2)))
    return out


# ----------------------------------------------------------------- strokes

def tokens_to_strokes(tokens: np.ndarray, size: int):
    """One row of tokens -> (X, Y) vertex runs in the crop's frame: up to
    the first EOS, a run per BOS, vertex token v = t - 3 an x below
    ``size`` and a y (v - size) above; an odd run drops its last value."""
    toks = np.asarray(tokens)
    eos = np.flatnonzero(toks == EOS)
    if eos.size:
        toks = toks[:eos[0]]
    keep = (toks != BOS) & (toks != PAD)
    vals = (toks[keep] - 3).astype(np.int64)
    if vals.size == 0:
        return []
    rid = np.cumsum(toks == BOS)[keep]
    out = []
    for seq in np.split(vals, np.flatnonzero(np.diff(rid)) + 1):
        if seq.size % 2:
            seq = seq[:-1]
        out.append((seq[0::2], seq[1::2] - size))
    return out


def glyph_strokes(tokens, size: int, trans1, ratio, trans2):
    """A glyph's tokens -> its polylines in the line's frame: vertices
    outside [0, size] dropped, then P = (P' - t2) / ratio + t1."""
    out = []
    for x, y in tokens_to_strokes(tokens, size):
        n = min(x.size, y.size)
        x, y = x[:n].astype(np.float64), y[:n].astype(np.float64)
        keep = (x >= 0) & (x <= size) & (y >= 0) & (y <= size)
        out.append(((x[keep] - trans2[0]) / ratio + trans1[0],
                    (y[keep] - trans2[1]) / ratio + trans1[1]))
    return out


def sort_strokes(strokes):
    """Writing order: strokes by their first endpoint in an (x, y)
    lexicographic sort of all endpoints truncated to int32 (stable), a
    stroke reversed where its tail comes first; empty strokes dropped."""
    strokes = [(x, y) for x, y in strokes if len(x) and len(y)]
    if not strokes:
        return []
    pts = np.empty((2 * len(strokes), 2), np.float64)
    pts[0::2] = [(x[0], y[0]) for x, y in strokes]
    pts[1::2] = [(x[-1], y[-1]) for x, y in strokes]
    keys = pts.astype(np.int32)
    seen = np.zeros(len(strokes), bool)
    out = []
    for e in np.lexsort((keys[:, 1], keys[:, 0])):
        s, tail = divmod(int(e), 2)
        if not seen[s]:
            seen[s] = True
            x, y = strokes[s]
            out.append((x[::-1], y[::-1]) if tail else (x, y))
    return out
