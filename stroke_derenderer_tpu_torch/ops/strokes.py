"""Stroke token grammar and polyline post-processing, copied from the JAX
``ops/strokes.py`` (host numpy): token decoding, sorting, and the residual
re-decode's fragment join and ink-snap refinement.

Tokens: PAD/BOS/EOS = 0/1/2, then vertex tokens where v = token - 3 is an
x coordinate if v < image_size and a y coordinate (v - image_size)
otherwise. Quirks kept on purpose: an odd-length vertex run drops its last
element; clipping tests X against img_shape[0] and Y against img_shape[1]
with inclusive upper bounds; the endpoint sort keys on coordinates
truncated to int32, with ties resolved stably.
"""

from __future__ import annotations

import numpy as np

from stroke_derenderer_tpu_torch.config import BOS, EOS, PAD

Stroke = tuple[np.ndarray, np.ndarray]


def tokens_to_strokes(token_seq: np.ndarray, image_size: int) -> list[Stroke]:
    """One token sequence -> (X, Y) polylines."""
    toks = np.asarray(token_seq)
    eos_pos = np.flatnonzero(toks == EOS)
    if eos_pos.size:
        toks = toks[:eos_pos[0]]
    keep = (toks != BOS) & (toks != PAD)
    vals = (toks[keep] - (EOS + 1)).astype(np.int64)
    if vals.size == 0:
        return []
    rid = np.cumsum(toks == BOS)[keep]
    strokes: list[Stroke] = []
    for seq in np.split(vals, np.flatnonzero(np.diff(rid)) + 1):
        # A single-vertex run truncates to an empty stroke that is still
        # appended; sort_strokes drops it later.
        if seq.size % 2 != 0:
            seq = seq[:-1]
        strokes.append((seq[0::2], seq[1::2] - image_size))
    return strokes


def decode_tokens_batch(tokens: np.ndarray, image_size: int,
                        img_shape: tuple[int, int],
                        trans1, ratio, trans2) -> list[list[Stroke]]:
    """tokens_to_strokes + clip_strokes + inverse_transform over a whole
    (N, L) token matrix in one numpy pass (empty strokes are dropped here
    rather than by sort_strokes; the final output is the same).
    ``trans1``/``trans2``: (N, 2) (x, y) rows; ``ratio``: (N,)."""
    toks = np.ascontiguousarray(tokens)
    n_rows, length = toks.shape
    alive = np.cumsum(toks == EOS, axis=1) == 0
    keep = alive & (toks != BOS) & (toks != PAD)
    rid = np.cumsum(toks == BOS, axis=1)
    rowk = np.arange(n_rows, dtype=np.int64)[:, None] * (length + 1)
    runkey = (rowk + rid)[keep]
    vals = (toks[keep] - (EOS + 1)).astype(np.int64)
    if vals.size == 0:
        return [[] for _ in range(n_rows)]

    bounds = np.flatnonzero(np.diff(runkey)) + 1
    starts = np.concatenate(([0], bounds))
    lens = np.diff(np.concatenate((starts, [vals.size])))
    seg_of = np.repeat(np.arange(starts.size), lens)
    pos = np.arange(vals.size) - starts[seg_of]
    even_len = lens - (lens & 1)
    tok_keep = pos < even_len[seg_of]
    vals, pos, seg_of = vals[tok_keep], pos[tok_keep], seg_of[tok_keep]
    row_seg = (runkey[starts] // (length + 1)).astype(np.int64)

    xs = vals[pos % 2 == 0].astype(np.float64)
    ys = (vals[pos % 2 == 1] - image_size).astype(np.float64)
    vseg = seg_of[pos % 2 == 0]
    vkeep = ((xs >= 0) & (xs <= img_shape[0])
             & (ys >= 0) & (ys <= img_shape[1]))
    xs, ys, vseg = xs[vkeep], ys[vkeep], vseg[vkeep]
    t1 = np.asarray(trans1, np.float64)
    t2 = np.asarray(trans2, np.float64)
    rr = np.asarray(ratio, np.float64)
    vrow = row_seg[vseg]
    xs = (xs - t2[vrow, 0]) / rr[vrow] + t1[vrow, 0]
    ys = (ys - t2[vrow, 1]) / rr[vrow] + t1[vrow, 1]

    vbounds = np.flatnonzero(np.diff(vseg)) + 1
    x_parts = np.split(xs, vbounds)
    y_parts = np.split(ys, vbounds)
    seg_rows = row_seg[vseg[np.concatenate(([0], vbounds))]] \
        if vseg.size else np.empty(0, np.int64)
    out: list[list[Stroke]] = [[] for _ in range(n_rows)]
    for r, x, y in zip(seg_rows, x_parts, y_parts):
        if x.size:
            out[int(r)].append((x, y))
    return out


def clip_strokes(strokes: list[Stroke],
                 img_shape: tuple[int, int]) -> list[Stroke]:
    """Drop vertices outside [0, img_shape] per coordinate."""
    out = []
    for x, y in strokes:
        n = min(x.size, y.size)
        x, y = x[:n], y[:n]
        keep = (x >= 0) & (x <= img_shape[0]) & (y >= 0) & (y <= img_shape[1])
        out.append((x[keep], y[keep]))
    return out


def inverse_transform(strokes: list[Stroke], trans1, ratio,
                      trans2) -> list[Stroke]:
    """Undo pad -> resize -> crop: P = (P' - t2) / ratio + t1."""
    (x1, y1), (x2, y2) = trans1, trans2
    return [((x - x2) / ratio + x1, (y - y2) / ratio + y1) for x, y in strokes]


def sort_strokes(strokes: list[Stroke]) -> list[Stroke]:
    """Order strokes by their first-seen endpoint in an (x, y) lexicographic
    sort over all endpoints, reversing a stroke whose tail came first.
    Empty strokes are dropped."""
    strokes = [(x, y) for x, y in strokes
               if np.asarray(x).size and np.asarray(y).size]
    if not strokes:
        return []
    pts = np.empty((2 * len(strokes), 2), dtype=np.float64)
    pts[0::2] = [(x[0], y[0]) for x, y in strokes]
    pts[1::2] = [(x[-1], y[-1]) for x, y in strokes]
    keys = pts.astype(np.int32)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    seen = np.zeros(len(strokes), dtype=bool)
    out: list[Stroke] = []
    for e in order:
        s, rem = divmod(int(e), 2)
        if seen[s]:
            continue
        seen[s] = True
        x, y = strokes[s]
        out.append((x[::-1], y[::-1]) if rem == 1 else (x, y))
    return out


def merge_stroke_fragments(strokes: list[Stroke],
                           tol: float = 4.0) -> list[Stroke]:
    """Join polylines whose endpoints lie within ``tol`` px into single
    strokes, the closest pair first (on a tie the last pair scanned, by
    ``d <= best``), until no pair is that close. Used by residual
    re-decode: a residual pass traces the uncovered remainder of a stroke
    that an earlier pass traced in part. Empty strokes are dropped."""
    strokes = [(np.asarray(x, np.float64), np.asarray(y, np.float64))
               for x, y in strokes if np.asarray(x).size]
    while len(strokes) > 1:
        best_d, best = tol, None
        for i in range(len(strokes)):
            xi, yi = strokes[i]
            for j in range(i + 1, len(strokes)):
                xj, yj = strokes[j]
                for ei in (0, -1):
                    for ej in (0, -1):
                        d = float(np.hypot(xi[ei] - xj[ej], yi[ei] - yj[ej]))
                        if d <= best_d:
                            best_d, best = d, (i, j, ei, ej)
        if best is None:
            break
        i, j, ei, ej = best
        xi, yi = strokes[i]
        xj, yj = strokes[j]
        if ei == 0:  # the joined end must be stroke i's tail
            xi, yi = xi[::-1], yi[::-1]
        if ej == -1:  # ... and stroke j's head
            xj, yj = xj[::-1], yj[::-1]
        strokes[i] = (np.concatenate([xi, xj]), np.concatenate([yi, yj]))
        del strokes[j]
    return strokes


def refine_strokes(strokes: list[Stroke], mask: np.ndarray,
                   max_shift: float = 3.0,
                   densify: float = 2.0) -> list[Stroke]:
    """Snap polylines onto the ink of ``mask``. With ``densify`` > 0 each
    polyline is resampled at ~``densify`` px of arc length, every point
    within ``max_shift`` px of ink (and not on it) moves to the 5x5 ink
    centroid around its nearest ink pixel, and the result is resampled
    back to the polyline's own vertex count, uniformly in arc length.
    With ``densify`` = 0 the vertices move to their nearest ink pixel.
    Points farther than ``max_shift`` from ink stay; consecutive
    duplicates are dropped."""
    from scipy import ndimage

    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    mask = mask.astype(bool)
    if not mask.any() or not strokes:
        return strokes
    # The EDT of the background gives each pixel its nearest ink pixel.
    dist, (iy, ix) = ndimage.distance_transform_edt(~mask,
                                                    return_indices=True)
    h, w = mask.shape
    if densify > 0:
        m = mask.astype(np.float64)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        ksum = ndimage.uniform_filter(m, size=5, mode="constant")
        cx = np.divide(
            ndimage.uniform_filter(m * xx, size=5, mode="constant"),
            ksum, out=xx.copy(), where=ksum > 0)
        cy = np.divide(
            ndimage.uniform_filter(m * yy, size=5, mode="constant"),
            ksum, out=yy.copy(), where=ksum > 0)
    else:
        cy, cx = (iy.astype(np.float64), ix.astype(np.float64))
    out: list[Stroke] = []
    for x, y in strokes:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n0 = x.size
        if densify > 0 and x.size > 1:
            seg = np.hypot(np.diff(x), np.diff(y))
            ts = np.concatenate([[0.0], np.cumsum(seg)])
            total = ts[-1]
            if total > densify:
                t = np.linspace(0.0, total,
                                int(np.ceil(total / densify)) + 1)
                x = np.interp(t, ts, x)
                y = np.interp(t, ts, y)
        xi = np.clip(np.rint(x), 0, w - 1).astype(np.int64)
        yi = np.clip(np.rint(y), 0, h - 1).astype(np.int64)
        d = dist[yi, xi]
        snap = (d > 0) & (d <= max_shift)
        ny, nx = iy[yi, xi], ix[yi, xi]
        sx = np.where(snap, cx[ny, nx], x)
        sy = np.where(snap, cy[ny, nx], y)
        if sx.size > 1:
            keep = np.concatenate(
                [[True], (np.diff(sx) != 0) | (np.diff(sy) != 0)])
            sx, sy = sx[keep], sy[keep]
        if densify > 0 and sx.size > 2 and n0 > 1:
            seg = np.hypot(np.diff(sx), np.diff(sy))
            ts = np.concatenate([[0.0], np.cumsum(seg)])
            if ts[-1] > 0:
                t = np.linspace(0.0, ts[-1], n0)
                sx = np.interp(t, ts, sx)
                sy = np.interp(t, ts, sy)
        out.append((sx, sy))
    return out


def strokes_to_json(strokes: list[Stroke], scale: float = 1.0) -> list:
    """[[X_list, Y_list], ...] scaled by ``scale``."""
    out = []
    for x, y in strokes:
        n = min(np.asarray(x).size, np.asarray(y).size)
        out.append(([float(v) for v in np.asarray(x)[:n] * scale],
                    [float(v) for v in np.asarray(y)[:n] * scale]))
    return out
