"""Synthetic handwriting: random pen strokes, their raster, and a noisy
"photo" of that raster, copied from the JAX ``data/synthetic.py`` (host
numpy). The evaluator (``eval/run.py``) draws its samples here and
``pipeline/strokes.residual_ink`` rasterizes predicted strokes here.

Every function draws from its ``np.random.Generator`` in exactly the order
the JAX package does, so a seed gives the same samples, the same
generator state afterwards, and so the same eval numbers. The training
generators (tokens, crops, batches) are not ported.
"""

from __future__ import annotations

import numpy as np


def random_strokes(rng: np.random.Generator, n_strokes: int,
                   shape: tuple[int, int], n_ctrl: int = 5,
                   points_per_stroke: int = 24) -> list:
    """Smooth random strokes inside ``shape`` = (h, w): Catmull-Rom-ish
    resampling of a few control points."""
    h, w = shape
    strokes = []
    for _ in range(n_strokes):
        cx = np.sort(rng.uniform(0, w, n_ctrl))
        cy = rng.uniform(0.15 * h, 0.85 * h, n_ctrl)
        t = np.linspace(0, 1, points_per_stroke)
        ts = np.linspace(0, 1, n_ctrl)
        # Smooth interpolation through control points.
        x = np.interp(t, ts, cx)
        y = np.interp(t, ts, cy)
        k = min(5, points_per_stroke - 1) | 1
        kernel = np.ones(k) / k
        x = np.convolve(np.pad(x, k // 2, mode="edge"), kernel, "valid")
        y = np.convolve(np.pad(y, k // 2, mode="edge"), kernel, "valid")
        strokes.append((np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)))
    return strokes


def _curl_stroke(rng: np.random.Generator, shape: tuple[int, int],
                 pts: int) -> tuple:
    """Closed-ish Lissajous curl: multi-lobe, self-crossing figures."""
    h, w = shape
    span = rng.uniform(2.0, 5.0) * np.pi
    t = np.linspace(0, span, pts) + rng.uniform(0, 2 * np.pi)
    fx = int(rng.integers(1, 4))
    fy = int(rng.integers(1, 3))
    amp_x = rng.uniform(0.15, 0.48) * min(w, 4 * h) / 2
    amp_y = rng.uniform(0.25, 0.48) * h
    cx = rng.uniform(amp_x, max(w - amp_x, amp_x + 1))
    cy = rng.uniform(0.5 * h - (0.48 * h - amp_y), 0.5 * h + (0.48 * h - amp_y))
    x = cx + amp_x * np.cos(fx * t + rng.uniform(0, 2 * np.pi))
    y = cy + amp_y * np.sin(fy * t)
    return np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)


def _travel_curl_stroke(rng: np.random.Generator, shape: tuple[int, int],
                        pts: int) -> tuple:
    """Cursive-style traveling loops ('eeee'): a rightward drift plus a
    rotating component, so consecutive loops cross themselves."""
    h, w = shape
    n_loops = rng.uniform(1.5, max(2.0, min(5.0, w / max(h, 1))))
    t = np.linspace(0, n_loops * 2 * np.pi, pts)
    amp_y = rng.uniform(0.2, 0.45) * h
    amp_x = rng.uniform(0.5, 1.4) * amp_y
    x0 = rng.uniform(0, max(w - amp_x * 2 - (w - 2 * amp_x) * 0.9, 1))
    drift = rng.uniform(0.4, 1.0) * max(w - x0 - 2 * amp_x, 1) / t[-1]
    cy = rng.uniform(0.35 * h, 0.65 * h)
    x = x0 + amp_x + drift * t + amp_x * np.cos(t + rng.uniform(0, 2 * np.pi))
    y = cy + amp_y * np.sin(t)
    return np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)


def _zigzag_stroke(rng: np.random.Generator, shape: tuple[int, int],
                   pts: int) -> tuple:
    """High-curvature zigzag: sharp direction reversals the smooth family
    never produces."""
    h, w = shape
    n_corners = int(rng.integers(3, 8))
    cx = np.sort(rng.uniform(0, w, n_corners))
    lo, hi = rng.uniform(0.1 * h, 0.4 * h), rng.uniform(0.6 * h, 0.9 * h)
    cy = np.where(np.arange(n_corners) % 2 == 0, lo, hi)
    cy = cy + rng.uniform(-0.08 * h, 0.08 * h, n_corners)
    t = np.linspace(0, 1, pts)
    ts = np.linspace(0, 1, n_corners)
    x = np.interp(t, ts, cx)
    y = np.interp(t, ts, cy)
    return np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)


def _smooth_stroke(rng: np.random.Generator, shape: tuple[int, int],
                   pts: int) -> tuple:
    return random_strokes(rng, 1, shape, points_per_stroke=pts)[0]


_STYLE_FNS = {
    "smooth": _smooth_stroke,
    "curl": _curl_stroke,
    "travel": _travel_curl_stroke,
    "zigzag": _zigzag_stroke,
}
# Point budgets per style: curls need more vertices to trace their loops.
_STYLE_PTS = {
    "smooth": (6, 23),
    "curl": (24, 56),
    "travel": (28, 72),
    "zigzag": (10, 28),
}
# The "hand" preset mixes the curve families with letterform words
# (data/letters.py) — script structure the curve families can't produce.
# Kept as a separate preset (not folded into the "mixed" defaults) so the
# "mixed" eval numbers stay comparable.
HAND_PROBS = {"smooth": 0.18, "curl": 0.17, "travel": 0.12, "zigzag": 0.08,
              "word": 0.45}


def mixed_strokes(rng: np.random.Generator, shape: tuple[int, int],
                  token_budget: int = 286, max_strokes: int = 6,
                  style_probs: dict | None = None) -> list:
    """Sample strokes of mixed styles under a hard token budget, so
    the token string never has to be truncated (truncation force-writes EOS
    mid-ink and teaches early stopping).

    Budget accounting mirrors the decode grammar exactly: 2 tokens per
    vertex, one BOS between strokes, one trailing EOS.

    A ``"word"`` entry in ``style_probs`` (the ``HAND_PROBS`` preset) emits
    a whole letterform word — a GROUP of strokes (data/letters.py) — in one
    step, charged against the same budget."""
    probs = style_probs or {"smooth": 0.35, "curl": 0.3, "travel": 0.2,
                            "zigzag": 0.15}
    names = list(probs)
    p = np.asarray([probs[k] for k in names], np.float64)
    p /= p.sum()
    strokes = []
    remaining = token_budget - 1  # EOS
    n = int(rng.integers(1, max_strokes + 1))
    for i in range(n):
        if i > 0:
            remaining -= 1  # BOS separator before this item
        style = names[int(rng.choice(len(names), p=p))]
        if style == "word":
            from stroke_derenderer_tpu_torch.data.letters import (
                sample_word, word_strokes,
            )
            # word_strokes' budget contract includes its own EOS slot and
            # the BOS separators BETWEEN its strokes; the separator before
            # the group was charged above.
            group = word_strokes(rng, sample_word(rng), shape,
                                 token_budget=remaining + 1)
            cost = (sum(2 * np.asarray(x).size for x, _ in group)
                    + max(len(group) - 1, 0))
            if not group or cost > remaining:
                break
            remaining -= cost
            strokes.extend(group)
            continue
        lo, hi = _STYLE_PTS[style]
        pts = int(rng.integers(lo, hi + 1))
        pts = min(pts, remaining // 2)
        if pts < 4:
            break
        remaining -= 2 * pts
        strokes.append(_STYLE_FNS[style](rng, shape, pts))
    return strokes


def rasterize_strokes(strokes, shape: tuple[int, int],
                      thickness: int = 2) -> np.ndarray:
    """Paint polylines into a (h, w) uint8 {0,1} mask by dense segment
    sampling (vectorized; no cv2)."""
    h, w = shape
    mask = np.zeros((h, w), np.uint8)
    for x, y in strokes:
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.size < 2:
            continue
        seg = np.hypot(np.diff(x), np.diff(y))
        n = int(np.ceil(seg.sum() * 2)) + x.size
        ts = np.concatenate([[0], np.cumsum(seg)])
        ts = ts / max(ts[-1], 1e-9)
        # Dense samples plus the exact vertices, so every stroke point's
        # rounded pixel is painted.
        t = np.union1d(np.linspace(0, 1, n), ts)
        xs = np.interp(t, ts, x)
        ys = np.interp(t, ts, y)
        xi = np.clip(np.round(xs).astype(int), 0, w - 1)
        yi = np.clip(np.round(ys).astype(int), 0, h - 1)
        mask[yi, xi] = 1
    if thickness > 1:
        from scipy import ndimage
        mask = ndimage.binary_dilation(
            mask, iterations=thickness - 1).astype(np.uint8)
    return mask


# Ruling-line palette: light blue / pink / gray guide lines, which the
# binarizer must leave out of the mask.
_RULE_COLORS = np.asarray([[150.0, 180.0, 230.0],
                           [230.0, 160.0, 185.0],
                           [175.0, 175.0, 175.0]])


def _photo_render(mask: np.ndarray, rng: np.random.Generator,
                  ruled: bool = False) -> np.ndarray:
    """Mask -> noisy 'scan' image (uint8 RGB), dark ink on light paper with
    illumination gradient and speckle. ``ruled=True`` adds a paper tint and
    colored horizontal ruling lines UNDER the ink — distractor structure
    the binarizer must learn to drop (its target stays the ink mask). The
    plain branch's rng draw sequence is unchanged (pinned evals)."""
    h, w = mask.shape
    paper = rng.uniform(200, 245) + rng.uniform(-15, 15) * np.linspace(
        0, 1, w)[None, :]
    img = paper + rng.normal(0, 6, (h, w))
    if not ruled:
        ink = rng.uniform(10, 70)
        img = np.where(mask > 0, ink + rng.normal(0, 10, (h, w)), img)
        img = np.clip(img, 0, 255).astype(np.uint8)
        return np.repeat(img[:, :, None], 3, axis=2)

    rgb = np.repeat(img[:, :, None], 3, axis=2)
    tint = rng.uniform(0.86, 1.0, 3)
    tint[int(rng.integers(0, 3))] = 1.0  # keep one channel bright
    rgb = rgb * tint[None, None, :]
    spacing = float(rng.uniform(18, 60))
    phase = float(rng.uniform(0, spacing))
    thickness = int(rng.integers(1, 3))
    color = _RULE_COLORS[int(rng.integers(0, len(_RULE_COLORS)))]
    color = np.clip(color + rng.normal(0, 8, 3), 0, 255)
    alpha = float(rng.uniform(0.35, 0.85))
    line_rows = ((np.arange(h) - phase) % spacing) < thickness
    rgb[line_rows] = rgb[line_rows] * (1 - alpha) + color[None, :] * alpha
    ink = rng.uniform(10, 70)
    ink_img = ink + rng.normal(0, 10, (h, w))
    rgb = np.where((mask > 0)[:, :, None], ink_img[:, :, None], rgb)
    return np.clip(rgb, 0, 255).astype(np.uint8)
