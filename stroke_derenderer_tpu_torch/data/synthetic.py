"""Synthetic handwriting: random pen strokes, their raster, a noisy
"photo" of that raster, and the training pairs built from them, copied
from the JAX ``data/synthetic.py`` (host numpy):

  * (tile, mask) pairs for the binarizer (:func:`tile_batches`);
  * (glyph crop, token sequence) pairs for the captioner, the crops made
    through the inference partition (:func:`partitioned_glyph_batches`) or
    drawn directly (:func:`glyph_batches`); the tokens are the inverse of
    the decode grammar (:func:`tokens_from_strokes`).

The evaluator (``eval/run.py``) draws its samples here and
``pipeline/strokes.residual_ink`` rasterizes predicted strokes here. Every
function draws from its ``np.random.Generator`` in exactly the order the
JAX package does, so a seed gives the same samples and the same generator
state afterwards.
"""

from __future__ import annotations

import numpy as np

from stroke_derenderer_tpu_torch.config import BOS, EOS, PAD


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


# ------------------------------------------------------ training pairs

def fragment_strokes(rng: np.random.Generator, strokes,
                     cut_prob: float = 0.5, max_cuts: int = 2) -> list:
    """Erase short arcs from strokes, splitting each into visible
    sub-polylines separated by gaps — the *residual-ink* input class: the
    iterated re-decode path (pipeline/strokes.py, config.redecode_passes)
    feeds the model masks of partially-erased strokes, which the base
    distributions never show it at training time.

    Token-budget safe by construction: every gap drops >= 2 vertices
    (>= 4 tokens) and adds exactly one BOS separator, so the fragmented
    sample always fits any budget the original fit."""
    out = []
    for x, y in strokes:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n = x.size
        if n < 12 or rng.random() > cut_prob:
            out.append((x, y))
            continue
        keep = np.ones(n, bool)
        for _ in range(int(rng.integers(1, max_cuts + 1))):
            gap = int(rng.integers(2, max(3, n // 6) + 1))
            start = int(rng.integers(1, n - gap))
            keep[start:start + gap] = False
        # Split the kept indices into contiguous runs; runs shorter than 4
        # points decode to noise, drop them.
        idx = np.flatnonzero(keep)
        runs = np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1)
        pieces = [(x[r], y[r]) for r in runs if r.size >= 4]
        out.extend(pieces if pieces else [(x, y)])
    return out if out else strokes


def tokens_from_strokes(strokes, image_size: int, max_length: int) -> np.ndarray:
    """Inverse of the decode grammar: x -> 3+x, y -> 3+image_size+y,
    BOS between strokes, EOS at the end, PAD-filled to max_length.
    Coordinates are rounded and clipped to [0, image_size)."""
    toks: list[int] = []
    for i, (x, y) in enumerate(strokes):
        if i > 0:
            toks.append(BOS)
        xi = np.clip(np.round(np.asarray(x)), 0, image_size - 1).astype(int)
        yi = np.clip(np.round(np.asarray(y)), 0, image_size - 1).astype(int)
        for a, b in zip(xi, yi):
            toks.append(3 + int(a))
            toks.append(3 + image_size + int(b))
    toks.append(EOS)
    toks = toks[:max_length]
    toks[-1] = EOS  # guarantee termination even when truncated
    out = np.full((max_length,), PAD, np.int32)
    out[:len(toks)] = toks
    return out


def make_line_sample(rng: np.random.Generator, height: int = 128,
                     width: int = 1152, n_strokes: int = 12,
                     style: str = "mixed", ruled: float = 0.0):
    """(rgb line image, clean {0,1} mask) for binarizer training. ``ruled``
    is the probability of rendering onto ruled colored paper (the
    reference's demo input class; the mask still excludes the ruling)."""
    if style == "mixed":
        # Token budget is irrelevant for binarizer masks; large cap.
        strokes = mixed_strokes(rng, (height, width), token_budget=10_000,
                                max_strokes=n_strokes)
    elif style == "hand":
        strokes = mixed_strokes(rng, (height, width), token_budget=10_000,
                                max_strokes=n_strokes,
                                style_probs=HAND_PROBS)
    elif style == "letters":
        from stroke_derenderer_tpu_torch.data.letters import line_of_words
        strokes = line_of_words(rng, (height, width))
    else:
        strokes = random_strokes(rng, n_strokes, (height, width))
    mask = rasterize_strokes(strokes, (height, width),
                             thickness=int(rng.integers(1, 4)))
    # Short-circuit keeps the rng draw sequence unchanged at ruled=0.0.
    use_ruled = ruled > 0.0 and bool(rng.random() < ruled)
    return _photo_render(mask, rng, ruled=use_ruled), mask


def make_glyph_sample(rng: np.random.Generator, image_size: int = 224,
                      max_length: int = 384, mean=None, std=None):
    """(model input (S,S,3) f32, tokens (max_length,) i32) for captioner
    training. The crop is ImageNet-normalized exactly like inference
    (pipeline/strokes.py)."""
    from stroke_derenderer_tpu_torch.config import StrokesConfig
    from stroke_derenderer_tpu_torch.ops.normalize import (
        imagenet_normalize_np, minmax_normalize_np,
    )

    cfg = StrokesConfig()
    mean = mean if mean is not None else cfg.mean
    std = std if std is not None else cfg.std
    n = int(rng.integers(1, 5))
    strokes = random_strokes(rng, n, (image_size, image_size))
    mask = rasterize_strokes(strokes, (image_size, image_size), thickness=2)
    img = minmax_normalize_np(mask.astype(np.uint8))
    model_in = imagenet_normalize_np(img, mean, std)
    toks = tokens_from_strokes(strokes, image_size, max_length)
    return model_in, toks


def make_partitioned_glyph_sample(rng: np.random.Generator,
                                  max_length: int = 384,
                                  height: int = 128,
                                  max_window: int = 600,
                                  style: str = "mixed"):
    """Training pair generated THROUGH the inference partition pipeline:
    strokes are drawn on a binarizer-height canvas, partitioned exactly
    like inference (pipeline/strokes.compute_partitions), and the ground
    truth tokens are the strokes mapped into the 224x224 crop frame with
    the partition's forward transform. Eliminates the train/test
    distribution gap of :func:`make_glyph_sample`.

    The ink window width is sampled log-uniformly in [30, max_window] so
    the crop resize ratio spans the full range inference sees — from tall
    isolated glyphs (ratio ~2) to whole-line-wide groups squeezed into
    224px (ratio ~0.3).

    Returns (model_input (S,S,3) f32, crop_u8 (S,S), tokens (max_length,)).
    """
    from stroke_derenderer_tpu_torch.config import StrokesConfig
    from stroke_derenderer_tpu_torch.pipeline.strokes import compute_partitions

    cfg = StrokesConfig()
    if max_length < 12:
        raise ValueError(
            f"max_length={max_length} cannot fit even a 4-vertex stroke "
            "target (2 tokens/vertex + EOS needs >= 12 with headroom); "
            "raise seq_len")
    h = height
    parts: list = []
    for _ in range(8):  # resample until the ink forms a single partition
        win = int(np.exp(rng.uniform(np.log(30), np.log(max_window))))
        # Token-budgeted sampling: targets must never truncate, because
        # truncation force-writes EOS mid-ink (tokens_from_strokes) and a
        # model trained on truncated targets learns to stop early on dense
        # glyphs.
        if style in ("mixed", "hand", "letters"):
            if style == "letters":
                from stroke_derenderer_tpu_torch.data.letters import (
                    sample_word, word_strokes,
                )
                strokes = (word_strokes(rng, sample_word(rng), (h - 20, win),
                                        token_budget=max_length - 2)
                           or mixed_strokes(rng, (h - 20, win),
                                            token_budget=max_length - 2))
            else:
                strokes = mixed_strokes(
                    rng, (h - 20, win), token_budget=max_length - 2,
                    style_probs=HAND_PROBS if style == "hand" else None)
            # Residual-ink augmentation (~1 in 4 samples): the re-decode
            # passes hand the model partially-erased strokes at inference;
            # show it that class at training time (fragment_strokes is
            # token-budget-safe, so targets still never truncate).
            if rng.random() < 0.25:
                strokes = fragment_strokes(rng, strokes)
        else:
            n = int(rng.integers(1, 7))
            strokes = random_strokes(rng, n, (h - 20, win),
                                     points_per_stroke=int(rng.integers(6, 23)))
        strokes = [(x + 10, y + 10) for x, y in strokes]
        mask = rasterize_strokes(strokes, (h, win + 20),
                                 thickness=int(rng.integers(1, 4)))
        parts = compute_partitions(mask, cfg)
        if len(parts) == 1:
            break
    if not parts:
        raise RuntimeError(
            "make_partitioned_glyph_sample: no ink partition after 8 "
            f"resamples (max_length={max_length}, style={style!r}) — the "
            "token budget is too small to draw any stroke")
    part = parts[0]
    (x1, y1), r, (x2, y2) = part["translate1"], part["ratio"], part["translate2"]
    crop_strokes = [((x - x1) * r + x2, (y - y1) * r + y2) for x, y in strokes]
    toks = tokens_from_strokes(crop_strokes, cfg.image_size, max_length)
    return part["image_input"], part["image"], toks


def partitioned_glyph_batches(rng: np.random.Generator, batch_size: int,
                              seq_len: int = 96,
                              n_batches: int | None = None,
                              style: str = "mixed"):
    """Yield (crops, tok_in, tok_out) built via the inference partition
    pipeline (see make_partitioned_glyph_sample)."""
    i = 0
    while n_batches is None or i < n_batches:
        crops, seqs = [], []
        for _ in range(batch_size):
            model_in, _, t = make_partitioned_glyph_sample(rng, seq_len + 1,
                                                           style=style)
            crops.append(model_in)
            seqs.append(t)
        seqs = np.stack(seqs)
        tok_in = np.concatenate(
            [np.full((batch_size, 1), BOS, np.int32), seqs[:, :seq_len - 1]], 1)
        tok_out = seqs[:, :seq_len]
        yield np.stack(crops), tok_in, tok_out
        i += 1


def tile_batches(rng: np.random.Generator, batch_size: int, height: int = 128,
                 width: int = 384, n_batches: int | None = None,
                 style: str = "mixed", ruled: float = 0.0,
                 narrow: float = 0.0):
    """Yield (tiles f32 [0,1] (B,H,W,3), masks f32 (B,H,W,1)) forever (or
    n_batches times). ``ruled`` is the per-sample probability of rendering
    on ruled colored paper (distractor lines excluded from the mask).

    ``narrow`` is the per-sample probability of a right-ZERO-PADDED tile:
    the line renders at a random width in [40, width) and the remainder is
    black, mask 0 — exactly what inference feeds the model for images
    narrower than one tile and for the final tile of every line (the
    ops/tiling pad contract). A model that never trains on padded tiles
    reads the black pad as ink context and suppresses real ink on narrow
    crops."""
    i = 0
    while n_batches is None or i < n_batches:
        imgs, masks = [], []
        for _ in range(batch_size):
            w_render = width
            if narrow > 0.0 and rng.random() < narrow:
                w_render = int(rng.integers(40, width))
            img, mask = make_line_sample(rng, height, w_render,
                                         n_strokes=int(rng.integers(3, 8)),
                                         style=style, ruled=ruled)
            if w_render < width:
                img = np.pad(img, ((0, 0), (0, width - w_render), (0, 0)))
                mask = np.pad(mask, ((0, 0), (0, width - w_render)))
            imgs.append(img.astype(np.float32) / 255.0)
            masks.append(mask.astype(np.float32)[:, :, None])
        yield np.stack(imgs), np.stack(masks)
        i += 1


def glyph_batches(rng: np.random.Generator, batch_size: int,
                  image_size: int = 224, seq_len: int = 64,
                  n_batches: int | None = None):
    """Yield (crops (B,S,S,3), tok_in (B,T), tok_out (B,T)): teacher-forced
    next-token pairs where tok_in starts at BOS."""
    i = 0
    while n_batches is None or i < n_batches:
        crops, seqs = [], []
        for _ in range(batch_size):
            c, t = make_glyph_sample(rng, image_size, seq_len + 1)
            crops.append(c)
            seqs.append(t)
        seqs = np.stack(seqs)
        tok_in = np.concatenate(
            [np.full((batch_size, 1), BOS, np.int32), seqs[:, :seq_len - 1]], 1)
        tok_out = seqs[:, :seq_len]
        yield np.stack(crops), tok_in, tok_out
        i += 1
