"""Letterform handwriting: per-letter stroke templates and words made of
them, copied from the JAX ``data/letters.py`` (host numpy) for the
evaluator's and the trainer's ``letters`` and ``hand`` styles.

``LETTER_TEMPLATES`` holds each lowercase letter, capital and digit as 1-3
polylines in a unit em box (y grows downward; baseline 0.80, x-height band
[0.40, 0.80], ascenders ~0.08, descenders ~1.0). ``sample_word`` draws a
word with english-like letter frequencies, ``word_strokes`` lays it out on
a canvas with slant, jitter and semi-cursive joins under a token budget
(2 tokens a vertex, a BOS between strokes, an EOS), ``line_of_words``
fills a binarizer training line with words. All draw from the generator in
the JAX package's order.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Template construction helpers (module-load time only; cheap).
# --------------------------------------------------------------------------

_BASE = 0.80    # baseline y
_XTOP = 0.40    # x-height top y
_ASC = 0.08     # ascender top y
_DESC = 1.00    # descender bottom y


def _line(x0, y0, x1, y1, n=8):
    t = np.linspace(0.0, 1.0, n)
    return np.stack([x0 + (x1 - x0) * t, y0 + (y1 - y0) * t], 1)


def _arc(cx, cy, rx, ry, a0, a1, n=16):
    """Elliptic arc from angle a0 to a1 (radians, standard math orientation
    on a y-down canvas — increasing angle winds clockwise visually)."""
    t = np.linspace(a0, a1, n)
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)


def _poly(*pts):
    """Polyline through explicit (x, y) points, 6 samples per segment."""
    pts = np.asarray(pts, np.float64)
    segs = [_line(*pts[i], *pts[i + 1], n=6)[:-1] for i in range(len(pts) - 1)]
    return np.concatenate(segs + [pts[-1:]], 0)


def _cat(*parts):
    """Join consecutive path pieces into one stroke (dedup the seams)."""
    out = [parts[0]]
    for p in parts[1:]:
        out.append(p[1:] if np.allclose(p[0], out[-1][-1], atol=1e-9) else p)
    return np.concatenate(out, 0)


_MID = (_XTOP + _BASE) / 2          # 0.60, x-height band center
_R = (_BASE - _XTOP) / 2            # 0.20, bowl radius

# Letter -> (advance width, [stroke arrays (N,2)]). Strokes listed in
# natural writing order. Coordinates stay inside [0, advance] x [0, 1.05].
LETTER_TEMPLATES: dict[str, tuple[float, list]] = {
    # round letters
    "o": (0.56, [_arc(0.28, _MID, _R, _R, -np.pi / 2, 3 * np.pi / 2, 20)]),
    "c": (0.52, [_arc(0.30, _MID, _R, _R, -np.pi / 3, -5 * np.pi / 3, 18)]),
    "e": (0.54, [_cat(_line(0.08, _MID, 0.46, _MID, 5),
                      _arc(0.27, _MID, _R, _R, 0, -4.2, 18))]),
    "a": (0.58, [_arc(0.26, _MID, _R, _R, -np.pi / 2, 3 * np.pi / 2, 18),
                 _poly((0.46, _XTOP), (0.46, _BASE), (0.54, _BASE - 0.04))]),
    "d": (0.58, [_arc(0.26, _MID, _R, _R, -np.pi / 2, 3 * np.pi / 2, 18),
                 _poly((0.46, _ASC), (0.46, _BASE), (0.54, _BASE - 0.04))]),
    "b": (0.58, [_line(0.12, _ASC, 0.12, _BASE, 10),
                 _arc(0.32, _MID, _R, _R, np.pi, -np.pi, 18)]),
    "g": (0.58, [_arc(0.26, _MID, _R, _R, -np.pi / 2, 3 * np.pi / 2, 18),
                 _cat(_line(0.46, _XTOP, 0.46, 0.92, 8),
                      _arc(0.30, 0.92, 0.16, 0.12, 0, np.pi, 8))]),
    "q": (0.58, [_arc(0.26, _MID, _R, _R, -np.pi / 2, 3 * np.pi / 2, 18),
                 _line(0.46, _XTOP, 0.46, _DESC, 10)]),
    "p": (0.58, [_line(0.12, _XTOP, 0.12, _DESC, 10),
                 _arc(0.32, _MID, _R, _R, np.pi, -np.pi, 18)]),
    "s": (0.50, [_cat(_arc(0.26, _MID - 0.10, 0.14, 0.10, -0.3,
                           -1.5 * np.pi, 12),
                      _arc(0.26, _MID + 0.10, 0.16, 0.10, -np.pi / 2,
                           np.pi - 0.4, 12))]),
    # stem + arch letters
    "l": (0.30, [_line(0.15, _ASC, 0.15, _BASE, 12)]),
    "i": (0.30, [_line(0.15, _XTOP, 0.15, _BASE, 8),
                 _line(0.15, _XTOP - 0.14, 0.15, _XTOP - 0.10, 3)]),
    "t": (0.40, [_line(0.18, _ASC + 0.08, 0.18, _BASE, 10),
                 _line(0.02, _XTOP, 0.36, _XTOP, 5)]),
    "f": (0.42, [_cat(_arc(0.30, _ASC + 0.10, 0.12, 0.10, -np.pi / 6,
                           -np.pi, 7),
                      _line(0.18, _ASC + 0.10, 0.18, _BASE, 9)),
                 _line(0.04, _XTOP, 0.34, _XTOP, 5)]),
    "n": (0.56, [_line(0.12, _XTOP, 0.12, _BASE, 8),
                 _cat(_line(0.12, _BASE - 0.02, 0.12, _MID, 4),
                      _arc(0.28, _MID, 0.16, _R, np.pi, 2 * np.pi, 10),
                      _line(0.44, _MID, 0.44, _BASE, 5))]),
    "m": (0.82, [_line(0.10, _XTOP, 0.10, _BASE, 8),
                 _cat(_line(0.10, _BASE - 0.02, 0.10, _MID, 4),
                      _arc(0.25, _MID, 0.15, _R, np.pi, 2 * np.pi, 9),
                      _line(0.40, _MID, 0.40, _BASE, 4)),
                 _cat(_line(0.40, _BASE - 0.02, 0.40, _MID, 4),
                      _arc(0.55, _MID, 0.15, _R, np.pi, 2 * np.pi, 9),
                      _line(0.70, _MID, 0.70, _BASE, 4))]),
    "h": (0.56, [_line(0.12, _ASC, 0.12, _BASE, 12),
                 _cat(_line(0.12, _BASE - 0.02, 0.12, _MID, 4),
                      _arc(0.28, _MID, 0.16, _R, np.pi, 2 * np.pi, 10),
                      _line(0.44, _MID, 0.44, _BASE, 5))]),
    "r": (0.42, [_line(0.12, _XTOP, 0.12, _BASE, 8),
                 _cat(_line(0.12, _BASE - 0.02, 0.12, _MID, 4),
                      _arc(0.26, _MID, 0.14, _R, np.pi, np.pi + 2.2, 8))]),
    "u": (0.56, [_cat(_line(0.12, _XTOP, 0.12, _MID, 5),
                      _arc(0.28, _MID, 0.16, _R, np.pi, 0.0, 10),
                      _line(0.44, _MID, 0.44, _XTOP, 5)),
                 _line(0.44, _XTOP, 0.46, _BASE, 6)]),
    "j": (0.34, [_cat(_line(0.20, _XTOP, 0.20, 0.92, 9),
                      _arc(0.12, 0.92, 0.08, 0.10, 0, np.pi, 7)),
                 _line(0.20, _XTOP - 0.14, 0.20, _XTOP - 0.10, 3)]),
    # diagonal letters
    "v": (0.52, [_poly((0.08, _XTOP), (0.26, _BASE), (0.44, _XTOP))]),
    "w": (0.74, [_poly((0.06, _XTOP), (0.20, _BASE), (0.34, _MID),
                       (0.48, _BASE), (0.62, _XTOP))]),
    "x": (0.52, [_line(0.08, _XTOP, 0.44, _BASE, 8),
                 _line(0.44, _XTOP, 0.08, _BASE, 8)]),
    "y": (0.54, [_poly((0.08, _XTOP), (0.26, _BASE)),
                 _poly((0.44, _XTOP), (0.16, _DESC))]),
    "z": (0.50, [_poly((0.06, _XTOP), (0.40, _XTOP), (0.06, _BASE),
                       (0.42, _BASE))]),
    "k": (0.52, [_line(0.12, _ASC, 0.12, _BASE, 12),
                 _poly((0.40, _XTOP), (0.12, _MID + 0.03), (0.42, _BASE))]),
}

_CTOP = 0.10                        # capital top y
_CMID = (_CTOP + _BASE) / 2         # 0.45
_CR = (_BASE - _CTOP) / 2           # 0.35, capital bowl radius

# Capitals: cap-height strokes (a line often starts with a capital).
CAPITAL_TEMPLATES: dict[str, tuple[float, list]] = {
    "A": (0.64, [_line(0.06, _BASE, 0.32, _CTOP, 9),
                 _line(0.32, _CTOP, 0.58, _BASE, 9),
                 _line(0.17, 0.58, 0.47, 0.58, 5)]),
    "B": (0.58, [_line(0.12, _CTOP, 0.12, _BASE, 10),
                 _cat(_line(0.12, _CTOP, 0.30, _CTOP, 3),
                      _arc(0.30, (_CTOP + _CMID) / 2, 0.17,
                           (_CMID - _CTOP) / 2, -np.pi / 2, np.pi / 2, 8),
                      _line(0.30, _CMID, 0.12, _CMID, 3)),
                 _cat(_line(0.12, _CMID, 0.32, _CMID, 3),
                      _arc(0.32, (_CMID + _BASE) / 2, 0.19,
                           (_BASE - _CMID) / 2, -np.pi / 2, np.pi / 2, 8),
                      _line(0.32, _BASE, 0.12, _BASE, 3))]),
    "C": (0.62, [_arc(0.34, _CMID, 0.26, _CR, -np.pi / 4, -7 * np.pi / 4, 16)]),
    "D": (0.62, [_line(0.12, _CTOP, 0.12, _BASE, 10),
                 _cat(_line(0.12, _CTOP, 0.26, _CTOP, 3),
                      _arc(0.26, _CMID, 0.24, _CR, -np.pi / 2, np.pi / 2, 12),
                      _line(0.26, _BASE, 0.12, _BASE, 3))]),
    "E": (0.54, [_poly((0.44, _CTOP), (0.12, _CTOP), (0.12, _BASE),
                       (0.44, _BASE)),
                 _line(0.12, _CMID, 0.38, _CMID, 4)]),
    "F": (0.52, [_poly((0.44, _CTOP), (0.12, _CTOP), (0.12, _BASE)),
                 _line(0.12, _CMID, 0.38, _CMID, 4)]),
    "G": (0.64, [_cat(_arc(0.34, _CMID, 0.26, _CR, -np.pi / 4,
                           -7 * np.pi / 4, 16),
                      _line(0.53, _CMID + 0.12, 0.36, _CMID + 0.12, 4))]),
    "H": (0.62, [_line(0.12, _CTOP, 0.12, _BASE, 10),
                 _line(0.50, _CTOP, 0.50, _BASE, 10),
                 _line(0.12, _CMID, 0.50, _CMID, 5)]),
    "I": (0.30, [_line(0.15, _CTOP, 0.15, _BASE, 10)]),
    "J": (0.44, [_cat(_line(0.32, _CTOP, 0.32, _BASE - 0.10, 9),
                      _arc(0.21, _BASE - 0.10, 0.11, 0.10, 0, np.pi, 7))]),
    "K": (0.58, [_line(0.12, _CTOP, 0.12, _BASE, 10),
                 _poly((0.48, _CTOP), (0.12, _CMID + 0.02), (0.50, _BASE))]),
    "L": (0.50, [_poly((0.12, _CTOP), (0.12, _BASE), (0.44, _BASE))]),
    "M": (0.78, [_poly((0.08, _BASE), (0.10, _CTOP), (0.38, _BASE - 0.12),
                       (0.66, _CTOP), (0.68, _BASE))]),
    "N": (0.64, [_poly((0.12, _BASE), (0.12, _CTOP), (0.52, _BASE),
                       (0.52, _CTOP))]),
    "O": (0.66, [_arc(0.33, _CMID, 0.26, _CR, -np.pi / 2, 3 * np.pi / 2, 20)]),
    "P": (0.56, [_line(0.12, _CTOP, 0.12, _BASE, 10),
                 _cat(_line(0.12, _CTOP, 0.30, _CTOP, 3),
                      _arc(0.30, (_CTOP + _CMID) / 2, 0.18,
                           (_CMID - _CTOP) / 2, -np.pi / 2, np.pi / 2, 9),
                      _line(0.30, _CMID, 0.12, _CMID, 3))]),
    "Q": (0.66, [_arc(0.33, _CMID, 0.26, _CR, -np.pi / 2, 3 * np.pi / 2, 20),
                 _line(0.40, _BASE - 0.14, 0.56, _BASE + 0.04, 4)]),
    "R": (0.58, [_line(0.12, _CTOP, 0.12, _BASE, 10),
                 _cat(_line(0.12, _CTOP, 0.30, _CTOP, 3),
                      _arc(0.30, (_CTOP + _CMID) / 2, 0.18,
                           (_CMID - _CTOP) / 2, -np.pi / 2, np.pi / 2, 9),
                      _line(0.30, _CMID, 0.12, _CMID, 3)),
                 _line(0.26, _CMID, 0.50, _BASE, 7)]),
    "S": (0.54, [_cat(_arc(0.28, _CTOP + 0.18, 0.17, 0.18, -0.3,
                           -1.5 * np.pi, 12),
                      _arc(0.28, _BASE - 0.18, 0.19, 0.18, -np.pi / 2,
                           np.pi - 0.4, 12))]),
    "T": (0.56, [_line(0.06, _CTOP, 0.50, _CTOP, 6),
                 _line(0.28, _CTOP, 0.28, _BASE, 10)]),
    "U": (0.62, [_cat(_line(0.12, _CTOP, 0.12, _CMID + 0.10, 6),
                      _arc(0.31, _CMID + 0.10, 0.19, _BASE - _CMID - 0.10,
                           np.pi, 0.0, 10),
                      _line(0.50, _CMID + 0.10, 0.50, _CTOP, 6))]),
    "V": (0.60, [_poly((0.08, _CTOP), (0.30, _BASE), (0.52, _CTOP))]),
    "W": (0.84, [_poly((0.06, _CTOP), (0.22, _BASE), (0.38, _CMID),
                       (0.54, _BASE), (0.70, _CTOP))]),
    "X": (0.58, [_line(0.08, _CTOP, 0.50, _BASE, 9),
                 _line(0.50, _CTOP, 0.08, _BASE, 9)]),
    "Y": (0.58, [_poly((0.08, _CTOP), (0.29, _CMID), (0.50, _CTOP)),
                 _line(0.29, _CMID, 0.29, _BASE, 7)]),
    "Z": (0.56, [_poly((0.08, _CTOP), (0.48, _CTOP), (0.08, _BASE),
                       (0.50, _BASE))]),
}

# Digits: cap-height.
DIGIT_TEMPLATES: dict[str, tuple[float, list]] = {
    "0": (0.58, [_arc(0.29, _CMID, 0.21, _CR, -np.pi / 2, 3 * np.pi / 2, 18)]),
    "1": (0.36, [_poly((0.08, _CTOP + 0.14), (0.22, _CTOP), (0.22, _BASE))]),
    "2": (0.54, [_cat(_arc(0.27, _CTOP + 0.16, 0.17, 0.16, np.pi, 2.5 * np.pi,
                           10),
                      _poly((0.40, _CMID - 0.02), (0.10, _BASE),
                            (0.46, _BASE)))]),
    "3": (0.52, [_cat(_arc(0.26, _CTOP + 0.16, 0.16, 0.16, -np.pi * 0.75,
                           np.pi / 2, 9),
                      _arc(0.26, _BASE - 0.18, 0.18, 0.18, -np.pi / 2,
                           np.pi * 0.75, 9))]),
    "4": (0.58, [_poly((0.38, _BASE), (0.38, _CTOP), (0.08, _CMID + 0.10),
                       (0.50, _CMID + 0.10))]),
    "5": (0.54, [_cat(_poly((0.44, _CTOP), (0.14, _CTOP), (0.12, _CMID)),
                      _arc(0.27, (_CMID + _BASE) / 2, 0.17,
                           (_BASE - _CMID) / 2, -np.pi / 2, np.pi * 0.85,
                           10))]),
    "6": (0.56, [_cat(_poly((0.42, _CTOP), (0.13, _CMID + 0.08)),
                      _arc(0.28, _BASE - 0.17, 0.17, 0.17, np.pi,
                           3 * np.pi, 14))]),
    "7": (0.52, [_poly((0.08, _CTOP), (0.46, _CTOP), (0.20, _BASE))]),
    "8": (0.54, [_cat(_arc(0.27, _CTOP + 0.16, 0.15, 0.16, np.pi / 2,
                           2.5 * np.pi, 12),
                      _arc(0.27, _BASE - 0.18, 0.18, 0.18, -np.pi / 2,
                           1.5 * np.pi, 12))]),
    "9": (0.56, [_arc(0.26, _CTOP + 0.17, 0.16, 0.17, 0, 2 * np.pi, 12),
                 _poly((0.42, _CTOP + 0.17), (0.40, _BASE))]),
}

LETTER_TEMPLATES.update(CAPITAL_TEMPLATES)
LETTER_TEMPLATES.update(DIGIT_TEMPLATES)

# Rough relative letter frequencies (english-ish) so words look like text
# rather than uniform glyph soup.
_FREQ = {"e": 12.7, "t": 9.1, "a": 8.2, "o": 7.5, "i": 7.0, "n": 6.7,
         "s": 6.3, "h": 6.1, "r": 6.0, "d": 4.3, "l": 4.0, "c": 2.8,
         "u": 2.8, "m": 2.4, "w": 2.4, "f": 2.2, "g": 2.0, "y": 2.0,
         "p": 1.9, "b": 1.5, "v": 1.0, "k": 0.8, "j": 0.15, "x": 0.15,
         "q": 0.1, "z": 0.1}
_LETTERS = sorted(_FREQ)  # lowercase sampling pool
_LETTER_P = np.asarray([_FREQ[c] for c in _LETTERS], np.float64)
_LETTER_P /= _LETTER_P.sum()
_DIGITS = sorted(DIGIT_TEMPLATES)


def sample_word(rng: np.random.Generator, n_letters: int | None = None) -> str:
    """A random letter sequence with english-ish letter statistics;
    occasionally a Capitalized word (sentence starts, names) or a digit
    string."""
    if n_letters is None:
        n_letters = int(rng.integers(2, 7))
    if rng.random() < 0.06:
        return "".join(_DIGITS[i] for i in
                       rng.integers(0, len(_DIGITS), n_letters))
    idx = rng.choice(len(_LETTERS), size=n_letters, p=_LETTER_P)
    w = "".join(_LETTERS[i] for i in idx)
    if rng.random() < 0.16:
        w = w[0].upper() + w[1:]
    return w


def _resample(x: np.ndarray, y: np.ndarray, n: int):
    """Resample a polyline to n points uniformly by arc length (keeps the
    endpoints; n >= 2)."""
    seg = np.hypot(np.diff(x), np.diff(y))
    ts = np.concatenate([[0.0], np.cumsum(seg)])
    ts = ts / max(ts[-1], 1e-9)
    t = np.linspace(0.0, 1.0, n)
    return np.interp(t, ts, x), np.interp(t, ts, y)


def word_strokes(rng: np.random.Generator, word: str,
                 shape: tuple[int, int], token_budget: int = 286,
                 slant: float | None = None,
                 jitter: float = 0.018,
                 join_prob: float | None = None) -> list:
    """Render ``word`` as jittered template strokes fitted inside ``shape``.

    Returns a list of (x, y) float arrays in writing order under the hard
    token-budget contract of ``synthetic.mixed_strokes`` (2 tokens per
    vertex + 1 BOS between strokes + 1 EOS <= token_budget): stroke point
    counts are scaled down (floor 3) and trailing strokes dropped if the
    word alone would overflow. Styling: random x-height scale, per-word
    slant shear, per-point gaussian jitter, baseline wobble, and
    semi-cursive letter JOINS (``join_prob`` per adjacent letter pair,
    default sampled per word): joined letters form multi-letter single
    strokes and bigger connected-component islands, both of which the
    estimator must handle.
    Joining never increases token cost (the bridge replaces a BOS with
    resampled vertices under the same budget).
    """
    h, w = shape
    letters = [c for c in word if c in LETTER_TEMPLATES]
    if not letters:
        letters = ["o"]
    advances = np.asarray([LETTER_TEMPLATES[c][0] for c in letters])
    spacing = rng.uniform(0.04, 0.16)
    total_adv = advances.sum() + spacing * (len(letters) - 1)

    # Scale: the em-box height (1.0) maps to `em` pixels; fit the word
    # horizontally too.
    em = rng.uniform(0.60, 0.95) * h
    em = min(em, (w - 2) / max(total_adv, 1e-9))
    if em < 6:  # canvas too narrow for this word: shrink to fewest letters
        letters = letters[:max(1, int((w - 2) / (0.7 * 6)))]
        advances = np.asarray([LETTER_TEMPLATES[c][0] for c in letters])
        total_adv = advances.sum() + spacing * (len(letters) - 1)
        em = max(min(0.8 * h, (w - 2) / max(total_adv, 1e-9)), 4.0)
    slant = rng.uniform(-0.08, 0.28) if slant is None else slant
    y_top = rng.uniform(0, max(h - 1.05 * em, 1e-9))

    raw = []  # (x, y, letter_index) in pixel space, template resolution
    pen_x = 1.0
    for i, c in enumerate(letters):
        adv, strokes = LETTER_TEMPLATES[c]
        wobble = rng.normal(0.0, 0.015) * em
        for s in strokes:
            x = pen_x + (s[:, 0] + slant * (_BASE - s[:, 1])) * em
            y = y_top + s[:, 1] * em + wobble
            x = x + rng.normal(0.0, jitter * em, x.shape)
            y = y + rng.normal(0.0, jitter * em, y.shape)
            raw.append((np.clip(x, 0, w - 1), np.clip(y, 0, h - 1), i))
        pen_x += (adv + spacing) * em

    # Semi-cursive joins: with probability join_prob per adjacent letter
    # pair, fuse the previous letter's trailing stroke with the next
    # letter's leading stroke when both endpoints sit in the x-height band
    # and the gap runs forward — the straight connector materializes at
    # resample time (arc-length interpolation bridges the concatenation).
    join_prob = float(rng.uniform(0.25, 0.85)) if join_prob is None else join_prob
    band_lo = y_top + (_XTOP - 0.06) * em
    band_hi = y_top + (_BASE + 0.08) * em
    joined: list = []
    prev_li = None
    for x, y, li in raw:
        if (joined and prev_li is not None and li == prev_li + 1
                and rng.random() < join_prob):
            px, py = joined[-1]
            if (band_lo <= py[-1] <= band_hi and band_lo <= y[0] <= band_hi
                    and 0.0 < x[0] - px[-1] < 0.9 * em):
                joined[-1] = (np.concatenate([px, x]),
                              np.concatenate([py, y]))
                prev_li = li
                continue
        joined.append((x, y))
        prev_li = li
    raw = joined

    # Token-budget fit: desired points per stroke ~ arc length / (em/9),
    # clipped to [3, len]; then scale down uniformly if over budget.
    lens = [float(np.hypot(np.diff(x), np.diff(y)).sum()) for x, y in raw]
    want = [int(np.clip(round(L / max(em / 9.0, 1.0)) + 2, 3, x.size))
            for (x, _), L in zip(raw, lens)]
    budget = token_budget - 1  # EOS
    out = []
    for (x, y), n in zip(raw, want):
        cost = 2 * n + (1 if out else 0)
        if cost > budget:
            n = (budget - (1 if out else 0)) // 2
            if n < 3:
                break
            cost = 2 * n + (1 if out else 0)
        xs, ys = _resample(x, y, n)
        out.append((xs, ys))
        budget -= cost
    return out  # may be [] when token_budget < 7 — callers must handle


def line_of_words(rng: np.random.Generator, shape: tuple[int, int],
                  max_words: int = 6) -> list:
    """Fill a (h, w) line canvas with left-to-right words (binarizer
    training lines; no token budget — masks only)."""
    h, w = shape
    strokes: list = []
    x0 = float(rng.uniform(0, 0.05 * w))
    n_words = int(rng.integers(1, max_words + 1))
    for _ in range(n_words):
        word = sample_word(rng)
        # Estimate word width at a nominal em to slice a sub-canvas.
        adv = sum(LETTER_TEMPLATES[c][0] for c in word) + 0.1 * len(word)
        em = rng.uniform(0.6, 0.95) * h
        width = min(adv * em + 4, w - x0)
        if width < 0.25 * h:
            break
        ws = word_strokes(rng, word, (h, int(width)), token_budget=10_000)
        strokes.extend((x + x0, y) for x, y in ws)
        x0 += width + rng.uniform(0.1, 0.5) * h
        if x0 >= w - 0.25 * h:
            break
    return strokes
