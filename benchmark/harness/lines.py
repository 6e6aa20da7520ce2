"""The traffic's lines: real-ink crops laid side by side.

A line is k crops of ``examples/real_data`` (each crop's photograph and
its ground-truth ``_BINARIZED.png`` ink mask), k drawn from
``crops_per_line``, each scaled to the line's height (drawn from
``height_px``), separated by gaps of ``gap_x_height`` x the height filled
with the paper tone of the crop to their left. The masks are composed the
same way at the height-normalized frame the strokes stage works in
(``norm_height`` rows, the width truncated as the line's resize truncates
it). Everything is drawn from seeds, in numpy.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import torch

from harness import png

CROPS_DIR = "examples/real_data"
# Decoded crops, kept inside the checkout at a fixed path: the first run of
# a checkout decodes the PNGs, later runs load the arrays.
CACHE = "benchmark/.cache/real_data.npz"


@dataclasses.dataclass
class Line:
    image: np.ndarray      # (H, W, 3) uint8
    mask: np.ndarray       # (norm_height, int(W * norm_height / H)) bool
    crops: tuple           # indices of the crops it holds


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize with half-pixel centres, rounded to uint8."""
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
    x = torch.nn.functional.interpolate(x, (h, w), mode="bilinear",
                                        align_corners=False)
    return x[0].permute(1, 2, 0).round_().clamp_(0, 255).to(torch.uint8).numpy()


def load_crops(root: Path):
    """[(photo (h, w, 3) uint8, mask (128, m) bool, paper tone (3,))] of
    every crop, in file-name order."""
    files = sorted(p for p in (root / CROPS_DIR).glob("*.png")
                   if not p.name.endswith("_BINARIZED.png"))
    digest = hashlib.sha1()
    for p in files:
        digest.update(p.read_bytes())
        digest.update((root / CROPS_DIR / f"{p.stem}_BINARIZED.png").read_bytes())
    key = digest.hexdigest()
    cache = root / CACHE
    if cache.exists():
        with np.load(cache) as z:
            if str(z["key"]) == key:
                n = int(z["n"])
                return [(z[f"img{i}"], z[f"mask{i}"], z[f"tone{i}"]) for i in range(n)]
    out = []
    for p in files:
        img = png.read(p)[..., :3]
        mask = png.read(root / CROPS_DIR / f"{p.stem}_BINARIZED.png")[..., 0] > 127
        out.append((img, mask, np.median(img.reshape(-1, 3), axis=0).astype(np.uint8)))
    cache.parent.mkdir(parents=True, exist_ok=True)
    arrays = {"key": key, "n": len(out)}
    for i, (img, mask, tone) in enumerate(out):
        arrays |= {f"img{i}": img, f"mask{i}": mask, f"tone{i}": tone}
    tmp = cache.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(cache)
    return out


def compose(crops, rng: np.random.Generator, params: dict,
            norm_height: int) -> Line:
    """One line drawn from ``rng`` under the traffic's ``params``."""
    k = int(rng.integers(params["crops_per_line"][0], params["crops_per_line"][1] + 1))
    ids = rng.integers(0, len(crops), k)
    h = int(rng.integers(params["height_px"][0], params["height_px"][1] + 1))
    gaps = np.rint(rng.uniform(*params["gap_x_height"], k - 1) * h).astype(int)
    pieces = []
    for i in ids:
        img = crops[i][0]
        pieces.append(_resize(img, h, max(1, int(round(img.shape[1] * h / img.shape[0])))))
    width = sum(p.shape[1] for p in pieces) + int(gaps.sum())
    image = np.empty((h, width, 3), np.uint8)
    s = norm_height / h
    mask = np.zeros((norm_height, int(width * s)), bool)
    x = 0
    for j, (i, piece) in enumerate(zip(ids, pieces)):
        w = piece.shape[1]
        image[:, x:x + w] = piece
        m = crops[i][1]
        x0, x1 = int(round(x * s)), min(int(round((x + w) * s)), mask.shape[1])
        if x1 > x0:
            cols = np.minimum(((np.arange(x1 - x0) + 0.5) * (m.shape[1] / (x1 - x0))).astype(int),
                              m.shape[1] - 1)
            rows = np.minimum(((np.arange(norm_height) + 0.5) * (m.shape[0] / norm_height)).astype(int),
                              m.shape[0] - 1)
            mask[:, x0:x1] = m[rows][:, cols]
        x += w
        if j < k - 1:
            image[:, x:x + gaps[j]] = crops[i][2]
            x += gaps[j]
    return Line(image, mask, tuple(int(i) for i in ids))


def pool(crops, params: dict, norm_height: int) -> list[Line]:
    """``params["pool_lines"]`` lines from the traffic's own ``pool_seed``:
    every run sees the same set of lines, the run's seed deciding only
    their order, so that the seed does not change the work."""
    rng = np.random.default_rng([params["pool_seed"], 1])
    return [compose(crops, rng, params, norm_height)
            for _ in range(params["pool_lines"])]
