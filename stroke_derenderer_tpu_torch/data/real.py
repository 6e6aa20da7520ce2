"""Real labelled line images for evaluation, the loaders of the JAX
``data/real.py``. A directory holds pairs in the pipeline's own output
format:

    <stem>.png             the line photo or scan
    <stem>_STROKES.json    ground-truth polylines [[X_list, Y_list], ...]
                           at the PNG's resolution, in writing order
    <stem>_BINARIZED.png   optional {0, 255} ink mask at the
                           height-normalized resolution (else the mask is
                           rasterized from the strokes)

Strokes are scaled into the height-normalized frame by ``height /
png_height``, the inverse of the CLI's output rescale. PNGs are read with
the port's own reader (``io.load_image``). The training pools of the JAX
module are not ported.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.data.synthetic import rasterize_strokes
from stroke_derenderer_tpu_torch.io import load_image
from stroke_derenderer_tpu_torch.ops.resize import resize_to_height_np


def discover_pairs(data_dir: str | Path) -> list[tuple[Path, Path]]:
    """(png, strokes_json) pairs under ``data_dir``, sorted by name;
    ``*_BINARIZED.png`` are masks, not inputs."""
    data_dir = Path(data_dir)
    pairs = []
    for png in sorted(data_dir.glob("*.png")):
        if png.stem.endswith("_BINARIZED"):
            continue
        sj = data_dir / f"{png.stem}_STROKES.json"
        if sj.exists():
            pairs.append((png, sj))
    return pairs


def load_pair(png: Path, strokes_json: Path, height: int = 128,
              thickness: int = 2):
    """-> (image_rs (height, W_rs, 3) uint8, mask (height, W_rs) uint8 {0,1},
    strokes [(x, y) float64 arrays] in the height-normalized frame)."""
    img = load_image(png)
    ratio = height / img.shape[0]
    img_rs = resize_to_height_np(img, height)

    raw = json.loads(Path(strokes_json).read_text())
    strokes = [(np.asarray(s[0], np.float64) * ratio,
                np.asarray(s[1], np.float64) * ratio) for s in raw]

    bin_png = png.with_name(f"{png.stem}_BINARIZED.png")
    if bin_png.exists():
        m = load_image(bin_png)[:, :, 0]
        if m.shape[0] != height:
            m = resize_to_height_np(m[:, :, None], height)[:, :, 0]
        if m.shape[1] != img_rs.shape[1]:  # rounding drift between files
            w = min(m.shape[1], img_rs.shape[1])
            pad = np.zeros((height, img_rs.shape[1]), m.dtype)
            pad[:, :w] = m[:, :w]
            m = pad
        mask = (m > 127).astype(np.uint8)
    else:
        mask = rasterize_strokes(strokes, img_rs.shape[:2],
                                 thickness=thickness).astype(np.uint8)
    return img_rs, mask, strokes
