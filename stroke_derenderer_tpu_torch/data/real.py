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
the port's own reader (``io.load_image``).

The training pools: :func:`real_tile_batches` gives binarizer pairs, the
photo height-normalized and cut into tiles as inference cuts it, the masks
aligned per tile; :func:`real_glyph_batches` gives captioner pairs, the
mask partitioned as inference partitions it
(``pipeline.strokes.compute_partitions``) and each glyph's strokes mapped
into its crop and tokenized. Glyphs whose token string would not fit the
teacher horizon are skipped, never truncated.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.config import (
    BOS, BinarizerConfig, StrokesConfig,
)
from stroke_derenderer_tpu_torch.data.synthetic import (
    rasterize_strokes, tokens_from_strokes,
)
from stroke_derenderer_tpu_torch.io import load_image
from stroke_derenderer_tpu_torch.ops.resize import resize_to_height_np
from stroke_derenderer_tpu_torch.ops.tiling import cut_tiles_np, plan_tiles
from stroke_derenderer_tpu_torch.utils.logging import get_logger


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


# ----------------------------------------------------------- binarizer side

# Preprocessed pools are cached per (dataset, config): every prefetch
# worker calls the batch generators, and without the cache each worker
# would re-decode, tile and partition the whole corpus and hold its own
# copy.
_pool_lock = threading.Lock()
_pool_cache: dict = {}


def _cached_pool(key, builder):
    with _pool_lock:  # second worker blocks instead of duplicating work
        if key not in _pool_cache:
            _pool_cache[key] = builder()
        return _pool_cache[key]


def _tile_pool(pairs, config: BinarizerConfig):
    """All (photo_tile, mask_tile) pairs across the dataset, tiled exactly
    like inference (plan_tiles/cut_tiles_np)."""
    xs, ys = [], []
    for png, sj in pairs:
        img_rs, mask, _ = load_pair(png, sj, config.height)
        plan = plan_tiles(img_rs.shape[1], config.width, config.overlap)
        xs.append(cut_tiles_np(img_rs, plan))
        ys.append(cut_tiles_np(mask[:, :, None] * np.uint8(255), plan))
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    return x, (y > 127)


def real_tile_batches(data_dir: str | Path, rng: np.random.Generator,
                      batch_size: int, height: int = 128, width: int = 384,
                      n_batches: int | None = None,
                      config: BinarizerConfig | None = None):
    """Yield (tiles f32 [0,1] (B,H,W,3), masks f32 (B,H,W,1)) sampled with
    replacement from the dataset's tile pool — same contract as
    data/synthetic.tile_batches."""
    config = config or BinarizerConfig(height=height, width=width)
    pairs = discover_pairs(data_dir)
    if not pairs:
        raise FileNotFoundError(f"no (png, _STROKES.json) pairs in {data_dir}")
    key = ("tiles", str(Path(data_dir).resolve()),
           json.dumps(config.export_dict(), sort_keys=True))
    x, y = _cached_pool(key, lambda: _tile_pool(pairs, config))
    i = 0
    while n_batches is None or i < n_batches:
        idx = rng.integers(0, x.shape[0], size=batch_size)
        yield (x[idx].astype(np.float32) / 255.0,
               y[idx].astype(np.float32))
        i += 1


# ----------------------------------------------------------- captioner side

def _assign_strokes(strokes, t1, ratio, t2, image_size: int, tol: float = 2.0):
    """Strokes whose transformed centroid lands inside the crop, mapped into
    the crop frame (file order preserved — natural writing order)."""
    (x1, y1), (x2, y2) = t1, t2
    out = []
    for x, y in strokes:
        cx = (np.mean(x) - x1) * ratio + x2
        cy = (np.mean(y) - y1) * ratio + y2
        if -tol <= cx < image_size + tol and -tol <= cy < image_size + tol:
            out.append(((x - x1) * ratio + x2, (y - y1) * ratio + y2))
    return out


def glyph_samples_from_pair(png: Path, strokes_json: Path,
                            config: StrokesConfig, max_length: int,
                            height: int = 128):
    """All (partition_index, model_input (S,S,3) f32, tokens (max_length,)
    i32) glyph samples of one labeled line, built through the inference
    partition pipeline. Glyphs whose token string would truncate are
    skipped — ``partition_index`` records which compute_partitions entry
    each surviving sample came from (samples are NOT positionally aligned
    with the partition list)."""
    from stroke_derenderer_tpu_torch.pipeline.strokes import compute_partitions

    _, mask, strokes = load_pair(png, strokes_json, height)
    samples = []
    for pi, part in enumerate(compute_partitions(mask, config)):
        crop_strokes = _assign_strokes(
            strokes, part["translate1"], part["ratio"], part["translate2"],
            config.image_size)
        if not crop_strokes:
            continue
        n_tokens = sum(2 * len(s[0]) for s in crop_strokes) \
            + len(crop_strokes)  # BOS separators + EOS
        # The teacher target is tokens[:max_length - 1], so the EOS must
        # land at index <= max_length - 2: at n_tokens == max_length the
        # EOS would be sliced off and the model would train on a
        # never-terminating target (the early-EOS trap this skip exists
        # to prevent).
        if n_tokens > max_length - 1:
            continue  # never truncate targets
        toks = tokens_from_strokes(crop_strokes, config.image_size,
                                   max_length)
        samples.append((pi, part["image_input"], toks))
    return samples


def real_glyph_batches(data_dir: str | Path, rng: np.random.Generator,
                       batch_size: int, seq_len: int = 96,
                       n_batches: int | None = None,
                       config: StrokesConfig | None = None,
                       height: int = 128, raw: bool = False):
    """Yield (crops (B,S,S,3), tok_in (B,T), tok_out (B,T)) sampled with
    replacement from the dataset's glyph pool — same teacher-forcing
    contract as data/synthetic.partitioned_glyph_batches.

    ``raw=True`` de-normalizes crops back to (B, S, S) uint8 GRAY (exact
    inverse of the partition pipeline's ImageNet normalize on channel 0,
    ±1 LSB; the pipeline's 3 channels are replicas of one gray crop) —
    the same format data/cache.py ships raw — so real batches interleave
    with raw cached batches under ONE train step that normalizes on
    device (train.loop --data + --cache mixing)."""
    config = config or StrokesConfig()
    pairs = discover_pairs(data_dir)
    if not pairs:
        raise FileNotFoundError(f"no (png, _STROKES.json) pairs in {data_dir}")
    def _glyph_pool():
        pool = []
        skipped = 0
        for png, sj in pairs:
            got = glyph_samples_from_pair(png, sj, config, seq_len + 1,
                                          height)
            pool.extend(got)
            skipped += 0 if got else 1
        if skipped:
            get_logger("data.real").warning(
                "%d/%d labeled lines contributed no glyphs (empty "
                "partitions or token strings over the %d-token horizon — "
                "raise --seq-len to include them)",
                skipped, len(pairs), seq_len + 1)
        if not pool:
            raise ValueError(
                f"{data_dir}: no usable glyphs (every partition was empty "
                f"or exceeded the {seq_len + 1}-token horizon; raise "
                "--seq-len)")
        return (np.stack([c for _, c, _t in pool]),
                np.stack([t for _, _c, t in pool]))

    key = ("glyphs", str(Path(data_dir).resolve()), seq_len, height,
           json.dumps(config.export_dict(), sort_keys=True))
    crops_all, toks_all = _cached_pool(key, _glyph_pool)
    if raw:
        crops_all = np.clip(
            np.rint((crops_all[..., 0] * config.std[0] + config.mean[0])
                    * 255.0), 0, 255).astype(np.uint8)
    i = 0
    while n_batches is None or i < n_batches:
        idx = rng.integers(0, len(crops_all), size=batch_size)
        seqs = toks_all[idx]
        tok_in = np.concatenate(
            [np.full((batch_size, 1), BOS, np.int32), seqs[:, :seq_len - 1]],
            axis=1)
        yield crops_all[idx], tok_in, seqs[:, :seq_len]
        i += 1
