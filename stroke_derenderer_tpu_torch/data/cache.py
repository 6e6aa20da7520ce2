"""Disk cache of partition-pipeline glyph training samples, counterpart of
the JAX ``data/cache.py`` with the same files, so that a cache built by
either package feeds the other.

Live glyph samples go through the inference partition (rasterize,
connected components, grouping, resize), some milliseconds of host CPU per
sample, which can hold the captioner's steps back. A cache generates them
once; training then streams them from RAM.

Storage: shards ``glyphs_XXXXX.npz`` of

  * ``crops``  (K, S, S) uint8, the partition crop before its second
    min-max pass (``"image"`` of ``pipeline.strokes.compute_partitions``);
  * ``tokens`` (K, L)    int16, BOS/EOS/PAD + vertex tokens;

and ``meta.json``. The model input is rebuilt at load time with the
pipeline's own normalize chain, so cached batches equal live
``partitioned_glyph_batches`` batches of the same samples.

    python -m stroke_derenderer_tpu_torch.data.cache --out DIR --n 50000 \
        --seq-len 384 --style mixed [--seed 0]
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.config import BOS, StrokesConfig
from stroke_derenderer_tpu_torch.ops.normalize import (
    imagenet_normalize_np, minmax_normalize_np,
)

SHARD = 2000


def build_glyph_cache(out_dir: str | Path, n: int, seq_len: int = 384,
                      style: str = "mixed", seed: int = 0,
                      log_every: int = 2000) -> Path:
    """Generate ``n`` partition-pipeline samples into ``out_dir``'s
    shards, from one generator seeded with ``seed``."""
    from stroke_derenderer_tpu_torch.data.synthetic import (
        make_partitioned_glyph_sample,
    )

    from stroke_derenderer_tpu_torch.utils.logging import get_logger

    log = get_logger("data.cache")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    s = StrokesConfig().image_size
    crops = np.zeros((min(SHARD, n), s, s), np.uint8)
    toks = np.zeros((min(SHARD, n), seq_len + 1), np.int16)
    shard = k = 0
    for i in range(n):
        _, crop_u8, t = make_partitioned_glyph_sample(rng, seq_len + 1,
                                                      style=style)
        crops[k] = crop_u8
        toks[k] = t.astype(np.int16)
        k += 1
        if k == crops.shape[0] or i == n - 1:
            np.savez_compressed(out / f"glyphs_{shard:05d}.npz",
                                crops=crops[:k], tokens=toks[:k])
            shard += 1
            k = 0
            rem = n - i - 1
            crops = crops[:min(SHARD, max(rem, 1))]
            toks = toks[:min(SHARD, max(rem, 1))]
        if (i + 1) % log_every == 0:
            log.info("cache: %d/%d samples", i + 1, n)
    (out / "meta.json").write_text(json.dumps(
        {"n": n, "seq_len": seq_len, "style": style, "seed": seed,
         "image_size": s}))
    return out


def load_glyph_cache(cache_dir: str | Path):
    """All shards into RAM: (crops (N, S, S) uint8, tokens (N, L) int16)."""
    cache_dir = Path(cache_dir)
    shards = sorted(cache_dir.glob("glyphs_*.npz"))
    if not shards:
        raise FileNotFoundError(f"no glyphs_*.npz shards in {cache_dir}")
    cs, ts = [], []
    for p in shards:
        with np.load(p) as z:
            cs.append(z["crops"])
            ts.append(z["tokens"])
    return np.concatenate(cs), np.concatenate(ts)


def cached_glyph_batches(cache_dir: str | Path, rng: np.random.Generator,
                         batch_size: int, seq_len: int = 384,
                         n_batches: int | None = None,
                         config: StrokesConfig | None = None,
                         raw: bool = False):
    """Yield (crops (B, S, S, 3) float32, tok_in (B, T), tok_out (B, T))
    drawn with replacement from the cache, the teacher-forcing contract of
    ``data.synthetic.partitioned_glyph_batches``. ``raw=True`` yields the
    uint8 crops (B, S, S) untouched instead, for a train step that
    normalizes on the device (``train.steps.device_normalize_u8``)."""
    cfg = config or StrokesConfig()
    crops, tokens = load_glyph_cache(cache_dir)
    if tokens.shape[1] < seq_len + 1:
        raise ValueError(
            f"cache at {cache_dir} holds {tokens.shape[1] - 1}-token "
            f"horizons; rebuild with --seq-len >= {seq_len}")
    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)
    i = 0
    while n_batches is None or i < n_batches:
        idx = rng.integers(0, crops.shape[0], batch_size)
        if raw:
            batch = crops[idx]
        else:
            batch = np.stack([
                imagenet_normalize_np(minmax_normalize_np(crops[j]), mean,
                                      std)
                for j in idx])
        seqs = tokens[idx, :seq_len + 1].astype(np.int32)
        tok_in = np.concatenate(
            [np.full((batch_size, 1), BOS, np.int32), seqs[:, :seq_len - 1]],
            axis=1)
        yield batch, tok_in, seqs[:, :seq_len]
        i += 1


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--seq-len", type=int, default=384)
    ap.add_argument("--style", default="mixed",
                    choices=["smooth", "mixed", "hand", "letters"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    build_glyph_cache(args.out, args.n, args.seq_len, args.style, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
