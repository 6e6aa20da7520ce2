"""Configuration dataclasses and the stroke token grammar.

A copy of the JAX package's ``config.py`` (same field names and defaults),
so that a model directory's ``configs_binarizer.json`` and
``configs_strokes.json`` load unchanged: JSON entries override keyword
arguments, which override the defaults; unknown keys are ignored.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

# Stroke token grammar: PAD/BOS/EOS, then interleaved (x, y) vertex tokens.
PAD, BOS, EOS = 0, 1, 2


def _load_params(configs_path: str | Path | None, params: dict) -> dict:
    merged = dict(params)
    if configs_path is not None:
        with open(configs_path) as f:
            merged.update(json.load(f))
    return merged


@dataclasses.dataclass(frozen=True)
class BinarizerConfig:
    """Binarization pipeline + attention-UNet architecture."""

    height: int = 128
    width: int = 128 * 3
    channels: int = 3
    overlap: int = 128 // 2
    bin_thr: float = 0.5
    minibatch: int = 8
    features: tuple[int, ...] = (32, 64, 128, 256)
    bottleneck: int = 512
    norm: str = "group"
    compute_dtype: str = "bfloat16"
    # "int8": the UNet's conv stacks contract in int8 (ops/quant.py).
    quant: str = "none"
    # Tile batches are padded to a multiple of this.
    batch_bucket: int = 8
    # binarize_images: width groups of at least this many images take the
    # batched fused program (device cut and stitch, bit-packed masks).
    # 0 disables.
    fused_batch_min: int = 3
    # Batch calls are split into this many sub-dispatches.
    io_chunks: int = 1

    def __post_init__(self):
        object.__setattr__(self, "features", tuple(self.features))

    # Execution policy, not architecture: left out of exported model dirs.
    EXEC_FIELDS = ("batch_bucket", "fused_batch_min", "quant", "io_chunks")

    @classmethod
    def from_json(cls, configs_path: str | Path | None = None,
                  **params) -> "BinarizerConfig":
        merged = _load_params(configs_path, params)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in merged.items() if k in known})

    def export_dict(self) -> dict:
        """The fields of a model dir's ``configs_binarizer.json``."""
        d = dataclasses.asdict(self)
        for k in self.EXEC_FIELDS:
            d.pop(k, None)
        return d


@dataclasses.dataclass(frozen=True)
class StrokesConfig:
    """Stroke-estimation pipeline + captioner architecture."""

    image_size: int = 224
    margin: int = 2
    max_length: int = 384
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    encode_image_size: int = 14
    encoder_arch: str = "resnet50"
    encoder_norm: str = "group"
    embed_dim: int = 512
    attention_dim: int = 512
    decoder_dim: int = 512
    projection_dim: int = 0
    decode: str = "greedy"  # "greedy" | "beam"
    beam_size: int = 5
    length_penalty: float = 0.0  # GNMT length normalization (beam only)
    # Residual re-decode (0.0 = off): while less than this share of the
    # ink lies within ~redecode_tol px of the predicted strokes, the
    # uncovered ink is partitioned and decoded again, up to
    # redecode_passes passes, each pass's strokes joined to the others
    # where endpoints lie within max(redecode_join_tol, 2*redecode_tol+2).
    redecode_coverage: float = 0.0
    redecode_tol: int = 2
    redecode_passes: int = 3
    redecode_join_tol: float = 20.0
    # Snap stroke points onto the ink within this many pixels (0 = off).
    refine_snap: float = 0.0
    compute_dtype: str = "bfloat16"
    # "int8": the encoder's conv stacks contract in int8 (ops/quant.py); the
    # decoder stays in compute_dtype.
    quant: str = "none"
    # Under int8 the encoder's glyph batch is padded with blank crops to a
    # multiple of this, as the JAX package pads it: the activation scale
    # spans the whole batch, pad rows included.
    glyph_bucket: int = 8
    device_partition: bool = True
    # Run-length encode the group-id image for its upload where that beats
    # the dense packing (ops/device_partition.pack_gid).
    gid_rle: bool = True
    # process_images: the batch is split into this many sub-dispatches.
    io_chunks: int = 1

    def __post_init__(self):
        object.__setattr__(self, "mean", tuple(self.mean))
        object.__setattr__(self, "std", tuple(self.std))

    @property
    def vocab_size(self) -> int:
        # 3 specials + an x token and a y token per crop pixel column/row.
        return 3 + 2 * self.image_size

    @property
    def tgt_shape(self) -> tuple[int, int]:
        return (self.image_size, self.image_size)

    # Execution policy, not architecture: left out of exported model dirs
    # (the JAX package's list, which also names its own kernel fields).
    EXEC_FIELDS = ("decode", "beam_size", "length_penalty", "glyph_bucket",
                   "device_partition", "fused_decode", "fused_block_b",
                   "redecode_coverage", "redecode_tol", "redecode_passes",
                   "redecode_join_tol",
                   "quant", "io_chunks", "refine_snap", "gid_rle")

    @classmethod
    def from_json(cls, configs_path: str | Path | None = None,
                  **params) -> "StrokesConfig":
        merged = _load_params(configs_path, params)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in merged.items() if k in known})

    def export_dict(self) -> dict:
        """The fields of a model dir's ``configs_strokes.json``."""
        d = dataclasses.asdict(self)
        for k in self.EXEC_FIELDS:
            d.pop(k, None)
        d["mean"], d["std"] = list(d["mean"]), list(d["std"])
        return d
