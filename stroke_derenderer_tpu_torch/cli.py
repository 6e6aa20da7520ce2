"""Command line: the main path of the JAX ``cli.py``.

    python -m stroke_derenderer_tpu_torch.cli -models models_demo \
        -input DIR --output DIR [--device cuda|cpu] \
        [--decode greedy|beam] [--beam-size K]

For every PNG in the input folder: binarize, save ``<name>_BINARIZED.png``,
estimate strokes, save ``<name>_STROKES.json`` rescaled to the input's
height, with the same timing prints. A failure on one image prints
``[error]`` and the run goes on; :func:`run` returns how many images went
through. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu_torch.io import load_image, save_image, save_json
from stroke_derenderer_tpu_torch.ops.normalize import minmax_normalize_np
from stroke_derenderer_tpu_torch.ops.strokes import strokes_to_json
from stroke_derenderer_tpu_torch.pipeline.binarize import Binarizer
from stroke_derenderer_tpu_torch.pipeline.strokes import StrokeEstimator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Handwriting derenderer (PyTorch / CUDA)")
    parser.add_argument("-models", required=True,
                        help="Folder holding the model files.")
    parser.add_argument("-input", default="./images/input",
                        help="Folder holding the input PNG images.")
    parser.add_argument("-output", "--output", default="./images/output",
                        help="Output folder.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--decode", choices=["greedy", "beam"], default=None,
                        help="Decoding strategy (default: model config / "
                             "greedy; the reference is greedy-only).")
    parser.add_argument("--beam-size", type=int, default=None,
                        help="Beam width for --decode beam.")
    return parser.parse_args(argv)


def initialize_sessions(folderpath, device=None,
                        se_overrides: dict | None = None):
    """Both pipelines from a model directory: the flax msgpack weights
    ``binarizer``, ``strokes_encoder`` and ``strokes_decoder``, and the
    config JSONs, whose entries override the defaults. ``se_overrides``
    are ``StrokesConfig`` fields that win over the config JSON (the
    ``--decode`` and ``--beam-size`` flags)."""
    folder = Path(folderpath)

    def _opt(name):
        return folder / name if (folder / name).exists() else None

    binarizer = Binarizer(
        BinarizerConfig.from_json(_opt("configs_binarizer.json")),
        folder / "binarizer.msgpack", device=device)
    se_cfg = StrokesConfig.from_json(_opt("configs_strokes.json"))
    if se_overrides:
        se_cfg = dataclasses.replace(se_cfg, **se_overrides)
    estimator = StrokeEstimator(
        se_cfg,
        {"encoder": folder / "strokes_encoder.msgpack",
         "decoder": folder / "strokes_decoder.msgpack"}, device=device)
    return binarizer, estimator


def run(imgs, binarizer: Binarizer, estimator: StrokeEstimator,
        output_folder) -> int:
    """Per image: binarize -> save -> estimate strokes -> rescale -> save.
    Returns the number of images processed."""
    out_dir = Path(output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    done = 0
    for img, filename in imgs:
        try:
            height = img.shape[0]
            start_bin = time.time()
            img_bin = binarizer.binarize_image(img)
            mask = img_bin[:, :, 0] > (255 * binarizer.config.bin_thr)
            comp_bin_time = round(time.time() - start_bin, 4)
            bin_path = str(out_dir / f"{filename}_BINARIZED.png")
            save_image(minmax_normalize_np(mask.astype(np.uint8)), bin_path,
                       grayscale=True)
            print(f"{filename} took {comp_bin_time} seconds to binarize. "
                  f"Result is saved to {bin_path}")
            ratio = height / img_bin.shape[0]
            start_se = time.time()
            stroke_list = estimator.process_image(mask)
            comp_se_time = round(time.time() - start_se, 4)
            st_path = str(out_dir / f"{filename}_STROKES.json")
            save_json(strokes_to_json(stroke_list, scale=ratio), st_path)
            print(f"{filename} took {comp_se_time} seconds to estimate "
                  f"strokes. Result is saved to {st_path}")
            done += 1
        except Exception as exc:  # one bad image does not stop the batch
            print(f"[error] {filename}: {type(exc).__name__}: {exc}")
    return done


def load_images(img_filepaths):
    """paths -> [(RGB image, stem), ...]; unreadable files are skipped with
    an ``[error]`` line."""
    out = []
    for p in img_filepaths:
        try:
            out.append((load_image(str(p)), Path(p).stem))
        except Exception as exc:
            print(f"[error] cannot load {p}: {type(exc).__name__}: {exc}")
    return out


def entrypoint(argv=None) -> int:
    args = parse_args(argv)
    imgs = load_images(sorted(Path(args.input).glob("*.png")))
    se_overrides = {}
    if args.decode:
        se_overrides["decode"] = args.decode
    if args.beam_size:
        se_overrides["beam_size"] = args.beam_size
    binarizer, estimator = initialize_sessions(
        args.models, device=args.device, se_overrides=se_overrides)
    run(imgs, binarizer, estimator, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(entrypoint())
