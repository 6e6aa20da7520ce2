"""Command line: the main path of the JAX ``cli.py``.

    python -m stroke_derenderer_tpu_torch.cli -models models_demo \
        -input DIR --output DIR [--device cuda|cpu] \
        [--decode greedy|beam] [--beam-size K] [--batch] [--fused] \
        [--no-strokes] [--svg] [--preset reference|real] [--redecode C] \
        [--redecode-passes K] [--refine PX] [--host-partition] \
        [--quant none|int8] [--two-stage [CHUNK]] [--mesh N [--mesh-tp K]]
    python -m stroke_derenderer_tpu_torch.cli --init-models DIR
    python -m stroke_derenderer_tpu_torch.cli -models DIR --export-onnx OUT

For every PNG in the input folder: binarize, save ``<name>_BINARIZED.png``,
estimate strokes, save ``<name>_STROKES.json`` rescaled to the input's
height (and ``<name>_STROKES.svg`` with ``--svg``), with the same timing
prints. :func:`run` goes image by image: a failure on one image prints
``[error]`` and the run goes on, and it returns how many images went
through. ``--batch`` takes :func:`run_batched` instead: every image's tiles
in one device batch and every image's glyphs in one, the same files, and
the prints give the amortized time per image. ``--preset real`` (residual
re-decode at coverage 0.9), ``--redecode``, ``--redecode-passes`` and
``--refine`` set the residual passes and the ink snap; explicit flags win
over the preset. ``--host-partition`` builds the glyph crops on the host
instead of the device (the same crops). ``--quant int8`` runs the UNet's and
the encoder's conv stacks in dynamic int8 (``ops.quant``); the decoder
stays in its float dtype. ``--two-stage [CHUNK]`` takes
:func:`run_two_stage`: binarization of chunk k + 1 beside the strokes of
chunk k (``parallel.TwoStagePipeline``), the same files, amortized prints.
``--init-models DIR`` writes a randomly initialized model dir; weights
missing from ``-models`` are drawn at random with a warning. ``-models``
may also be the upstream project's own ONNX model directory
(``binarizer.onnx``, ``encoder.onnx``, the decoder graphs,
``projection.onnx`` where there is one, and the two config JSONs): it is
imported on the fly (``weights.graph_import``). ``--export-onnx OUT``
writes a native ``-models`` directory in that layout
(``weights.graph_export``) and exits. Runs on the card unless ``--device
cpu`` is given. ``--mesh N`` runs N ranks, one process each
(``parallel.multihost.spawn``; on ``cuda:0`` .. ``cuda:N-1``, or on the
CPU with ``--device cpu``), over a ('dp', 'tp') mesh with ``--mesh-tp K``
(``parallel.mesh``): every rank runs the same run on the same inputs, the
tile and glyph batches sharded over dp and the binarizer's tile width over
tp, and rank 0 alone prints and writes the files; the exit code is
non-zero when a rank fails. With fewer than N cards it warns and runs on
one device, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys
import time
from pathlib import Path

import numpy as np

from stroke_derenderer_tpu_torch.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu_torch.io import (
    load_image, save_image, save_json, save_svg,
)
from stroke_derenderer_tpu_torch.ops.normalize import minmax_normalize_np
from stroke_derenderer_tpu_torch.ops.strokes import strokes_to_json
from stroke_derenderer_tpu_torch.pipeline.binarize import Binarizer
from stroke_derenderer_tpu_torch.pipeline.strokes import StrokeEstimator


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Handwriting derenderer (PyTorch / CUDA)")
    parser.add_argument("-models", default=None,
                        help="Folder holding the model files (weights "
                             "missing there are drawn at random, with a "
                             "warning).")
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
    parser.add_argument("--preset", choices=["reference", "real"],
                        default="reference",
                        help="Decode policy preset. 'reference' (default) "
                             "is the single greedy pass. 'real' is the "
                             "JAX package's best measured policy for real "
                             "photographed handwriting: coverage-driven "
                             "residual re-decode at 0.9 with the 20 px "
                             "fragment join. Explicit --redecode/"
                             "--redecode-passes flags win over the "
                             "preset.")
    parser.add_argument("--redecode", type=float, default=None, metavar="C",
                        help="Coverage-driven re-decode: while less than "
                             "fraction C of the ink lies within ~2 px of "
                             "the predicted strokes, the uncovered residual "
                             "gets another decode pass (counters early EOS "
                             "on dense glyphs). E.g. 0.9.")
    parser.add_argument("--redecode-passes", type=int, default=None,
                        metavar="K",
                        help="Max residual passes for --redecode "
                             "(default 3; each pass stops early once "
                             "coverage C is met or nothing new decodes).")
    parser.add_argument("--refine", type=float, default=None, metavar="PX",
                        help="Snap decoded stroke vertices onto the "
                             "binarized ink within PX pixels "
                             "(ops/strokes.refine_strokes): keeps the "
                             "model's stroke order and topology, takes "
                             "metric accuracy from the mask. E.g. 3.")
    parser.add_argument("--batch", action="store_true",
                        help="Throughput mode: one device batch for every "
                             "image's tiles and one for every image's "
                             "glyphs; amortized timing prints.")
    parser.add_argument("--fused", action="store_true",
                        help="Binarize with the tiles cut and stitched on "
                             "the device.")
    parser.add_argument("--no-strokes", action="store_true",
                        help="Binarize only.")
    parser.add_argument("--svg", action="store_true",
                        help="Also write <name>_STROKES.svg.")
    parser.add_argument("--init-models", default=None, metavar="DIR",
                        help="Write a randomly initialized model dir and "
                             "exit.")
    parser.add_argument("--export-onnx", default=None, metavar="DIR",
                        help="Write -models (a native msgpack model dir) "
                             "into DIR as the upstream project's ONNX "
                             "model directory and exit.")
    parser.add_argument("--device-partition", action="store_true",
                        help="Build the glyph crops on the device (the "
                             "default; accepted as the JAX CLI accepts "
                             "it).")
    parser.add_argument("--host-partition", action="store_true",
                        help="Build the glyph crops on the host "
                             "(pipeline.strokes.compute_partitions) and "
                             "upload them.")
    parser.add_argument("--two-stage", type=int, nargs="?", const=8,
                        default=0, metavar="CHUNK",
                        help="Overlap: binarize chunk k+1 while chunk k's "
                             "strokes decode (parallel.TwoStagePipeline, "
                             "each stage on its own thread and CUDA "
                             "stream). Optional value = chunk size "
                             "(default 8).")
    parser.add_argument("--quant", choices=["none", "int8"], default=None,
                        help="Dynamic int8 quantization of the UNet and "
                             "encoder conv stacks (ops/quant.py: im2col "
                             "and an int8 GEMM with int32 sums). Any "
                             "checkpoint runs in either mode.")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="Data-parallel inference over N ranks, one "
                             "process each: params replicated, tile/glyph "
                             "batch axes sharded over a ('dp', 'tp') mesh "
                             "(parallel/mesh.py). 0/1 = single device.")
    parser.add_argument("--mesh-tp", type=int, default=1, metavar="K",
                        help="Sequence-parallel extent within --mesh: the "
                             "binarizer's tile WIDTH axis shards over a tp "
                             "axis of size K (N must be divisible by K).")
    return parser.parse_args(argv)


def initialize_sessions(folderpath, device=None,
                        se_overrides: dict | None = None,
                        fused: bool = False,
                        bin_overrides: dict | None = None, mesh=None):
    """Both pipelines from a model directory: the flax msgpack weights
    ``binarizer``, ``strokes_encoder``, ``strokes_decoder`` and, where the
    config has a projection head, ``strokes_projection``, and the config
    JSONs, whose entries override the defaults. ``se_overrides`` and
    ``bin_overrides`` are ``StrokesConfig`` and ``BinarizerConfig`` fields
    that win over the config JSON (``--decode``, ``--beam-size``,
    ``--preset``, ``--redecode``, ``--redecode-passes``, ``--refine``);
    ``fused`` is the binarizer's mode (``--fused``). Weight files missing
    from the folder (or no folder at all) fall back to random weights with
    a warning, as in the JAX CLI. A folder that holds ``binarizer.onnx``
    and no ``binarizer.msgpack`` is the upstream project's ONNX model
    directory, imported on the fly (``weights.graph_import``). ``mesh``:
    this rank's ``parallel.mesh.Mesh`` (both pipelines run on its
    device)."""
    folder = Path(folderpath) if folderpath else None

    def _opt(name):
        p = folder / name if folder else None
        return p if (p and p.exists()) else None

    if _opt("binarizer.onnx") and not _opt("binarizer.msgpack"):
        return _sessions_from_onnx(folder, device, se_overrides, fused,
                                   bin_overrides, mesh)
    bin_cfg = BinarizerConfig.from_json(_opt("configs_binarizer.json"))
    if bin_overrides:
        bin_cfg = dataclasses.replace(bin_cfg, **bin_overrides)
    bin_weights = _opt("binarizer.msgpack")
    if folder and not bin_weights:
        print(f"[warn] {folder}/binarizer.msgpack not found; using random "
              "init")
    binarizer = Binarizer(bin_cfg, bin_weights, device=device, fused=fused,
                          mesh=mesh)
    se_cfg = StrokesConfig.from_json(_opt("configs_strokes.json"))
    if se_overrides:
        se_cfg = dataclasses.replace(se_cfg, **se_overrides)
    enc_w, dec_w = (_opt("strokes_encoder.msgpack"),
                    _opt("strokes_decoder.msgpack"))
    paths = None
    if enc_w and dec_w:
        paths = {"encoder": enc_w, "decoder": dec_w}
        proj_w = _opt("strokes_projection.msgpack")
        if proj_w:
            paths["projection"] = proj_w
    elif folder:
        print(f"[warn] stroke model weights not found in {folder}; using "
              "random init")
    estimator = StrokeEstimator(se_cfg, paths, device=device, mesh=mesh)
    return binarizer, estimator


def _sessions_from_onnx(folder: Path, device, se_overrides, fused: bool,
                        bin_overrides, mesh=None):
    """Both pipelines straight from the upstream project's ONNX model
    directory (``weights.graph_import.import_reference_models``)."""
    from stroke_derenderer_tpu_torch.weights.graph_import import (
        import_reference_models,
    )
    print(f"[info] importing reference ONNX models from {folder}")
    (bin_cfg, bin_vars, se_cfg, enc_vars, dec_vars,
     proj_vars) = import_reference_models(folder)
    if bin_overrides:
        bin_cfg = dataclasses.replace(bin_cfg, **bin_overrides)
    if se_overrides:
        se_cfg = dataclasses.replace(se_cfg, **se_overrides)
    binarizer = Binarizer(bin_cfg, device=device, fused=fused,
                          variables=bin_vars, mesh=mesh)
    estimator = StrokeEstimator(se_cfg, device=device,
                                variables=(enc_vars, dec_vars, proj_vars),
                                mesh=mesh)
    return binarizer, estimator


def _save_strokes(out_dir: Path, filename: str, img, stroke_list,
                  ratio: float, svg: bool) -> str:
    st_path = str(out_dir / f"{filename}_STROKES.json")
    save_json(strokes_to_json(stroke_list, scale=ratio), st_path)
    if svg:
        save_svg(stroke_list, out_dir / f"{filename}_STROKES.svg",
                 size=(img.shape[1], img.shape[0]), scale=ratio)
    return st_path


def _save_mask(out_dir: Path, filename: str, mask) -> str:
    bin_path = str(out_dir / f"{filename}_BINARIZED.png")
    save_image(minmax_normalize_np(mask.astype(np.uint8)), bin_path,
               grayscale=True)
    return bin_path


def _savers(write: bool):
    """(save mask, save strokes) of a run: the real ones, or, for a rank
    other than a mesh's first (``write`` False), ones that write
    nothing."""
    if write:
        return _save_mask, _save_strokes
    nothing = lambda *a, **k: ""
    return nothing, nothing


def run(imgs, binarizer: Binarizer, estimator: StrokeEstimator | None,
        output_folder, strokes: bool = True, svg: bool = False,
        write: bool = True) -> int:
    """Per image: binarize -> save -> estimate strokes -> rescale -> save
    (strokes only with ``strokes`` and an estimator; an SVG beside the JSON
    with ``svg``). Returns the number of images processed. ``write``
    False: the same work, no file written."""
    save_mask, save_strokes = _savers(write)
    out_dir = Path(output_folder)
    if write:
        out_dir.mkdir(parents=True, exist_ok=True)
    done = 0
    for img, filename in imgs:
        try:
            height = img.shape[0]
            start_bin = time.time()
            img_bin = binarizer.binarize_image(img)
            mask = img_bin[:, :, 0] > (255 * binarizer.config.bin_thr)
            comp_bin_time = round(time.time() - start_bin, 4)
            bin_path = save_mask(out_dir, filename, mask)
            print(f"{filename} took {comp_bin_time} seconds to binarize. "
                  f"Result is saved to {bin_path}")
            if strokes and estimator is not None:
                ratio = height / img_bin.shape[0]
                start_se = time.time()
                stroke_list = estimator.process_image(mask)
                comp_se_time = round(time.time() - start_se, 4)
                st_path = save_strokes(out_dir, filename, img, stroke_list,
                                       ratio, svg)
                print(f"{filename} took {comp_se_time} seconds to estimate "
                      f"strokes. Result is saved to {st_path}")
            done += 1
        except Exception as exc:  # one bad image does not stop the batch
            print(f"[error] {filename}: {type(exc).__name__}: {exc}")
    return done


def run_batched(imgs, binarizer: Binarizer,
                estimator: StrokeEstimator | None, output_folder,
                strokes: bool = True, svg: bool = False,
                write: bool = True) -> int:
    """Throughput mode: one device batch for every image's tiles
    (``binarize_images``), one for every image's glyphs
    (``process_images``). The same files as :func:`run`; the prints give
    the amortized time per image. A failure fails the whole batch."""
    save_mask, save_strokes = _savers(write)
    out_dir = Path(output_folder)
    if write:
        out_dir.mkdir(parents=True, exist_ok=True)
    if not imgs:
        return 0
    t0 = time.time()
    bins = binarizer.binarize_images([img for img, _ in imgs])
    masks = [b[:, :, 0] > (255 * binarizer.config.bin_thr) for b in bins]
    t_bin = round((time.time() - t0) / len(imgs), 4)
    for (img, filename), mask in zip(imgs, masks):
        bin_path = save_mask(out_dir, filename, mask)
        print(f"{filename} took {t_bin} seconds to binarize (amortized). "
              f"Result is saved to {bin_path}")
    if strokes and estimator is not None:
        t0 = time.time()
        all_strokes = estimator.process_images(masks)
        t_se = round((time.time() - t0) / len(imgs), 4)
        for (img, filename), mask, stroke_list in zip(imgs, masks,
                                                      all_strokes):
            st_path = save_strokes(out_dir, filename, img, stroke_list,
                                   img.shape[0] / mask.shape[0], svg)
            print(f"{filename} took {t_se} seconds to estimate strokes "
                  f"(amortized). Result is saved to {st_path}")
    return len(imgs)


def run_two_stage(imgs, binarizer: Binarizer,
                  estimator: StrokeEstimator | None, output_folder,
                  chunk_size: int = 8, strokes: bool = True,
                  svg: bool = False, write: bool = True) -> int:
    """Overlap mode: stage A (``binarize_images`` of a chunk) beside stage
    B (``process_images`` of the chunk before it), each on its own thread
    (``parallel.TwoStagePipeline``). The same files as :func:`run`; the
    prints give the amortized time per image. Without strokes there is no
    stage B, and :func:`run_batched` does the same work."""
    save_mask, save_strokes = _savers(write)
    out_dir = Path(output_folder)
    if write:
        out_dir.mkdir(parents=True, exist_ok=True)
    if not imgs:
        return 0
    if not strokes or estimator is None:
        return run_batched(imgs, binarizer, None, output_folder,
                           strokes=False, svg=svg, write=write)
    from stroke_derenderer_tpu_torch.parallel import TwoStagePipeline
    pipe = TwoStagePipeline(binarizer, estimator)
    t0 = time.time()
    masks, all_strokes = pipe.process_batched([img for img, _ in imgs],
                                              chunk_size=chunk_size)
    t_img = round((time.time() - t0) / len(imgs), 4)
    for (img, filename), mask, stroke_list in zip(imgs, masks, all_strokes):
        bin_path = save_mask(out_dir, filename, mask)
        print(f"{filename} took {t_img} seconds e2e (two-stage amortized). "
              f"Result is saved to {bin_path}")
        st_path = save_strokes(out_dir, filename, img, stroke_list,
                               img.shape[0] / mask.shape[0], svg)
        print(f"{filename} strokes saved to {st_path}")
    return len(imgs)


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


def strokes_overrides(args) -> dict:
    """The ``StrokesConfig`` fields the decode flags set: the preset first,
    then the explicit flags, which win over it."""
    ov = {}
    if args.preset == "real":
        ov["redecode_coverage"] = 0.9
    if args.decode:
        ov["decode"] = args.decode
    if args.beam_size:
        ov["beam_size"] = args.beam_size
    if args.redecode is not None:
        ov["redecode_coverage"] = args.redecode
    if args.redecode_passes is not None:
        ov["redecode_passes"] = args.redecode_passes
    if args.refine is not None:
        ov["refine_snap"] = args.refine
    if args.device_partition:
        ov["device_partition"] = True
    if args.host_partition:
        ov["device_partition"] = False
    return ov


def entrypoint(argv=None) -> int:
    args = parse_args(argv)
    if args.init_models:
        from stroke_derenderer_tpu_torch.weights import materialize_model_dir
        materialize_model_dir(args.init_models)
        print(f"initialized model dir at {args.init_models}")
        return 0
    if args.export_onnx:
        if not args.models:
            print("[error] --export-onnx requires -models <native dir>")
            return 2
        from stroke_derenderer_tpu_torch.weights.graph_export import (
            export_reference_models,
        )
        export_reference_models(args.models, args.export_onnx)
        print(f"exported reference-layout ONNX model dir to "
              f"{args.export_onnx}")
        return 0
    if args.mesh and args.mesh > 1:
        import torch

        from stroke_derenderer_tpu_torch.parallel import multihost
        n_dev = (torch.cuda.device_count()
                 if torch.device(args.device).type == "cuda" else args.mesh)
        if n_dev < args.mesh:
            print(f"[warn] --mesh {args.mesh} requested but only {n_dev} "
                  f"device(s) present; running single-device")
        else:
            cpu = torch.device(args.device).type != "cuda"
            try:
                multihost.spawn(
                    _mesh_rank, args.mesh,
                    multihost.rank_devices(args.device, args.mesh),
                    args=(argv,), threads=max(
                        1, (os.cpu_count() or 1) // args.mesh)
                    if cpu else None)
            except (RuntimeError, TimeoutError) as exc:
                print(f"[error] --mesh {args.mesh}: {exc}")
                return 1
            return 0
    _run(args)
    return 0


def _mesh_rank(argv) -> None:
    """One rank of ``--mesh``: the run of :func:`entrypoint` over the
    mesh; only rank 0 prints and writes."""
    from stroke_derenderer_tpu_torch.parallel.mesh import make_mesh
    args = parse_args(argv)
    mesh = make_mesh(args.mesh, tp=args.mesh_tp)
    with contextlib.redirect_stdout(
            sys.stdout if mesh.rank == 0 else io.StringIO()):
        _run(args, mesh)


def _run(args, mesh=None) -> None:
    """The run the flags ask for, on one device or as a rank of ``mesh``."""
    write = mesh is None or mesh.rank == 0
    imgs = load_images(sorted(Path(args.input).glob("*.png")))
    se_overrides = strokes_overrides(args)
    bin_overrides = {}
    if args.quant:
        se_overrides["quant"] = bin_overrides["quant"] = args.quant
    binarizer, estimator = initialize_sessions(
        args.models, device=args.device, se_overrides=se_overrides,
        fused=args.fused, bin_overrides=bin_overrides, mesh=mesh)
    if args.two_stage:
        run_two_stage(imgs, binarizer, estimator, args.output,
                      chunk_size=args.two_stage,
                      strokes=not args.no_strokes, svg=args.svg, write=write)
        return
    runner = run_batched if args.batch else run
    runner(imgs, binarizer, estimator, args.output,
           strokes=not args.no_strokes, svg=args.svg, write=write)


if __name__ == "__main__":
    raise SystemExit(entrypoint())
