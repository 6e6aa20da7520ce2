#!/usr/bin/env python3
"""The evaluator's samples through the cross-image batched path: one
``binarize_images`` and one ``process_images`` call for the whole set, as
``--batch`` runs them, scored with the evaluator's metrics.

    python scripts/eval_batched.py --package stroke_derenderer_tpu \
        --models models_demo (--data examples/real_data | --style mixed \
        --n 50 --seed 0) [--redecode 0.9] [--device cpu]

``--package`` names the package to run: ``stroke_derenderer_tpu`` (the JAX
package; set ``JAX_PLATFORMS=cpu`` for its CPU run) or
``stroke_derenderer_tpu_torch`` (the port, on the card unless ``--device
cpu``). Both packages have the same pipeline and metric functions, so this
one file drives either: the samples are those of their ``eval/run.py``
(the same pairs, and for synthetic samples the same draws from the same
seed, binarizer lines first), and the result dict has the evaluator's keys.
Prints one JSON line. ``scripts/jax_cpu_eval.py --batched`` records the
JAX package's runs; ``chip_smoke.py``'s eval phase holds the port's to
them. This file imports neither JAX nor torch itself.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


def _sessions(package: str, models_dir, se_overrides, device):
    init = _mod(package, "cli").initialize_sessions
    kw = {"se_overrides": se_overrides}
    if package.endswith("_torch"):
        kw["device"] = device
    return init(models_dir, **kw)


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return float(np.mean(xs)) if xs else None


def _finite(x):
    return x if np.isfinite(x) else None


def _stroke_summary(m, preds, truths) -> dict:
    """The evaluator's stroke metrics over (predicted, true) stroke lists."""
    dtw = [_finite(m.stroke_dtw(p, t)) for p, t in zip(preds, truths)]
    ok = [x for x in dtw if x is not None]
    return {
        "stroke_dtw": _mean(dtw),
        "stroke_dtw_ci95": (float(1.96 * np.std(ok) / len(ok) ** 0.5)
                            if len(ok) > 1 else None),
        "stroke_dtw_failures": sum(x is None for x in dtw),
        "stroke_dtw_assigned": _mean([_finite(m.stroke_dtw_assigned(p, t))
                                      for p, t in zip(preds, truths)]),
        "stroke_dtw_split": _mean([_finite(m.stroke_dtw_split(p, t))
                                   for p, t in zip(preds, truths)]),
        "stroke_chamfer": _mean([_finite(m.strokes_chamfer(p, t))
                                 for p, t in zip(preds, truths)]),
        "stroke_coverage": _mean([m.stroke_coverage(p, t)
                                  for p, t in zip(preds, truths)]),
    }


def evaluate_real_batched(package: str, models_dir, data_dir,
                          se_overrides: dict | None = None,
                          device=None) -> dict:
    """``evaluate_real``'s pairs and metrics, every pair binarized in one
    ``binarize_images`` call and its strokes estimated in one
    ``process_images`` call."""
    real = _mod(package, "data.real")
    m = _mod(package, "eval.metrics")
    pairs = real.discover_pairs(data_dir)
    if not pairs:
        raise FileNotFoundError(f"no (png, _STROKES.json) pairs in {data_dir}")
    binarizer, estimator = _sessions(package, models_dir, se_overrides,
                                     device)
    h = binarizer.config.height
    loaded = [real.load_pair(png, sj, h) for png, sj in pairs]
    outs = binarizer.binarize_images([img for img, _, _ in loaded])
    thr = 255 * binarizer.config.bin_thr
    masks = [out[:, :, 0] > thr for out in outs]
    truth = [mask > 0 for _, mask, _ in loaded]
    preds = estimator.process_images(masks)
    return {"n": len(pairs),
            "binarization_f1": _mean([m.binarization_f1(p, t)
                                      for p, t in zip(masks, truth)]),
            "binarization_f1_tol1": _mean([m.binarization_f1_tol(p, t)
                                           for p, t in zip(masks, truth)])
            } | _stroke_summary(m, preds, [s for _, _, s in loaded])


def evaluate_full_batched(package: str, models_dir, n: int = 50,
                          seed: int = 0, width: int = 1152,
                          style: str = "mixed",
                          se_overrides: dict | None = None,
                          device=None) -> dict:
    """``evaluate_full``'s samples at ``style`` ("smooth" or "mixed"; the
    evaluator's other options at their defaults) and metrics: the ``n``
    binarizer lines in one ``binarize_images`` call, the ``n`` glyph
    samples in one ``process_images`` call."""
    syn = _mod(package, "data.synthetic")
    m = _mod(package, "eval.metrics")
    if style not in ("smooth", "mixed"):
        raise ValueError(f"style {style!r}: smooth or mixed")
    rng = np.random.default_rng(seed)
    binarizer, estimator = _sessions(package, models_dir, se_overrides,
                                     device)
    h = binarizer.config.height
    imgs, lines = [], []
    for _ in range(n):
        strokes = syn.random_strokes(rng, int(rng.integers(3, 8)),
                                     (h, width))
        mask = syn.rasterize_strokes(strokes, (h, width),
                                     thickness=int(rng.integers(1, 4)))
        imgs.append(syn._photo_render(mask, rng, ruled=False))
        lines.append(mask > 0)
    thr = 255 * binarizer.config.bin_thr
    f1s = [m.binarization_f1(out[:, :, 0] > thr, t)
           for out, t in zip(binarizer.binarize_images(imgs), lines)]
    widths_cycle = [h, 2 * h, 4 * h]
    masks, truths = [], []
    for i in range(n):
        cw = widths_cycle[i % len(widths_cycle)]
        if style == "mixed":
            strokes = syn.mixed_strokes(rng, (h, cw), token_budget=380,
                                        max_strokes=3)
        else:
            strokes = syn.random_strokes(rng, int(rng.integers(1, 4)),
                                         (h, cw), points_per_stroke=24)
        masks.append(syn.rasterize_strokes(strokes, (h, cw),
                                           thickness=2) > 0)
        truths.append(strokes)
    preds = estimator.process_images(masks)
    return {"n": n, "binarization_f1": float(np.mean(f1s))} | (
        _stroke_summary(m, preds, truths))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", required=True,
                    choices=["stroke_derenderer_tpu",
                             "stroke_derenderer_tpu_torch"])
    ap.add_argument("--models", required=True)
    ap.add_argument("--data", default=None, metavar="DIR")
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--style", choices=["smooth", "mixed"], default="smooth")
    ap.add_argument("--redecode", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="the port's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    ov = ({"redecode_coverage": args.redecode}
          if args.redecode is not None else None)
    if args.data:
        res = evaluate_real_batched(args.package, args.models, args.data, ov,
                                    args.device)
    else:
        res = evaluate_full_batched(args.package, args.models, args.n,
                                    args.seed, style=args.style,
                                    se_overrides=ov, device=args.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
