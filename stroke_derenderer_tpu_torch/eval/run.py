"""Evaluation runner: score a model directory on synthetic ground truth or
on real labelled pairs, as the JAX ``eval/run.py`` does.

    python -m stroke_derenderer_tpu_torch.eval.run --models models_demo \
        [--n 50 --seed 0 --style smooth|mixed|hand|letters] \
        [--data examples/real_data] [--redecode C] [--refine PX] \
        [--device cuda|cpu]

Synthetic: line images rendered from random strokes (``data/synthetic.py``)
score the binarizer (F1), glyph-sized samples with known polylines score
the strokes (DTW with greedy, optimal and many-to-one matching, chamfer,
coverage). Real: each ``<stem>.png`` runs through binarize and strokes,
scored against its ``_BINARIZED.png`` and ``_STROKES.json``. The same
seed draws the same samples as the JAX evaluator, and the result dicts
have its keys. Prints one JSON line. Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from stroke_derenderer_tpu_torch.cli import initialize_sessions
from stroke_derenderer_tpu_torch.eval.metrics import (
    binarization_f1, binarization_f1_tol, stroke_coverage, stroke_dtw,
    stroke_dtw_assigned, stroke_dtw_split, strokes_chamfer,
)


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return float(np.mean(xs)) if xs else None


def _finite(x):
    return x if np.isfinite(x) else None


def _stroke_scores(pred_strokes, strokes, acc: dict) -> None:
    """Append one sample's stroke metrics to the lists of ``acc``."""
    acc["dtw"].append(_finite(stroke_dtw(pred_strokes, strokes)))
    acc["chamfer"].append(_finite(strokes_chamfer(pred_strokes, strokes)))
    acc["coverage"].append(stroke_coverage(pred_strokes, strokes))
    acc["assigned"].append(_finite(stroke_dtw_assigned(pred_strokes,
                                                       strokes)))
    acc["split"].append(_finite(stroke_dtw_split(pred_strokes, strokes)))


def _stroke_summary(acc: dict) -> dict:
    dtw_ok = [x for x in acc["dtw"] if x is not None]
    return {
        "stroke_dtw": _mean(acc["dtw"]),
        # 95% CI half-width of the DTW mean.
        "stroke_dtw_ci95": (float(1.96 * np.std(dtw_ok)
                                  / max(len(dtw_ok), 1) ** 0.5)
                            if len(dtw_ok) > 1 else None),
        "stroke_dtw_failures": sum(x is None for x in acc["dtw"]),
        "stroke_dtw_assigned": _mean(acc["assigned"]),
        "stroke_dtw_split": _mean(acc["split"]),
        "stroke_chamfer": _mean(acc["chamfer"]),
        "stroke_coverage": _mean(acc["coverage"]),
    }


def _new_acc() -> dict:
    return {k: [] for k in ("dtw", "chamfer", "coverage", "assigned",
                            "split")}


def evaluate_full(models_dir, n: int = 50, seed: int = 0,
                  width: int = 1152, se_overrides: dict | None = None,
                  dense: bool = False, style: str = "smooth",
                  bin_overrides: dict | None = None,
                  ruled: float = 0.0, binarizer_only: bool = False,
                  device=None) -> dict:
    """Binarization F1 on ``n`` rendered lines (``ruled``: the chance of
    ruled coloured paper), then stroke metrics on ``n`` glyph-sized samples
    (widths cycling through 1, 2 and 4 line heights) of ``style``
    (``dense``: 40-point smooth strokes). ``binarizer_only`` stops after
    the F1."""
    from stroke_derenderer_tpu_torch.data.synthetic import (
        HAND_PROBS, _photo_render, mixed_strokes, random_strokes,
        rasterize_strokes,
    )

    rng = np.random.default_rng(seed)
    binarizer, estimator = initialize_sessions(
        models_dir, device=device, se_overrides=se_overrides,
        bin_overrides=bin_overrides)
    h = binarizer.config.height

    f1s = []
    for _ in range(n):
        strokes = random_strokes(rng, int(rng.integers(3, 8)), (h, width))
        mask = rasterize_strokes(strokes, (h, width),
                                 thickness=int(rng.integers(1, 4)))
        # Short-circuit: at ruled=0.0 the generator draws nothing here.
        use_ruled = ruled > 0.0 and bool(rng.random() < ruled)
        img = _photo_render(mask, rng, ruled=use_ruled)
        out = binarizer.binarize_image(img)
        pred = out[:, :, 0] > (255 * binarizer.config.bin_thr)
        f1s.append(binarization_f1(pred, mask > 0))

    if binarizer_only:
        return {"n": n, "binarization_f1": float(np.mean(f1s))}

    acc = _new_acc()
    widths_cycle = [h, 2 * h, 4 * h]
    pts = 40 if dense else 24
    for i in range(n):
        cw = widths_cycle[i % len(widths_cycle)]
        if style in ("mixed", "hand"):
            strokes = mixed_strokes(
                rng, (h, cw), token_budget=380, max_strokes=3,
                style_probs=HAND_PROBS if style == "hand" else None)
        elif style == "letters":
            from stroke_derenderer_tpu_torch.data.letters import (
                sample_word, word_strokes,
            )
            strokes = (word_strokes(rng, sample_word(rng), (h, cw),
                                    token_budget=380)
                       or mixed_strokes(rng, (h, cw), token_budget=380,
                                        max_strokes=3))
        else:
            strokes = random_strokes(rng, int(rng.integers(1, 4)), (h, cw),
                                     points_per_stroke=pts)
        mask = rasterize_strokes(strokes, (h, cw), thickness=2)
        _stroke_scores(estimator.process_image(mask > 0), strokes, acc)

    return {"n": n, "binarization_f1": float(np.mean(f1s))} | (
        _stroke_summary(acc))


def evaluate_real(models_dir, data_dir, se_overrides: dict | None = None,
                  bin_overrides: dict | None = None, device=None) -> dict:
    """Binarize and estimate strokes on every real pair of ``data_dir``
    (``data/real.py``); the metrics compare with the files' ground truth in
    the height-normalized frame."""
    from stroke_derenderer_tpu_torch.data.real import (
        discover_pairs, load_pair,
    )

    pairs = discover_pairs(data_dir)
    if not pairs:
        raise FileNotFoundError(f"no (png, _STROKES.json) pairs in {data_dir}")
    binarizer, estimator = initialize_sessions(
        models_dir, device=device, se_overrides=se_overrides,
        bin_overrides=bin_overrides)
    h = binarizer.config.height

    f1s, f1s_tol = [], []
    acc = _new_acc()
    for png, sj in pairs:
        img_rs, mask, strokes = load_pair(png, sj, h)
        out = binarizer.binarize_image(img_rs)
        pred_mask = out[:, :, 0] > (255 * binarizer.config.bin_thr)
        f1s.append(binarization_f1(pred_mask, mask > 0))
        f1s_tol.append(binarization_f1_tol(pred_mask, mask > 0))
        _stroke_scores(estimator.process_image(pred_mask), strokes, acc)

    return {"n": len(pairs), "binarization_f1": _mean(f1s),
            # Within 1 px: the exact-against-tolerant gap is the share of
            # the F1 deficit that is mask convention (edge width, halo).
            "binarization_f1_tol1": _mean(f1s_tol)} | _stroke_summary(acc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", required=True)
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode", choices=["greedy", "beam"], default=None)
    ap.add_argument("--beam-size", type=int, default=None)
    ap.add_argument("--length-penalty", type=float, default=None,
                    help="GNMT length normalization for beam ranking "
                         "(beam decode only; config.length_penalty)")
    ap.add_argument("--redecode", type=float, default=None,
                    help="coverage-driven residual re-decode floor "
                         "(config.redecode_coverage), e.g. 0.9")
    ap.add_argument("--redecode-passes", type=int, default=None,
                    help="max residual passes (config.redecode_passes)")
    ap.add_argument("--refine", type=float, default=None, metavar="PX",
                    help="ink-snap refinement radius "
                         "(config.refine_snap), e.g. 3")
    ap.add_argument("--dense", action="store_true",
                    help="harder 40-point-stroke distribution (decode-length "
                         "generalization)")
    ap.add_argument("--style", choices=["smooth", "mixed", "hand", "letters"],
                    default="smooth",
                    help="stroke eval distribution: 'mixed' includes "
                         "Lissajous curls/loops/zigzags; 'letters' is "
                         "letterform words (data/letters.py); 'hand' mixes "
                         "both")
    ap.add_argument("--ruled", type=float, default=0.0, metavar="P",
                    help="probability a binarization-F1 line renders on "
                         "ruled colored paper (distractor guide lines)")
    ap.add_argument("--binarizer-only", action="store_true",
                    help="report binarization F1 only (skips the stroke "
                         "stage)")
    ap.add_argument("--quant", choices=["none", "int8"], default=None,
                    help="int8: dynamic int8 UNet and encoder conv stacks "
                         "(ops/quant.py)")
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="score on REAL labeled pairs from DIR "
                         "(data/real.py format) instead of synthetic "
                         "samples; --n/--seed/--style/--dense are ignored")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    ov = {}
    if args.decode:
        ov["decode"] = args.decode
    if args.beam_size:
        ov["beam_size"] = args.beam_size
    if args.length_penalty is not None:
        ov["length_penalty"] = args.length_penalty
    if args.redecode is not None:
        ov["redecode_coverage"] = args.redecode
    if args.redecode_passes is not None:
        ov["redecode_passes"] = args.redecode_passes
    if args.refine is not None:
        ov["refine_snap"] = args.refine
    bov = {}
    if args.quant:
        ov["quant"] = args.quant
        bov["quant"] = args.quant
    if args.data:
        print(json.dumps(evaluate_real(args.models, args.data,
                                       se_overrides=ov or None,
                                       bin_overrides=bov or None,
                                       device=args.device)))
        return 0
    print(json.dumps(evaluate_full(args.models, args.n, args.seed,
                                   se_overrides=ov or None,
                                   dense=args.dense, style=args.style,
                                   bin_overrides=bov or None,
                                   ruled=args.ruled,
                                   binarizer_only=args.binarizer_only,
                                   device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
