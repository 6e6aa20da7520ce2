#!/usr/bin/env python3
"""K1 and K2 of one tree of the port on one CUDA card, at the shapes of
``chip_smoke.py``: time per launch and the phase clock.

    python3 scripts/torch_phase_clock.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout whose ``stroke_derenderer_tpu_torch``
is imported (default: this one), for instance a parent commit unpacked
with ``git archive`` into a git-ignored directory; its kernels are built
into that tree's ``_build/``. Run two trees in one call to the card, in
the order A, B, B, A, to compare them on the same card.

The rows are those of ``chip_smoke.py``: the golden image's glyphs (K1,
and K2 at K = 5) and the 197 glyphs of the 45 smoke inputs in one batch
(K1 at B = 197, K2 at 985 beams), encoded by ``models_demo``'s encoder in
bfloat16, decoded with its decoder at up to 384 steps; and a page of the
benchmark's ``page_beam`` traffic, the beams of one call: those glyphs
repeated to PAGE_GLYPHS (480, a page's glyph rows) x 5 beams. For
each case one JSON line: ms per launch (CUDA events around 3 launches
after a warm-up), steps, the phase clock's microseconds per step of each
phase (scores, attend, LSTM, head[, select], each with its grid barrier),
the steps whose attended sum split an image's columns over blocks
(``decode_attend_split_steps``; null for a tree without that record) and
the tokens' digest (equal digests: equal tokens). The first line is the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

MAX_LENGTH = 384
BEAM = 5
PAGE_GLYPHS = 480


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent
                                          .parent))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_phase_clock: no CUDA device is available",
              file=sys.stderr)
        return 1
    from stroke_derenderer_tpu_torch import cli
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    assert Path(fd.__file__).resolve().is_relative_to(tree)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    label = args.label or str(tree)
    dev = torch.device("cuda")
    binarizer, est = cli.initialize_sessions(
        tree / "models_demo", device=dev,
        se_overrides={"max_length": MAX_LENGTH})
    dec = est.decoder
    golden = tree / "tests" / "golden" / "golden_input.png"
    inputs = [golden] + sorted(
        p for p in (tree / "data_pseudo_real").glob("*.png")
        if not p.stem.endswith("_BINARIZED"))
    imgs = [img for img, _ in cli.load_images(inputs)]

    def encoded(masks):
        crops = est._gather_batch(masks)[0]
        return encode_postprocess(est.encoder(est._normalize_raw(crops)),
                                  est.config.encode_image_size)

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    with torch.inference_mode():
        masks = [b[:, :, 0] > 127 for b in binarizer.binarize_images(imgs)]
        seqs = {"golden": encoded(masks[:1]), "batched": encoded(masks)}
        reps = -(-PAGE_GLYPHS // seqs["batched"].shape[0])
        seqs["page"] = seqs["batched"].repeat(reps, 1, 1)[:PAGE_GLYPHS]
        w = dec.weights(torch.bfloat16)
        packed = fd.pack_step_weights(w)
        for case, k in (("golden", 1), ("golden", BEAM), ("batched", 1),
                        ("batched", BEAM), ("page", BEAM)):
            enc = seqs[case].to(torch.bfloat16).contiguous()
            ep = dec.project_encoding(enc).contiguous()
            h, c = (t.contiguous() for t in dec.init_state(enc))
            b = enc.shape[0]
            if k == 1:
                run = lambda: fd.fused_greedy_decode_packed(
                    enc, ep, h, c, w, MAX_LENGTH, packed)
                name, nph = "fused_decode", 4
            else:
                run = lambda: fb.fused_beam_decode_packed(
                    enc, ep, h, c, w, MAX_LENGTH, k, packed)[0]
                name, nph = "fused_beam", 5
            tokens = run()
            t = ms(run)
            stamps = torch.zeros(3 + MAX_LENGTH * nph, dtype=torch.int64,
                                 device=dev)
            launched = fd.launch_step_kernel(
                name, enc, ep, h, c, packed, k, MAX_LENGTH, {
                "preds": torch.zeros((b, k, MAX_LENGTH), dtype=torch.int32,
                                     device=dev),
                "score_out": torch.zeros((b, k), device=dev),
                "lens_out": torch.zeros((b, k), dtype=torch.int32,
                                        device=dev),
                "stamps": stamps})
            torch.cuda.synchronize()
            astat = launched.get("astat")
            st = stamps.cpu().numpy().astype("float64")
            steps = int((st[3:] > 0).sum()) // nph
            per = (st[3:3 + steps * nph] - st[2:2 + steps * nph]).reshape(
                steps, nph) / 1e3
            print(json.dumps({
                "tree": label, "kernel": "K1" if k == 1 else "K2",
                "case": case, "rows": b * k, "ms": t, "steps": steps,
                "step_us": float(per.sum(1).mean()),
                "phase_us": [float(x) for x in per.mean(0)],
                "decode_attend_split_steps": None if astat is None
                else int(astat[0]),
                "tokens_sha1": hashlib.sha1(
                    tokens.cpu().numpy().tobytes()).hexdigest()[:16]}),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
