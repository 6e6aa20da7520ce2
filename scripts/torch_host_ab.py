#!/usr/bin/env python3
"""Compare trees of the port end to end on one CUDA card, in one run.

    python3 scripts/torch_host_ab.py TREE [TREE ...]

Each TREE is a directory that holds a ``stroke_derenderer_tpu_torch``
package: this repository's root, or another commit's port unpacked there
with ``git archive``. The trees run one after another, each in a process
of its own (so that each imports its own package and builds its own
kernels), in the order given: name them A, B, B, A so that drift of the
card and its host shows. Each run loads ``models_demo`` onto the card,
takes the 45 inputs of ``chip_smoke.py`` (``tests/golden/golden_input.png``
and ``data_pseudo_real``), runs every mode once to warm up (so that no
shape is seen first in a timed run), then three times each: per image
(``binarize_image``, ``process_image``), batched (``binarize_images``,
``process_images``), the same in chunks of 8 in turn, and
``TwoStagePipeline.process_batched`` in chunks of 8. Each call ends in a
download, and the card is synchronised around it. One JSON line per run:
ms per image of each mode and stage, per repetition.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 8


def run_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from stroke_derenderer_tpu_torch import cli
    from stroke_derenderer_tpu_torch.parallel import TwoStagePipeline

    if not Path(cli.__file__).resolve().is_relative_to(
            Path(tree).resolve()):
        raise SystemExit(f"imported {cli.__file__}, not the tree {tree}")
    inputs = [ROOT / "tests" / "golden" / "golden_input.png"] + sorted(
        p for p in (ROOT / "data_pseudo_real").glob("*.png")
        if not p.stem.endswith("_BINARIZED"))
    b, e = cli.initialize_sessions(ROOT / "models_demo", device="cuda")
    thr = 255 * b.config.bin_thr
    imgs = [img for img, _ in cli.load_images(inputs)]
    n = len(imgs)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def per_image():
        tb = ts = 0.0
        for img in imgs:
            t0 = clock()
            mask = b.binarize_image(img)[:, :, 0] > thr
            t1 = clock()
            e.process_image(mask)
            t2 = clock()
            tb, ts = tb + t1 - t0, ts + t2 - t1
        return {"binarize": 1e3 * tb / n, "strokes": 1e3 * ts / n}

    def batched():
        t0 = clock()
        masks = [m[:, :, 0] > thr for m in b.binarize_images(imgs)]
        t1 = clock()
        e.process_images(masks)
        t2 = clock()
        return {"binarize": 1e3 * (t1 - t0) / n,
                "strokes": 1e3 * (t2 - t1) / n}

    def chunks():
        t0 = clock()
        for c in range(0, n, CHUNK):
            e.process_images([m[:, :, 0] > thr for m in
                              b.binarize_images(imgs[c:c + CHUNK])])
        return {"total": 1e3 * (clock() - t0) / n}

    pipe = TwoStagePipeline(b, e)

    def two_stage():
        t0 = clock()
        pipe.process_batched(imgs, chunk_size=CHUNK)
        return {"total": 1e3 * (clock() - t0) / n}

    modes = {"per_image": per_image, "batched": batched,
             "chunks": chunks, "two_stage": two_stage}
    for fn in modes.values():
        fn()
    return {"tree": tree, "images": n,
            "card": torch.cuda.get_device_name(0)} | {
        name: [fn() for _ in range(3)] for name, fn in modes.items()}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_tree(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
