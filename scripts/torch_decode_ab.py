#!/usr/bin/env python3
"""Compare builds of the port's decode kernels, K1 and K2, in one run on one
CUDA card.

    python3 scripts/torch_decode_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each CSRC_DIR holds ``fused_decode.cu``, ``fused_beam.cu`` and
``decode_step.cuh``: the port's own ``stroke_derenderer_tpu_torch/csrc``, or
another commit's, unpacked with ``git archive``. Every variant is built
with one ``nvcc`` call per source, all started together, into
``stroke_derenderer_tpu_torch/_build/ab/NAME``. Then the variants run in
the order A, B, ..., B, A (so that drift of the card shows) on the same
inputs, made from a numpy seed, with the shipped decoder weights in
bfloat16: K1 at B = 4 and B = 80, K2 at B = 4 and K = 5, at most 384
steps. One JSON line per variant and case: whether its tokens equal the
first variant's, ms per call (CUDA events around 5 calls after a warm-up),
steps, us per step, and the phase clock's us per step of each phase
(scores, attend, LSTM, head[, select]), each with its grid barrier.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LIBS = ("fused_decode", "fused_beam")
MAX_LENGTH = 384
CASES = {"K1 B=4": (4, 1), "K1 B=80": (80, 1), "K2 B=4 K=5": (4, 5)}


def build_all(variants: dict, out: Path) -> None:
    from stroke_derenderer_tpu_torch.kernels import build

    def one(job):
        name, src, lib = job
        (out / name).mkdir(parents=True, exist_ok=True)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
               str(out / name / f"lib{lib}.so"), str(src / f"{lib}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{name}/{lib}: nvcc failed\n{proc.stdout}"
                             f"{proc.stderr}")

    jobs = [(n, s, lib) for n, s in variants.items() for lib in LIBS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(one, jobs))


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    from stroke_derenderer_tpu_torch import weights as tw
    from stroke_derenderer_tpu_torch.kernels import build
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder

    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    variants = {a.split("=", 1)[0]: Path(a.split("=", 1)[1]) for a in argv}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = ROOT / "stroke_derenderer_tpu_torch" / "_build" / "ab"
    build_all(variants, out)

    dev = torch.device("cuda")
    dec = AttentiveDecoder(451, 512, 512, 512, 512, dtype=torch.bfloat16)
    dec.load_state_dict(tw.from_flax_decoder(tw.read_msgpack(
        ROOT / "models_demo" / "strokes_decoder.msgpack")))
    dec = dec.to(dev)
    w = dec.weights(torch.bfloat16)
    packed = fd.pack_step_weights(w)
    inputs = {}
    for seed, (case, (b, _)) in enumerate(CASES.items()):
        rng = np.random.default_rng(seed)
        enc = torch.from_numpy(np.maximum(rng.normal(1.0, 1.5, (b, 196, 512)),
                                          0).astype(np.float32)).to(
            dev, torch.bfloat16)
        h, c = dec.init_state(enc)
        inputs[case] = (enc, dec.project_encoding(enc).contiguous(),
                        h.contiguous(), c.contiguous())

    def run(case):
        enc, ep, h, c = inputs[case]
        b, k = CASES[case]
        if k == 1:
            return fd.fused_greedy_decode_packed(enc, ep, h, c, w,
                                                 MAX_LENGTH, packed)
        return fb.fused_beam_decode_packed(enc, ep, h, c, w, MAX_LENGTH, k,
                                           packed)[0]

    def ms(case, reps=5):
        run(case)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run(case)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def phases(case):
        enc, ep, h, c = inputs[case]
        b, k = CASES[case]
        nph = 4 if k == 1 else 5
        stamps = torch.zeros(3 + MAX_LENGTH * nph, dtype=torch.int64,
                             device=dev)
        outputs = {"preds": torch.zeros((b, k, MAX_LENGTH), dtype=torch.int32,
                                        device=dev),
                   "score_out": torch.zeros((b, k), device=dev),
                   "lens_out": torch.zeros((b, k), dtype=torch.int32,
                                           device=dev),
                   "stamps": stamps}
        fd.launch_step_kernel("fused_beam" if k > 1 else "fused_decode", enc,
                              ep, h, c, packed, k, MAX_LENGTH, outputs)
        torch.cuda.synchronize()
        t = stamps.cpu().numpy().astype("float64")
        steps = int((t[3:] > 0).sum()) // nph
        per = (t[3:3 + steps * nph] - t[2:2 + steps * nph]).reshape(steps,
                                                                     nph)
        return steps, [round(float(x) / 1e3, 2) for x in per.mean(0)]

    first = {}
    names = list(variants)
    with torch.inference_mode():
        for name in names + names[::-1]:
            build._LIBS.clear()
            build._LIBS.update({lib: ctypes.CDLL(str(out / name /
                                                     f"lib{lib}.so"))
                                for lib in LIBS})
            fd._PLANS.clear()
            for case in CASES:
                got = run(case)
                first.setdefault(case, got)
                t = ms(case)
                steps, per = phases(case)
                print(json.dumps({
                    "variant": name, "case": case,
                    "same_tokens_as_first": bool(torch.equal(got,
                                                             first[case])),
                    "ms": round(t, 3), "steps": steps,
                    "us_per_step": round(t * 1e3 / steps, 2),
                    "phase_us": per}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
