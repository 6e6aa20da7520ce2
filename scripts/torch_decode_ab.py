#!/usr/bin/env python3
"""Compare builds of the port's decode kernels, K1, K2 and K3, in one run on
one CUDA card.

    python3 scripts/torch_decode_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each CSRC_DIR holds ``fused_decode.cu``, ``fused_beam.cu``,
``decode_step.cuh`` and ``decode_attention.cu``: the port's own
``stroke_derenderer_tpu_torch/csrc``, or another commit's, unpacked with
``git archive``. Every variant is built
with one ``nvcc`` call per source, all started together, into
``stroke_derenderer_tpu_torch/_build/ab/NAME``. Then the variants run in
the order A, B, ..., B, A (so that drift of the card shows) on the same
inputs, made from a numpy seed, with the shipped decoder weights in
bfloat16: K1 at B = 4 and B = 80, K2 at B = 4 and K = 5, at most 384
steps. One JSON line per variant and case: whether its tokens equal the
first variant's, ms per call (CUDA events around 5 calls after a warm-up),
steps, us per step, and the phase clock's us per step of each phase
(scores, attend, LSTM, head[, select]), each with its grid barrier.

K3 runs one attention step at B = 4 and B = 80 (P = 196) on the decoder's
initial h, through each variant's own C entry on prepared bfloat16 inputs:
the cluster design's (``sd_attention_config`` present: the packed weights
of ``attention_weights``) or the first design's (one block per row: the
weights cast to bfloat16 once). One JSON line per variant and case: the
largest difference of out and alpha from the first variant's, the kernel's
own ms (a CUDA graph of 20 launches, replayed 5 times, CUDA events), and
the ms of 20 launches from the host in a loop.
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

LIBS = ("fused_decode", "fused_beam", "decode_attention")
MAX_LENGTH = 384
CASES = {"K1 B=4": (4, 1), "K1 B=80": (80, 1), "K2 B=4 K=5": (4, 5)}
K3_CASES = {"K3 B=4": 4, "K3 B=80": 80}


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
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
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

    for seed, (case, b) in enumerate(K3_CASES.items(), start=len(CASES)):
        rng = np.random.default_rng(seed)
        enc = torch.from_numpy(np.maximum(rng.normal(1.0, 1.5, (b, 196, 512)),
                                          0).astype(np.float32)).to(
            dev, torch.bfloat16)
        inputs[case] = (enc, dec.project_encoding(enc).contiguous(),
                        dec.init_state(enc)[0].contiguous())
    att_packed = da.attention_weights(dec)
    plain_w = [getattr(dec, k).to(torch.bfloat16).contiguous()
               for k in ("watt", "batt", "v", "wf", "bf")]

    def k3_launcher(lib, case):
        enc, ep, h = inputs[case]
        b, p, e = enc.shape
        res = (torch.empty((b, e), device=dev),
               torch.empty((b, p), device=dev))
        if hasattr(lib, "sd_attention_config"):
            return (lambda: da.launch_attention(enc, ep, h, att_packed,
                                                *res), res)
        fn = lib.sd_attention_gate
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        ptrs = [t.data_ptr() for t in (enc, ep, h, *plain_w, *res)]

        def launch():
            rc = fn(*ptrs, b, p, e, ep.shape[-1], h.shape[-1],
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")
        return launch, res

    def events_ms(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def k3_times(launch):
        launch()
        torch.cuda.synchronize()
        loop = events_ms(launch, 20)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                launch()
        graph.replay()
        torch.cuda.synchronize()
        return events_ms(graph.replay, 5) / 20, loop

    first = {}
    names = list(variants)
    with torch.inference_mode():
        for name in names + names[::-1]:
            build._LIBS.clear()
            build._LIBS.update({lib: ctypes.CDLL(str(out / name /
                                                     f"lib{lib}.so"))
                                for lib in LIBS})
            fd._PLANS.clear()
            da._CONFIGS.clear()
            for case in K3_CASES:
                launch, res = k3_launcher(build._LIBS["decode_attention"],
                                          case)
                launch()
                torch.cuda.synchronize()
                ref = first.setdefault(case, [t.clone() for t in res])
                graph_ms, loop_ms = k3_times(launch)
                print(json.dumps({
                    "variant": name, "case": case,
                    "max_abs_diff_from_first": max(
                        float((t - r).abs().max()) for t, r in zip(res, ref)),
                    "kernel_ms": graph_ms, "loop_ms": loop_ms}), flush=True)
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
