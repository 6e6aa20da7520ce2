"""The port's spans and counters on a CUDA card (marker ``gpu``): the checks
of ``tests/test_torch_tracing.py`` on ``models_demo`` in bfloat16, greedy
(K1) and beam (K2), plus what only the card has: every decode kernel
launched inside an ``sd.strokes.decode`` span, and the tensor-core path's
recheck counters. Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_tracing.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch.io import decode_png, to_rgb
from stroke_derenderer_tpu_torch.kernels import fused_beam
from stroke_derenderer_tpu_torch.ops.device_partition import plan_partitions
from stroke_derenderer_tpu_torch.utils import profiling as tp

REPO = Path(__file__).resolve().parent.parent
SPANS = {"sd.binarize", "sd.binarize.prep", "sd.binarize.launch",
         "sd.binarize.wait", "sd.binarize.unpack", "sd.strokes",
         "sd.strokes.components", "sd.strokes.grouping", "sd.strokes.gather",
         "sd.strokes.encode", "sd.strokes.decode", "sd.strokes.wait",
         "sd.strokes.polylines"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stroke_derenderer_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _lines():
    """Four real-ink lines, the first three of one width (the batched fused
    binarize program) and one other (the bucketed tile batch)."""
    paths = sorted((REPO / "examples" / "real_data").glob("real0*_line_*.png"))
    paths = [p for p in paths if "_BINARIZED" not in p.name][:2]
    imgs = [to_rgb(decode_png(p.read_bytes())) for p in paths]
    return [imgs[0], imgs[0].copy(), imgs[0].copy(), imgs[1]]


def _steps(tokens, max_length):
    eos = tokens == 2
    return np.where(eos.any(1), eos.argmax(1) + 1, max_length)


@pytest.mark.gpu
@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_spans_and_counters_on_the_card(decode, tmp_path, monkeypatch):
    dev = _card()
    k = 3 if decode == "beam" else 1
    binarizer, estimator = cli.initialize_sessions(
        REPO / "models_demo", device=dev,
        se_overrides={"decode": decode, "beam_size": k})
    images = _lines()
    thr = 255 * binarizer.config.bin_thr
    masks = [m[:, :, 0] > thr for m in binarizer.binarize_images(images)]
    estimator.process_images(masks)  # kernels built and loaded
    seen = []
    if decode == "beam":
        select = fused_beam.select_beam

        def catch(preds, score, lens, length_penalty=0.0):
            seen.append(lens.max(1).values.cpu().numpy())
            return select(preds, score, lens, length_penalty)

        monkeypatch.setattr(fused_beam, "select_beam", catch)
    else:
        process_tokens = estimator.process_tokens

        def catch(toks, partitions):
            seen.append(toks)
            return process_tokens(toks, partitions)

        monkeypatch.setattr(estimator, "process_tokens", catch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        binarizer.binarize_images(images)
        estimator.process_images(masks)
    counts = tp.COUNTERS.snapshot()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("sd.")]
    assert {e["name"] for e in spans} == SPANS
    for e in spans:
        parent = e["name"].rsplit(".", 1)[0]
        assert parent == "sd" or any(
            p["name"] == parent and p["tid"] == e["tid"] and p["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= p["ts"] + p["dur"] for p in spans), e

    # Each decode kernel was launched inside a decode span.
    kernel = "beam_decode_kernel" if decode == "beam" else "greedy_decode_kernel"
    decode_spans = [e for e in spans if e["name"] == "sd.strokes.decode"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel in e["name"]]
    assert len(kernels) == len(decode_spans) == 1
    corr = kernels[0]["args"]["correlation"]
    launches = [e for e in events if e.get("cat", "").startswith("cuda_")
                and e.get("args", {}).get("correlation") == corr]
    assert launches, "no launch event of the decode kernel in the trace"
    d = decode_spans[0]
    assert all(d["ts"] <= e["ts"] and e["ts"] + e["dur"] <= d["ts"] + d["dur"]
               for e in launches)

    scfg = estimator.config
    rows = sum(len(p.partitions) for p in (
        plan_partitions(m, scfg.margin, scfg.image_size) for m in masks)
        if p is not None)
    steps = (seen[0] if decode == "beam" else
             np.concatenate([_steps(t, scfg.max_length) for t in seen]))
    assert rows > 0 and len(steps) == rows
    head = scfg.attention_dim + (scfg.projection_dim
                                 or estimator.encoder.out_features)
    hdim = scfg.decoder_dim
    need = k * int(steps.sum())
    assert {n: counts[n] for n in ("decode_row_steps", "decode_row_slots",
                                   "decode_fix_checked")} == {
        "decode_row_steps": need,
        "decode_row_slots": k * int(steps.max()) * rows,
        "decode_fix_checked": rows * k * head + need * (4 * hdim + head)}
    assert 0 <= counts["decode_fixed_elements"] <= counts["decode_fix_checked"]
    tp.COUNTERS.clear()
    tp.SPANS.clear()
