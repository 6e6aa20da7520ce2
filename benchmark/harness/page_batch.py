"""Runner of the ``page_batch`` traffic: a closed loop with one caller.

A call is one page of ``lines_per_call`` lines, drawn in a seeded order
from a pool of lines composed from the seed: ``binarize_images`` over the
page's lines, then ``process_images`` over the masks (the binarizer's, or
the traffic's ground-truth masks where the configuration says so), the
calls that ``cli.run_batched`` and ``serve.BatchWorker`` make, with no
files written. Calls run back to back for ``--seconds``; every call that
starts within them is counted, and ``img_per_s`` is the lines of those
calls over the time from the first call's start to the last one's end.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from harness import check, lines, trace, weights
from harness.cell import ROOT, metric_reader


class Probe:
    """Sees what the program's layers hand on during a call, by wrapping
    methods of the program's own objects (and the beam selection of its
    beam kernel's module): the glyph crops and their order, the decoder's
    input, each image's tokens and, under beam search, every beam's length
    (and, for the calls the check draws, every beam with its score). Tensors
    are held only for the calls the check draws."""

    def __init__(self, estimator):
        from stroke_derenderer_tpu_torch.kernels import fused_beam

        self.keep = False
        self.reset()
        est, dec = estimator, estimator.decoder
        gather, tokens, project = est._gather_batch, est.process_tokens, dec.project_encoding
        select = fused_beam.select_beam

        def gather_w(imgs_bin):
            crops, inv, plans, counts = out = gather(imgs_bin)
            self.counts.extend(counts)
            if self.keep:
                self.crops, self.inv = crops, inv
            return out

        def tokens_w(toks, partitions):
            self.tokens.append(toks)
            return tokens(toks, partitions)

        def project_w(enc_seq):
            if self.keep:
                self.seq = enc_seq
            return project(enc_seq)

        def select_w(preds, score, lens, length_penalty=0.0):
            self.beam_lens.append(lens)
            if self.keep and self.beams is None:
                self.beams = (preds, score, lens)
            return select(preds, score, lens, length_penalty)

        est._gather_batch, est.process_tokens = gather_w, tokens_w
        dec.project_encoding = project_w
        fused_beam.select_beam = select_w
        self._undo = lambda: setattr(fused_beam, "select_beam", select)

    def reset(self):
        self.counts, self.tokens, self.beam_lens = [], [], []
        self.crops = self.inv = self.seq = self.beams = None

    def close(self):
        self._undo()


def _steps(tokens: np.ndarray, max_length: int) -> np.ndarray:
    """Steps each greedy row ran: through its first EOS, else all."""
    eos = tokens == 2
    return np.where(eos.any(1), eos.argmax(1) + 1, max_length)


def _call_counts(page, probe: Probe, cfg: dict, traffic: dict) -> dict:
    """What one call asked of each layer, counted from its inputs and its
    outputs: lines, tiles, glyph rows and the decode steps they ran."""
    from reference.geometry import tile_plan
    b, s = cfg["binarizer"], cfg["strokes"]
    tiles = sum(len(tile_plan(int(ln.image.shape[1] * (b["height"] / ln.image.shape[0])),
                              b["width"], b["overlap"])[0]) for ln in page)
    rows = sum(probe.counts)
    if traffic["decode"] == "beam":
        steps = [] if not probe.beam_lens else probe.beam_lens[0].max(1).values.cpu().numpy()
    else:
        steps = (np.concatenate([_steps(np.asarray(t), s["max_length"]) for t in probe.tokens])
                 if probe.tokens else np.zeros(0))
    return {"lines": len(page), "tiles": tiles, "rows": rows,
            "steps": [int(x) for x in steps]}


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        control: str | None = None) -> dict:
    from stroke_derenderer_tpu_torch import cli

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    phases = {"start": time.perf_counter() - t_start}
    # Weights: the configuration's committed directory, or drawn on the card
    # from its fixed seed into a model directory the program then loads.
    tmp = None
    if cfg["weights"] == "random":
        tmp = tempfile.TemporaryDirectory(prefix="bench_models_")
        model_dir = Path(tmp.name)
        trees = weights.random_model_dir(cfg, model_dir, dev)
    else:
        model_dir = ROOT / cfg["weights"]
        trees = weights.read_model_dir(model_dir, cfg)
    # The int8 control is the program's own path; the fp8 one is the
    # reference's (``check``), judged in the program's place.
    quant = {"quant": control} if control == "int8" else {}
    decode = {k: tr[k] for k in ("decode", "beam_size", "length_penalty") if k in tr}
    binarizer, estimator = cli.initialize_sessions(
        model_dir, device=dev, se_overrides=decode | quant, bin_overrides=quant)
    if tmp is not None:
        tmp.cleanup()
    phases["sessions"] = time.perf_counter() - t_start
    for part in ("binarizer", "strokes"):
        held = getattr(binarizer if part == "binarizer" else estimator, "config")
        for k, v in cfg[part].items():
            got = getattr(held, k)
            if (list(got) if isinstance(got, tuple) else got) != v:
                raise RuntimeError(f"{part}.{k}: the program runs {got!r}, the "
                                   f"configuration states {v!r}")

    pool = lines.pool(lines.load_crops(ROOT), tr, cfg["binarizer"]["height"])
    phases["lines"] = time.perf_counter() - t_start
    rng = np.random.default_rng([seed, 2])
    per = tr["lines_per_call"]
    pages = len(pool) // per

    def page(i: int, stream: int = 3):
        """The i-th page: each pass over the pool in an order of its own."""
        order = np.random.default_rng([seed, stream, i // pages]).permutation(len(pool))
        return [pool[k] for k in order[i % pages * per:(i % pages + 1) * per]]

    use_gt = cfg["strokes_masks"] == "ground_truth"
    thr = 255 * cfg["binarizer"]["bin_thr"]
    probe = Probe(estimator)

    def call(ln, span=contextlib.nullcontext):
        with span("bench.call"):
            with span("bench.binarize"):
                bins = binarizer.binarize_images([x.image for x in ln])
            masks = [x.mask for x in ln] if use_gt else [m[:, :, 0] > thr for m in bins]
            with span("bench.strokes"):
                strokes = estimator.process_images(masks)
        return ln, bins, masks, strokes

    # Warm-up on pages in an order of their own: every kernel loaded and
    # built, the caches filled.
    for w in range(tr["warmup_calls"]):
        call(page(w, stream=4))
        probe.reset()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    check_at = set(rng.choice(tr["min_calls"], tr["check_calls"], replace=False).tolist())
    trace_at = range(tr["trace_from"], tr["trace_from"] + tr["trace_calls"]) if traced else range(0)
    kept, traced_calls, prof = [], [], None
    attempted = failed = 0
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while time.perf_counter() - t0 < seconds or i < max(tr["min_calls"], trace_at.stop):
        probe.keep = i in check_at
        if traced and i == trace_at.start:
            prof = _profiler(dev)
            prof.__enter__()
        span = torch.profiler.record_function if i in trace_at else contextlib.nullcontext
        ln, bins, masks, strokes = call(page(i), span)
        t_end = time.perf_counter()
        attempted += len(ln)
        failed += len(ln) - len(strokes)
        if i in trace_at:
            traced_calls.append(_call_counts(ln, probe, cfg, tr))
        if traced and i == trace_at.stop - 1:
            prof.__exit__(None, None, None)
        if probe.keep:
            kept.append({"images": [x.image for x in ln], "bins": bins, "masks": masks,
                         "strokes": strokes, "crops": probe.crops, "inv": probe.inv,
                         "counts": list(probe.counts), "seq": probe.seq,
                         "tokens": list(probe.tokens), "beams": probe.beams})
        probe.reset()
        i += 1
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    probe.close()
    del binarizer, estimator, call, probe
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result = {"attempted": attempted, "failed": failed, "calls": i,
              "window_s": window_s, "setup_s": setup_s, "memory_peak_bytes": peak,
              "e2e": {"img_per_s": (attempted - failed) / window_s, "setup_s": setup_s}}
    if prof is not None:
        with tempfile.TemporaryDirectory(prefix="bench_trace_") as d:
            path = Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            run_t = trace.load(path, traced_calls, cfg, tr)
        layer = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(run_t)
            if v is not None:
                layer[m["name"]] = {"value": v, "unit": m["unit"]}
        result |= {"per_layer": layer, "busy_s": run_t.busy_s, "traced_window_s": run_t.window_s,
                   "breakdown": trace.breakdown(run_t)}
    t_check = time.perf_counter()
    result["numbers"] = check.numbers(kept, trees, cfg, tr, dev, control)
    phases["check"] = time.perf_counter() - t_check
    result["phases_s"] = phases
    return result


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    return profile(activities=acts)
