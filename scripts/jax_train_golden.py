#!/usr/bin/env python3
"""The JAX package's train steps on the CPU, the reference the PyTorch
port's trainer is held to on the card (``chip_smoke.py`` phase ``train``),
and the port's own steps on the same CPU.

    python scripts/jax_train_golden.py [--out FILE]

Makes 3 binarizer batches and 3 captioner batches of 4 with the port's
generators at seed 0 (``chip_smoke.train_golden_batches``: lines of
``letters`` at ruled 0.5 and narrow 0.5; ``hand`` glyphs at a teacher
horizon of 96 tokens), then takes 3 update steps of each model from
``models_demo`` with the JAX package's own steps (``train/steps.py``) and
``optax.adamw`` on the JAX loop's warmup-cosine schedule, in float32 and in
bfloat16, the captioner with coordinate smoothing 1.0 and no scheduled
sampling. It records every step's loss, the batches' sums (so a drift of
the generators shows), and the port's losses on the same batches on this
CPU (``port_cpu``, from ``chip_smoke.golden_train_losses``) with their
relative differences. About 2 minutes on 8 cores.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODELS = ROOT / "models_demo"
CONFIG = {"seed": 0, "batch": 4, "steps": 3, "seq_len": 96, "lr": 3e-4,
          "line_style": "letters", "ruled": 0.5, "narrow": 0.5,
          "glyph_style": "hand", "coord_sigma": 1.0}


def jax_losses(dtype: str, batches: dict) -> dict:
    """The JAX package's per-step losses on ``batches``."""
    import dataclasses

    import jax
    import optax

    from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
    from stroke_derenderer_tpu.train.steps import (
        make_binarizer_train_step, make_captioner_train_step,
    )
    from stroke_derenderer_tpu.weights.store import (
        init_binarizer_variables, init_strokes_variables, load_variables,
    )
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, CONFIG["lr"], min(100, CONFIG["steps"] // 10 + 1),
        CONFIG["steps"]))
    out = {}
    cfg = dataclasses.replace(BinarizerConfig.from_json(
        MODELS / "configs_binarizer.json"), compute_dtype=dtype)
    model, variables = init_binarizer_variables(cfg, 0)
    params = load_variables(variables, MODELS / "binarizer.msgpack")["params"]
    step = jax.jit(make_binarizer_train_step(model, tx))
    opt = tx.init(params)
    out["binarizer"] = []
    for x, y in batches["binarizer"]:
        params, opt, loss = step(params, opt, x, y)
        out["binarizer"].append(float(loss))
    cfg = dataclasses.replace(StrokesConfig.from_json(
        MODELS / "configs_strokes.json"), compute_dtype=dtype)
    enc, dec, ev, dv, _ = init_strokes_variables(cfg, 0)
    params = {
        "encoder": load_variables(
            ev, MODELS / "strokes_encoder.msgpack")["params"],
        "decoder": load_variables(
            dv, MODELS / "strokes_decoder.msgpack")["params"]}
    step = jax.jit(make_captioner_train_step(
        enc, dec, tx, enc_image_size=cfg.encode_image_size,
        coord_sigma=CONFIG["coord_sigma"]))
    opt = tx.init(params)
    out["captioner"] = []
    for crops, tin, tout in batches["captioner"]:
        params, opt, loss = step(params, opt, crops, tin, tout)
        out["captioner"].append(float(loss))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "golden"
                                         / "jax_train_steps.json"))
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import jax
    import torch

    record = {"config": CONFIG}
    batches = chip_smoke.train_golden_batches(record)
    record["batch_sums"] = chip_smoke.batch_sums(batches)
    record["losses"], record["port_cpu"] = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.monotonic()
        record["losses"][dtype] = jax_losses(dtype, batches)
        jax_s = time.monotonic() - t0
        t0 = time.monotonic()
        port = chip_smoke.golden_train_losses(MODELS, dtype, "cpu", batches,
                                              record)
        record["port_cpu"][dtype] = {
            "losses": port, "seconds": time.monotonic() - t0,
            "jax_seconds": jax_s,
            "rel_diff": {k: [abs(a - b) / abs(b) for a, b in zip(
                port[k], record["losses"][dtype][k])] for k in port}}
        print(json.dumps({dtype: record["port_cpu"][dtype]}), flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    record["made_with"] = {
        "command": "python scripts/jax_train_golden.py", "commit": commit,
        "jax": jax.__version__, "torch": torch.__version__,
        "machine": platform.machine(), "cpus": os.cpu_count()}
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
