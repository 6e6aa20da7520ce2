#!/usr/bin/env python3
"""The JAX package's quality on the CPU, the reference the PyTorch port's
evaluator is held to on the card (``chip_smoke.py`` phase ``eval``), and
the port's own on the same CPU.

    python scripts/jax_cpu_eval.py [--quant int8 | --batched] [--keep-jax]
        [--out FILE]

Runs the JAX evaluator (``python -m stroke_derenderer_tpu.eval.run``) with
``JAX_PLATFORMS=cpu`` on ``models_demo`` (bfloat16, its shipped config)
three times, the three runs in parallel processes:

- ``real_greedy``: the 44 real-ink pairs of ``examples/real_data``, greedy;
- ``real_redecode``: the same pairs with ``--redecode 0.9`` (the policy of
  ``--preset real``);
- ``mixed_greedy``: ``--style mixed --n 50 --seed 0``, greedy.

Then it runs the port's evaluator (``python -m
stroke_derenderer_tpu_torch.eval.run ... --device cpu``) on the same three
runs, one after another (torch processes side by side oversubscribe the
cores): the port on the same CPU, in bfloat16, before any card is asked.
It writes every result dict, with the exact commands, the commit, the JAX
version and each run's wall seconds, to ``--out`` (the port's under
``port_cpu``). ``--keep-jax`` keeps the JAX runs already in ``--out`` and
runs only the port's; the JAX record is written before the port's runs
start. About 4 minutes for the JAX runs and 20 for the port's on 8 cores.
The XLA compile cache goes to the git-ignored ``.jax_eval_cache/``.

``--quant int8`` runs ``real_greedy`` and ``mixed_greedy`` with both
evaluators' own ``--quant int8`` (dynamic int8 conv stacks) and writes
``tests/golden/jax_cpu_eval_int8.json``; the JAX package's int8
convolutions are several times slower than its bfloat16 ones on the CPU.
Under int8 it also runs each of them through
``scripts/jax_eval_blocked_stats.py`` (the same JAX evaluator with flax's
normalization statistics summed in another float32 order) into
``variants``: int8 turns such a rounding into whole int8 steps, so these
runs are as valid a reference as the first ones. The four JAX processes
run side by side (~14 min).

``--batched`` runs the same three sets through the cross-image batched
path instead (``scripts/eval_batched.py``: one ``binarize_images`` and one
``process_images`` call per set, scored with the evaluator's metrics), the
JAX package alone, into ``tests/golden/jax_cpu_eval_batched.json`` (~4
min).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = {
    "real_greedy": ["--data", "examples/real_data"],
    "real_redecode": ["--data", "examples/real_data", "--redecode", "0.9"],
    "mixed_greedy": ["--style", "mixed", "--n", "50", "--seed", "0"],
}


def runs(quant: str) -> dict:
    """The runs of one ``--quant`` mode: every run in bfloat16, the greedy
    ones with the int8 conv stacks."""
    if quant == "none":
        return RUNS
    return {k: RUNS[k] + ["--quant", quant]
            for k in ("real_greedy", "mixed_greedy")}


# Under int8: JAX runs with the normalization statistics summed in another
# float32 order (name -> the script that runs the JAX evaluator so).
VARIANTS = {"groupnorm_blocked_sum": "scripts/jax_eval_blocked_stats.py"}


def command(package: str, args: list[str], batched: bool = False
            ) -> list[str]:
    if batched:
        cmd = [sys.executable, "scripts/eval_batched.py", "--package",
               package, "--models", "models_demo"] + args
    else:
        cmd = [sys.executable, "-m", f"{package}.eval.run", "--models",
               "models_demo"] + args
    return cmd + (["--device", "cpu"] if package.endswith("_torch") else [])


def variant_command(script: str, args: list[str]) -> list[str]:
    return [sys.executable, script, "--models", "models_demo"] + args


def run_one(cmd: list[str], env: dict) -> dict:
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} failed:\n{proc.stdout}\n"
                         f"{proc.stderr}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"result": result, "seconds": time.monotonic() - t0}


def shown(cmd: list[str], env_prefix: str = "") -> str:
    return env_prefix + " ".join(["python"] + cmd[1:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quant", choices=["none", "int8"], default="none",
                    help="int8: the greedy runs with the int8 conv stacks, "
                         "into tests/golden/jax_cpu_eval_int8.json")
    ap.add_argument("--batched", action="store_true",
                    help="the sets through binarize_images and "
                         "process_images, into "
                         "tests/golden/jax_cpu_eval_batched.json")
    ap.add_argument("--out", default=None,
                    help="default tests/golden/jax_cpu_eval.json, or "
                         "jax_cpu_eval_int8.json with --quant int8, or "
                         "jax_cpu_eval_batched.json with --batched")
    ap.add_argument("--keep-jax", action="store_true",
                    help="keep the JAX runs of --out, run only the port's")
    args = ap.parse_args(argv)
    if args.batched and (args.quant != "none" or args.keep_jax):
        ap.error("--batched runs the JAX package alone, without --quant")
    out = Path(args.out or ROOT / "tests" / "golden" / (
        "jax_cpu_eval_batched.json" if args.batched
        else "jax_cpu_eval.json" if args.quant == "none"
        else f"jax_cpu_eval_{args.quant}.json"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SD_TPU_COMPILE_CACHE=str(ROOT / ".jax_eval_cache"))
    todo = runs(args.quant)
    if args.keep_jax:
        record = json.loads(out.read_text())
    else:
        record = jax_runs(env, todo, args.quant, args.batched)
        out.write_text(json.dumps(record, indent=1) + "\n")
    if args.batched:
        print(json.dumps(record))
        return 0
    import torch
    record["port_cpu"] = {"torch_version": torch.__version__, "runs": {}}
    for k, a in todo.items():
        cmd = command("stroke_derenderer_tpu_torch", a)
        got = run_one(cmd, env)
        record["port_cpu"]["runs"][k] = {
            "command": shown(cmd), "seconds": got["seconds"],
            "result": got["result"]}
    out.write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    return 0


def jax_runs(env: dict, todo: dict, quant: str, batched: bool = False
             ) -> dict:
    """The JAX runs of ``todo`` in parallel processes -> the file's
    record."""
    jax_cmds = {(None, k): command("stroke_derenderer_tpu", a, batched)
                for k, a in todo.items()}
    if quant != "none":
        jax_cmds |= {(v, k): variant_command(script, a)
                     for v, script in VARIANTS.items()
                     for k, a in todo.items()}
    with ThreadPoolExecutor(len(jax_cmds)) as pool:
        done = dict(zip(jax_cmds, pool.map(lambda c: run_one(c, env),
                                           jax_cmds.values())))

    def record(variant) -> dict:
        return {k: {"command": shown(jax_cmds[variant, k],
                                     "JAX_PLATFORMS=cpu "),
                    "seconds": done[variant, k]["seconds"],
                    "result": done[variant, k]["result"]} for k in todo}

    import jax
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    dirty = bool(subprocess.run(
        ["git", "status", "--porcelain", "--", "stroke_derenderer_tpu",
         "models_demo", "examples/real_data"], cwd=ROOT, capture_output=True,
        text=True).stdout.strip())
    return {
        "what": ("JAX package, scripts/eval_batched.py (binarize_images "
                 "and process_images once per set)" if batched
                 else "JAX package evaluator")
                + ", JAX_PLATFORMS=cpu, models_demo (bfloat16"
                + (", int8 conv stacks)" if quant != "none" else ")"),
        "commit": commit, "jax_package_modified": dirty,
        "jax_version": jax.__version__,
        "python": sys.version.split()[0],
        "runs": record(None),
    } | ({"variants": {v: {"script": script, "runs": record(v)}
                       for v, script in VARIANTS.items()}}
         if quant != "none" else {})


if __name__ == "__main__":
    raise SystemExit(main())
