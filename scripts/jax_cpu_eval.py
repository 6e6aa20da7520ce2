#!/usr/bin/env python3
"""The JAX package's quality on the CPU, the reference the PyTorch port's
evaluator is held to on the card (``chip_smoke.py`` phase ``eval``), and
the port's own on the same CPU.

    python scripts/jax_cpu_eval.py [--keep-jax] [--out FILE]

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
runs only the port's. About 4 minutes for the JAX runs and 20 for the
port's on 8 cores. The XLA compile cache goes to the git-ignored
``.jax_eval_cache/``.
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


def command(package: str, args: list[str]) -> list[str]:
    cmd = [sys.executable, "-m", f"{package}.eval.run", "--models",
           "models_demo"] + args
    return cmd + (["--device", "cpu"] if package.endswith("_torch") else [])


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
    ap.add_argument("--out", default=str(ROOT / "tests" / "golden"
                                         / "jax_cpu_eval.json"))
    ap.add_argument("--keep-jax", action="store_true",
                    help="keep the JAX runs of --out, run only the port's")
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SD_TPU_COMPILE_CACHE=str(ROOT / ".jax_eval_cache"))
    if args.keep_jax:
        record = json.loads(Path(args.out).read_text())
    else:
        record = jax_runs(env)
    import torch
    record["port_cpu"] = {"torch_version": torch.__version__, "runs": {}}
    for k, a in RUNS.items():
        cmd = command("stroke_derenderer_tpu_torch", a)
        got = run_one(cmd, env)
        record["port_cpu"]["runs"][k] = {
            "command": shown(cmd), "seconds": got["seconds"],
            "result": got["result"]}
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    return 0


def jax_runs(env: dict) -> dict:
    """The three JAX runs in parallel processes -> the file's record."""
    jax_cmds = {k: command("stroke_derenderer_tpu", a)
                for k, a in RUNS.items()}
    with ThreadPoolExecutor(len(RUNS)) as pool:
        done = dict(zip(jax_cmds, pool.map(lambda c: run_one(c, env),
                                           jax_cmds.values())))
    import jax
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    dirty = bool(subprocess.run(
        ["git", "status", "--porcelain", "--", "stroke_derenderer_tpu",
         "models_demo", "examples/real_data"], cwd=ROOT, capture_output=True,
        text=True).stdout.strip())
    return {
        "what": "JAX package evaluator, JAX_PLATFORMS=cpu, models_demo "
                "(bfloat16)",
        "commit": commit, "jax_package_modified": dirty,
        "jax_version": jax.__version__,
        "python": sys.version.split()[0],
        "runs": {k: {"command": shown(jax_cmds[k], "JAX_PLATFORMS=cpu "),
                     "seconds": done[k]["seconds"],
                     "result": done[k]["result"]} for k in RUNS},
    }


if __name__ == "__main__":
    raise SystemExit(main())
