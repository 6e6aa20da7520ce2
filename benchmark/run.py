"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. The cell is a
``workloads`` entry of ``BENCHMARK.json``; the files that define it are
found by name (``harness/cell.py``). Set-up (weights, the traffic's lines,
a warm-up) is timed as ``setup_s``, then calls run for ``--seconds``, then
the outputs of the drawn calls are checked against the plain reference
(``reference/``). With ``--trace 0`` the last line of standard output is
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a ``torch.profiler`` trace of a stretch of the calls, with a
``breakdown``. The numbers the check compared are printed last on
standard error and last in the result line, each beside its limit.

``--control int8`` runs the program's int8 path in its place, and
``--control fp8`` judges the reference computed in float8 in the
program's place: the controls the limits were set against, not runs the
benchmark makes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8", "fp8"), default=None)
    return p.parse_args(argv)


def compared(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """{name: [number, limit]} for every number the cell's limits name,
    and whether each is within its limit (a number the check did not
    produce is not). An empty ``limits`` passes nothing."""
    out = {k: [numbers.get(k), lim["limit"]] for k, lim in limits.items()}
    ok = bool(out) and all(v is not None and v <= lim for v, lim in out.values())
    return out, ok


def result_line(cell, res: dict, traced: bool, device: dict, ok: bool, cmp: dict) -> dict:
    if traced:
        metrics = res["per_layer"]
        device = device | {"busy_s": res["busy_s"], "window_s": res["traced_window_s"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if traced:
        line["breakdown"] = res["breakdown"]
    line["compared"] = cmp
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / ".cache" / "triton"))
    os.environ["USE_FLAX"] = "0"
    import importlib

    import torch

    from harness import cell as cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 3
    runner = importlib.import_module(f"harness.{cell.traffic['kind']}")
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                     control=args.control)
    bad = cells.forbidden_modules(sys.modules)
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    cmp, ok = compared(res["numbers"], cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = result_line(cell, res, bool(args.trace), device, ok, cmp)
    print(json.dumps({"calls": res["calls"], "window_s": res["window_s"],
                      "setup_s": res["setup_s"], "phases_s": res["phases_s"]}),
          file=sys.stderr)
    for k, v in res["numbers"].items():
        if k not in cmp:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, (v, lim) in cmp.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
