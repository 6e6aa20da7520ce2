"""A cell of ``BENCHMARK.json`` with the files that define it, found by
name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (its ``kind``
names the runner, ``harness/<kind>.py``), ``limits/<cell>.json`` (the
limits of the correctness check) and ``metrics/<metric>.py`` for each
per-layer metric of the cell."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stroke_derenderer_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str) -> Cell:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    limits_file = BENCH / "limits" / f"{name}.json"
    return Cell(
        name=name, config_name=entry["config"],
        config=json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads(limits_file.read_text()) if limits_file.exists() else {},
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_file(path: Path, prefix: str):
    """The module of the file ``path``, run under the name ``prefix`` and
    its stem (dots made underscores)."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return load_file(BENCH / "metrics" / f"{name}.py", "bench_metric_").read


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of :data:`FORBIDDEN` as a whole word (the program's package name
    begins with the JAX package's, and is not one of them)."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
