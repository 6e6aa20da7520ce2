"""The import guard, the reference's independence and the result line."""

import json
import subprocess
import sys

import run as bench_run
from harness import cell as cells
from harness.cell import BENCH, ROOT


def test_forbidden_names_match_whole_top_level_names():
    found = cells.forbidden_modules([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "stroke_derenderer_tpu", "stroke_derenderer_tpu.ops.strokes",
        "stroke_derenderer_tpu_torch", "stroke_derenderer_tpu_torch.cli",
        "jaxtyping", "flaxen", "numpy"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                     "stroke_derenderer_tpu", "stroke_derenderer_tpu.ops.strokes"]


def test_reference_loads_nothing_of_the_program_or_jax():
    """The reference and every encoder family of ``encoders/``, each family
    file run as ``encoders.family`` runs it."""
    code = ("import json, sys; sys.path[:0] = [sys.argv[1]]; "
            "import reference.geometry, reference.models, reference.msgpack, counts, encoders; "
            "fams = [encoders.load(p).__name__ for p in sorted(encoders.DIR.glob('*.py')) "
            "if p.name != '__init__.py']; "
            "print(json.dumps([fams, [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'stroke_derenderer_tpu', 'stroke_derenderer_tpu_torch')]]))")
    p = subprocess.run([sys.executable, "-c", code, str(BENCH)], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    families, loaded = json.loads(p.stdout.strip().splitlines()[-1])
    assert "bench_encoder_resnet" in families and loaded == []
    for path in [*(BENCH / "reference").glob("*.py"), *(BENCH / "encoders").glob("*.py")]:
        text = path.read_text()
        assert "stroke_derenderer_tpu" not in text, path
        assert "import jax" not in text and "from jax" not in text, path


def test_result_line_schema():
    cell = cells.load("demo.batch_greedy")
    res = {"attempted": 64, "failed": 0, "e2e": {"img_per_s": 41.5, "setup_s": 12.25},
           "per_layer": {"mfu": {"value": 0.3, "unit": "%"}}, "busy_s": 1.5,
           "traced_window_s": 4.5,
           "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["host in strokes", 0.2]]}}
    cmp, ok = bench_run.compared({"a": 1.0, "b": 0}, {"a": {"limit": 2.0}, "b": {"limit": 0}})
    assert ok and cmp == {"a": [1.0, 2.0], "b": [0, 0]}
    assert not bench_run.compared({"a": 3.0}, {"a": {"limit": 2.0}})[1]
    assert not bench_run.compared({"c": 0.0}, {})[1]
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123}
    line = bench_run.result_line(cell, res, False, device, ok, cmp)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["metrics"] == {"img_per_s": {"value": 41.5, "unit": "img/s"},
                               "setup_s": {"value": 12.25, "unit": "s"}}
    traced = bench_run.result_line(cell, res, True, device, ok, cmp)
    assert list(traced)[-1] == "compared" and "breakdown" in traced
    assert traced["device"]["busy_s"] == 1.5 and traced["device"]["window_s"] == 4.5
    json.dumps(traced)


def test_benchmark_json_names_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()
    names = {m["name"] for m in spec["per_layer"]}
    for n in names:
        assert (BENCH / "metrics" / f"{n}.py").exists(), n
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
