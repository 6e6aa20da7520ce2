"""The port's CLI end to end on the CPU against the committed goldens, its
device policy, and the import guard: the port and ``chip_smoke.py`` import
and run with JAX, flax, optax, PIL, msgpack, ml_dtypes, onnx and the JAX
package made unimportable."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stroke_derenderer_tpu.eval.metrics import strokes_chamfer
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch.io import read_png, write_png

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
MODELS = REPO / "models_demo"
MASK_AGREE = 0.999
# The goldens come from the JAX package's bfloat16 decode. The port rounds
# at the same points but sums in another order (float64, then one
# rounding), and a greedy bfloat16 decode that differs by one ulp somewhere
# can take another token and go on from there; the port's strokes on the
# golden image lie about 3 px (chamfer) from the golden ones. The bound
# leaves room for that and still fails on a wrong pipeline (misplaced or
# missing glyphs lie tens of pixels off).
STROKES_CHAMFER_PX = 6.0


def test_cli_on_golden_cpu(tmp_path, capsys):
    rc = cli.entrypoint(["-models", str(MODELS), "-input", str(GOLDEN),
                         "--output", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "golden_input took" in out and "[error]" not in out
    got = read_png(tmp_path / "golden_input_BINARIZED.png")
    want = read_png(GOLDEN / "expected_BINARIZED.png")
    assert got.shape == want.shape
    assert (got == want).mean() >= MASK_AGREE
    strokes = json.loads((tmp_path / "golden_input_STROKES.json").read_text())
    expected = json.loads((GOLDEN / "expected_STROKES.json").read_text())
    assert strokes and len(strokes) >= len(expected) // 2
    assert strokes_chamfer(strokes, expected) <= STROKES_CHAMFER_PX


def test_run_counts_only_good_images(tmp_path, capsys):
    binarizer, estimator = cli.initialize_sessions(MODELS, device="cpu")
    good = (np.full((40, 90, 3), 255, np.uint8), "blank")
    bad = (np.zeros((0, 5, 3), np.uint8), "empty")
    assert cli.run([good, bad], binarizer, estimator, tmp_path) == 1
    assert "[error] empty" in capsys.readouterr().out
    assert json.loads((tmp_path / "blank_STROKES.json").read_text()) == []


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.initialize_sessions(MODELS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.entrypoint(["-models", str(MODELS), "-input", str(GOLDEN),
                        "--output", "unused"])


_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "PIL", "msgpack", "ml_dtypes",
           "stroke_derenderer_tpu"}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Blocker())
# onnx is blocked as absent: importing it raises, and torch, which probes
# for it with importlib.util.find_spec, is told that it is not installed.
sys.modules["onnx"] = None
BLOCKED.add("onnx")
repo, models, inp, out = sys.argv[1:5]
sys.path.insert(0, repo)
import stroke_derenderer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("kernels.fused_beam", "kernels.decode_attention", "serve",
             "ops.quant", "parallel", "parallel.two_stage", "parallel.mesh",
             "parallel.multihost",
             "eval.run", "eval.metrics", "data.real", "data.synthetic",
             "data.letters", "data.cache", "data.loader", "train.loop",
             "train.steps", "train.losses", "train.checkpoint",
             "utils.profiling", "utils.flops", "utils.logging",
             "native.cc_native", "native.resize_native"):
    assert pkg.__name__ + "." + name in names, name
import chip_smoke
import torch
from stroke_derenderer_tpu_torch.cli import entrypoint, initialize_sessions
from stroke_derenderer_tpu_torch.models.decoder import greedy_decode
assert entrypoint(["-models", models, "-input", inp, "--output", out,
                   "--device", "cpu"]) == 0
assert entrypoint(["-models", models, "-input", inp, "--output", out,
                   "--device", "cpu", "--decode", "beam",
                   "--beam-size", "3"]) == 0
assert entrypoint(["-models", models, "-input", inp, "--output", out + "_b",
                   "--device", "cpu", "--batch", "--svg"]) == 0
assert entrypoint(["-models", models, "-input", inp, "--output", out + "_r",
                   "--device", "cpu", "--preset", "real", "--refine", "3"]) == 0
assert entrypoint(["-models", models, "-input", inp, "--output", out + "_q",
                   "--device", "cpu", "--quant", "int8", "--two-stage",
                   "2"]) == 0
from stroke_derenderer_tpu_torch.eval.run import main as eval_main
assert eval_main(["--models", models, "--n", "1", "--style", "letters",
                  "--redecode", "0.9", "--device", "cpu"]) == 0
from stroke_derenderer_tpu_torch.train.loop import main as train_main
assert train_main(["--device", "cpu", "--model", "both", "--steps", "2",
                   "--batch", "1", "--bin-features", "8", "--encoder-arch",
                   "tiny", "--se-dims", "16,16,16", "--seq-len", "12",
                   "--out", out + "_t"], num_workers=1) == 0
assert entrypoint(["-models", models, "-input", inp, "--output",
                   out + "_mesh", "--device", "cpu", "--mesh", "2"]) == 0
assert entrypoint(["--init-models", out + "_m"]) == 0
assert entrypoint(["-models", models, "--export-onnx", out + "_x"]) == 0
assert entrypoint(["-models", out + "_x", "-input", inp, "--output",
                   out + "_o", "--device", "cpu"]) == 0
dec = initialize_sessions(models, device="cpu")[1].decoder
assert greedy_decode(dec, torch.zeros(2, 196, dec.enc_att_w.shape[0]), 4,
                     fused=True).shape == (2, 4)
leaked = sorted(m for m, mod in sys.modules.items()
                if m.split(".")[0] in BLOCKED and mod is not None)
assert not leaked, leaked
print("GUARD OK", len(names))
"""


def test_import_guard(tmp_path):
    """Every port module (the server's, the evaluator's, the trainer's,
    ``ops.quant`` and ``parallel`` too) and chip_smoke.py import, and the
    CLI (greedy, --decode beam, --batch, --preset real, --quant int8 with
    --two-stage 2, --mesh 2 on two CPU ranks, --init-models, --export-onnx
    and -models on the
    exported ONNX dir), the evaluator's main, the trainer's main (both
    models, 2 steps) and the fused-attention greedy entry run a tiny model
    on the CPU, with the JAX stack, PIL, msgpack and onnx unimportable."""
    from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
    from stroke_derenderer_tpu.weights.store import materialize_model_dir
    models, inp = tmp_path / "models", tmp_path / "in"
    materialize_model_dir(
        models, BinarizerConfig(features=(8, 16), bottleneck=16),
        StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                      decoder_dim=16, max_length=12))
    inp.mkdir()
    img = np.full((40, 150, 3), 255, np.uint8)
    img[12:28, 20:60] = 0
    img[15:20, 90:140] = 0
    write_png(inp / "tiny.png", img)
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, str(REPO), str(models), str(inp),
         str(tmp_path / "out")], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "GUARD OK" in proc.stdout
    assert (tmp_path / "out" / "tiny_BINARIZED.png").exists()
    assert (tmp_path / "out" / "tiny_STROKES.json").exists()
    assert (tmp_path / "out_b" / "tiny_STROKES.svg").exists()
    assert (tmp_path / "out_r" / "tiny_STROKES.json").exists()
    assert (tmp_path / "out_q" / "tiny_STROKES.json").exists()
    assert (tmp_path / "out_mesh" / "tiny_BINARIZED.png").read_bytes() == (
        tmp_path / "out" / "tiny_BINARIZED.png").read_bytes()
    assert (tmp_path / "out_mesh" / "tiny_STROKES.json").exists()
    assert "e2e (two-stage amortized)" in proc.stdout
    assert '"stroke_dtw"' in proc.stdout
    for f in ("binarizer.msgpack", "strokes_decoder.msgpack",
              "ckpt_captioner/step_00000002/opt_state.msgpack"):
        assert (tmp_path / "out_t" / f).exists(), f
    assert (tmp_path / "out_m" / "strokes_encoder.msgpack").exists()
    assert (tmp_path / "out_x" / "decoder_iter.onnx").exists()
    assert (tmp_path / "out_o" / "tiny_STROKES.json").exists()
    assert "[info] importing reference ONNX models" in proc.stdout


def _tiny_dir(tmp_path):
    from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
    from stroke_derenderer_tpu.weights.store import materialize_model_dir
    models, inp = tmp_path / "models", tmp_path / "in"
    materialize_model_dir(
        models, BinarizerConfig(features=(8, 16), bottleneck=16,
                                compute_dtype="float32"),
        StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                      decoder_dim=16, max_length=12,
                      compute_dtype="float32"))
    inp.mkdir()
    for k in range(3):
        img = np.full((40, 150 + 30 * k, 3), 255, np.uint8)
        img[12:28, 20 + 5 * k:60] = 0
        img[15:20, 90:140] = 0
        write_png(inp / f"line{k}.png", img)
    return models, inp


def _outputs(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_mesh_flags(tmp_path, capsys):
    """--mesh 2 on two CPU ranks writes the files of one device (float32),
    with --batch, --decode beam, --preset real and --host-partition; only
    rank 0 prints (tests/test_torch_multihost.py holds --mesh-tp's and
    two-stage's outputs). With --device cuda and fewer cards than ranks it
    warns and runs on one device, as the JAX CLI does."""
    models, inp = _tiny_dir(tmp_path)
    base = ["-models", str(models), "-input", str(inp), "--device", "cpu"]
    extra = ["--batch", "--decode", "beam", "--beam-size", "3", "--preset",
             "real", "--host-partition"]
    assert cli.entrypoint(base + extra + ["--output", str(tmp_path / "a")]
                          ) == 0
    capsys.readouterr()
    assert cli.entrypoint(base + extra + ["--mesh", "2", "--output",
                                          str(tmp_path / "a2")]) == 0
    assert _outputs(tmp_path / "a2") == _outputs(tmp_path / "a")
    assert "[error]" not in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.entrypoint(base[:-2] + ["--mesh", "2", "--output",
                                    str(tmp_path / "c")])
    assert ("[warn] --mesh 2 requested but only 0 device(s) present; "
            "running single-device") in capsys.readouterr().out


def test_quant_and_two_stage_flags(tmp_path, capsys):
    """--two-stage 2 writes the per-image run's files (float32, rows
    independent); --quant int8 runs the int8 conv stacks, with and without
    --two-stage; --two-stage --no-strokes falls back to the batched
    binarize."""
    from stroke_derenderer_tpu_torch.ops import quant
    models, inp = _tiny_dir(tmp_path)
    base = ["-models", str(models), "-input", str(inp), "--device", "cpu"]
    assert cli.entrypoint(base + ["--output", str(tmp_path / "seq")]) == 0
    assert cli.entrypoint(base + ["--output", str(tmp_path / "two"),
                                  "--two-stage", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("e2e (two-stage amortized)") == 3
    assert _outputs(tmp_path / "two") == _outputs(tmp_path / "seq")
    assert len(_outputs(tmp_path / "seq")) == 6
    calls = quant.call_count
    assert cli.entrypoint(base + ["--output", str(tmp_path / "q"),
                                  "--quant", "int8"]) == 0
    assert quant.call_count > calls
    assert cli.entrypoint(base + ["--output", str(tmp_path / "q2"),
                                  "--quant", "int8", "--two-stage"]) == 0
    assert set(_outputs(tmp_path / "q2")) == set(_outputs(tmp_path / "seq"))
    assert cli.entrypoint(base + ["--output", str(tmp_path / "nos"),
                                  "--two-stage", "--no-strokes"]) == 0
    assert sorted(_outputs(tmp_path / "nos")) == [
        f"line{k}_BINARIZED.png" for k in range(3)]
    assert "[error]" not in capsys.readouterr().out
    assert cli.parse_args(["--two-stage"]).two_stage == 8
    defaults = cli.parse_args([])
    assert defaults.two_stage == 0 and defaults.quant is None
