"""``chip_smoke.py`` rehearsed on the CPU: the card is faked (availability,
name, events, ``nvidia-smi``, the kernels' SASS), the device is the CPU, the
server listens on 127.0.0.1, and the wrappers of K1, K2 and K3 run their
plain versions (K3's with bfloat16 streams, as on the card) and count a
launch (K1 and K2 by path, as on the card); K3's bare launch runs the
split-position emulation. This checks the script's phases and its output
contract, not the kernels. ``rehearse`` runs a group of phases through
``chip_smoke.main``'s ``phases``: this file's test the kernels' group
(``KERNEL_PHASES``: phases k1 to fused-binarize, two_stage and mesh, with
the kernel table), ``test_torch_smoke_paths.py``'s the rest
(``PATH_PHASES``), so that two workers take them side by side. The eval
phase scores two real pairs and two synthetic samples, per image and
batched, with its bars against the JAX reference opened (the decode is cut
to a few steps here). The train phase holds the shipped models' steps to
the JAX reference with the card's bars, and runs its recipe, resume, cache
and from-scratch runs on a tiny model dir for a few steps at batch 2, with
one loader worker. The onnx phase exports and runs ``models_demo`` as on
the card, and its random upstream-shaped model is shrunk to tiny widths (a
one-level UNet, the tiny encoder, a 64 -> 12 projection). The int8 and
two_stage phases drive the CLI on the first 9 inputs (two chunks of 8),
check the int8 convs at three small shapes and hold the int8 eval to the
bf16 reference's greedy runs, bars open. The profile phase runs on the
first 3 inputs; its CPU traces hold no device track, so the card's busy
time is None there. The mesh phase runs its two ranks on the CPU
(processes of their own, where the K1 and K2 wrappers count their plain
runs) on the first 3 inputs, and its trainer at tiny widths."""

import json
import sys
import time
import types
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


class _Event:
    def __init__(self, **kwargs):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


# torch's threads per rehearsal: the test runner's workers run the two
# rehearsals side by side, and OpenMP threads of both spinning on every
# core made each several times slower than alone.
REHEARSAL_THREADS = 4


def _count_plain_launches():
    """In a rank of the rehearsal's mesh phase (a process of its own, on
    the CPU): the K1 and K2 wrappers count a launch where they run their
    plain versions, as the faked card's do in the parent."""
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    for mod, name in ((fd, "fused_greedy_decode_packed"),
                      (fb, "fused_beam_decode_packed")):
        def counted(*args, _mod=mod, _real=getattr(mod, name), **kw):
            _mod.launch_count += 1
            return _real(*args, **kw)
        setattr(mod, name, counted)


def rehearse(monkeypatch, capsys, tmp_path, phases):
    """``chip_smoke.main`` on the CPU with the card faked (module
    docstring), running ``phases`` (and the phases they need). Returns the
    printed lines, the record it wrote and the module."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from stroke_derenderer_tpu_torch import device
    from stroke_derenderer_tpu_torch.kernels import build
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.pipeline import binarize, strokes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "fake card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    real_resolve = device.resolve_device
    for mod in (device, binarize, strokes):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda dev=None: real_resolve("cpu"))

    def fake_load(name, force=False, timeout=600.0):
        build.BUILD_LOG[name] = {"seconds": 0.0, "ptxas": "(no nvcc)"}

    monkeypatch.setattr(build, "load_library", fake_load)
    # The kernels' SASS: HMMA in the bfloat16 instantiations only.
    monkeypatch.setattr(chip_smoke, "sass_mma_counts", lambda build, name: {
        f"k_{name}I13__nv_bfloat16EEvN2sd6ParamsIT_EE": 28,
        f"k_{name}IfEEvN2sd6ParamsIT_EE": 0})
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(fd, "launch_grid", lambda *a: (7, None))
    monkeypatch.setattr(fd, "barrier_probe", lambda n, grid, dev: None)

    def fake_clock(name, enc, ep, h, c, packed, k, max_length, outputs):
        # A run of 3 steps whose phases take 1, 2, ... microseconds.
        nph = 4 if name == "fused_decode" else 5
        t = torch.cumsum(torch.arange(1, 3 + 3 * nph + 1) * 1000, 0)
        outputs["stamps"][:len(t)] = t

    monkeypatch.setattr(fd, "launch_step_kernel", fake_clock)

    def counted_plain(*args, packed=None):
        fd.launch_count += 1
        fd.engine_launches[fd.ENGINES[args[0].dtype]] += 1
        return fd.fused_greedy_decode_plain(*args[:6])

    monkeypatch.setattr(fd, "fused_greedy_decode_packed", counted_plain)

    def counted_beam(*args, packed=None):
        fb.launch_count += 1
        fb.engine_launches[fd.ENGINES[args[0].dtype]] += 1
        return fb.fused_beam_decode_plain(*args[:7])

    monkeypatch.setattr(fb, "fused_beam_decode_packed", counted_beam)

    def counted_attention(*args, packed=None, cluster=None):
        da.launch_count += 1
        return da.fused_attention_gate_plain(*args,
                                             stream_dtype=torch.bfloat16)

    monkeypatch.setattr(da, "fused_attention_gate", counted_attention)
    monkeypatch.setattr(da, "kernel_config", lambda dev, c, p, e, a, d: {
        "clusters": 132 // c, "smem": 1000, "row_tile": 16, "stages": 2,
        "threads": 256, "kmax": 2})

    def split_into(enc, enc_proj, h, packed, out, alpha, cluster,
                   stamps=None):
        got = da.fused_attention_gate_split(enc, enc_proj, h, packed,
                                            cluster, 132 // cluster)
        out.copy_(got[0])
        alpha.copy_(got[1])
        if stamps is not None:  # phases of 1, 2, ... microseconds
            n = da.STAMPS.index("timer_entry")
            cycles = torch.cumsum(torch.arange(n) * 1000, 0)
            stamps[:n] = cycles
            stamps[n:] = torch.tensor([0, int(cycles[-1])])

    monkeypatch.setattr(da, "launch_attention", split_into)
    monkeypatch.setattr(da, "cluster_probe", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "kernel_ms",
                        lambda fn, reps=20: chip_smoke.cuda_ms(fn, reps))
    monkeypatch.setattr(
        chip_smoke.subprocess, "run",
        lambda cmd, **k: types.SimpleNamespace(stdout="fake card, 700.00 W\n"))
    monkeypatch.setattr(chip_smoke, "MAX_LENGTH", 6)
    # The estimators decode MAX_LENGTH steps, so here the strokes are cut
    # short and the script's bar on the golden strokes cannot hold
    # (tests/test_torch_cli.py holds the CPU's strokes to it).
    monkeypatch.setattr(chip_smoke, "STROKES_CHAMFER_PX", float("inf"))
    monkeypatch.setattr(chip_smoke, "K1_BATCHES", (1, 3))
    monkeypatch.setattr(chip_smoke, "K2_BATCH", 3)
    monkeypatch.setattr(chip_smoke, "K3_BATCHES", (1, 3))
    monkeypatch.setattr(chip_smoke, "ONNX_VARIANT_BIN", {
        "norm": "batch", "features": (8,), "bottleneck": 16})
    monkeypatch.setattr(chip_smoke, "ONNX_VARIANT_SE", {
        "encoder_arch": "tiny", "encoder_norm": "batch", "projection_dim": 12,
        "embed_dim": 16, "attention_dim": 16, "decoder_dim": 16})
    monkeypatch.setattr(chip_smoke, "ONNX_K1_BATCHES", (2, 3))
    monkeypatch.setattr(chip_smoke, "ONNX_K2_BATCH", 2)
    real = tmp_path / "real"
    real.mkdir()
    for stem in ("real00_line_hearts", "real01_line_grid"):
        for suffix in (".png", "_BINARIZED.png", "_STROKES.json"):
            src = chip_smoke.REAL_DATA / f"{stem}{suffix}"
            (real / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(chip_smoke, "REAL_DATA", real)
    monkeypatch.setattr(chip_smoke, "EVAL_MIXED_N", 2)
    reference = json.loads(chip_smoke.JAX_EVAL.read_text())
    for run in reference["runs"].values():
        run["result"]["stroke_dtw_ci95"] = float("inf")
    (tmp_path / "jax.json").write_text(json.dumps(reference))
    monkeypatch.setattr(chip_smoke, "JAX_EVAL", tmp_path / "jax.json")
    batched = json.loads(chip_smoke.JAX_EVAL_BATCHED.read_text())
    for run in batched["runs"].values():
        run["result"]["stroke_dtw_ci95"] = float("inf")
    (tmp_path / "jax_batched.json").write_text(json.dumps(batched))
    monkeypatch.setattr(chip_smoke, "JAX_EVAL_BATCHED",
                        tmp_path / "jax_batched.json")
    # The int8 eval's reference: the bf16 file's greedy runs, bars open.
    (tmp_path / "jax_int8.json").write_text(json.dumps({"runs": {
        k: reference["runs"][k] for k in ("real_greedy", "mixed_greedy")}}))
    monkeypatch.setattr(chip_smoke, "JAX_EVAL_INT8",
                        tmp_path / "jax_int8.json")
    monkeypatch.setattr(chip_smoke, "SLICE_INPUTS", 9)
    monkeypatch.setattr(chip_smoke, "PROFILE_INPUTS", 3)
    monkeypatch.setattr(chip_smoke, "INT8_CONVS", (
        ("unet 3x3", 2, 16, 16, 24, 16, 3, 1, 1, False),
        ("gate 1x1", 2, 16, 16, 24, 8, 1, 1, 0, True),
        ("stem 7x7 s2 p3", 2, 3, 32, 32, 64, 7, 2, 3, False)))
    monkeypatch.setattr(chip_smoke, "EVAL_F1_TOL", float("inf"))
    monkeypatch.setattr(chip_smoke, "EVAL_COVERAGE_TOL", float("inf"))
    from stroke_derenderer_tpu_torch import weights as tw
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    tiny = tmp_path / "tiny_models"
    tw.materialize_model_dir(
        tiny, BinarizerConfig(features=(8,), bottleneck=16),
        StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                      decoder_dim=16, max_length=12))
    for name, value in (("TRAIN_MODELS", tiny), ("TRAIN_STEPS", 8),
                        ("TRAIN_RESUME_STEPS", 10), ("TRAIN_BATCH", 2),
                        ("TRAIN_SEQ_LEN", 16), ("TRAIN_CACHE_N", 6),
                        ("TRAIN_WINDOW", 3), ("TRAIN_WORKERS", 1),
                        ("TRAIN_SCRATCH", ("--bin-features", "8",
                                           "--encoder-arch", "tiny",
                                           "--se-dims", "16,16,16",
                                           "--lr", "1e-2"))):
        monkeypatch.setattr(chip_smoke, name, value)

    for name, value in (
            ("MESH_DEVICES", ("cpu", "cpu")), ("MESH_INPUTS", 3),
            ("MESH_RANK_SETUP", ("test_torch_smoke", "_count_plain_launches")),
            ("MESH_TRAIN_BIN", {"features": (8,), "bottleneck": 16,
                                "compute_dtype": "float32"}),
            ("MESH_TRAIN_SE", {"encoder_arch": "tiny", "embed_dim": 16,
                               "attention_dim": 16, "decoder_dim": 16,
                               "compute_dtype": "float32"}),
            ("MESH_TRAIN_BATCH", 2), ("MESH_TRAIN_SEQ", 12)):
        monkeypatch.setattr(chip_smoke, name, value)

    threads = torch.get_num_threads()
    torch.set_num_threads(REHEARSAL_THREADS)
    try:
        assert chip_smoke.main(["--out", str(tmp_path / "smoke.json")],
                               phases=phases) == 0
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "fake card", "count": 1}}
    assert "fake card, 700.00 W" in lines
    record = json.loads((tmp_path / "smoke.json").read_text())
    assert set(record["build"]) == set(chip_smoke.LIBS)
    return lines, record, chip_smoke


# The rehearsal's phases in two groups of about equal time, one per test
# file so that the test runner's workers take them in parallel (this file
# and test_torch_smoke_paths.py); each runs the phases its own need too
# (the second runs main and main-beam again).
KERNEL_PHASES = ("k1", "main", "k2", "k3", "main-beam", "onnx", "batch",
                 "batch-beam", "fused-binarize", "two_stage", "mesh")
PATH_PHASES = ("serve", "real", "train", "eval", "int8", "profile")


def test_rehearsal_groups_cover_every_phase_once():
    import sys
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert sorted(KERNEL_PHASES + PATH_PHASES) == sorted(
        chip_smoke.PHASE_NAMES)
    assert chip_smoke.phase_closure(PATH_PHASES) == set(PATH_PHASES) | {
        "main", "main-beam"}
    assert chip_smoke.phase_closure(None) == set(chip_smoke.PHASE_NAMES)


def test_chip_smoke_rehearsal(monkeypatch, capsys, tmp_path):
    """The kernels' phases (KERNEL_PHASES), with the kernel table."""
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    lines, record, chip_smoke = rehearse(monkeypatch, capsys, tmp_path,
                                         KERNEL_PHASES)
    kernels = json.loads(lines[-2])["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [set(k) for k in kernels] == [keys] * 3
    assert [k["name"][:2] for k in kernels] == ["K1", "K2", "K3"]
    # K1: one launch per input image with glyphs on the per-image path, one
    # on the batched path; K2 likewise on the beam paths; K3: one per
    # decoded step of the fused-attention entry. Every K1 and K2 launch of
    # the bfloat16 paths took the tensor-core path.
    engines = json.loads(lines[-3])["launches_by_engine"]
    assert engines["K1"]["mma"] > 0 and engines["K2"]["mma"] > 0
    by_path = json.loads(lines[-4])["launches_by_path"]
    assert [k["launches"] for k in kernels[:2]] == [
        sum(by_path["K1"].values()), sum(by_path["K2"].values())]
    assert by_path["K1"] == {"main": 45, "batch": 1, "onnx": 45,
                             "onnx-variant": 1, "two-stage": 2,
                             "two-stage-int8": 2, "two-stage-per-image": 9,
                             "mesh": 2, "mesh-f32": 2, "mesh-int8": 2,
                             "mesh-two-stage": 1}
    assert by_path["K2"] == {"main-beam": 45, "batch-beam": 1,
                             "onnx-beam": 1, "mesh-beam": 2}
    for phase, kernel in (("main", "K1"), ("main_beam", "K2"),
                          ("batch", "K1"), ("batch_beam", "K2")):
        assert record[phase]["engines"][kernel] == {
            "f64": 0, "mma": record[phase]["launches"][kernel]}, phase
    # The build: HMMA in the bfloat16 kernels only, no spill there.
    assert set(record["sass_mma"]) == {"fused_decode", "fused_beam"}
    # The mesh: two CPU ranks over gloo; the CLI's --mesh 2 on the CPU ran
    # its own two ranks.
    mesh = record["mesh"]
    assert (mesh["devices"], mesh["backend"]) == (["cpu", "cpu"], "gloo")
    assert mesh["float32"]["images_tokens_identical"] == 3
    for run in ("greedy", "tp", "int8"):
        assert mesh[run]["masks"]["differing_px"] == 0, run
    assert mesh["two_stage"]["strokes_identical"] == 3
    assert mesh["train"]["resumed_from"] == {"binarizer": 2, "captioner": 2}
    assert set(mesh["train"]) >= {"train_losses", "train_tp_losses",
                                  "train_param_max_abs_diff",
                                  "train_tp_param_max_abs_diff"}
    assert mesh["cli"] == {"exit": 0, "warned": False, "files": 1,
                           "cards": 1}
    assert "no scaling figure" in mesh["img_per_s"]["note"]
    # K1 and K2 sharded over dp against their plain versions (here the
    # wrappers run the plain versions: every token agrees).
    assert [c["k1_agree"] for c in mesh["decode_check"]] == [1.0, 1.0]
    assert [c["k2_agree"] for c in mesh["decode_check"]] == [1.0, 1.0]
    assert all(c["rows"] > 0 for c in mesh["decode_check"])
    # two-stage: outputs as the sequential chunks', per image as phase 4's,
    # each stage's seconds and the overlap.
    two = record["two_stage"]
    for quant in ("none", "int8"):
        r = two[quant]
        assert r["against_sequential_chunks"]["differing_px"] == 0
        assert r["against_sequential_chunks"]["strokes_identical"] == 9
        assert r["sequential_launches"]["K1"] == 2
        assert r["stage_s"]["a"] > 0 and r["stage_s"]["b"] > 0
        assert r["stage_s"]["wall"] > 0 and "overlap" in r
        assert set(r["s_per_image"]) == {"two_stage", "sequential_chunks",
                                         "batch"}
    assert two["per_image"]["against_per_image"]["strokes_identical"] == 9
    assert all(two[q]["native_calls"]["resize"] == 9
               and two[q]["native_calls"]["cc"] > 0 for q in ("none", "int8"))
    # onnx: models_demo through ONNX and back gives phase 4's outputs; the
    # variant's K1 and K2 comparisons at its projected and unprojected
    # widths.
    onnx = record["onnx"]
    assert set(onnx["export_bytes"]) == {
        "binarizer.onnx", "encoder.onnx", "decoder_init_hc.onnx",
        "decoder_embedding.onnx", "decoder_iter.onnx",
        "configs_binarizer.json", "configs_strokes.json"}
    assert onnx["cli"]["per_image"]["differing_px"] == 0
    assert onnx["cli"]["per_image"]["strokes_identical"] == 45
    assert onnx["variant_binarize"]["card_vs_cpu_agree"] == 1.0
    cases = [(c["kernel"], c["case"], c["dtype"]) for c in onnx["checks"]]
    for b in (2, 3):
        for e in ("projected E=12", "unprojected E=64"):
            for dt in ("float32", "bfloat16"):
                assert ("K1", f"{e} B={b}", dt) in cases
    assert {c for c in cases if c[0] == "K2"} == {
        ("K2", "projected E=12 B=2", "float32"),
        ("K2", "projected E=12 B=2", "bfloat16")}
    assert all(c["ok"] and c["grid"] == 7 for c in onnx["checks"])
    assert 0 < kernels[2]["launches"] <= chip_smoke.MAX_LENGTH
    for k in kernels:
        assert (REPO / k["source"]).exists()
        path, line = k["replaces"].split(":")
        assert "pallas_call" in (REPO / path).read_text().splitlines()[
            int(line) - 1]
    for phase in ("main", "main_beam", "batch", "batch_beam"):
        assert record[phase]["golden_mask_agree"] >= chip_smoke.MASK_AGREE
    assert record["main_beam"]["launches"]["K1"] == 0
    # The batched paths: one launch each, and on the CPU (float32 crops,
    # the UNet batch-invariant) the per-image run's masks and strokes.
    assert record["batch"]["launches"] == {"K1": 1, "K2": 0, "K3": 0}
    assert record["batch_beam"]["launches"] == {"K1": 0, "K2": 1, "K3": 0}
    for phase in ("batch", "batch_beam"):
        assert record[phase]["per_image"]["differing_px"] == 0
    assert record["batch"]["per_image"]["strokes_identical"] == 45
    rows = record["batch"]["rows_against_alone"]
    assert rows["rows"] == 197
    for key in ("crops_identical_rows", "encoder_identical_rows",
                "tokens_identical_rows"):
        assert rows[key] == 197, key
    assert [c["B"] for c in record["k1_batched"]] == [197, 197]
    assert [c["B"] * c["K"] for c in record["k2_batched"]] == [985, 985]
    assert all(c["ok"] for c in record["k1_batched"] + record["k2_batched"])
    assert record["k1_batched_breakdown"]["B"] == 197
    for phase, key in (("batch", "k1_ms"), ("batch_beam", "k2_ms")):
        assert record[phase][key]["per_image_launches"] > 0
    fused = record["fused_binarize"]
    assert fused["fused_program_images"]["fused"] == 45
    assert fused["fused_vs_default"]["differing_px"] == 0
    assert fused["fused_vs_per_image"]["differing_px"] == 0
    for phase in ("k1", "k2", "k3"):
        assert record[phase] and all(c["ok"] for c in record[phase])
    # K2 beyond the old limit of 16 beams, and the launch shape of K1 and K2.
    assert {c.get("K") for c in record["k2"]} >= {chip_smoke.BEAM,
                                                  chip_smoke.BIG_BEAM}
    for c in record["k1"] + [c for c in record["k2"] if "ms" in c]:
        assert c["grid"] == 7 and c["step_ms"] > 0
    assert record["k1_breakdown"]["steps"] == 3
    assert list(record["k2_breakdown"]["phase_us"]) == list(
        chip_smoke.PHASES)
    # Steps of 4+5+6+7, 8+...+11 and 12+...+15 us.
    assert record["k1_breakdown"]["step_us"] == (22 + 38 + 54) / 3
    assert record["k1_breakdown"]["phase_us"]["scores"] == (4 + 8 + 12) / 3
    # The bfloat16 breakdowns: the tensor-core path, its bound's record and
    # the torch.matmul yardsticks.
    for key in ("k1_breakdown", "k2_breakdown", "k1_batched_breakdown",
                "k2_batched_breakdown"):
        bd = record[key]
        assert bd["engine"] == "mma" and bd["max_err_over_bound"] < 1
        assert bd["lstm_matmul_us"] > 0 and bd["head_matmul_us"] > 0
    launches = [json.loads(x) for x in lines if x.startswith('{"launch"')]
    assert [(x["launch"], x.get("barriers_per_step")) for x in launches] == [
        ("K1", 4), ("K2", 5), ("K3", None)]
    assert [x.get("engine_bf16") for x in launches] == ["mma", "mma", None]
    # K3: the ragged case, every cluster size timed, the barrier probes.
    k3 = {c["case"]: c for c in record["k3"]}
    assert "ragged B=3 P=13" in k3 and k3["ragged B=3 P=13"]["P"] == 13
    for c in record["k3"][:len(chip_smoke.K3_BATCHES) + 2]:
        assert set(c["ms_by_cluster"]) == {str(x)
                                           for x in chip_smoke.K3_CLUSTERS}
        assert c["wrapper_ms"] > 0 and c["bytes_per_cta"] > 0
    # The wrapper's choice: 16 CTAs while the rows fit one cluster each
    # (132 // 16 = 8 clusters faked here), else 8.
    assert [k3[f"synthetic B={b}"]["C"] for b in (1, 3)] == [16, 16]
    assert list(k3["golden"]["phase_us"].values()) == [
        float(i) for i in range(1, da.STAMPS.index("timer_entry"))]
    assert launches[2]["grid"] == k3["golden"]["G"] * k3["golden"]["C"]
    assert [b["cluster"] for b in record["cluster_barrier"]] == list(
        chip_smoke.K3_CLUSTERS)
