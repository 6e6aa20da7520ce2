"""``chip_smoke.py`` rehearsed on the CPU, its second group of phases (the
server, ``--preset real``, the trainer, the evaluator, int8 and the
profile; ``test_torch_smoke.PATH_PHASES``), with the card faked as in
``test_torch_smoke.py``, whose test runs the other group beside this one.
The script runs phases main and main-beam first, whose results these
phases use; ``test_torch_smoke.py`` rehearses them as phases of their own.
"""

import json

from test_torch_smoke import PATH_PHASES, rehearse


def test_chip_smoke_rehearsal_paths(monkeypatch, capsys, tmp_path):
    lines, record, chip_smoke = rehearse(monkeypatch, capsys, tmp_path,
                                         PATH_PHASES)
    # No kernel table without phases k1, k2 and k3: the launches by path
    # and by engine end the output.
    engines = json.loads(lines[-2])["launches_by_engine"]
    assert engines["K1"]["mma"] > 0 and engines["K2"]["mma"] > 0
    by_path = json.loads(lines[-3])["launches_by_path"]
    assert not any(x.startswith('{"kernels"') for x in lines)
    # K1: one launch per input image with glyphs on the per-image paths,
    # one per served batch with /derender requests, one per pass batched.
    served = record["serve"]["launches"]["K1"]
    assert 0 < served < record["serve"]["derender_requests"]
    real = record["real"]
    passes = real["passes"]
    assert passes == 3 and real["redecode_coverage"] == 0.9
    assert 45 + 1 <= by_path["K1"].pop("real") <= 45 * (1 + passes)
    assert 2 <= by_path["K1"].pop("batch-real") <= 1 + passes
    assert 0 < by_path["K1"].pop("eval")
    assert 3 <= by_path["K1"].pop("eval-batched") <= 3 + passes
    assert by_path["K1"].pop("train") == 1
    assert 0 < by_path["K1"].pop("int8-eval")
    assert by_path["K1"] == {"main": 45, "serve": served, "refine": 45,
                             "int8": 9, "int8-batch": 1, "profile": 9,
                             "profile-batch": 3}
    assert by_path["K2"].pop("real-beam") >= 2
    assert by_path["K2"] == {"main-beam": 45, "int8-beam": 1}
    for run in ("per_image", "batched", "beam", "refine"):
        launches = real[run]["launches"]
        assert real[run]["engines"] == {
            k: {"f64": 0, "mma": launches[k]} for k in ("K1", "K2")}, run
    # int8: every conv card == CPU (both the CPU here), the demo bars, the
    # CLI's int8 runs, the eval runs.
    int8 = record["int8"]
    assert len(int8["convs"]) == 6 and all(
        c["int32_equal"] and c["bit_equal"] and c["cudnn_ms"] > 0
        for c in int8["convs"])
    assert int8["demo"]["mask_agree"] >= chip_smoke.INT8_AGREE
    assert int8["demo"]["encoder_cosine"] > chip_smoke.INT8_COSINE
    assert int8["conv_calls"] > 0
    assert int8["cli"]["against_bf16"]["agree"] >= chip_smoke.INT8_AGREE
    assert set(int8["eval"]) == {"real_greedy", "mixed_greedy", "launches"}
    assert [(c["case"], c.get("K"), c["ok"]) for c in int8["kernels"]] == [
        ("int8 batched", None, True), ("int8 batched", 5, True)]
    assert all(int8["eval"][k]["within"] == ["default"]
               for k in ("real_greedy", "mixed_greedy"))
    # profile: native ops as the plain ones, the ledger per stage (packed
    # below dense), the timer, no device track on the CPU, FLOPs, K1.
    prof = record["profile"]
    assert prof["images"] == 3
    assert set(prof["native_ms_per_image"]) == {"resize", "cc"}
    led = prof["ledger_per_image"]
    assert set(led) == {"per_image_packed", "per_image_dense",
                        "batch_packed", "batch_dense"}
    for path in ("per_image", "batch"):
        assert (led[f"{path}_packed"]["strokes"]["up_bytes"]
                < led[f"{path}_dense"]["strokes"]["up_bytes"])
        assert led[f"{path}_packed"]["binarize"] == \
            led[f"{path}_dense"]["binarize"]
        assert prof["packed_strokes_as_dense"][path] == 3
    assert led["per_image_packed"]["strokes"]["up_events"] == 1
    assert led["batch_packed"]["strokes"]["up_events"] == 1 / 3
    assert set(prof["busy"]) == {"per_image_binarize", "per_image_strokes",
                                 "batch_binarize", "batch_strokes"}
    assert all(b["busy_ms"] is None and b["wall_ms"] > 0
               and b["trace_bytes"] > 0 for b in prof["busy"].values())
    assert prof["flops"]["n_glyphs"] > 0 and all(
        v > 0 for v in prof["flops"]["bf16_peak_share"].values())
    assert {"binarize", "strokes", "binarize_batch",
            "strokes_batch"} <= set(prof["timer"])
    assert prof["k1"]["ok"] and prof["k1"]["B"] > 0
    # --preset real: every run's prints, the host seconds of the three
    # wrapped functions, coverage that the passes do not lower, and K1 on
    # the residual rows against its plain version.
    for run in ("per_image", "batched", "beam", "refine"):
        assert real[run]["strokes_s_per_image"] > 0
        assert set(real[run]["host_s"]) == {
            "residual_ink", "merge_stroke_fragments", "refine_strokes"}
    assert real["per_image"]["host_s"]["residual_ink"]["calls"] >= 45
    assert real["per_image"]["host_s"]["merge_stroke_fragments"][
        "max_strokes"] > 0
    assert real["refine"]["host_s"]["refine_strokes"]["calls"] > 0
    assert real["refine"]["host_s"]["residual_ink"]["calls"] == 0
    assert real["batched"]["per_image_run"]["strokes_identical"] == 45
    cover = real["golden_coverage"]
    assert cover["real"] >= cover["main"] and cover["real"] < 1
    assert cover["real-beam"] >= cover["main-beam"]
    assert real["residual_images"] > 0
    assert [c["dtype"] for c in real["k1_residual"]] == ["float32",
                                                         "bfloat16"]
    assert all(c["ok"] and c["B"] > 0 for c in real["k1_residual"])
    # eval: the three runs, each beside the JAX reference, per image and
    # batched (one binarize_images and one process_images per set).
    runs = json.loads(chip_smoke.JAX_EVAL.read_text())["runs"]
    for key in ("eval", "eval_batched"):
        ev = record[key]
        assert {k for k in ev if k != "launches"} == set(runs)
        assert ev["real_greedy"]["result"]["n"] == 2
        assert ev["mixed_greedy"]["result"]["n"] == 2
        assert all(ev[k]["within"] == ["default"] for k in runs)
    assert record["eval_batched"]["launches"]["K2"] == 0
    # train: the reference steps within the bars, the resume, every run's
    # rates, the from-scratch losses falling, the export served.
    train = record["train"]
    assert not train["golden"]["misses"]
    assert set(train["golden"]["port"]) == {"float32", "bfloat16"}
    assert train["resume_start_steps"] == {"binarizer": 8, "captioner": 8}
    assert set(train["rates"]) == {
        "binarizer", "captioner", "captioner-cache", "binarizer-resumed",
        "captioner-resumed", "binarizer-scratch", "captioner-scratch"}
    assert train["rates"]["captioner-resumed"]["steps"] == 2
    assert all(r["steps_per_s"] > 0 and 0 <= r["wait_share"] <= 1
               for r in train["rates"].values())
    assert all(b < a for a, b in train["scratch_means"].values())
    assert set(train["step_alone_ms"]) == {"binarizer", "captioner"}
    assert train["cli"]["launches"] == {"K1": 1, "K2": 0, "K3": 0}
    serve = record["serve"]
    assert max(int(k) for k in serve["batch_size_hist"]) > 1
    assert serve["svg_ok"]
    assert serve["latency_s"]["strokes"]["p50"] is not None
    for phase in ("main", "main_beam"):
        assert record[phase]["golden_mask_agree"] >= chip_smoke.MASK_AGREE
