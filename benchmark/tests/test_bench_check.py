"""The check, driven through a whole run on the CPU at a tiny size (the
harness's look for a card skipped): a sound run passes its exact numbers
and loads nothing of JAX; each fault the cells can have, planted under
the timed path, makes ``correct`` false. The control at the cell's own
size runs on the card only."""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

import run as bench_run
from harness import cell as cells, page_batch
from harness.cell import BENCH, ROOT
from stroke_derenderer_tpu_torch.kernels import fused_beam
from stroke_derenderer_tpu_torch.pipeline import binarize, strokes

TINY = {"lines_per_call": 2, "pool_lines": 4, "pool_seed": 9, "crops_per_line": [1, 2],
        "warmup_calls": 1, "min_calls": 1, "check_calls": 1,
        "trace_from": 0, "trace_calls": 1}


def tiny_run(name="demo.batch_greedy", seed=2**31 + 77, traced=False):
    cell = cells.load(name)
    cell = dataclasses.replace(cell, traffic=cell.traffic | TINY)
    torch.set_num_threads(4)
    res = page_batch.run(cell, seed, 0.05, traced, "cpu", time.perf_counter())
    return cell, res


@pytest.mark.parametrize("name", ["demo.batch_greedy", "demo.batch_beam",
                                  "upstream.batch_greedy"])
def test_sound_run(name):
    cell, res = tiny_run(name, traced=True)
    nums = res["numbers"]
    for k in ("glyph_count_off", "crop_px_off", "poly_off"):
        assert nums[k] == 0, (k, nums)
    _, ok = bench_run.compared(nums, cell.limits)
    assert ok, nums
    assert res["attempted"] == 2 and res["failed"] == 0
    assert set(res["per_layer"]) >= {"binarize_ms_per_img", "strokes_ms_per_img", "mfu"}
    assert cells.forbidden_modules(sys.modules) == []


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _decode_fault(alter):
    """A fault planted where the decode's tokens are produced: ``alter``
    changes the (rows, max_length) tokens in place."""
    def make(orig):
        def decode(decoder, seq, max_length, *args):
            toks = orig(decoder, seq, max_length, *args).clone()
            alter(toks)
            return toks
        return decode
    return make


def _one_token(toks):
    toks[0, 1] = 3 + (int(toks[0, 1]) + 101) % 448   # a vertex token, moved


def _one_row(toks):
    toks[0] = toks[-1]   # the first row given the last row's tokens


def _wrong_beam(orig):
    def select_beam(preds, score, lens, length_penalty=0.0):
        other = (score.argmax(dim=1) + 1) % preds.shape[1]   # not the best
        return preds[torch.arange(preds.shape[0], device=preds.device), other]
    return select_beam


def _half_batch(orig):
    def process_images(self, masks, *args):
        masks = list(masks)
        half = orig(self, masks[:len(masks) // 2], *args)
        return half + [[] for _ in masks[len(masks) // 2:]]
    return process_images


def _altered_mask(orig):
    def binarize_images(self, images):
        out = [m.copy() for m in orig(self, images)]
        out[0][:, : out[0].shape[1] // 4] ^= 255
        return out
    return binarize_images


# Each fault a cell can have, planted under its timed path: (object,
# attribute, wrapper of the original).
FAULTS = {
    "token": (strokes, "fused_greedy_decode", _decode_fault(_one_token)),
    "row": (strokes, "fused_greedy_decode", _decode_fault(_one_row)),
    "beam_token": (strokes, "fused_beam_decode", _decode_fault(_one_token)),
    "beam_row": (strokes, "fused_beam_decode", _decode_fault(_one_row)),
    "wrong_beam": (fused_beam, "select_beam", _wrong_beam),
    "half_batch": (strokes.StrokeEstimator, "process_images", _half_batch),
    "mask": (binarize.Binarizer, "binarize_images", _altered_mask),
}
CELL_FAULTS = [("demo.batch_greedy", f) for f in ("token", "row", "half_batch", "mask")] + [
    ("demo.batch_beam", f) for f in ("beam_token", "beam_row", "wrong_beam", "half_batch")] + [
    ("upstream.batch_greedy", f) for f in ("token", "half_batch", "mask")]


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_fault_is_not_correct(name, fault):
    with patched(*FAULTS[fault]):
        cell, res = tiny_run(name)
    _, ok = bench_run.compared(res["numbers"], cell.limits)
    assert not ok, res["numbers"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "demo.batch_greedy", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name,control", [
    ("demo.batch_greedy", "int8"), ("upstream.batch_greedy", "int8"),
    ("upstream.batch_greedy", "fp8"), ("demo.batch_beam", "int8")])
def test_control_fails_on_the_card(name, control):
    """Each control at the cell's own size fails the check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", name,
                        "--seed", str(2**31 + 4242), "--seconds", "5", "--trace", "0",
                        "--control", control], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
