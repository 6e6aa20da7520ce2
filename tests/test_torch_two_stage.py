"""The port's two-stage overlap (``parallel/two_stage.py``) on the CPU:
the counterparts of the JAX package's ``tests/test_two_stage.py`` (outputs
as the sequential path's, a stage-B error stops stage A, the end-of-stream
sentinel survives a lagging consumer), the port's two-stage against the
JAX package's ``TwoStagePipeline`` on the same inputs in float32, and
under int8 against the sequential run over the same chunks; over a
two-rank mesh against the JAX package's over its own."""

import threading
import time

import numpy as np
import pytest

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.parallel.two_stage import (
    TwoStagePipeline as JTwoStage,
)
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch.parallel import TwoStagePipeline

TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=12,
                        compute_dtype="float32")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(d, TINY_BIN, TINY_SE)
    return d


def _imgs(n=3):
    out = []
    for k in range(n):
        img = np.full((150, 400 + 100 * k, 3), 255, np.uint8)
        img[60:64, 50:350] = 0
        img[100:103, 80:300] = 0
        img[20:40, 30 + 20 * k:45 + 20 * k] = 0
        out.append(img)
    return out


def _sessions(models, quant=None):
    ov = {"quant": quant} if quant else None
    return cli.initialize_sessions(models, device="cpu", se_overrides=ov,
                                   bin_overrides=ov)


def _pipe(models, quant=None):
    return TwoStagePipeline(*_sessions(models, quant), devices=["cpu",
                                                                "cpu"])


def _same_strokes(a, b):
    assert len(a) == len(b)
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_two_stage_matches_sequential(models):
    imgs = _imgs()
    binarizer, estimator = _sessions(models)
    seq_masks = [binarizer.binarize_image(img)[:, :, 0] > 127
                 for img in imgs]
    seq_strokes = [estimator.process_image(m, max_length=12)
                   for m in seq_masks]
    pipe = _pipe(models)
    pp_masks, pp_strokes = pipe.process(imgs, max_length=12)
    for a, b in zip(seq_masks, pp_masks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(seq_strokes, pp_strokes):
        _same_strokes(a, b)
    assert sum(len(s) for s in pp_strokes) > 0
    # Chunk-overlapped mode: the same outputs at any chunk size.
    for chunk in (2, 3):
        cb_masks, cb_strokes = pipe.process_batched(imgs, chunk_size=chunk,
                                                    max_length=12)
        for a, b in zip(pp_masks, cb_masks):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pp_strokes, cb_strokes):
            _same_strokes(a, b)


def test_two_stage_matches_jax(models):
    """The port's and the JAX package's TwoStagePipeline on the same model
    dir and images, float32: the same masks and strokes, per image and
    chunked."""
    imgs = _imgs()
    jpipe = JTwoStage(*j_cli.initialize_sessions(models))
    pipe = _pipe(models)
    for run in (lambda p: p.process(imgs, max_length=12),
                lambda p: p.process_batched(imgs, chunk_size=2,
                                            max_length=12)):
        jm, js = run(jpipe)
        tm, ts = run(pipe)
        for a, b in zip(jm, tm):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(js, ts):
            _same_strokes(b, a)


def test_two_stage_int8_matches_sequential_chunks(models):
    """Under int8 a chunk's outputs depend on its chunk-mates, so the
    two-stage run is held to the sequential ``binarize_images`` +
    ``process_images`` over the same chunks."""
    imgs = _imgs(5)
    binarizer, estimator = _sessions(models, "int8")
    seq_masks, seq_strokes = [], []
    for c in range(0, 5, 2):
        bins = binarizer.binarize_images(imgs[c:c + 2])
        masks = [b[:, :, 0] > 127 for b in bins]
        seq_masks += masks
        seq_strokes += estimator.process_images(masks, max_length=12)
    pp_masks, pp_strokes = _pipe(models, "int8").process_batched(
        imgs, chunk_size=2, max_length=12)
    for a, b in zip(seq_masks, pp_masks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(seq_strokes, pp_strokes):
        _same_strokes(a, b)


class Boom(RuntimeError):
    pass


def _explode(*a, **k):
    raise Boom("stage B down")


@pytest.mark.parametrize("mode", ["process_batched", "process"])
def test_consumer_exception_stops_producer(models, mode):
    """A stage-B error reaches the caller, and the stage-A thread is joined
    rather than left blocked on the full queue."""
    pipe = _pipe(models)
    target = "process_images" if mode == "process_batched" else \
        "process_image"
    setattr(pipe.estimator, target, _explode)
    before = threading.active_count()
    kwargs = {"chunk_size": 1} if mode == "process_batched" else {}
    with pytest.raises(Boom):
        getattr(pipe, mode)(_imgs(2) * 4, **kwargs)
    assert threading.active_count() <= before


def test_producer_exception_reaches_the_caller(models):
    pipe = _pipe(models)
    pipe.binarizer.binarize_images = _explode
    with pytest.raises(Boom):
        pipe.process_batched(_imgs(2), chunk_size=1)


def test_batched_sentinel_survives_lagging_consumer(models):
    """The producer finishes while the queue (maxsize 1) still holds the
    last chunk: the end-of-stream sentinel must still be delivered, or the
    consumer's next get() blocks forever."""
    pipe = _pipe(models)
    imgs = _imgs(3)
    orig = pipe.estimator.process_images

    def slow(masks, max_length=None):
        time.sleep(0.4)
        return orig(masks, max_length=max_length)

    pipe.estimator.process_images = slow
    result = {}

    def run():
        result["r"] = pipe.process_batched(imgs, chunk_size=1, max_length=8)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "the end-of-stream sentinel was dropped"
    masks, strokes = result["r"]
    assert all(m is not None for m in masks)
    assert all(s is not None for s in strokes)


def test_mesh_is_not_ported(models):
    """Two-stage over a mesh, ported: two ranks split into stage A (the
    first dp half) and stage B; every rank returns the JAX package's
    ``TwoStagePipeline`` outputs over its own (2, 1) mesh, per image and
    chunked; the pipelines it was built from keep their mesh."""
    from torch_mesh_worker import two_stage
    from stroke_derenderer_tpu.parallel import make_mesh as j_make_mesh
    from stroke_derenderer_tpu_torch.parallel.multihost import spawn
    imgs = _imgs()
    jpipe = JTwoStage(*j_cli.initialize_sessions(models,
                                                 mesh=j_make_mesh(2)))
    want = (jpipe.process(imgs, max_length=12),
            jpipe.process_batched(imgs, chunk_size=2, max_length=12))
    for split, kept, *got in spawn(two_stage, 2, args=(str(models), imgs),
                                   timeout_s=300):
        assert split and kept
        for (jm, js), (tm, ts) in zip(want, got):
            for a, b in zip(jm, tm):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(js, ts):
                _same_strokes(b, a)
