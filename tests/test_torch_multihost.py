"""The port's mesh on real process groups: two gloo ranks on the CPU,
started by ``parallel.multihost.spawn`` (the rank functions are in
``tests/torch_mesh_worker.py``), at tiny float32 widths.

Each rank runs every inference path sharded and unsharded; the sharded
output must be the unsharded output exactly (masks and strokes, per image
and batched, device and host partitions, beam, residual passes, chunks),
on a (2, 1) mesh and on a (1, 2) mesh whose tp splits the tile width, and
within the port-against-JAX bars of the JAX package's own mesh runs on
its 8 virtual CPU devices (``make_mesh(2)``, ``make_mesh(2, dp=1,
tp=2)``), as ``tests/test_mesh_inference.py`` runs them. int8 at dp = 2 is
bit for bit the unsharded run over the same padded batch, and differs
from a run with each shard's own activation scale. One data-parallel step
and one tensor-parallel step (kernels column-parallel over tp = 2) of
each model match the single-process full batch (loss within 1e-5,
mean parameter within 1e-6, as ``tests/multihost_worker.py`` holds the
JAX package), and the trainer's ``--distributed`` run writes one
checkpoint, from rank 0, that a single process loads."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import (
    BinarizerConfig as JBin, StrokesConfig as JSe,
)
from stroke_derenderer_tpu.parallel import make_mesh as j_make_mesh
from stroke_derenderer_tpu.weights.store import materialize_model_dir
from stroke_derenderer_tpu_torch.parallel.multihost import spawn

# float32 masks of the port against the JAX package's (the batched path's
# bar, PERF.md section 2).
MASK_AGREE = 0.9999
TRAIN_LOSS_TOL = 1e-5
TRAIN_MEAN_TOL = 1e-6
LR = 1e-3


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    materialize_model_dir(
        d, JBin(features=(8, 16), bottleneck=16, compute_dtype="float32"),
        JSe(encoder_arch="tiny", embed_dim=16, attention_dim=16,
            decoder_dim=16, max_length=24, compute_dtype="float32"))
    return str(d)


@pytest.fixture(scope="module")
def runs(models):
    """Both meshes' rank results: {"dp": [rank 0, rank 1], "tp": [...]}."""
    return {name: spawn(worker.inference, 2, args=(models, tp),
                        timeout_s=400)
            for name, tp in (("dp", 1), ("tp", 2))}


@pytest.fixture(scope="module")
def single(models):
    """The same paths on one device, in this process."""
    return worker.unsharded(models)


def _same_strokes(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert len(sa) == len(sb)
        for (ax, ay), (bx, by) in zip(sa, sb):
            np.testing.assert_array_equal(ax, bx)
            np.testing.assert_array_equal(ay, by)


def _same(a, b):
    """Two results of ``worker._runs``: every mask and stroke of ``a``
    equal to ``b``'s."""
    assert set(a) <= set(b)
    for key in a:
        if key.startswith("mask"):
            ms_a = a[key] if isinstance(a[key], list) else [a[key]]
            ms_b = b[key] if isinstance(b[key], list) else [b[key]]
            assert len(ms_a) == len(ms_b)
            for x, y in zip(ms_a, ms_b):
                np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            _same_strokes(a[key], b[key])


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_sharded_equals_unsharded(runs, single, mesh):
    ranks = runs[mesh]
    assert [r["rank"] for r in ranks] == [0, 1]
    want = {"dp": {"dp": 2, "tp": 1}, "tp": {"dp": 1, "tp": 2}}[mesh]
    assert all(r["shape"] == want for r in ranks)
    for r in ranks:
        if mesh == "dp":
            assert sum(len(s) for s in r["sharded"]["strokes"]) > 0
        _same(r["sharded"], single["single"])
        _same(r["int8_sharded"], single["int8_single"])
    # Every rank holds the whole result.
    _same(ranks[0]["sharded"], ranks[1]["sharded"])


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_one_decode_launch_per_rank(runs, mesh):
    """One process_images (one chunk) calls K1 once on every rank, and the
    beam pipeline K2 once: each rank decodes its rows in one launch."""
    for r in runs[mesh]:
        assert r["decode_calls"] == {"K1": 1, "K2": 1}


def test_int8_scale_is_global(runs):
    """Under int8 each rank's UNet output equals its rows of the unsharded
    batch, because the scale is the max over both ranks; a rank with only
    low-contrast tiles would quantize otherwise with its own scale."""
    checks = [r["int8_scale"] for r in runs["dp"]]
    assert all(c["global_equal"] for c in checks)
    assert not all(c["per_shard_equal"] for c in checks)


def test_collectives(runs):
    for r in runs["tp"]:
        c = r["collectives"]
        assert c["halo_ok"] and c["bf16_gather_ok"]
        assert c["max"] == 1.0 and c["sum"] == 3.0
        assert c["bool_gather"] == [False, True]
        assert c["dp_gather_alone"] == [r["tp_index"]]


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_two_stage_over_the_mesh(runs, single, mesh):
    """``TwoStagePipeline`` over the mesh (split into two stages at dp = 2,
    shared at dp = 1) gives every rank the outputs of the same chunks run
    in turn."""
    want = single["two_stage"]
    for r in runs[mesh]:
        ts = r["two_stage"]
        assert ts["split"] is (mesh == "dp")
        for a, b in zip(ts["masks"] + ts["per_image_masks"],
                        want["masks"] + want["masks"][:2]):
            np.testing.assert_array_equal(a, b)
        _same_strokes(ts["strokes"], want["strokes"])
        _same_strokes(ts["per_image_strokes"], want["per_image_strokes"])


_JAX_SINGLE: dict = {}


def _jax_masks(models, mesh, quant):
    """The JAX package's masks of the lines over ``mesh`` (None: one
    device, computed once per quant mode)."""
    if mesh is None and quant in _JAX_SINGLE:
        return _JAX_SINGLE[quant]
    ov = {"quant": quant} if quant else None
    jb, _ = j_cli.initialize_sessions(models, mesh=mesh, bin_overrides=ov)
    imgs = worker.line_images()
    out = {"masks": [x[:, :, 0] for x in jb.binarize_images(imgs)],
           "mask0": jb.binarize_image(imgs[3])[:, :, 0]}
    if mesh is None:
        _JAX_SINGLE[quant] = out
    return out


def _jax_runs(models, mesh, port_masks, quant=None):
    """The JAX package's masks over ``mesh`` (and over one device), and its
    strokes over ``mesh`` on the masks the port's run took."""
    out = dict(_jax_masks(models, mesh, quant))
    out.update({"single_" + k: v for k, v in _jax_masks(
        models, None, quant).items()})
    if quant or mesh.shape["tp"] > 1:
        return out
    _, je = j_cli.initialize_sessions(models, mesh=mesh)
    masks = worker.glyph_masks() + [x > 127 for x in port_masks]
    out["strokes"] = worker._strokes(je.process_images(masks))
    out["strokes0"] = worker._strokes([je.process_image(masks[0])])
    _, jh = j_cli.initialize_sessions(models, mesh=mesh, se_overrides={
        "device_partition": False})
    out["strokes_host"] = worker._strokes(jh.process_images(masks))
    return out


def _differing(a, b):
    return [int((x != y).sum()) for x, y in zip(a, b)]


def _as_list(run, key):
    return run[key] if isinstance(run[key], list) else [run[key]]


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_against_the_jax_mesh(runs, single, models, mesh):
    """The port's sharded run against the JAX package's on its own mesh.
    The strokes exactly, on the same masks. The masks: the port's sharded
    ones are its unsharded ones (``test_sharded_equals_unsharded``), and
    against the JAX mesh run they differ where the port's unsharded masks
    differ from the JAX package's unsharded ones, plus, at tp = 2, where
    the JAX package's own tp run differs from its unsharded one (JAX's
    width-sharded statistics are summed in another order: 1 float32 and
    34 int8 pixels of 268,288 here). float32 on at least ``MASK_AGREE`` of
    the pixels. int8 rounding makes float-order noise whole steps: on these
    lines the unsharded port and the unsharded JAX package already part on
    1.4% of the int8 pixels (``tests/test_torch_quant.py``'s own lines
    agree on at least 0.99), and the mesh adds nothing to that."""
    jmesh = j_make_mesh(2) if mesh == "dp" else j_make_mesh(2, dp=1, tp=2)
    r = runs[mesh][0]
    for quant, got, one in ((None, r["sharded"], single["single"]),
                            ("int8", r["int8_sharded"],
                             single["int8_single"])):
        want = _jax_runs(models, jmesh, got["masks"], quant)
        for key in ("masks", "mask0"):
            g, s = _as_list(got, key), _as_list(one, key)
            w, ws = _as_list(want, key), _as_list(want, "single_" + key)
            jax_own = _differing(w, ws)
            for d, d_one, j in zip(_differing(g, w), _differing(s, ws),
                                   jax_own):
                assert abs(d - d_one) <= j, (quant, key)
            if mesh == "dp":
                assert not any(jax_own), (quant, key)
            if quant is None:
                px = sum(x.size for x in g)
                assert 1 - sum(_differing(g, w)) / px >= MASK_AGREE, key
        for key in want:
            if key.startswith("strokes"):
                _same_strokes(got[key], want[key])


def _full_batch_step(seed: int) -> dict:
    """The single-process step of each model on the whole global batch."""
    from stroke_derenderer_tpu_torch import weights as tw
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    from stroke_derenderer_tpu_torch.train import steps as tsteps
    tiles, masks, crops, tin, tout = worker.train_batches(seed)
    model = tw.init_binarizer(BinarizerConfig(
        features=(8,), bottleneck=16, compute_dtype="float32"), seed)
    step = tsteps.make_binarizer_train_step(
        model, tsteps.make_optimizer(model), lambda c: LR)
    out = {"binarizer": worker._step_record(step(
        torch.from_numpy(tiles), torch.from_numpy(masks)), model)}
    se = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                       decoder_dim=16, compute_dtype="float32")
    enc, dec = tw.init_strokes(se, seed)
    cap = tsteps.Captioner(enc, dec)
    dec.requires_grad_(True)
    step = tsteps.make_captioner_train_step(
        cap, tsteps.make_optimizer(cap), lambda c: LR,
        enc_image_size=se.encode_image_size, sample_prob=0.5, total_steps=4,
        seed=seed)
    out["captioner"] = worker._step_record(step(
        torch.from_numpy(crops), torch.from_numpy(tin).long(),
        torch.from_numpy(tout).long(), step_idx=3), cap)
    return out


def test_data_parallel_training(tmp_path):
    """One dp step and one tp step of each model against the full batch
    in one process; then ``--distributed`` training: each process its own seed
    (``fold_in_process``), one checkpoint and export written by rank 0,
    which a single process resumes."""
    from stroke_derenderer_tpu_torch.train import loop as tloop
    from stroke_derenderer_tpu_torch.train.checkpoint import (
        latest_checkpoint,
    )
    argv = lambda steps: [
        "--device", "cpu", "--model", "both", "--steps", str(steps),
        "--batch", "2", "--bin-features", "8", "--encoder-arch", "tiny",
        "--se-dims", "16,16,16", "--seq-len", "12", "--ckpt-every", "1"]
    ranks = spawn(worker.train_step, 2,
                  args=(0, LR, str(tmp_path / "dist"), argv(2)),
                  timeout_s=400)
    full = _full_batch_step(0)
    assert ranks[0]["real_tokens"] != ranks[1]["real_tokens"]
    # tp = 2: the conv kernels and enc_att column-parallel (the head and
    # the embedding stay whole: the vocabulary is odd).
    assert "decoder.enc_att_w" in ranks[0]["tp_sharded"]
    assert "encoder.stem.weight" in ranks[0]["tp_sharded"]
    assert not {"decoder.emb", "decoder.wfc"} & set(ranks[0]["tp_sharded"])
    for name in ("binarizer", "captioner", "tp_binarizer", "tp_captioner"):
        for r in ranks:
            got, want = r[name], full[name.replace("tp_", "")]
            assert abs(got["loss"] - want["loss"]) < TRAIN_LOSS_TOL, name
            assert abs(got["mean"] - want["mean"]) < TRAIN_MEAN_TOL, name
        # Every rank made the same update.
        np.testing.assert_array_equal(ranks[0][name]["params"],
                                      ranks[1][name]["params"])
    assert [r["fold"] for r in ranks] == [7, 7 + 100_003]
    # Both processes report the whole batch's losses (with --tp 2 too,
    # where the tp group trains on its first rank's batches), and both
    # hold the same model after the run: the ranks start from the same
    # weights and make the same updates, whatever their data seeds.
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["tp_losses"] == ranks[1]["tp_losses"]
    for run in ("exported", "tp_exported"):
        assert set(ranks[0][run]) == {"binarizer", "captioner"}
        for k, v in ranks[0][run].items():
            np.testing.assert_array_equal(v, ranks[1][run][k],
                                          err_msg=f"{run} {k}")
    assert (tmp_path / "dist_tp" / "strokes_decoder.msgpack").exists()
    out = tmp_path / "dist"
    for sub in ("ckpt_binarizer", "ckpt_captioner"):
        assert latest_checkpoint(out / sub).name == "step_00000002"
    assert (out / "binarizer.msgpack").exists()
    res = tloop.train(argv(3) + ["--out", str(out)], num_workers=1)
    assert {k: r.start_step for k, r in res.items()} == {
        "binarizer": 2, "captioner": 2}
