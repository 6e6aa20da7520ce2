"""Rank functions of ``tests/test_torch_multihost.py``, run by
``parallel.multihost.spawn`` in gloo process groups on the CPU.

This module imports no JAX (the parent test holds the results against the
JAX package); each function runs many checks, so that a rank's start-up is
paid rarely, and returns plain numpy results for the parent to compare."""

from __future__ import annotations

import numpy as np
import torch

from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu_torch.parallel import TwoStagePipeline
from stroke_derenderer_tpu_torch.parallel import mesh as tmesh
from stroke_derenderer_tpu_torch.parallel import multihost

TINY_BIN = BinarizerConfig(features=(8, 16), bottleneck=16,
                           compute_dtype="float32")
TINY_SE = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                        decoder_dim=16, max_length=24,
                        compute_dtype="float32")


def line_images():
    """Lines of three widths (two of them sharing a tile plan), loops of
    dark ink on light paper, numpy-seeded."""
    rng = np.random.default_rng(3)
    imgs = []
    for i, w in enumerate((500, 500, 500, 700, 260)):
        img = np.full((150, w, 3), 250, np.uint8)
        for k in range(4):
            t = np.linspace(0, 2 * np.pi, 160)
            xs = np.clip((40 + k * w // 5 + 30 * np.cos(t * (1 + k % 2))
                          ).astype(int), 0, w - 1)
            ys = np.clip((75 + 50 * np.sin(t + k + i)).astype(int), 0, 149)
            img[ys, xs] = 10
            img[np.clip(ys + 1, 0, 149), xs] = 10
        img[rng.integers(0, 150, 40), rng.integers(0, w, 40)] = 0
        imgs.append(img)
    return imgs


def glyph_masks():
    """Masks of many glyphs (loops of a few pixels' ink), one without any."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 2 * np.pi, 200)
    out = []
    for h, w, n in ((128, 400, 5), (128, 200, 0), (128, 333, 3),
                    (64, 250, 4), (128, 520, 7)):
        m = np.zeros((h, w), bool)
        for _ in range(n):
            cx, cy = rng.integers(20, w - 20), rng.integers(20, h - 20)
            r = rng.integers(5, 18)
            xs = (cx + r * np.cos(t * rng.uniform(0.5, 2))).astype(int)
            ys = (cy + r * np.sin(t)).astype(int)
            m[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = True
        out.append(m)
    return out


def contrast_tiles():
    """Eight 128 x 384 tiles: four of dark ink on white, then four of the
    same ink at low contrast (grey on light grey), so that the two halves'
    largest activations differ."""
    rng = np.random.default_rng(5)
    tiles = np.full((8, 128, 384, 3), 255, np.uint8)
    for i in range(4):
        for _ in range(12):
            y, x = rng.integers(5, 110), rng.integers(0, 340)
            tiles[i, y:y + rng.integers(3, 14), x:x + rng.integers(5, 40)] = 0
    tiles[4:] = (150 + tiles[:4].astype(int) * 60 // 255).astype(np.uint8)
    return tiles


def _strokes(s):
    return [[(np.asarray(x), np.asarray(y)) for x, y in im] for im in s]


def _runs(models, mesh, quant="none", strokes: bool = True, **se):
    """Every inference path of both pipelines on the inputs, as one dict:
    masks of ``binarize_images`` (bucketed and fused) and of
    ``binarize_image``; with ``strokes``, the strokes of ``process_images``
    and ``process_image`` with device and host partitions, beam, residual
    passes and chunks (float32 only)."""
    ov = {"quant": quant}
    out = {}
    b, e = cli.initialize_sessions(models, device="cpu", bin_overrides=ov,
                                   se_overrides=dict(ov, **se), mesh=mesh)
    imgs = line_images()
    out["masks"] = [m[:, :, 0] for m in b.binarize_images(imgs)]
    out["mask0"] = b.binarize_image(imgs[3])[:, :, 0]
    b.fused = True
    out["masks_fused"] = [m[:, :, 0] for m in b.binarize_images(imgs)]
    if quant != "none" or not strokes:
        return out
    masks = glyph_masks() + [m > 127 for m in out["masks"]]
    out["strokes"] = _strokes(e.process_images(masks))
    out["strokes0"] = _strokes([e.process_image(masks[0])])
    for name, kw in (("host", {"device_partition": False}),
                     ("beam", {"decode": "beam", "beam_size": 3}),
                     ("redecode", {"redecode_coverage": 0.9,
                                   "redecode_passes": 2}),
                     ("chunks", {"io_chunks": 2})):
        _, e2 = cli.initialize_sessions(models, device="cpu",
                                        se_overrides=dict(se, **kw),
                                        mesh=mesh)
        out[f"strokes_{name}"] = _strokes(e2.process_images(masks))
        out[f"strokes0_{name}"] = _strokes([e2.process_image(masks[4])])
    return out


def _int8_scale_check(models, mesh) -> dict:
    """The int8 UNet on :func:`contrast_tiles`: this rank's rows under the
    mesh (the scale the max over both ranks) against the same rows of the
    unsharded batch, and against a run with each rank's own scale."""
    b, _ = cli.initialize_sessions(models, device="cpu",
                                   bin_overrides={"quant": "int8"})
    x = torch.from_numpy(contrast_tiles()).float() / 255.0
    rows = mesh.rows(x.shape[0])
    with torch.inference_mode():
        whole = b.model(x)[rows]
        with tmesh.spmd(mesh):
            sharded = b.model(x[rows])
        per_shard = b.model(x[rows])
    return {"global_equal": bool(torch.equal(sharded, whole)),
            "per_shard_equal": bool(torch.equal(per_shard, whole))}


def inference(models: str, tp: int) -> dict:
    """A rank of a (2 / tp, tp) mesh: every path sharded and unsharded (in
    this rank), float32 and int8, and ``TwoStagePipeline`` over the mesh
    against the same chunks run in turn."""
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    mesh = tmesh.make_mesh(2, tp=tp)
    calls = {"K1": 0, "K2": 0}
    orig = (fd.fused_greedy_decode_packed, fb.fused_beam_decode_packed)

    def count(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    # The decode calls of one process_images (one chunk), greedy and beam.
    _, greedy = cli.initialize_sessions(models, device="cpu", mesh=mesh)
    _, beam = cli.initialize_sessions(models, device="cpu", mesh=mesh,
                                      se_overrides={"decode": "beam",
                                                    "beam_size": 3})
    fd.fused_greedy_decode_packed = count("K1", orig[0])
    fb.fused_beam_decode_packed = count("K2", orig[1])
    try:
        greedy.process_images(glyph_masks())
        beam.process_images(glyph_masks())
    finally:
        fd.fused_greedy_decode_packed, fb.fused_beam_decode_packed = orig
    # At dp = 1 the glyph rows are not sharded (tp ranks decode replicas):
    # only the binarizer's paths differ from one device.
    res = {"rank": mesh.rank, "dp_index": mesh.dp_index,
           "tp_index": mesh.tp_index, "shape": mesh.shape,
           "sharded": _runs(models, mesh, strokes=mesh.shape["dp"] > 1),
           "decode_calls": calls,
           "int8_sharded": _runs(models, mesh, "int8")}
    if mesh.shape["dp"] > 1:
        res["int8_scale"] = _int8_scale_check(models, mesh)
    else:
        res["collectives"] = _collectives(mesh)
    # Two-stage over the mesh, chunked and per image.
    b, e = cli.initialize_sessions(models, device="cpu", mesh=mesh)
    pipe = TwoStagePipeline(b, e)
    imgs = line_images()
    masks, strokes = pipe.process_batched(imgs, chunk_size=2)
    pm, ps = pipe.process(imgs[:2])
    res["two_stage"] = {"masks": masks, "strokes": _strokes(strokes),
                        "per_image_masks": pm,
                        "per_image_strokes": _strokes(ps),
                        "split": pipe._split}
    return res


def unsharded(models: str) -> dict:
    """What :func:`inference`'s sharded runs are held to, on one device:
    every path float32 and int8, and the two-stage run's chunks of 2 in
    turn and images one by one."""
    out = {"single": _runs(models, None),
           "int8_single": _runs(models, None, "int8")}
    b, e = cli.initialize_sessions(models, device="cpu")
    imgs = line_images()
    masks, strokes = [], []
    for c in range(0, len(imgs), 2):
        ms = [m[:, :, 0] > 127 for m in b.binarize_images(imgs[c:c + 2])]
        masks += ms
        strokes += e.process_images(ms)
    out["two_stage"] = {"masks": masks, "strokes": _strokes(strokes),
                        "per_image_strokes": _strokes(
                            [e.process_image(m) for m in masks[:2]])}
    return out


def _collectives(mesh) -> dict:
    """A (1, 2) mesh's collectives on known tensors: all_max, all_sum, the
    column gathers (bfloat16 and bool too), the dp gather of a group of
    one and the tp halo."""
    c = mesh.tp_index
    x = torch.arange(24, dtype=torch.float32).view(1, 2, 3, 4) + 100 * c
    halo = mesh.halo(x, 1)
    full = torch.cat([torch.arange(24, dtype=torch.float32).view(1, 2, 3, 4),
                      torch.arange(24, dtype=torch.float32).view(
                          1, 2, 3, 4) + 100], dim=-1)
    want = torch.nn.functional.pad(full, (1, 1))[..., 4 * c:4 * c + 6]
    bf = [torch.arange(6, dtype=torch.bfloat16) / 3 + k for k in (0, 1)]
    return {"halo_ok": bool(torch.equal(halo, want)),
            "max": float(mesh.all_max(torch.tensor([float(c)]), "tp")),
            "sum": float(mesh.all_sum(torch.tensor([1.0 + c]), "tp")),
            "bf16_gather_ok": bool(torch.equal(mesh.all_gather(bf[c], "tp"),
                                               torch.cat(bf))),
            "bool_gather": mesh.all_gather(torch.tensor([c == 1]), "tp",
                                           0).tolist(),
            "dp_gather_alone": mesh.all_gather(torch.tensor([c]), "dp",
                                               0).tolist()}


def train_step(seed: int, lr: float, out_dir: str, argv: list) -> dict:
    """One data-parallel step of each model on this rank's rows of a fixed
    global batch (the captioner's shards with different counts of real
    tokens), then the trainer's ``--distributed`` run (``argv``) into
    ``out_dir``."""
    from stroke_derenderer_tpu_torch import weights as tw
    from stroke_derenderer_tpu_torch.train import steps as tsteps
    mesh = tmesh.make_mesh(2)
    tiles, masks, crops, tin, tout = train_batches(seed)
    rows = mesh.rows(tiles.shape[0])
    out = {"rank": mesh.rank}
    cfg = BinarizerConfig(features=(8,), bottleneck=16,
                          compute_dtype="float32")
    model = tw.init_binarizer(cfg, seed)
    opt = tsteps.make_optimizer(model)
    step = tsteps.make_binarizer_train_step(model, opt, lambda c: lr, mesh)
    loss = step(torch.from_numpy(tiles[rows]), torch.from_numpy(masks[rows]))
    out["binarizer"] = _step_record(loss, model)
    se = StrokesConfig(encoder_arch="tiny", embed_dim=16, attention_dim=16,
                       decoder_dim=16, compute_dtype="float32")
    enc, dec = tw.init_strokes(se, seed)
    cap = tsteps.Captioner(enc, dec)
    dec.requires_grad_(True)
    opt = tsteps.make_optimizer(cap)
    step = tsteps.make_captioner_train_step(
        cap, opt, lambda c: lr, enc_image_size=se.encode_image_size,
        sample_prob=0.5, total_steps=4, seed=seed, mesh=mesh)
    crop_rows = mesh.rows(crops.shape[0])
    loss = step(torch.from_numpy(crops[crop_rows]),
                torch.from_numpy(tin[crop_rows]).long(),
                torch.from_numpy(tout[crop_rows]).long(), step_idx=3)
    out["captioner"] = _step_record(loss, cap)
    out["real_tokens"] = int((tout[crop_rows] != 0).sum())
    out["fold"] = multihost.fold_in_process(7)
    # One step of each model over a (1, 2) mesh: the kernels column-parallel
    # on tp, the whole batch on both ranks.
    tp2 = tmesh.make_mesh(2, dp=1, tp=2)
    model = tw.init_binarizer(cfg, seed)
    sharded = tmesh.shard_columns(model, tp2)
    step = tsteps.make_binarizer_train_step(
        model, tsteps.make_optimizer(model), lambda c: lr, tp2)
    loss = step(torch.from_numpy(tiles), torch.from_numpy(masks))
    out["tp_binarizer"] = _step_record(loss, model, sharded, tp2)
    enc, dec = tw.init_strokes(se, seed)
    cap = tsteps.Captioner(enc, dec)
    dec.requires_grad_(True)
    sharded = tmesh.shard_columns(cap, tp2)
    out["tp_sharded"] = sorted(sharded)
    step = tsteps.make_captioner_train_step(
        cap, tsteps.make_optimizer(cap), lambda c: lr,
        enc_image_size=se.encode_image_size, sample_prob=0.5, total_steps=4,
        seed=seed, mesh=tp2)
    loss = step(torch.from_numpy(crops), torch.from_numpy(tin).long(),
                torch.from_numpy(tout).long(), step_idx=3)
    out["tp_captioner"] = _step_record(loss, cap, sharded, tp2)
    # The trainer's --distributed run in this group: per-process data,
    # checkpoints and the export from rank 0 alone.
    from stroke_derenderer_tpu_torch.train import loop
    res = loop.train(argv + ["--distributed", "--out", out_dir],
                     num_workers=1)
    out["losses"] = {k: r.losses for k, r in res.items()}
    out["exported"] = _exported(res)
    # And with --tp 2: one tp group, whose first rank draws its batches.
    res = loop.train(argv + ["--distributed", "--tp", "2", "--out",
                             out_dir + "_tp"], num_workers=2)
    out["tp_losses"] = {k: r.losses for k, r in res.items()}
    out["tp_exported"] = _exported(res)
    return out


def _exported(results: dict) -> dict:
    """Each run's exported parameters, flattened in name order."""
    return {k: torch.cat([r.exported[n].detach().float().reshape(-1)
                          for n in sorted(r.exported)]).numpy().copy()
            for k, r in results.items()}




def _step_record(loss, module, sharded=None, mesh=None) -> dict:
    """The loss and the parameters (whole: tp slices gathered)."""
    sharded = sharded or {}
    params = torch.cat([
        (mesh.all_gather(p.detach(), "tp", sharded[n][0]) if n in sharded
         else p.detach()).reshape(-1) for n, p in module.named_parameters()])
    return {"loss": float(loss), "mean": float(params.double().mean()),
            "params": params.numpy().copy()}


def train_batches(seed: int):
    """A global batch of 4 tiles and masks and of 4 glyph crops and token
    rows; the first two token rows are long, the last two short, so that
    the two dp shards hold different counts of real tokens."""
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(0, 1, (4, 16, 48, 3)).astype(np.float32)
    masks = (tiles[..., :1] > 0.5).astype(np.float32)
    crops = rng.normal(0, 1, (4, 224, 224, 3)).astype(np.float32)
    tout = rng.integers(3, 451, (4, 12)).astype(np.int64)
    for i, n in enumerate((12, 10, 3, 2)):
        tout[i, n - 1] = 2
        tout[i, n:] = 0
    tin = np.concatenate([np.ones((4, 1), np.int64), tout[:, :-1]], axis=1)
    return tiles, masks, crops, tin, tout


def two_stage(models: str, imgs) -> tuple:
    """A rank of a (2, 1) mesh: ``TwoStagePipeline`` over it on ``imgs``,
    per image and in chunks of 2 (max_length 12); and whether the two
    pipelines held the whole mesh again after each step."""
    mesh = tmesh.make_mesh(2)
    b, e = cli.initialize_sessions(models, device="cpu", mesh=mesh)
    pipe = TwoStagePipeline(b, e)
    kept = [b.mesh is mesh and e.mesh is mesh]
    per_image = pipe.process(imgs, max_length=12)
    kept.append(b.mesh is mesh and e.mesh is mesh)
    batched = pipe.process_batched(imgs, chunk_size=2, max_length=12)
    kept.append(b.mesh is mesh and e.mesh is mesh)
    return pipe._split, all(kept), per_image, batched
