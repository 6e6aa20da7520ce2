"""Training loop: train the binarizer and/or the captioner with checkpoints,
resume and model-dir export, counterpart of the JAX ``train/loop.py`` with
its flags, its files and its formats.

    python -m stroke_derenderer_tpu_torch.train.loop --model both \
        --steps 300 --batch 16 --out ./models [--device cuda|cpu]

Writes ``<out>/ckpt_{binarizer,captioner}/step_%08d/`` (flax msgpack
params, optax-layout optimizer state, the EMA shadow as
``extra_ema.msgpack``, ``meta.json``) and exports ``binarizer.msgpack``,
``strokes_{encoder,decoder}.msgpack`` and the ``configs_*.json`` into
``<out>``, so the CLI of either package loads the result and either
package's trainer resumes the other's checkpoints. A run resumes from the
newest checkpoint in ``<out>``. Runs on the card unless ``--device cpu`` is
given.

``--mesh N`` trains data-parallel over N ranks, one process each
(``parallel.multihost.spawn``; ``cuda:0`` .. ``cuda:N-1``, sharing the
cards round-robin when there are fewer, or the CPU with ``--device cpu``):
the mesh's first rank draws each global batch of ``--batch`` rows and every
rank keeps its dp rows, as the JAX package shards one global batch.
``--distributed`` joins a process group from the ``SD_COORDINATOR`` /
``SD_NUM_PROCESSES`` / ``SD_PROCESS_ID`` environment
(``parallel.multihost.initialize``); each process draws its own ``--batch``
rows from its own data seed (``fold_in_process``), while the model starts
from the unfolded ``--seed`` on every rank. Either way the gradients are
the whole batch's (``train/steps.py``), every rank makes the same update,
and rank 0 alone writes the checkpoints and the export. ``--tp K`` lays
the conv kernels and the decoder's ``enc_att`` out column-parallel over
groups of K ranks (``parallel.mesh.shard_columns``), the JAX package's
tensor-parallel layout; checkpoints and exports gather them whole.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from stroke_derenderer_tpu_torch.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu_torch.data.loader import PrefetchLoader
from stroke_derenderer_tpu_torch.device import resolve_device
from stroke_derenderer_tpu_torch.models.encoder import ARCHS
from stroke_derenderer_tpu_torch.parallel import multihost
from stroke_derenderer_tpu_torch.parallel.mesh import (
    make_mesh, shard_columns,
)
from stroke_derenderer_tpu_torch.train.checkpoint import (
    latest_checkpoint, load_opt_state, opt_state_tree, restore_checkpoint,
    save_checkpoint,
)
from stroke_derenderer_tpu_torch.train.steps import (
    Captioner, lr_at, make_binarizer_train_step, make_captioner_train_step,
    make_optimizer,
)
from stroke_derenderer_tpu_torch.weights import (
    from_flax_decoder, from_flax_encoder, from_flax_unet, init_binarizer,
    init_strokes, read_msgpack, save_model_files, to_flax_decoder,
    to_flax_encoder, to_flax_unet,
)

log = logging.getLogger("train")

@dataclasses.dataclass
class TrainResult:
    """What a run did: the exported parameters (the EMA shadow when on),
    every step's loss, the step it started from, and the seconds spent
    waiting on the loader and in the steps."""
    exported: dict
    losses: list
    start_step: int
    wait_s: float
    step_s: float


@dataclasses.dataclass
class _Layout:
    """Maps between a module's ``state_dict`` names and the flax tree.
    ``whole`` turns a dict named like the state dict into whole tensors
    (identity unless :func:`_tp_layout` sharded the module); a layout whose
    maps are ``collective`` runs them on every rank."""
    to_tree: Callable[[dict], dict]
    from_tree: Callable[[dict], dict]
    whole: Callable[[dict], dict] = lambda sd: sd
    collective: bool = False


def _tp_layout(layout: _Layout, module, mesh) -> _Layout:
    """``layout`` for ``module`` laid out column-parallel on the mesh's tp
    group (``parallel.mesh.shard_columns``): trees hold whole tensors,
    gathered over tp on the way out and cut to this rank's slice on the
    way in, so that checkpoints and exports are those of one device."""
    sharded = shard_columns(module, mesh) if mesh is not None else {}
    if not sharded:
        return layout
    k, tp = mesh.tp_index, mesh.shape["tp"]

    def whole(sd):
        return {n: (mesh.all_gather(t, "tp", dim=sharded[n][0])
                    if n in sharded and t.shape[sharded[n][0]]
                    != sharded[n][1] else t) for n, t in sd.items()}

    def local(sd):
        return {n: (t.narrow(sharded[n][0], k * (sharded[n][1] // tp),
                             sharded[n][1] // tp) if n in sharded else t)
                for n, t in sd.items()}

    return _Layout(lambda sd: layout.to_tree(whole(sd)),
                   lambda tree: local(layout.from_tree(tree)), whole, True)


def _unet_layout(config: BinarizerConfig) -> _Layout:
    n = len(config.features)
    return _Layout(lambda sd: to_flax_unet(sd, n),
                   lambda t: from_flax_unet(t, n))


def _captioner_layout(config: StrokesConfig) -> _Layout:
    if config.encoder_arch not in ARCHS:
        raise ValueError(f"the trainer trains ResNet encoders only; "
                         f"encoder_arch {config.encoder_arch!r} is not one")
    kind = ARCHS[config.encoder_arch][0]

    def sub(sd, prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    def to_tree(sd):
        return {"encoder": to_flax_encoder(sub(sd, "encoder."), kind),
                "decoder": to_flax_decoder(sub(sd, "decoder."))}

    def from_tree(t):
        enc = from_flax_encoder(t["encoder"], kind)
        dec = from_flax_decoder(t["decoder"])
        return ({f"encoder.{k}": v for k, v in enc.items()}
                | {f"decoder.{k}": v for k, v in dec.items()})

    return _Layout(to_tree, from_tree)


class _Ema:
    """EMA shadow of the trained parameters (float32, on their device). It
    is what gets exported; the raw parameters stay in the checkpoints with
    the shadow beside them as ``extra_ema`` for an exact resume."""

    def __init__(self, decay: float, module: torch.nn.Module,
                 restored: dict | None = None):
        self.decay = float(decay)
        self.params = {
            name: (restored[name].to(p.device, p.dtype).clone()
                   if restored is not None else p.detach().clone())
            for name, p in module.named_parameters()}

    @torch.no_grad()
    def update(self, module: torch.nn.Module, step: int) -> None:
        """``e = e * dt + p * (1 - dt)`` with the decay warmup ``dt = min(d,
        (1 + t) / (10 + t))`` on the global step ``t`` (so a resume
        continues it): without it a fresh run's export would keep d^steps of
        the random init. float32, rounded as XLA fuses it: ``p * (1 - dt)``
        rounded, then one fused multiply-add (exact in float64 here)."""
        f32 = np.float32
        dt = min(f32(self.decay), f32(1.0 + step) / f32(10.0 + step))
        om = float(f32(1.0) - dt)
        params = dict(module.named_parameters())
        for name, e in self.params.items():
            e.copy_(e.double() * float(dt)
                    + (params[name].detach() * om).double())


def _partial_merge(dst, src, path=""):
    """Copy every leaf of the flax tree ``src`` into ``dst`` where the key
    path exists in ``dst`` with the same shape; other leaves of ``dst``
    keep their fresh init. Returns (merged, copied paths, skipped paths)."""
    if isinstance(dst, dict):
        merged, copied, skipped = {}, [], []
        src = src if isinstance(src, dict) else {}
        for k, v in dst.items():
            if k in src:
                m, c, s = _partial_merge(v, src[k], f"{path}/{k}")
                merged[k] = m
                copied += c
                skipped += s
            else:
                merged[k] = v
                skipped.append(f"{path}/{k}")
        return merged, copied, skipped
    if src is not None and np.shape(dst) == np.shape(src):
        return np.asarray(src).astype(np.asarray(dst).dtype), [path], []
    return dst, [], [path]


def _deepen_remap(src_arch: str, dst_arch: str):
    """(rename, extra) for growing a basic-block ResNet deeper with function
    preservation: flax numbers ``BasicBlock_N`` across stages, so blocks
    map stage-aligned (dst stage s block j takes src stage s block j) and
    the dst blocks without a source are listed in ``extra``; zeroing an
    extra block's last GroupNorm makes it an identity. None when the archs
    are not a compatible basic/basic deepening."""
    if src_arch not in ARCHS or dst_arch not in ARCHS:
        return None
    skind, sstages, sstem, _ = ARCHS[src_arch]
    dkind, dstages, dstem, _ = ARCHS[dst_arch]
    if (skind, dkind) != ("basic", "basic") or sstem != dstem \
            or len(sstages) != len(dstages) \
            or any(d < s for s, d in zip(sstages, dstages)):
        return None
    rename, extra = {}, []
    si = di = 0
    for sn, dn in zip(sstages, dstages):
        for j in range(dn):
            if j < sn:
                rename[f"BasicBlock_{di}"] = f"BasicBlock_{si + j}"
            else:
                extra.append(f"BasicBlock_{di}")
            di += 1
        si += sn
    return rename, extra


def _partial_warm_start(params: dict, model_dir: Path,
                        dst_encoder_arch: str | None = None) -> dict:
    """Shape-matched warm start of the captioner's flax tree ``params``
    ({"encoder", "decoder"}) from a possibly different architecture's model
    dir; a compatible basic-ResNet deepening maps its blocks stage-aligned
    and starts the extra blocks as identities (:func:`_deepen_remap`)."""
    def raw(name):
        t = read_msgpack(model_dir / name)
        return t.get("params", t)

    remap = None
    cfg_p = model_dir / "configs_strokes.json"
    if dst_encoder_arch and cfg_p.exists():
        src_arch = json.loads(cfg_p.read_text()).get("encoder_arch")
        if src_arch and src_arch != dst_encoder_arch:
            remap = _deepen_remap(src_arch, dst_encoder_arch)
            if remap:
                log.info("deepen warm start: %s -> %s, %d blocks "
                         "stage-mapped, %d extra blocks zero-init to "
                         "identity", src_arch, dst_encoder_arch,
                         len(remap[0]), len(remap[1]))
    out = {}
    for part, fname in (("encoder", "strokes_encoder.msgpack"),
                        ("decoder", "strokes_decoder.msgpack")):
        src = raw(fname)
        if part == "encoder" and remap:
            src = {**{k: v for k, v in src.items()
                      if not k.startswith("BasicBlock_")},
                   **{k: src[v] for k, v in remap[0].items()}}
        merged, copied, skipped = _partial_merge(params[part], src)
        if part == "encoder" and remap:
            for blk in remap[1]:
                gn = merged[blk]["GroupNorm_1"]
                gn["scale"] = np.zeros_like(gn["scale"])
                gn["bias"] = np.zeros_like(gn["bias"])
        log.info("partial warm start %s from %s: %d leaves copied (%d "
                 "fresh)", part, model_dir, len(copied), len(skipped))
        if skipped:
            log.info("  fresh-init (first 8): %s", skipped[:8])
        out[part] = merged
    return out


def _restore_with_ema(last: Path, ema_decay: float):
    """(step, params tree, opt tree, EMA tree or None); the EMA slot is None
    when the EMA is off or the checkpoint has none."""
    step, params, opt, extras = restore_checkpoint(
        last, ("ema",) if ema_decay > 0.0 else ())
    return step, params, opt, extras.get("ema")


def _resume(module, optimizer, layout: _Layout, ckpt_dir: Path,
            ema_decay: float, name: str):
    """Load the newest checkpoint of ``ckpt_dir``, if any, into ``module``
    and ``optimizer``; returns (start step, the EMA shadow or None)."""
    last = latest_checkpoint(ckpt_dir)
    if last is None:
        return 0, None
    step, params, opt, ema = _restore_with_ema(last, ema_decay)
    module.load_state_dict(layout.from_tree(params))
    load_opt_state(optimizer, module, layout.from_tree, opt)
    log.info("resumed %s from %s (step %d)", name, last, step)
    return step, (layout.from_tree(ema) if ema is not None else None)


class _MeshBatches:
    """The batches of a run over a mesh: with ``per_rank`` (``--distributed``)
    the first rank of each tp group draws its group's batch and sends it to
    the others, as the ranks of one tp group compute on the same rows;
    else the mesh's first rank draws each global batch and sends it to
    every rank, and each keeps the rows of its dp index. Over gloo."""

    def __init__(self, make_loader, mesh, per_rank: bool):
        self.mesh, self.per_rank = mesh, per_rank
        self.axis = "tp_host" if per_rank else "host"
        first = (mesh.tp_index == 0 if per_rank
                 else mesh.rank == int(mesh.ranks.ravel()[0]))
        self.loader = make_loader() if first else None

    def __iter__(self):
        it = iter(self.loader) if self.loader is not None else None
        while True:
            batch = self.mesh.broadcast_object(
                next(it, None) if it is not None else None, self.axis)
            if batch is None:
                return
            yield batch if self.per_rank else tuple(
                np.asarray(a)[self.mesh.rows(len(a))] for a in batch)

    def close(self):
        if self.loader is not None:
            self.loader.close()


def _data(make, num_workers: int, mesh, per_rank: bool):
    """The loader of a run: whole batches on one device, and per process
    under ``--distributed`` (``per_rank``) without tp; else
    :class:`_MeshBatches`."""
    loader = lambda: PrefetchLoader(make, num_workers=num_workers)
    if mesh is None or mesh.size == 1 or (per_rank
                                          and mesh.shape["tp"] == 1):
        return loader()
    return _MeshBatches(loader, mesh, per_rank)


def _run(name: str, module, optimizer, layout: _Layout, step_fn, data,
         steps: int, start_step: int, ema: _Ema | None, ckpt_dir: Path,
         ckpt_every: int, ckpt_keep: int, log_every: int,
         writer: bool = True) -> TrainResult:
    """The steps from ``start_step`` to ``steps``: a batch from the loader,
    one update, the EMA, the log line every ``log_every`` steps and a
    checkpoint every ``ckpt_every`` steps and at the end (only where
    ``writer``: the rank that writes). Each step's loss is read back, so
    the step's seconds include its device time."""
    losses, wait_s, step_s = [], 0.0, 0.0
    t_log = time.time()
    it = iter(data)
    try:
        for i in range(start_step, steps):
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            losses.append(float(step_fn(batch, i)))
            step_s += time.perf_counter() - t1
            wait_s += t1 - t0
            if ema is not None:
                ema.update(module, i + 1)
            if (i + 1) % log_every == 0:
                log.info("%s step %d loss %.4f (%.2f steps/s)", name, i + 1,
                         losses[-1], log_every / max(time.time() - t_log,
                                                     1e-9))
                t_log = time.time()
            if (writer or layout.collective) and (
                    (i + 1) % ckpt_every == 0 or i + 1 == steps):
                extras = ({"ema": layout.to_tree(ema.params)}
                          if ema is not None else None)
                params = layout.to_tree(module.state_dict())
                opt = opt_state_tree(optimizer, module, layout.to_tree)
                if writer:
                    save_checkpoint(ckpt_dir, i + 1, params, opt,
                                    extras=extras, keep_last=ckpt_keep)
    finally:
        data.close()
    if ema is not None:
        log.info("exporting EMA(decay=%g) shadow params", ema.decay)
        exported = ema.params
    else:
        exported = module.state_dict()
    return TrainResult(layout.whole(exported), losses, start_step, wait_s,
                       step_s)


def _placement(mesh, device):
    """(device, mesh or None, whether this rank writes)."""
    if mesh is None:
        return resolve_device(device), None, True
    return resolve_device(mesh.device), mesh, mesh.rank == 0


def _check_trainable(bin_config: BinarizerConfig | None = None,
                     se_config: StrokesConfig | None = None) -> None:
    """Batch norms' running statistics and the projection head are not
    trained (nor by the JAX trainer): such a model loads and runs, but a
    training run would export it without them."""
    if (bin_config is not None and bin_config.norm == "batch") or (
            se_config is not None and (se_config.encoder_norm == "batch"
                                       or se_config.projection_dim)):
        raise NotImplementedError(
            "training a batch-norm model or a projection head is not "
            "supported")


def train_binarizer(config: BinarizerConfig, steps: int, batch_size: int,
                    out_dir: str | Path, lr: float = 3e-4, seed: int = 0,
                    ckpt_every: int = 200, ckpt_keep: int = 0,
                    log_every: int = 25, mesh=None,
                    data_dir: str | Path | None = None,
                    line_style: str = "mixed", ruled: float = 0.0,
                    narrow: float = 0.0,
                    init_from: str | Path | None = None,
                    ema_decay: float = 0.0, device=None,
                    num_workers: int = 2,
                    per_rank_data: bool = False,
                    data_seed: int | None = None) -> TrainResult:
    """Train the attention-UNet on synthetic lines (or ``data_dir``'s real
    pairs) and export it into ``out_dir``. ``mesh``: this rank's
    data-parallel ``parallel.mesh.Mesh`` (the run then takes its device);
    ``per_rank_data``: each rank draws its own ``batch_size`` rows (from
    its own ``data_seed``) instead of its rows of one global batch. The
    model starts from ``seed``, so every rank starts from the same
    weights; the data comes from ``data_seed`` (default ``seed``)."""
    _check_trainable(bin_config=config)
    device, mesh, writer = _placement(mesh, device)
    data_seed = seed if data_seed is None else data_seed
    model = init_binarizer(config, seed)
    layout = _unet_layout(config)
    if init_from is not None:
        model.load_state_dict(layout.from_tree(read_msgpack(
            Path(init_from) / "binarizer.msgpack")["params"]))
        log.info("warm-started binarizer from %s", init_from)
    model.to(device).train()
    layout = _tp_layout(layout, model, mesh)
    optimizer = make_optimizer(model)
    ckpt_dir = Path(out_dir) / "ckpt_binarizer"
    start_step, ema_restored = _resume(model, optimizer, layout, ckpt_dir,
                                       ema_decay, "binarizer")
    ema = (_Ema(ema_decay, model, ema_restored) if ema_decay > 0.0
           else None)
    update = make_binarizer_train_step(model, optimizer,
                                       lambda c: lr_at(c, lr, steps), mesh)

    def step_fn(batch, i):
        tiles, masks = batch
        return update(torch.from_numpy(tiles).to(device),
                      torch.from_numpy(masks).to(device))

    if data_dir is not None:
        from stroke_derenderer_tpu_torch.data.real import real_tile_batches
        make = lambda w: real_tile_batches(
            data_dir, np.random.default_rng(data_seed + w), batch_size,
            config.height, config.width, config=config)
    else:
        from stroke_derenderer_tpu_torch.data.synthetic import tile_batches
        make = lambda w: tile_batches(np.random.default_rng(data_seed + w),
                                      batch_size, config.height, config.width,
                                      style=line_style, ruled=ruled,
                                      narrow=narrow)
    result = _run("binarizer", model, optimizer, layout, step_fn,
                  _data(make, num_workers, mesh, per_rank_data), steps,
                  start_step, ema, ckpt_dir, ckpt_every, ckpt_keep,
                  log_every, writer)
    if writer:  # result.exported holds whole tensors
        save_model_files(out_dir, layout.to_tree(result.exported), config)
        log.info("binarizer exported to %s", out_dir)
    if mesh is not None:
        mesh.barrier()
    return result


def _captioner_data(config: StrokesConfig, batch_size: int, seed: int,
                    seq_len: int, glyph_mode: str, glyph_style: str,
                    data_dir, cache_dir, real_frac: float):
    """The loader's iterator factory for the captioner's data source:
    ``data_dir`` + ``cache_dir`` interleaved at ``real_frac`` (both raw
    uint8), ``data_dir`` alone, ``cache_dir`` alone (raw uint8), or live
    synthetic glyphs (partitioned, or direct with ``glyph_mode``
    "direct")."""
    from stroke_derenderer_tpu_torch.data import synthetic
    if data_dir is not None and cache_dir is not None:
        from stroke_derenderer_tpu_torch.data.cache import (
            cached_glyph_batches,
        )
        from stroke_derenderer_tpu_torch.data.real import real_glyph_batches

        def make(w):
            pick = np.random.default_rng(seed + w + 7)
            gr = real_glyph_batches(
                data_dir, np.random.default_rng(seed + w + 101),
                batch_size, seq_len, config=config, raw=True)
            gc = cached_glyph_batches(
                cache_dir, np.random.default_rng(seed + w), batch_size,
                seq_len, config=config, raw=True)
            while True:
                yield next(gr if pick.random() < real_frac else gc)
        return make
    if data_dir is not None:
        from stroke_derenderer_tpu_torch.data.real import real_glyph_batches
        return lambda w: real_glyph_batches(
            data_dir, np.random.default_rng(seed + w), batch_size, seq_len,
            config=config)
    if cache_dir is not None:
        from stroke_derenderer_tpu_torch.data.cache import (
            cached_glyph_batches,
        )
        return lambda w: cached_glyph_batches(
            cache_dir, np.random.default_rng(seed + w), batch_size, seq_len,
            config=config, raw=True)
    if glyph_mode == "partitioned":
        return lambda w: synthetic.partitioned_glyph_batches(
            np.random.default_rng(seed + w), batch_size, seq_len,
            style=glyph_style)
    return lambda w: synthetic.glyph_batches(
        np.random.default_rng(seed + w), batch_size, config.image_size,
        seq_len)


def train_captioner(config: StrokesConfig, steps: int, batch_size: int,
                    out_dir: str | Path, lr: float = 3e-4, seed: int = 0,
                    seq_len: int = 96, ckpt_every: int = 200,
                    ckpt_keep: int = 0, log_every: int = 25,
                    glyph_mode: str = "partitioned",
                    init_from: str | Path | None = None,
                    init_partial: str | Path | None = None,
                    coord_sigma: float = 0.0, sample_prob: float = 0.0,
                    glyph_style: str = "mixed", mesh=None,
                    data_dir: str | Path | None = None,
                    cache_dir: str | Path | None = None,
                    ema_decay: float = 0.0, ss_ramp_frac: float = 1.0,
                    real_frac: float = 0.5, device=None,
                    num_workers: int = 2,
                    per_rank_data: bool = False,
                    data_seed: int | None = None) -> TrainResult:
    """Train the ResNet encoder and the attentive decoder on glyph crops and
    export them into ``out_dir``. ``mesh``, ``per_rank_data`` and
    ``data_seed`` as in :func:`train_binarizer`; scheduled sampling draws
    its mask over the whole batch from ``seed``."""
    _check_trainable(se_config=config)
    device, mesh, writer = _placement(mesh, device)
    data_seed = seed if data_seed is None else data_seed
    layout = _captioner_layout(config)
    encoder, decoder = init_strokes(config, seed)
    captioner = Captioner(encoder, decoder)
    if init_from is not None:
        p = Path(init_from)
        captioner.load_state_dict(layout.from_tree({
            "encoder": read_msgpack(p / "strokes_encoder.msgpack")["params"],
            "decoder": read_msgpack(p / "strokes_decoder.msgpack")["params"],
        }))
        log.info("warm-started captioner from %s", p)
    elif init_partial is not None:
        captioner.load_state_dict(layout.from_tree(_partial_warm_start(
            layout.to_tree(captioner.state_dict()), Path(init_partial),
            config.encoder_arch)))
    decoder.requires_grad_(True)
    captioner.to(device).train()
    layout = _tp_layout(layout, captioner, mesh)
    optimizer = make_optimizer(captioner)
    ckpt_dir = Path(out_dir) / "ckpt_captioner"
    start_step, ema_restored = _resume(captioner, optimizer, layout,
                                       ckpt_dir, ema_decay, "captioner")
    ema = (_Ema(ema_decay, captioner, ema_restored) if ema_decay > 0.0
           else None)
    raw = cache_dir is not None  # cached batches ship uint8 crops
    update = make_captioner_train_step(
        captioner, optimizer, lambda c: lr_at(c, lr, steps),
        enc_image_size=config.encode_image_size, coord_sigma=coord_sigma,
        sample_prob=sample_prob, total_steps=steps,
        ss_ramp_frac=ss_ramp_frac, normalize_on_device=raw,
        mean=config.mean, std=config.std, seed=seed, mesh=mesh)

    def step_fn(batch, i):
        crops, tok_in, tok_out = (torch.from_numpy(np.ascontiguousarray(a))
                                  .to(device) for a in batch)
        return update(crops, tok_in.long(), tok_out.long(), step_idx=i)

    make = _captioner_data(config, batch_size, data_seed, seq_len,
                           glyph_mode, glyph_style, data_dir, cache_dir,
                           real_frac)
    result = _run("captioner", captioner, optimizer, layout, step_fn,
                  _data(make, num_workers, mesh, per_rank_data), steps,
                  start_step, ema, ckpt_dir, ckpt_every, ckpt_keep,
                  log_every, writer)
    if writer:
        tree = layout.to_tree(result.exported)
        save_model_files(out_dir, encoder_tree=tree["encoder"],
                         decoder_tree=tree["decoder"], strokes_config=config)
        log.info("captioner exported to %s", out_dir)
    if mesh is not None:
        mesh.barrier()
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Train the binarizer and/or the captioner (PyTorch)")
    ap.add_argument("--model", choices=["binarizer", "captioner", "both"],
                    default="both")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default="./models")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    ap.add_argument("--bin-features", default=None,
                    help="comma list, e.g. 16,32,64")
    ap.add_argument("--encoder-arch", default=None)
    ap.add_argument("--se-dims", default=None, metavar="E,A,D",
                    help="captioner embed,attention,decoder dims (comma "
                         "list); small values make smoke training cheap")
    ap.add_argument("--seq-len", type=int, default=96,
                    help="teacher-forcing sequence length (captioner)")
    ap.add_argument("--init-partial", default=None, metavar="MODELDIR",
                    help="shape-matched warm start from a possibly "
                         "different-architecture model dir: leaves whose "
                         "path and shape match are copied, the rest keep "
                         "their fresh init. The new architecture comes from "
                         "--encoder-arch/--se-dims (the source dir's config "
                         "JSON is not adopted, unlike --init-from). "
                         "Captioner only.")
    ap.add_argument("--init-from", default=None, metavar="MODELDIR",
                    help="warm-start params from a model dir (binarizer "
                         "and/or captioner); the dir's config JSONs are "
                         "adopted so architectures match the weights")
    ap.add_argument("--coord-smoothing", type=float, default=0.0,
                    help="Gaussian sigma (px) for coordinate-aware label "
                         "smoothing of vertex tokens (captioner)")
    ap.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                    help="exponential moving average of the trained params "
                         "(e.g. 0.999); the EMA shadow is exported as the "
                         "model and checkpointed for exact resume")
    ap.add_argument("--ss-ramp-frac", type=float, default=1.0,
                    help="fraction of the run over which scheduled sampling "
                         "ramps to its nominal rate (1.0 = whole run)")
    ap.add_argument("--scheduled-sampling", type=float, default=0.0,
                    help="final probability of feeding the model's own "
                         "previous prediction instead of the gold token "
                         "(ramped linearly; captioner)")
    ap.add_argument("--real-frac", type=float, default=0.5,
                    help="when both --data and --cache are given, the "
                         "fraction of batches drawn from --data")
    ap.add_argument("--cache", default=None, metavar="DIR",
                    help="captioner: train from a pre-generated glyph cache "
                         "(data/cache.py) instead of live synthesis")
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="train on real labeled pairs from DIR "
                         "(<stem>.png + <stem>_STROKES.json "
                         "[+ <stem>_BINARIZED.png], data/real.py) instead "
                         "of synthetic rendering")
    ap.add_argument("--glyph-style",
                    choices=["mixed", "smooth", "hand", "letters"],
                    default="mixed",
                    help="stroke family mix for captioner data")
    ap.add_argument("--line-style",
                    choices=["mixed", "smooth", "hand", "letters"],
                    default="mixed",
                    help="stroke family for binarizer line rendering")
    ap.add_argument("--narrow", type=float, default=0.0, metavar="P",
                    help="probability a binarizer training tile is a "
                         "right-zero-padded narrow line")
    ap.add_argument("--ruled", type=float, default=0.0, metavar="P",
                    help="probability a binarizer training line renders on "
                         "ruled colored paper")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="data-parallel training over N ranks, one process "
                         "each (parallel/mesh.py): the global batch of "
                         "--batch rows sharded on dp, the gradients summed "
                         "over dp. 0/1 = single device.")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel extent within --mesh or "
                         "--distributed: conv kernels and enc_att "
                         "column-parallel over tp ranks (default 1)")
    ap.add_argument("--ckpt-every", type=int, default=200,
                    help="checkpoint cadence in steps (default 200)")
    ap.add_argument("--ckpt-keep", type=int, default=0, metavar="K",
                    help="prune all but the newest K checkpoints "
                         "(0 = keep everything)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training: join the process group "
                         "(parallel.multihost.initialize, from the "
                         "SD_COORDINATOR/SD_NUM_PROCESSES/SD_PROCESS_ID "
                         "environment), build the ('dp', 'tp') mesh over "
                         "every rank and draw per-process batches: --batch "
                         "is the PER-PROCESS batch size; each process draws "
                         "a distinct data stream.")
    return ap.parse_args(argv)


def _train_rank(argv, num_workers: int) -> dict:
    """One rank of ``--mesh``: :func:`train` in the rank's process group;
    rank 0 logs. The results come back with their tensors on the CPU."""
    if dist.get_rank() == 0 and not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname).1s %(name)s: "
                                   "%(message)s", datefmt="%H:%M:%S")
        log.setLevel(logging.INFO)
    out = train(argv, num_workers)
    return {k: dataclasses.replace(r, exported={
        n: t.detach().cpu() for n, t in r.exported.items()})
        for k, r in out.items()}


def train(argv=None, num_workers: int = 2) -> dict:
    """Run the command line's training and return {"binarizer" and/or
    "captioner": :class:`TrainResult`} (under ``--mesh``, rank 0's)."""
    args = parse_args(argv)
    mesh, data_seed, per_rank = None, args.seed, False
    if args.distributed:
        multihost.initialize(kind=args.device)
        mesh = multihost.global_mesh(tp=args.tp)
        data_seed = multihost.fold_in_process(args.seed, mesh.dp_index)
        per_rank = True
        log.info("distributed: process %d/%d, global (%d, %d) dp/tp mesh",
                 multihost.process_index(), multihost.process_count(),
                 mesh.shape["dp"], mesh.shape["tp"])
    elif args.mesh and args.mesh > 1:
        if not dist.is_initialized():
            cpu = torch.device(args.device).type != "cuda"
            return multihost.spawn(
                _train_rank, args.mesh,
                multihost.rank_devices(args.device, args.mesh),
                args=(argv, num_workers), threads=max(
                    1, (os.cpu_count() or 1) // args.mesh) if cpu else None,
                timeout_s=24 * 3600.0)[0]
        mesh = make_mesh(args.mesh, tp=args.tp)
        log.info("training on a (%d, %d) dp/tp mesh", mesh.shape["dp"],
                 mesh.shape["tp"])
    bin_kw = {}
    if args.bin_features:
        feats = tuple(int(x) for x in args.bin_features.split(","))
        bin_kw = {"features": feats, "bottleneck": feats[-1] * 2}
    se_kw = {"encoder_arch": args.encoder_arch} if args.encoder_arch else {}
    if args.se_dims:
        e, a, d = (int(x) for x in args.se_dims.split(","))
        se_kw.update(embed_dim=e, attention_dim=a, decoder_dim=d)
    # A warm start adopts the model dir's config JSONs (JSON over flags),
    # so the architecture matches the weights.
    bin_cfg_json = se_cfg_json = None
    if args.init_from:
        p = Path(args.init_from) / "configs_binarizer.json"
        bin_cfg_json = p if p.exists() else None
        p = Path(args.init_from) / "configs_strokes.json"
        se_cfg_json = p if p.exists() else None
    results = {}
    if args.model in ("binarizer", "both"):
        results["binarizer"] = train_binarizer(
            BinarizerConfig.from_json(bin_cfg_json, **bin_kw), args.steps,
            args.batch, args.out, args.lr, args.seed, mesh=mesh,
            per_rank_data=per_rank, data_seed=data_seed, data_dir=args.data,
            line_style=args.line_style, ruled=args.ruled,
            narrow=args.narrow, init_from=args.init_from,
            ema_decay=args.ema, ckpt_every=args.ckpt_every,
            ckpt_keep=args.ckpt_keep, device=args.device,
            num_workers=num_workers)
    if args.model in ("captioner", "both"):
        results["captioner"] = train_captioner(
            StrokesConfig.from_json(se_cfg_json, **se_kw), args.steps,
            args.batch, args.out, args.lr, args.seed, seq_len=args.seq_len,
            mesh=mesh, per_rank_data=per_rank, data_seed=data_seed,
            init_from=args.init_from, init_partial=args.init_partial,
            coord_sigma=args.coord_smoothing,
            sample_prob=args.scheduled_sampling,
            glyph_style=args.glyph_style, data_dir=args.data,
            cache_dir=args.cache, ema_decay=args.ema,
            ss_ramp_frac=args.ss_ramp_frac, real_frac=args.real_frac,
            ckpt_every=args.ckpt_every, ckpt_keep=args.ckpt_keep,
            device=args.device, num_workers=num_workers)
    return results


def main(argv=None, num_workers: int = 2) -> int:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname).1s %(name)s: "
                                   "%(message)s", datefmt="%H:%M:%S")
    log.setLevel(logging.INFO)
    train(argv, num_workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
