"""The port's mesh layer in one process, against the JAX package's
``parallel`` on its 8 virtual CPU devices: mesh shapes and the dp * tp
assert, the tile layout rule, the parameter specs on the real binarizer
and captioner trees (with the replicate-when-tp-does-not-divide fallback
of the odd vocabulary), the lcm padding of a sharded batch, the sharded
decode wrappers' divisibility error, the multi-host runtime's rules
(half-specified fleets, tp groups inside a host, the data-seed stride) and
a one-process group brought up from the ``SD_*`` values."""

from __future__ import annotations

import importlib
import math
import socket
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stroke_derenderer_tpu import parallel as jpar
from stroke_derenderer_tpu.kernels import fused_beam as jfb
from stroke_derenderer_tpu.kernels import fused_decode as jfd
from stroke_derenderer_tpu_torch.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu_torch.kernels import fused_beam as tfb
from stroke_derenderer_tpu_torch.kernels import fused_decode as tfd
from stroke_derenderer_tpu_torch.parallel import mesh as tmesh
from stroke_derenderer_tpu_torch.parallel import multihost as tmh
from stroke_derenderer_tpu_torch.pipeline.binarize import Binarizer
from stroke_derenderer_tpu_torch.weights import (
    init_strokes, read_msgpack, to_flax_decoder,
)

MODELS = Path(__file__).resolve().parent.parent / "models_demo"
# Imported by name: the JAX package's ``parallel`` resolves ``multihost``
# lazily.
jmh = importlib.import_module("stroke_derenderer_tpu.parallel.multihost")


@pytest.mark.parametrize("n,dp,tp", [(8, None, 1), (8, None, 2),
                                     (4, 2, 2), (2, 1, 2), (1, None, 1)])
def test_mesh_shapes_as_jax(n, dp, tp):
    got = tmesh.make_mesh(n, dp=dp, tp=tp)
    want = jpar.make_mesh(n, dp=dp, tp=tp)
    assert got.shape == {"dp": int(want.shape["dp"]),
                         "tp": int(want.shape["tp"])}
    # Row-major: rank = dp_index * tp + tp_index, as make_mesh reshapes
    # the JAX device list.
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids - ids.min())
    # Without a process group a mesh of one runs alone; a larger one only
    # describes a layout.
    assert (got.rank, got.dp_index) == ((0, 0) if n == 1 else (None, None))


@pytest.mark.parametrize("n,dp,tp", [(8, 3, 2), (6, 4, 1)])
def test_mesh_dp_times_tp_must_be_n(n, dp, tp):
    for make in (tmesh.make_mesh, jpar.make_mesh):
        with pytest.raises(AssertionError, match=r"dp\*tp"):
            make(n, dp=dp, tp=tp)


@pytest.mark.parametrize("tp,width,ndim", [(1, 384, 4), (2, 384, 4),
                                           (4, 384, 4), (3, 384, 4),
                                           (5, 384, 4), (2, 384, 3)])
def test_tile_sharding_as_jax(tp, width, ndim):
    got = tmesh.tile_sharding(tmesh.make_mesh(tp * (2 if tp < 4 else 1),
                                              tp=tp), ndim, width)
    want = jpar.tile_sharding(jpar.make_mesh(tp * (2 if tp < 4 else 1),
                                             tp=tp), ndim, width)
    assert got == tuple(want.spec)


def _trees():
    """The real binarizer and captioner parameter trees of models_demo,
    and a full-width decoder's (V = 451)."""
    trees = {name: read_msgpack(MODELS / f"{name}.msgpack")["params"]
             for name in ("binarizer", "strokes_encoder", "strokes_decoder")}
    _, dec = init_strokes(StrokesConfig(encoder_arch="tiny"), 0)
    trees["decoder_full"] = to_flax_decoder(dec.state_dict())
    return trees


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def test_param_specs_as_jax():
    """``param_partition_specs`` and the effective layout of
    ``shard_params`` at tp = 2 and 4, leaf for leaf as the JAX package's
    on the same trees; the embedding and the head stay replicated at even
    tp (the vocabulary is odd), the 4-D conv kernels and ``enc_att`` are
    sharded."""
    for name, tree in _trees().items():
        got = dict(_leaves(tmesh.param_partition_specs(tree)))
        want = dict(_leaves(jpar.mesh.param_partition_specs(tree)))
        assert got.keys() == want.keys()
        for path in got:
            assert got[path] == tuple(want[path]), (name, path)
        for tp in (2, 4):
            mesh = jpar.make_mesh(8, tp=tp)
            placed = dict(_leaves(jpar.shard_params(tree, mesh)))
            for path, leaf in _leaves(tree):
                spec = tuple(placed[path].sharding.spec)
                assert tmesh.effective_spec(path, leaf, tp) == spec, (
                    name, path, tp)
    dec = dict(_leaves(_trees()["decoder_full"]))
    emb = next(p for p in dec if "embedding" in p)
    fc = next(p for p in dec if p.endswith("fc/kernel"))
    att = next(p for p in dec if p.endswith("enc_att/kernel"))
    assert dec[emb].shape[0] == 451 and dec[fc].shape[1] == 451
    for tp in (2, 4):
        assert tmesh.effective_spec(emb, dec[emb], tp) == ()
        assert tmesh.effective_spec(fc, dec[fc], tp) == ()
        assert tmesh.effective_spec(att, dec[att], tp) == (None, "tp")


def test_shard_params_takes_the_rank_slice():
    tree = read_msgpack(MODELS / "binarizer.msgpack")["params"]
    for tp_index in (0, 1):
        mesh = types.SimpleNamespace(shape={"tp": 2}, tp_index=tp_index)
        local = dict(_leaves(tmesh.shard_params(tree, mesh)))
        for path, leaf in _leaves(tree):
            spec = tmesh.effective_spec(path, leaf, 2)
            want = (np.split(leaf, 2, axis=spec.index("tp"))[tp_index]
                    if spec else leaf)
            np.testing.assert_array_equal(local[path], want)
    emb = {"Embed_0": {"embedding": np.zeros((452, 4), np.float32)}}
    with pytest.raises(NotImplementedError, match="output axis"):
        tmesh.shard_params(emb, types.SimpleNamespace(shape={"tp": 2},
                                                      tp_index=0))


def test_shard_columns_follows_the_jax_layout():
    """``shard_columns`` at tp = 2 cuts exactly the kernels the JAX layout
    shards (as many parameters, each to half its output axis), and raises
    where tp would shard the embedding's vocabulary."""
    from stroke_derenderer_tpu_torch.config import BinarizerConfig
    from stroke_derenderer_tpu_torch.train.steps import Captioner
    from stroke_derenderer_tpu_torch.weights import (
        init_binarizer, to_flax_encoder, to_flax_unet,
    )
    mesh = types.SimpleNamespace(shape={"tp": 2}, tp_index=1)
    unet = init_binarizer(BinarizerConfig(features=(8, 16), bottleneck=16),
                          0)
    enc, dec = init_strokes(StrokesConfig(encoder_arch="tiny",
                                          embed_dim=16, attention_dim=16,
                                          decoder_dim=16), 0)
    flax = {"unet": to_flax_unet(unet.state_dict(), 2),
            "captioner": {"encoder": to_flax_encoder(enc.state_dict(),
                                                     "basic"),
                          "decoder": to_flax_decoder(dec.state_dict())}}
    for name, module in (("unet", unet), ("captioner", Captioner(enc, dec))):
        whole = {k: tuple(v.shape) for k, v in module.named_parameters()}
        sharded = tmesh.shard_columns(module, mesh)
        want = [p for p, leaf in _leaves(flax[name])
                if tmesh.effective_spec(p, leaf, 2)]
        assert len(sharded) == len(want) > 0, name
        for pname, (axis, n) in sharded.items():
            got = dict(module.named_parameters())[pname].shape
            assert whole[pname][axis] == n and got[axis] == n // 2
    _, odd = init_strokes(StrokesConfig(encoder_arch="tiny", embed_dim=16,
                                        attention_dim=16, decoder_dim=16,
                                        image_size=55), 0)  # V = 113
    with pytest.raises(NotImplementedError, match="vocabulary"):
        tmesh.shard_columns(odd, types.SimpleNamespace(shape={"tp": 113},
                                                       tp_index=0))


@pytest.mark.parametrize("bucket", [1, 8, 6])
@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_padded_batch_is_lcm_padding(bucket, dp):
    for n in range(0, 40):
        m = math.lcm(bucket, dp)
        assert tmesh.padded_batch(n, bucket, dp) == -(-n // m) * m


@pytest.mark.parametrize("kernel", ["greedy", "beam"])
def test_sharded_wrappers_refuse_a_batch_dp_does_not_divide(kernel):
    """The JAX package's message, before any collective."""
    _, dec = init_strokes(StrokesConfig(encoder_arch="tiny", embed_dim=16,
                                        attention_dim=16, decoder_dim=16), 0)
    seq = torch.zeros((3, 4, 512))
    port = (tfd.fused_greedy_decode_sharded if kernel == "greedy"
            else tfb.fused_beam_decode_sharded)
    with pytest.raises(ValueError) as got:
        port(dec, seq, 4, tmesh.make_mesh(2), batch=5)
    jax_fn = (jfd.fused_greedy_decode_sharded if kernel == "greedy"
              else jfb.fused_beam_decode_sharded)
    with pytest.raises(ValueError) as want:
        jax_fn(None, None, np.zeros((5, 4, 8)), 4, jpar.make_mesh(2))
    assert str(got.value) == str(want.value) == "batch 5 not divisible by dp=2"
    with pytest.raises(ValueError, match="more than"):
        port(dec, seq, 4, tmesh.make_mesh(2), batch=4)


def test_binarizer_refuses_a_width_split_its_pooling_cannot_take():
    cfg = BinarizerConfig(features=(8, 16, 32), bottleneck=16, width=200,
                          compute_dtype="float32")
    with pytest.raises(ValueError, match="pooling"):
        Binarizer(cfg, device="cpu", mesh=tmesh.make_mesh(2, dp=1, tp=2))
    # tp that does not divide the width: dp only, as tile_sharding says.
    b = Binarizer(BinarizerConfig(features=(8,), bottleneck=16, width=201),
                  device="cpu", mesh=tmesh.make_mesh(2, dp=1, tp=2))
    assert b._tp == 1


@pytest.mark.parametrize("hosts,tp,ok", [
    (["a"] * 4, 2, True), (["a", "a", "b", "b"], 2, True),
    (["a", "b", "a", "b"], 2, False), (["a", "a", "a", "b"], 2, False),
    (["a"] * 2, 4, False), (["a"] * 6, 3, True)])
def test_global_mesh_keeps_tp_groups_on_one_host(monkeypatch, hosts, tp,
                                                 ok):
    monkeypatch.setattr(tmh, "process_count", lambda: len(hosts))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None), hosts))
    monkeypatch.setattr(tmesh, "make_mesh",
                        lambda n, tp=1: (n // tp, tp))
    if ok:
        assert tmh.global_mesh(tp) == (len(hosts) // tp, tp)
    else:
        with pytest.raises(ValueError, match="host"):
            tmh.global_mesh(tp)


def test_global_mesh_alone_and_the_jax_rule():
    assert tmh.global_mesh(1).shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="must divide"):
        tmh.global_mesh(2)
    with pytest.raises(ValueError, match="must divide"):
        jmh.global_mesh(3)  # 8 local devices


def test_fold_in_process_stride_as_jax():
    assert tmh.SEED_STRIDE == 100_003
    assert tmh.fold_in_process(7) == jmh.fold_in_process(7) == 7
    assert tmh.fold_in_process(7, 3) == 7 + 3 * 100_003


@pytest.mark.parametrize("devices,hosts,backend", [
    (["cuda:0", "cuda:1"], None, "nccl"),
    (["cuda:0", "cuda:0"], None, "gloo"),
    (["cuda:0", "cuda:0"], ["a", "b"], "nccl"),
    (["cuda:0", "cuda:1", "cuda:1"], ["a", "a", "a"], "gloo"),
    (["cpu", "cpu"], ["a", "b"], "gloo"),
    (["cuda:0", "cpu"], None, "gloo")])
def test_backend_is_nccl_only_when_every_rank_has_a_card(devices, hosts,
                                                         backend):
    assert tmh.backend_for(devices, hosts) == backend


def test_initialize_refuses_half_a_fleet(monkeypatch):
    for var in ("SD_COORDINATOR", "SD_NUM_PROCESSES", "SD_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for kw in ({"coordinator": "h:1"}, {"num_processes": 2}):
        with pytest.raises(ValueError, match="must be given together"):
            tmh.initialize(**kw)
        with pytest.raises(ValueError, match="must be given together"):
            jmh.initialize(**kw)
    with pytest.raises(ValueError, match="process_id is required"):
        tmh.initialize("h:1", 2)


def test_initialize_one_process_group_from_the_environment(monkeypatch):
    """A fleet of one from the ``SD_*`` variables: the group comes up on
    gloo, a second call returns, the mesh over it is one rank, and its
    collectives are the identity."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("SD_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("SD_NUM_PROCESSES", "1")
    monkeypatch.setenv("SD_PROCESS_ID", "0")
    try:
        tmh.initialize(kind="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        tmh.initialize(kind="cpu")  # idempotent
        mesh = tmh.global_mesh()
        assert (mesh.rank, mesh.shape) == (0, {"dp": 1, "tp": 1})
        t = torch.arange(4.0)
        assert torch.equal(mesh.all_gather(mesh.all_sum(t)), t)
        np.testing.assert_array_equal(tmh.shard_host_batch(mesh, np.ones(
            (3, 2))), np.ones((3, 2)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmh._device = None
