"""The glyph encoder families of ``encoders/``: the readings of the two
configurations frozen as the harness gave them while the ResNet lived in
``counts``, ``harness/weights.py`` and ``reference/models.py`` (the
features held against a verbatim copy of that arithmetic, whose bits do
not depend on the host), and a toy family written into a directory of its
own, which a configuration reaches through every caller with no other
file touched."""

import hashlib
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

import counts
import encoders
from harness import cell as cells, check, weights
from harness.cell import ROOT
from reference import models, msgpack

CELLS = ("demo.batch_greedy", "upstream.batch_greedy", "demo.batch_beam")

# Frozen on the CPU: sha256 of every leaf (path, dtype, shape, bytes) in
# path order, the first 32 hex digits.
UPSTREAM_DRAWN = {"binarizer": "39119efb16184ddc29877fd6f9cdb5e1",
                  "encoder": "1267990d5024806b6ceff85c96221cab",
                  "projection": "2f51ca35ef9513ca8b8821c1050a7ab6",
                  "decoder": "8cd7e862a4069e4067dc5097e231bd21"}
ARCH_COUNTS = {"resnet18": {224: 3627122688, 64: 296091648, "width": 512},
               "resnet50": {224: 8174272512, 64: 667287552, "width": 2048}}
DECODE_BOUND_S = {("demo", 1): "0.0014840215798422648",
                  ("demo", 5): "0.007422122966299292",
                  ("upstream", 1): "0.0014840215798422648",
                  ("upstream", 5): "0.007422122966299292",
                  ("upstream_unprojected", 1): "0.002997141622034378"}
MFU = {"demo.batch_greedy": "0.3233424770496028",
       "upstream.batch_greedy": "0.7510666694240069",
       "demo.batch_beam": "0.6584480035683952"}


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in sorted(_flat(tree), key=lambda x: x[0]):
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f"{'/'.join(path)}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


def crops(n=3, size=224, seed=20):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 256, (n, size, size)),
                           dtype=torch.float32)


def calls():
    rng = np.random.default_rng(21)
    return [{"lines": 32, "tiles": 97, "rows": 480,
             "steps": rng.integers(1, 385, 480).tolist()},
            {"lines": 32, "tiles": 0, "rows": 0, "steps": []},
            {"lines": 31, "tiles": 88, "rows": 455,
             "steps": rng.integers(1, 385, 455).tolist()}]


def _config(name):
    return cells.load(f"{name}.batch_greedy").config


@pytest.fixture(scope="module")
def upstream_drawn(tmp_path_factory):
    return weights.random_model_dir(_config("upstream"), tmp_path_factory.mktemp("up"), "cpu")


def test_upstream_drawn_weights_frozen(upstream_drawn):
    assert {k: digest(v) for k, v in upstream_drawn.items() if v is not None} == UPSTREAM_DRAWN


def resnet_before_the_move(p, images):
    """``reference.models.resnet`` as it stood before the encoder became a
    family of ``encoders/``, kept verbatim: the same operations in the same
    order, so that on any host its bits are the moved ``forward``'s."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(models._norm(models._conv(x, p["stem"], 2, 3), p, 0, 8))
    x = F.max_pool2d(x, 3, 2, 1)
    bottleneck = "BottleneckBlock_0" in p
    name = "BottleneckBlock" if bottleneck else "BasicBlock"
    i = 0
    while f"{name}_{i}" in p:
        q = p[f"{name}_{i}"]
        n = 3 if bottleneck else 2
        stride = _stride_before_the_move(p, name, i)
        if bottleneck:
            y = F.relu(models._norm(models._conv(x, q["Conv_0"]), q, 0, 8))
            y = F.relu(models._norm(models._conv(y, q["Conv_1"], stride, 1), q, 1, 8))
            y = models._norm(models._conv(y, q["Conv_2"]), q, 2, 8)
        else:
            y = F.relu(models._norm(models._conv(x, q["Conv_0"], stride, 1), q, 0, 8))
            y = models._norm(models._conv(y, q["Conv_1"], 1, 1), q, 1, 8)
        res = x if "proj" not in q else models._norm(models._conv(x, q["proj"], stride), q, n, 8)
        x = F.relu(y + res)
        i += 1
    x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def _stride_before_the_move(p, name, i):
    if i == 0:
        return 1
    conv = "Conv_1" if name == "BottleneckBlock" else "Conv_0"
    prev = p[f"{name}_{i - 1}"][conv]["kernel"].shape[-1]
    return 2 if p[f"{name}_{i}"][conv]["kernel"].shape[-1] > prev else 1


@pytest.mark.parametrize("name,low", [(n, low) for n in ("demo", "upstream")
                                      for low in (None, "fp8")])
def test_reference_features_frozen(name, low, upstream_drawn):
    """The check's features (``check._features``, through the family and the
    projection) equal those of the encoder's arithmetic before the move,
    bit for bit, in float32 and under the fp8 control."""
    cfg = _config(name)
    trees = (upstream_drawn if name == "upstream"
             else weights.read_model_dir(ROOT / cfg["weights"], cfg))
    tw = {k: models.to_tensors(v, "cpu") if v is not None else None for k, v in trees.items()}
    x = crops()
    with torch.no_grad():
        f = check._features(tw, x, cfg["strokes"], low)
        with models.low_precision(low):
            want = resnet_before_the_move(
                tw["encoder"], models.normalize_crops(x, cfg["strokes"]["mean"],
                                                      cfg["strokes"]["std"]))
            if tw["projection"] is not None:
                want = models.dense(want, tw["projection"])
    assert f.shape == (3, 196, 512)
    assert torch.equal(f, want)


@pytest.mark.parametrize("arch", list(ARCH_COUNTS))
def test_resnet_counts_frozen(arch):
    fam = encoders.family(arch)
    s = {"encoder_arch": arch, "image_size": 224, "encode_image_size": 14}
    assert fam.width(s) == ARCH_COUNTS[arch]["width"]
    assert fam.positions(s) == 196
    for size in (224, 64):
        assert fam.flops(s | {"image_size": size}) == ARCH_COUNTS[arch][size]


@pytest.mark.parametrize("name,k", list(DECODE_BOUND_S))
def test_decode_bound_s_frozen(name, k):
    s = _config(name.split("_")[0])["strokes"]
    if name.endswith("_unprojected"):
        s = s | {"projection_dim": 0}
    assert repr(counts.decode_bound_s(calls(), s, k)) == DECODE_BOUND_S[name, k]


@pytest.mark.parametrize("name", CELLS)
def test_mfu_frozen(name):
    c = cells.load(name)
    run = types.SimpleNamespace(config=c.config, traffic=c.traffic, calls=calls(), window_s=1.75)
    assert repr(cells.metric_reader("mfu")(run)) == MFU[name]


# A family of its own: a patch embedding and one dense layer.
TOY = '''
import torch

from reference import models

ARCHS = ("toy_patch",)
PATCH, WIDTH = 8, 24


def shapes(s):
    return {"patch": {"kernel": (PATCH, PATCH, 3, WIDTH), "bias": (WIDTH,)},
            "dense": {"kernel": (WIDTH, WIDTH), "bias": (WIDTH,)}}


def forward(p, images):
    x = models._conv(images.permute(0, 3, 1, 2), p["patch"], PATCH)
    return models.dense(torch.relu(x.flatten(2).transpose(1, 2)), p["dense"])


def width(s):
    return WIDTH


def positions(s):
    return (s["image_size"] // PATCH) ** 2


def flops(s):
    return 2 * positions(s) * (PATCH * PATCH * 3 * WIDTH + WIDTH * WIDTH)
'''

TOY_CONFIG = {
    "weights": "random", "weights_seed": 7,
    "binarizer": {"height": 32, "width": 64, "channels": 3, "overlap": 16, "bin_thr": 0.5,
                  "minibatch": 2, "features": [4, 8], "bottleneck": 8, "norm": "group",
                  "compute_dtype": "bfloat16"},
    "strokes": {"image_size": 32, "margin": 2, "max_length": 16,
                "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225],
                "encode_image_size": 4, "encoder_arch": "toy_patch", "encoder_norm": "none",
                "embed_dim": 6, "attention_dim": 10, "decoder_dim": 8, "projection_dim": 0,
                "compute_dtype": "bfloat16"},
}


@pytest.fixture
def toy_dir(tmp_path, monkeypatch):
    d = tmp_path / "encoders"
    d.mkdir()
    (d / "toy.py").write_text(TOY)
    monkeypatch.setattr(encoders, "DIR", d)
    return d


@pytest.mark.parametrize("projection_dim", [0, 12])
def test_toy_family_reaches_every_caller(toy_dir, tmp_path, projection_dim):
    cfg = TOY_CONFIG | {"strokes": TOY_CONFIG["strokes"] | {"projection_dim": projection_dim}}
    s = cfg["strokes"]
    toy = encoders.family("toy_patch")
    p, e = 16, projection_dim or 24

    trees = weights.random_model_dir(cfg, tmp_path / "model", "cpu")
    written = models.merged(msgpack.read(tmp_path / "model" / "strokes_encoder.msgpack"))
    assert digest(written) == digest(trees["encoder"])
    assert weights._shapes(trees["encoder"]) == toy.shapes(s)
    assert trees["decoder"]["enc_att"]["kernel"].shape == (e, 10)

    tw = {k: models.to_tensors(v, "cpu") if v is not None else None for k, v in trees.items()}
    with torch.no_grad():
        f = check._features(tw, crops(2, 32), s)
        low = check._features(tw, crops(2, 32), s, "fp8")
    assert f.shape == low.shape == (2, p, e)
    assert 0 < float((low - f).norm() / f.norm()) < 0.2

    run = types.SimpleNamespace(config=cfg, traffic={"decode": "greedy"},
                                calls=calls(), window_s=1.75)
    row = (toy.flops(s) + (2 * p * 24 * e if projection_dim else 0)
           + counts.decoder_row_flops(p, e, 10, 8))
    step = counts.decoder_step_flops(p, e, 10, 8, 6, 67)
    want = sum(c["tiles"] * counts.unet_flops([4, 8], 8, 3, 32, 64) + c["rows"] * row
               + sum(c["steps"]) * step for c in calls())
    got = cells.metric_reader("mfu")(run)
    assert got == pytest.approx(want / (1.75 * counts.PEAK_FLOPS["bfloat16"]) * 100.0, rel=1e-12)

    bound = sum(counts.decode_cost(c["rows"], c["steps"], 5, p, e, 10, 8, 6, 67, 16,
                                   "bfloat16")["bound_s"] for c in calls() if c["rows"])
    assert counts.decode_bound_s(calls(), s, 5) == pytest.approx(bound, rel=1e-12)


def test_toy_flops_match_flop_counter(toy_dir):
    s = TOY_CONFIG["strokes"]
    toy = encoders.family("toy_patch")
    tree = weights.draw(toy.shapes(s), torch.Generator().manual_seed(0), "cpu")
    with FlopCounterMode(display=False) as fc:
        toy.forward(tree, torch.zeros(3, 32, 32, 3))
    assert fc.get_total_flops() == 3 * toy.flops(s)


def test_arch_served_by_no_family_or_two(toy_dir):
    with pytest.raises(LookupError, match=r"'vit_l16' is served by none of the files "
                                          r"it selects \(none\).*: toy\.py"):
        encoders.family("vit_l16")
    (toy_dir / "toy_patch.py").write_text(TOY)
    with pytest.raises(LookupError, match=r"'toy_patch' is served by toy\.py, toy_patch\.py"):
        encoders.family("toy_patch")


def test_a_lookup_runs_only_the_files_its_name_selects(toy_dir):
    """A family file beside, that would fail or change a torch setting on
    import, is never run for a name that does not select it."""
    (toy_dir / "boom.py").write_text(
        "import torch\ntorch.backends.cudnn.allow_tf32 = False\nraise ImportError('boom')\n")
    (toy_dir / "toy_patchy.py").write_text("raise ImportError('toy_patchy')\n")
    tf32 = torch.backends.cudnn.allow_tf32
    assert encoders.family("toy_patch").ARCHS == ("toy_patch",)
    assert torch.backends.cudnn.allow_tf32 == tf32
    assert [p.name for p in sorted(toy_dir.glob("*.py")) if encoders.selects("toy_patch", p)] \
        == ["toy.py"]
    assert encoders.selects("resnet18", encoders.DIR / "resnet.py")
    assert encoders.selects("vit_l16", encoders.DIR / "vit.py")
    assert encoders.selects("vit_l16", encoders.DIR / "vit_l.py")
    assert not encoders.selects("resnet18", encoders.DIR / "res.py")
    with pytest.raises(ImportError, match="boom"):
        encoders.family("boom")
