"""The port's ONNX interop against the JAX package's, on the same
numpy-seeded inputs: the wire-format reader and the writer, the import of
the upstream project's model directory (built here from the torch twins of
``tests/test_graph_import.py``, loaded by path: attention gates with and
without batch norm, both LSTM export styles, with and without
``projection.onnx``, basic and bottleneck encoders), the export of native
directories, and the CLI, the server and the evaluator on an ONNX
directory. Import trees are compared leaf for leaf and bit for bit,
exported files byte for byte, and the port's float32 forwards are held to
the torch oracles at the JAX tests' ``atol=2e-4``."""

import dataclasses
import http.client
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as tnn

from stroke_derenderer_tpu import cli as j_cli
from stroke_derenderer_tpu.config import BinarizerConfig, StrokesConfig
from stroke_derenderer_tpu.weights import graph_export as j_export
from stroke_derenderer_tpu.weights import graph_import as j_import
from stroke_derenderer_tpu.weights import importer as j_importer
from stroke_derenderer_tpu.weights import onnx_graph as j_graph
from stroke_derenderer_tpu.weights import store as jstore
from stroke_derenderer_tpu_torch import cli
from stroke_derenderer_tpu_torch import weights as tw
from stroke_derenderer_tpu_torch.io import encode_png, read_png, write_png
from stroke_derenderer_tpu_torch.models.decoder import AttentiveDecoder
from stroke_derenderer_tpu_torch.models.encoder import ARCHS, ResNetEncoder
from stroke_derenderer_tpu_torch.models.layers import linear
from stroke_derenderer_tpu_torch.models.unet import AttentionUNet
from stroke_derenderer_tpu_torch.weights import graph_export as t_export
from stroke_derenderer_tpu_torch.weights import graph_import as t_import
from stroke_derenderer_tpu_torch.weights import importer as t_importer
from stroke_derenderer_tpu_torch.weights import onnx_graph as t_graph
from stroke_derenderer_tpu_torch.weights.onnx_run import run_onnx

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-4  # the JAX package's own bar (tests/test_graph_import.py)


def _load_twins():
    spec = importlib.util.spec_from_file_location(
        "graph_import_twins", REPO / "tests" / "test_graph_import.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


T = _load_twins()


class TBottleneck(tnn.Module):
    """A torchvision-style bottleneck block (the projection shortcut traced
    after the three convs)."""

    def __init__(self, cin, f, stride):
        super().__init__()
        self.c = tnn.ModuleList([
            tnn.Conv2d(cin, f, 1, bias=False),
            tnn.Conv2d(f, f, 3, stride, 1, bias=False),
            tnn.Conv2d(f, 4 * f, 1, bias=False)])
        self.b = tnn.ModuleList([tnn.BatchNorm2d(f), tnn.BatchNorm2d(f),
                                 tnn.BatchNorm2d(4 * f)])
        self.proj = self.bp = None
        if cin != 4 * f or stride != 1:
            self.proj = tnn.Conv2d(cin, 4 * f, 1, stride, bias=False)
            self.bp = tnn.BatchNorm2d(4 * f)

    def forward(self, x):
        y = torch.relu(self.b[0](self.c[0](x)))
        y = torch.relu(self.b[1](self.c[1](y)))
        y = self.b[2](self.c[2](y))
        r = self.bp(self.proj(x)) if self.proj is not None else x
        return torch.relu(y + r)

    def emit(self, b, x):
        y = b.add_node("Relu", [T.emit_bn(b, T.emit_conv(b, x, self.c[0]),
                                          self.b[0])])
        y = b.add_node("Relu", [T.emit_bn(b, T.emit_conv(b, y, self.c[1]),
                                          self.b[1])])
        y = T.emit_bn(b, T.emit_conv(b, y, self.c[2]), self.b[2])
        r = (T.emit_bn(b, T.emit_conv(b, x, self.proj), self.bp)
             if self.proj is not None else x)
        return b.add_node("Relu", [b.add_node("Add", [y, r])])


class TResNet50(T.TResNetTiny):
    """A torch ResNet-50 twin (stem 64, stages 3, 4, 6, 3, output 2048)."""

    def __init__(self):
        tnn.Module.__init__(self)
        self.stem = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn = tnn.BatchNorm2d(64)
        self.blocks = tnn.ModuleList()
        cin = 64
        for i, n in enumerate((3, 4, 6, 3)):
            for j in range(n):
                f = 64 * 2 ** i
                self.blocks.append(TBottleneck(cin, f, 2 if j == 0 and i > 0
                                               else 1))
                cin = 4 * f

    def emit(self, b, size=64):
        super().emit(b, size)
        b.graph_outputs[-1] = ("output", (1, 2048, size // 32, size // 32), 1)


@dataclasses.dataclass
class TwinDir:
    path: Path
    unet: tnn.Module
    encoder: tnn.Module
    decoder: tnn.Module
    projection: tnn.Module | None
    size: int


def twin_dir(path: Path, gate_bn=False, lstm_style="lstm_op",
             projection=False, arch="tiny", builder=j_graph.OnnxGraphBuilder,
             compute_dtype=None, head=None) -> TwinDir:
    """The upstream project's model directory, from torch twins with
    randomized batch-norm statistics, written by ``builder``. ``head``:
    (gain, centre) turns the UNet's head logit l into gain * (l - centre),
    so that a random UNet's probabilities, all near 0.46 on line images,
    spread across the threshold."""
    torch.manual_seed(0)
    path.mkdir(parents=True, exist_ok=True)
    unet = T.TUNet(gate_bn=gate_bn).eval()
    T._randomize_bn(unet)
    if head is not None:
        gain, centre = head
        with torch.no_grad():
            unet.head.weight *= gain
            unet.head.bias.copy_(gain * (unet.head.bias - centre))
    b = builder("binarizer")
    unet.emit(b)
    b.save(path / "binarizer.onnx")
    size = 56 if arch == "tiny" else 64
    encoder = (T.TResNetTiny() if arch == "tiny" else TResNet50()).eval()
    T._randomize_bn(encoder)
    b = builder("encoder")
    encoder.emit(b, size)
    b.save(path / "encoder.onnx")
    enc_dim = 64 if arch == "tiny" else 2048
    proj = None
    if projection:
        proj = tnn.Linear(enc_dim, 12).eval()
        b = builder("projection")
        b.add_input("input", (1, 16, enc_dim))
        T.emit_linear_matmul(b, "input", proj)
        b.nodes[-1].outputs[0] = "output"
        b.add_output("output", (1, 16, 12))
        b.save(path / "projection.onnx")
        enc_dim = 12
    dec = T.TDecoder(vocab=3 + 2 * size, enc_dim=enc_dim).eval()
    for name, emit in (("decoder_init_hc",
                        lambda b: dec.emit_init_hc(b, enc_dim)),
                       ("decoder_embedding", dec.emit_embedding),
                       ("decoder_iter",
                        lambda b: dec.emit_iter(b, 16, lstm_style))):
        b = builder(name)
        emit(b)
        b.save(path / f"{name}.onnx")
    extra = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    (path / "configs_binarizer.json").write_text(json.dumps(
        {"height": 32, "width": 96, "overlap": 16} | extra))
    (path / "configs_strokes.json").write_text(json.dumps(
        {"image_size": size, "max_length": 24, "encode_image_size": 4}
        | extra))
    return TwinDir(path, unet, encoder, dec, proj, size)


def assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), f"{path}: {set(got)} != {set(want)}"
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f"{path}/{k}"
            assert np.array_equal(a, b), f"{path}/{k}"


# ------------------------------------------------------- reader and writer

def test_reader_and_writer_match_jax(tmp_path):
    """The twins' graphs written by the JAX builder read back the same in
    the port (nodes, attributes, initializers, graph inputs and outputs),
    and the port's builder writes the same bytes for the same graphs."""
    j = twin_dir(tmp_path / "j", gate_bn=True, projection=True)
    t = twin_dir(tmp_path / "t", gate_bn=True, projection=True,
                 builder=t_graph.OnnxGraphBuilder)
    for f in sorted(j.path.glob("*.onnx")):
        assert (t.path / f.name).read_bytes() == f.read_bytes(), f.name
        got, want = t_graph.read_onnx_graph(f), j_graph.read_onnx_graph(f)
        assert (got.name, got.inputs, got.outputs) == (
            want.name, want.inputs, want.outputs)
        assert [dataclasses.asdict(n) for n in got.nodes] == [
            dataclasses.asdict(n) for n in want.nodes]
        assert_trees_equal(got.initializers, want.initializers)
        assert_trees_equal(t_importer.read_onnx_initializers(f),
                           j_importer.read_onnx_initializers(f))
    g = t_graph.read_onnx_graph(j.path / "decoder_iter.onnx")
    assert "LSTM" in [n.op_type for n in g.nodes]


def test_convtranspose_layout_round_trip():
    """An asymmetric torch ConvTranspose2d kernel through the import's
    layout (spatial flip) and the port's ``from_flax_unet`` layout (flipped
    back): the same kernel, and the same output."""
    w = np.random.default_rng(0).normal(size=(6, 4, 2, 2)).astype(np.float32)
    assert not np.array_equal(w, w[:, :, ::-1, ::-1])
    k = t_import.torch_convtranspose_to_flax(w)
    back = np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1))
    assert np.array_equal(back, w)


# ------------------------------------------------------------------ import

IMPORT_CASES = [
    dict(gate_bn=False, lstm_style="lstm_op", projection=False),
    dict(gate_bn=True, lstm_style="gemms", projection=True),
    dict(gate_bn=True, lstm_style="lstm_op", projection=True,
         arch="resnet50"),
]


@pytest.mark.parametrize("case", IMPORT_CASES,
                         ids=lambda c: "-".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_import_matches_jax_and_the_torch_twins(tmp_path, case):
    twin = twin_dir(tmp_path / "onnx", **case)
    got = t_import.import_reference_models(twin.path)
    want = j_import.import_reference_models(twin.path)
    for i in (0, 2):  # the configs (the JAX ones have kernel fields more)
        mine = dataclasses.asdict(got[i])
        assert mine == {k: v for k, v in dataclasses.asdict(want[i]).items()
                        if k in mine}
    for i in (1, 3, 4):  # binarizer, encoder and decoder variables
        assert_trees_equal(got[i], want[i])
    assert (got[5] is None) == (want[5] is None) == (not case["projection"])
    if got[5] is not None:
        assert_trees_equal(got[5], want[5])
    bin_cfg, bin_vars, se_cfg, enc_vars, dec_vars, proj_vars = got
    assert bin_cfg.norm == "batch" and se_cfg.encoder_norm == "batch"
    assert se_cfg.encoder_arch == case.get("arch", "tiny")
    assert se_cfg.projection_dim == (12 if case["projection"] else 0)

    # The port's float32 forwards against the torch oracles.
    x = torch.rand(2, 3, 32, 96)
    unet = AttentionUNet(bin_cfg.features, bin_cfg.bottleneck,
                         dtype=torch.float32, norm="batch")
    unet.load_state_dict(tw.from_flax_unet(bin_vars, len(bin_cfg.features)))
    g = torch.randn(2, 3, twin.size, twin.size)
    enc = ResNetEncoder(se_cfg.encoder_arch, dtype=torch.float32,
                        norm="batch")
    enc.load_state_dict(tw.from_flax_encoder(
        enc_vars, ARCHS[se_cfg.encoder_arch][0]))
    seq = torch.randn(3, 16, twin.decoder.enc_att.in_features)
    dec = AttentiveDecoder(se_cfg.vocab_size, se_cfg.embed_dim,
                           se_cfg.attention_dim, se_cfg.decoder_dim,
                           seq.shape[-1], dtype=torch.float32)
    dec.load_state_dict(tw.from_flax_decoder(dec_vars))
    toks = torch.tensor([5, 60, 110])
    with torch.no_grad():
        np.testing.assert_allclose(
            unet(x.permute(0, 2, 3, 1))[..., 0], twin.unet(x)[:, 0],
            atol=ATOL)
        np.testing.assert_allclose(enc(g.permute(0, 2, 3, 1)),
                                   twin.encoder(g).permute(0, 2, 3, 1),
                                   atol=ATOL)
        h, c = dec.init_state(seq)
        oh, oc = twin.decoder.init_h(seq.mean(1)), twin.decoder.init_c(
            seq.mean(1))
        np.testing.assert_allclose(h, oh, atol=ATOL)
        np.testing.assert_allclose(c, oc, atol=ATOL)
        emb = dec.embed(toks)
        np.testing.assert_allclose(emb, twin.decoder.embedding(toks),
                                   atol=1e-6)
        got_step = dec.step(seq, dec.project_encoding(seq), emb, h, c)
        want_step = twin.decoder.step(seq, emb, oh, oc)
        for a, b in zip(got_step, want_step):
            np.testing.assert_allclose(a, b, atol=ATOL)
        if twin.projection is not None:
            raw = torch.randn(2, 16, twin.projection.in_features)
            proj = torch.nn.Linear(raw.shape[-1], 12)
            proj.load_state_dict(tw.from_flax_projection(proj_vars))
            np.testing.assert_allclose(linear(raw, proj),
                                       twin.projection(raw), atol=ATOL)


def test_import_writes_a_native_dir(tmp_path):
    """``import_reference_models(dir, out_dir)``: the native dir holds the
    same trees (batch_stats and the projection included) and both CLIs'
    ``initialize_sessions`` load it with the variants."""
    twin = twin_dir(tmp_path / "onnx", projection=True,
                    compute_dtype="float32")
    got = t_import.import_reference_models(twin.path, tmp_path / "native")
    for i, name in ((1, "binarizer"), (3, "strokes_encoder"),
                    (4, "strokes_decoder"), (5, "strokes_projection")):
        assert_trees_equal(tw.read_msgpack(tmp_path / "native"
                                           / f"{name}.msgpack"), got[i])
    tb, te = cli.initialize_sessions(tmp_path / "native", device="cpu")
    assert tb.config.norm == "batch" and te.config.encoder_norm == "batch"
    assert te.projection is not None
    jb, je = j_cli.initialize_sessions(tmp_path / "native")
    assert je.config.projection_dim == te.config.projection_dim == 12


# ------------------------------------------------------------------ export

def native_dir(path: Path, norm: str, projection: bool) -> Path:
    """A tiny JAX-made native dir, every leaf (and batch norms' running
    statistics) drawn from a numpy seed and written back."""
    bin_cfg = BinarizerConfig(norm=norm, features=(8, 16), bottleneck=32,
                              height=32, width=96, overlap=16,
                              compute_dtype="float32")
    se_cfg = StrokesConfig(encoder_arch="tiny", encoder_norm=norm,
                           embed_dim=16, attention_dim=16, decoder_dim=16,
                           image_size=56, encode_image_size=4,
                           max_length=12, compute_dtype="float32",
                           projection_dim=12 if projection else 0)
    jstore.materialize_model_dir(path, bin_cfg, se_cfg)
    rng = np.random.default_rng(7)

    def draw(t, key=""):
        if isinstance(t, dict):
            return {k: draw(v, k) for k, v in t.items()}
        if key == "var":
            return rng.uniform(0.5, 2.0, t.shape).astype(np.float32)
        return rng.normal(0.1, 0.5, t.shape).astype(np.float32)

    for f in sorted(path.glob("*.msgpack")):
        tw.write_msgpack(draw(tw.read_msgpack(f)), f)
    return path


@pytest.mark.parametrize("norm,projection", [("group", False),
                                             ("batch", True)])
def test_export_is_byte_identical_and_runs(tmp_path, norm, projection):
    """The port's export of a native dir is the JAX package's, byte for
    byte; the port's ONNX executor runs every graph to the port's own
    forwards; the port's import gives back the dir's trees."""
    src = native_dir(tmp_path / "native", norm, projection)
    t_export.export_reference_models(src, tmp_path / "t")
    j_export.export_reference_models(src, tmp_path / "j")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert ("projection.onnx" in names) == projection
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name

    onnx = tmp_path / "t"
    tb, te = cli.initialize_sessions(src, device="cpu")
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 3, 32, 96)).astype(np.float32)
    with torch.no_grad():
        want = tb.model(torch.from_numpy(x).permute(0, 2, 3, 1))
    np.testing.assert_allclose(run_onnx(onnx / "binarizer.onnx",
                                        {"input": x})["output"],
                               want.permute(0, 3, 1, 2), atol=2e-5,
                               rtol=1e-4)
    g = rng.normal(0, 1, (2, 3, 56, 56)).astype(np.float32)
    with torch.no_grad():
        fm = te.encoder(torch.from_numpy(g).permute(0, 2, 3, 1))
    np.testing.assert_allclose(run_onnx(onnx / "encoder.onnx",
                                        {"input": g})["output"],
                               fm.permute(0, 3, 1, 2), atol=3e-5, rtol=1e-4)
    enc_dim = 12 if projection else 64
    seq = torch.from_numpy(rng.normal(0, 1, (2, 16, enc_dim)).astype(
        np.float32))
    dec = te.decoder
    toks = np.asarray([5, 9], np.int64)
    with torch.no_grad():
        emb = dec.embed(torch.from_numpy(toks))
        h, c = dec.init_state(seq)
        step = dec.step(seq, dec.project_encoding(seq), emb, h, c)
        if projection:
            raw = torch.from_numpy(rng.normal(0, 1, (2, 16, 64)).astype(
                np.float32))
            np.testing.assert_allclose(
                run_onnx(onnx / "projection.onnx",
                         {"input": raw.numpy()})["output"],
                linear(raw, te.projection), atol=1e-5)
    np.testing.assert_allclose(run_onnx(onnx / "decoder_embedding.onnx",
                                        {"input": toks})["output"], emb,
                               atol=1e-6)
    init = run_onnx(onnx / "decoder_init_hc.onnx",
                    {"input": seq.mean(1).numpy()})
    np.testing.assert_allclose(init["output_h"], h, atol=1e-5)
    np.testing.assert_allclose(init["output_c"], c, atol=1e-5)
    it = run_onnx(onnx / "decoder_iter.onnx",
                  {"input_enc": seq.numpy(), "input_emb": emb.numpy(),
                   "input_h": h.numpy(), "input_c": c.numpy()})
    for key, want in zip(("output_pred", "output_h", "output_c"), step):
        np.testing.assert_allclose(it[key], want, atol=2e-4, rtol=1e-4)

    back = t_import.import_reference_models(onnx)
    for i, name in ((1, "binarizer"), (3, "strokes_encoder"),
                    (4, "strokes_decoder")):
        assert_trees_equal(back[i], tw.read_msgpack(src / f"{name}.msgpack"))
    if projection:
        assert_trees_equal(back[5], tw.read_msgpack(
            src / "strokes_projection.msgpack"))


# --------------------------------------------------- CLI, server, evaluator

def _line(rng):
    img = np.full((48, 200, 3), 255, np.uint8)
    for _ in range(5):
        y, x = rng.integers(5, 35), rng.integers(0, 170)
        img[y:y + rng.integers(3, 10), x:x + rng.integers(5, 30)] = 0
    return img


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(9)
    for i in range(2):
        write_png(d / f"line{i}.png", _line(rng))
    return d


@pytest.fixture(scope="module")
def onnx_models(tmp_path_factory):
    """A twin dir whose masks of the ``inputs`` lines are neither empty
    nor full, so that the CLI decodes glyphs."""
    d = tmp_path_factory.mktemp("onnx_models")
    twin_dir(d, gate_bn=True, projection=True, compute_dtype="float32",
             head=(200.0, -0.157))
    binarizer, _ = cli.initialize_sessions(d, device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(2):
        ink = (binarizer.binarize_image(_line(rng)) > 0).mean()
        assert 0.05 < ink < 0.95, ink
    return d


@pytest.mark.parametrize("flags", [[], ["--decode", "beam", "--beam-size",
                                        "3"], ["--batch"]],
                         ids=["greedy", "beam", "batch"])
def test_cli_on_an_onnx_dir_writes_what_the_jax_cli_writes(
        onnx_models, inputs, tmp_path, capsys, flags):
    args = ["-models", str(onnx_models), "-input", str(inputs)] + flags
    assert j_cli.entrypoint(args + ["--output", str(tmp_path / "j")]) == 0
    assert cli.entrypoint(args + ["--output", str(tmp_path / "t"),
                                  "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[info] importing reference ONNX models from {onnx_models}" in out
    assert "[error]" not in out
    files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(files) == 4
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == files
    for name in files:  # the PNG codecs differ: masks compare as pixels
        got, want = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(read_png(got), read_png(want))
        else:
            assert json.loads(got.read_text()) == json.loads(
                want.read_text()), name
    assert all(json.loads((tmp_path / "t" / n).read_text())
               for n in files if n.endswith(".json"))


def test_export_onnx_flag_and_device_partition(tmp_path, inputs, capsys):
    src = native_dir(tmp_path / "native", "batch", True)
    assert cli.entrypoint(["--export-onnx", str(tmp_path / "x")]) == 2
    assert "requires -models" in capsys.readouterr().out
    assert cli.entrypoint(["-models", str(src), "--export-onnx",
                           str(tmp_path / "t")]) == 0
    j_export.export_reference_models(src, tmp_path / "j")
    for f in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / f.name).read_bytes() == f.read_bytes()
    args = cli.parse_args(["--device-partition"])
    assert cli.strokes_overrides(args) == {"device_partition": True}
    assert cli.entrypoint(["-models", str(tmp_path / "t"), "-input",
                           str(inputs), "--output", str(tmp_path / "o"),
                           "--device", "cpu", "--device-partition"]) == 0
    assert len(list((tmp_path / "o").glob("*_STROKES.json"))) == 2


def test_serve_and_eval_load_an_onnx_dir(onnx_models, inputs, monkeypatch,
                                         capsys):
    from stroke_derenderer_tpu_torch import serve
    from stroke_derenderer_tpu_torch.eval import run as eval_run

    replies = []
    real = serve.ThreadingHTTPServer.serve_forever

    def serve_one_request(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.server_port,
                                              timeout=120)
            conn.request("POST", "/derender", body=encode_png(
                np.asarray(255 - 200 * (np.arange(48 * 160).reshape(48, 160)
                                        % 37 < 3), np.uint8)[..., None]
                .repeat(3, 2)))
            r = conn.getresponse()
            replies.append((r.status, json.loads(r.read())))
            conn.close()
        finally:
            self.shutdown()
            t.join(30)
            assert not t.is_alive()

    monkeypatch.setattr(serve.ThreadingHTTPServer, "serve_forever",
                        serve_one_request)
    serve.main(["--models", str(onnx_models), "--device", "cpu",
                "--port", "0"])
    assert replies and replies[0][0] == 200 and "strokes" in replies[0][1]
    assert eval_run.main(["--models", str(onnx_models), "--n", "1",
                          "--style", "letters", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[info] importing reference ONNX models") == 2
    assert '"stroke_dtw"' in out
