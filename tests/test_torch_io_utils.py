"""The port's copies of the JAX package's I/O and utility leaves, held
against the originals: ``io``'s ``load_json``, ``load_yaml``,
``save_metrics``/``load_metrics`` and ``json_strokes_to_svg``,
``weights.onnx_run.TorchOnnxSession`` (against ``run_onnx`` and the JAX
package's session) and ``utils.logging.get_logger``."""

import json
import logging

import numpy as np
import pytest

from stroke_derenderer_tpu import io as j_io
from stroke_derenderer_tpu.io import serial as j_serial
from stroke_derenderer_tpu.utils import logging as j_logging
from stroke_derenderer_tpu.weights import onnx_run as j_onnx_run
from stroke_derenderer_tpu_torch import io as t_io
from stroke_derenderer_tpu_torch.utils import logging as t_logging
from stroke_derenderer_tpu_torch.weights import onnx_run as t_onnx_run
from stroke_derenderer_tpu_torch.weights.onnx_graph import OnnxGraphBuilder


def test_json_and_metrics_round_trip_across_packages(tmp_path):
    obj = {"a": [1, 2.5, None], "b": {"c": "d"}}
    (tmp_path / "x.json").write_text(json.dumps(obj))
    assert t_io.load_json(tmp_path / "x.json") == j_serial.load_json(
        tmp_path / "x.json") == obj
    metrics = {"dtw": np.arange(5, dtype=np.float32), "n": 3,
               "names": ("a", "b")}
    t_io.save_metrics(metrics, tmp_path / "port.pkl")
    j_serial.save_metrics(metrics, tmp_path / "jax.pkl")
    for path in ("port.pkl", "jax.pkl"):
        for load in (t_io.load_metrics, j_serial.load_metrics):
            got = load(tmp_path / path)
            np.testing.assert_array_equal(got["dtw"], metrics["dtw"])
            assert (got["n"], got["names"]) == (3, ("a", "b"))
    assert (tmp_path / "port.pkl").read_bytes() == (
        tmp_path / "jax.pkl").read_bytes()


def test_load_yaml_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    (tmp_path / "c.yaml").write_text("model:\n  height: 128\n  dims: [16, 32]"
                                     "\nname: demo\n")
    assert t_io.load_yaml(tmp_path / "c.yaml") == j_serial.load_yaml(
        tmp_path / "c.yaml") == {"model": {"height": 128, "dims": [16, 32]},
                                 "name": "demo"}


@pytest.mark.parametrize("kwargs", [{}, {"size": (300, 128), "scale": 0.5},
                                    {"stroke_width": 3.0, "color": "#f00"}])
def test_json_strokes_to_svg_matches_jax(kwargs):
    strokes = [[[1.0, 5.5, 9.25], [2.0, 3.0, 40.125]], [[7.0], [8.0]],
               [[], []], [[0, 1], [2, 3]]]
    assert t_io.json_strokes_to_svg(strokes, **kwargs) == \
        j_io.json_strokes_to_svg(strokes, **kwargs)


def _graph(path):
    """x (2, 6) -> relu(x @ W + b) (2, 4) and its sum over axis 1."""
    rng = np.random.default_rng(0)
    g = OnnxGraphBuilder("tiny")
    g.add_input("x", (2, 6))
    w = g.add_init(rng.normal(size=(6, 4)).astype(np.float32))
    b = g.add_init(rng.normal(size=(4,)).astype(np.float32))
    y = g.add_node("Add", [g.add_node("MatMul", ["x", w]), b])
    g.add_node("Relu", [y], ["y"])
    g.add_node("ReduceSum", ["y", g.add_init(np.array([1], np.int64))],
               ["s"], keepdims=0)
    g.add_output("y", (2, 4))
    g.add_output("s", (2,))
    g.save(path)
    return rng.normal(size=(2, 6)).astype(np.float32)


def test_torch_onnx_session_matches_run_onnx(tmp_path):
    x = _graph(tmp_path / "tiny.onnx")
    sess = t_onnx_run.TorchOnnxSession(tmp_path / "tiny.onnx",
                                       providers=["CPUExecutionProvider"])
    want = t_onnx_run.run_onnx(tmp_path / "tiny.onnx", {"x": x})
    j_sess = j_onnx_run.TorchOnnxSession(tmp_path / "tiny.onnx")
    for names in (None, ["s"], ["s", "y"]):
        got = sess.run(names, {"x": x})
        order = names or ["y", "s"]
        assert len(got) == len(order)
        for name, arr in zip(order, got):
            np.testing.assert_array_equal(arr, want[name])
        for a, b in zip(got, j_sess.run(names, {"x": x})):
            np.testing.assert_array_equal(a, b)
    # The session reuses its parsed graph: a second run gives the same.
    np.testing.assert_array_equal(sess.run(["y"], {"x": x})[0], want["y"])


def test_get_logger_matches_jax(capsys):
    name = "test_torch_io_utils.logger"
    log = t_logging.get_logger(name)
    assert log is t_logging.get_logger(name)  # one handler, added once
    assert len(log.handlers) == 1 and not log.propagate
    assert log.level == logging.INFO
    j_log = j_logging.get_logger(name + ".jax")
    assert (log.handlers[0].formatter._fmt ==
            j_log.handlers[0].formatter._fmt)
    log.info("hello %d", 3)
    assert log.handlers[0].stream is not None
