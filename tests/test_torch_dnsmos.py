"""The port's ONNX reader and executor, ``convert/`` and DNSMOS, held against JAX on the CPU.

The repo carries no DNS Challenge checkpoint, so the graphs are fabricated in the ONNX
wire format (``tests/helpers/onnx_fab.py``) with seeded weights, as JAX's own tests
prove its executor. Covered: every op of JAX's executor table (``onnx_flax.py``) against
JAX's ``run_graph``, one small graph an op or an attribute form, the host-side shape
plumbing, the ops that raise and name themselves; the reader's parse equal to JAX's;
converted directories written by either package and run by the other, with the same
``MANIFEST.json`` entry; the conversion CLI; the mel front end against JAX's
``_melspec_db`` and its filterbank bitwise; DNSMOS end to end on P.808- and P.835-shaped
graphs (``chip_smoke.dnsmos_graphs`` at narrow widths) against JAX's at 16 kHz and from
8 kHz, clips shorter than a segment (tiled) and of two hops, plain and personalized; the
class over batches; JAX's ``ModuleNotFoundError`` without checkpoints; the cache recovery
of a corrupted converted directory.

Tolerances: executor outputs within 1e-5 (absolute and relative; integer outputs
exactly); the mel features within 1e-5; DNSMOS scores within 1e-4; the filterbank and
the reader's arrays bitwise.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import torchmetrics_tpu.audio as ja  # noqa: E402
import torchmetrics_tpu.functional.audio.dnsmos as jdnsmos  # noqa: E402
import torchmetrics_tpu_torch.audio as ta  # noqa: E402
import torchmetrics_tpu_torch.functional.audio.dnsmos as tdnsmos  # noqa: E402
from tests.helpers.onnx_fab import _model, _node  # noqa: E402
from torchmetrics_tpu.convert import onnx_flax as jonnx  # noqa: E402
from torchmetrics_tpu.convert.onnx_reader import parse_onnx as jparse  # noqa: E402
from torchmetrics_tpu_torch.convert import onnx_torch as tonnx  # noqa: E402
from torchmetrics_tpu_torch.convert.onnx_reader import parse_onnx as tparse  # noqa: E402

ATOL = 1e-5
DNSMOS_ATOL = 1e-4
F = np.float32
_r = np.random.RandomState(0)
X = (_r.randn(2, 3, 6, 8) * 0.8).astype(F)
POS = (_r.rand(2, 3, 6, 8) + 0.1).astype(F)
V8 = _r.randn(8).astype(F)


def _i64(*v):
    return np.asarray(v, np.int64)


# (nodes, initializers, the input) of one graph an op or attribute form
OPS = {
    "Relu": ([_node("Relu", ["x"], ["y"])], {}, X),
    "Sigmoid": ([_node("Sigmoid", ["x"], ["y"])], {}, X),
    "Tanh": ([_node("Tanh", ["x"], ["y"])], {}, X),
    "Softmax": ([_node("Softmax", ["x"], ["y"], axis=1)], {}, X),
    "LeakyRelu": ([_node("LeakyRelu", ["x"], ["y"], alpha=0.2)], {}, X),
    "Exp": ([_node("Exp", ["x"], ["y"])], {}, X),
    "Sqrt": ([_node("Sqrt", ["x"], ["y"])], {}, POS),
    "Pow": ([_node("Pow", ["x", "p"], ["y"])], {"p": np.asarray(3.0, F)}, X),
    "Clip_inputs": ([_node("Clip", ["x", "lo", "hi"], ["y"])], {"lo": np.asarray(-0.5, F), "hi": np.asarray(0.7, F)}, X),
    "Clip_min_only": ([_node("Clip", ["x", "lo", ""], ["y"])], {"lo": np.asarray(0.1, F)}, X),
    "Clip_attrs": ([_node("Clip", ["x"], ["y"], min=-0.2, max=0.3)], {}, X),
    "Clip_boundless": ([_node("Clip", ["x"], ["y"])], {}, X),
    "Add": ([_node("Add", ["x", "v"], ["y"])], {"v": V8}, X),
    "Sub": ([_node("Sub", ["v", "x"], ["y"])], {"v": V8}, X),
    "Mul": ([_node("Mul", ["x", "x"], ["y"])], {}, X),
    "Div": ([_node("Div", ["x", "v"], ["y"])], {"v": V8 + 3}, X),
    "MatMul": ([_node("MatMul", ["x", "w"], ["y"])], {"w": _r.randn(8, 5).astype(F)}, X),
    "Gemm": ([_node("Gemm", ["x", "w", "c"], ["y"], transB=1, alpha=0.7, beta=0.3)],
             {"w": _r.randn(5, 8).astype(F), "c": _r.randn(5).astype(F)}, X[0, 0]),
    "Gemm_transA_no_c": ([_node("Gemm", ["x", "w"], ["y"], transA=1)], {"w": _r.randn(6, 4).astype(F)}, X[0, 0]),
    "Conv": ([_node("Conv", ["x", "w", "b"], ["y"], pads=[1, 0, 2, 1], strides=[2, 1], dilations=[1, 2])],
             {"w": _r.randn(4, 3, 3, 3).astype(F), "b": _r.randn(4).astype(F)}, X),
    "Conv_group": ([_node("Conv", ["x", "w"], ["y"], group=3, pads=[1, 1, 1, 1])],
                   {"w": _r.randn(6, 1, 3, 3).astype(F)}, X),
    "Conv_same_upper": ([_node("Conv", ["x", "w"], ["y"], auto_pad="SAME_UPPER", strides=[2, 2])],
                        {"w": _r.randn(2, 3, 2, 3).astype(F)}, X),
    "Conv_same_lower": ([_node("Conv", ["x", "w"], ["y"], auto_pad="SAME_LOWER", strides=[2, 2])],
                        {"w": _r.randn(2, 3, 2, 3).astype(F)}, X),
    "Conv_1d": ([_node("Conv", ["x", "w", "b"], ["y"], strides=[3], pads=[2, 1])],
                {"w": _r.randn(5, 3, 4).astype(F), "b": _r.randn(5).astype(F)}, X[:, :, 0]),
    "MaxPool": ([_node("MaxPool", ["x"], ["y"], kernel_shape=[2, 3], strides=[2, 1], pads=[1, 0, 0, 1])], {}, X),
    "MaxPool_1d": ([_node("MaxPool", ["x"], ["y"], kernel_shape=[2], strides=[2])], {}, X[:, :, 0]),
    "AveragePool": ([_node("AveragePool", ["x"], ["y"], kernel_shape=[3, 3], strides=[1, 2], pads=[1, 1, 1, 0])],
                    {}, X),
    "AveragePool_include_pad": ([_node("AveragePool", ["x"], ["y"], kernel_shape=[3, 2], pads=[1, 1, 1, 1],
                                       count_include_pad=1)], {}, X),
    "GlobalAveragePool": ([_node("GlobalAveragePool", ["x"], ["y"])], {}, X),
    "GlobalMaxPool": ([_node("GlobalMaxPool", ["x"], ["y"])], {}, X),
    "BatchNormalization": ([_node("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"], epsilon=1e-3)],
                           {"s": _r.rand(3).astype(F) + 0.5, "b": _r.randn(3).astype(F),
                            "m": _r.randn(3).astype(F), "v": _r.rand(3).astype(F) + 0.5}, X),
    "Reshape": ([_node("Reshape", ["x", "shape"], ["y"])], {"shape": _i64(0, -1, 4)}, X),
    "Transpose": ([_node("Transpose", ["x"], ["y"], perm=[0, 2, 3, 1])], {}, X),
    "Transpose_default": ([_node("Transpose", ["x"], ["y"])], {}, X),
    "Flatten": ([_node("Flatten", ["x"], ["y"], axis=2)], {}, X),
    "Squeeze": ([_node("Squeeze", ["x"], ["y"], axes=[1])], {}, X[:, :1]),
    "Squeeze_input_axes": ([_node("Squeeze", ["x", "axes"], ["y"])], {"axes": _i64(1)}, X[:, :1]),
    "Unsqueeze": ([_node("Unsqueeze", ["x"], ["y"], axes=[0, 3])], {}, X),
    "Concat": ([_node("Concat", ["x", "x"], ["y"], axis=1)], {}, X),
    "Slice_inputs": ([_node("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
                     {"st": _i64(1, -1), "en": _i64(1 << 62, -7), "ax": _i64(2, 3), "sp": _i64(2, -2)}, X),
    "Slice_attrs": ([_node("Slice", ["x"], ["y"], starts=[0, 1], ends=[1, 5], axes=[1, 3])], {}, X),
    "Gather": ([_node("Gather", ["x", "idx"], ["y"], axis=3)], {"idx": _i64(2, -1, 0)}, X),
    "Gather_2d_index": ([_node("Gather", ["x", "idx"], ["y"], axis=1)], {"idx": np.asarray([[0, 2], [1, 1]])}, X),
    "Shape_Cast": ([_node("Shape", ["x"], ["s"]), _node("Cast", ["s"], ["y"], to=1)], {}, X),
    "Cast_int64": ([_node("Cast", ["x"], ["y"], to=7)], {}, X * 10),
    "Cast_double": ([_node("Cast", ["x"], ["y"], to=11)], {}, X),
    "ReduceMean": ([_node("ReduceMean", ["x"], ["y"], axes=[2, 3], keepdims=0)], {}, X),
    "ReduceMean_all": ([_node("ReduceMean", ["x"], ["y"])], {}, X),
    "Pad_attrs": ([_node("Pad", ["x"], ["y"], pads=[0, 1, 2, 0, 0, 0, 1, 3], value=0.5)], {}, X),
    "Pad_inputs": ([_node("Pad", ["x", "pads", "fill"], ["y"])],
                   {"pads": _i64(0, 0, 1, 1, 0, 0, 1, 1), "fill": np.asarray([-2.0], F)}, X),
    "Identity_Dropout": ([_node("Identity", ["x"], ["i"]), _node("Dropout", ["i"], ["y", "mask"])], {}, X),
    "Constant": ([_node("Constant", [], ["c"], value=V8), _node("Add", ["x", "c"], ["y"])], {}, X),
    "ConstantOfShape": ([_node("Shape", ["x"], ["s"]), _node("ConstantOfShape", ["s"], ["c"],
                                                             value=np.asarray([1.5], F)),
                         _node("Mul", ["x", "c"], ["y"])], {}, X),
    "Expand": ([_node("Expand", ["x", "shape"], ["y"])], {"shape": _i64(2, 3, 4, 5)}, X[:1, :, :1, :1]),
    "shape_plumbing": ([_node("Shape", ["x"], ["sh"]), _node("Gather", ["sh", "i0"], ["n"], axis=0),
                        _node("Clip", ["n", "lo", ""], ["ncl"]), _node("Unsqueeze", ["ncl"], ["n1"], axes=[0]),
                        _node("Concat", ["n1", "m1"], ["t"], axis=0), _node("Reshape", ["x", "t"], ["y"])],
                       {"i0": np.asarray(0, np.int64), "lo": np.asarray(1, np.int64), "m1": _i64(-1)}, X),
}


def _graph(case: str):
    nodes, init, x = OPS[case]
    outputs = ["y"]
    return _model(nodes, init, ["x"], outputs), x


@pytest.mark.parametrize("case", sorted(OPS))
def test_every_op_of_jax_s_table_equals_jax_run_graph(case):
    model, x = _graph(case)
    jg, tg = jparse(model), tparse(model)
    want = np.asarray(jonnx.run_graph(jg, jg["initializers"], {"x": jnp.asarray(x)})[0])
    got = tonnx.run_graph(tg, tg["initializers"], {"x": torch.from_numpy(x)})[0]
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_host_concrete_subgraphs_stay_numpy_as_in_jax():
    """``Shape -> Gather -> Clip(min only) -> Unsqueeze -> Concat`` evaluates on the host,
    so the reshape target is known; a ``Shape`` output is a numpy array."""
    model, x = _graph("shape_plumbing")
    g = tparse(model)
    module = tonnx.OnnxGraph(g, g["initializers"], device="cpu")
    assert module(torch.from_numpy(x))[0].shape == (2, 144)
    model, x = _graph("Shape_Cast")
    g = tparse(model)
    out = tonnx.OnnxGraph(g, g["initializers"], device="cpu")(torch.from_numpy(x))[0]
    assert isinstance(out, np.ndarray) and out.dtype == np.float32


@pytest.mark.parametrize("nodes, name", [
    ([_node("LSTM", ["x"], ["y"])], "LSTM"),
    ([_node("Pad", ["x"], ["y"], pads=[0, 0, 1, 1, 0, 0, 1, 1], mode="reflect")], "reflect"),
    ([_node("MaxPool", ["x"], ["y"], kernel_shape=[2, 2], ceil_mode=1)], "ceil_mode"),
])
def test_an_op_outside_the_table_raises_and_names_it(nodes, name):
    g = tparse(_model(nodes, {}, ["x"], ["y"]))
    jg = jparse(_model(nodes, {}, ["x"], ["y"]))
    with pytest.raises(NotImplementedError, match=name) as terr:
        tonnx.run_graph(g, g["initializers"], {"x": torch.from_numpy(X)})
    with pytest.raises(NotImplementedError) as jerr:
        jonnx.run_graph(jg, jg["initializers"], {"x": jnp.asarray(X)})
    assert str(terr.value).split(" — ")[0] == str(jerr.value).split(" — ")[0]


def test_the_reader_parses_as_jax_s():
    graphs = chip_smoke.dnsmos_graphs(seed=3, p808_widths=(2, 3), sbo_widths=(2, 2, 2))
    for data in graphs.values():
        want, got = jparse(data), tparse(data)
        assert json.dumps(got["nodes"], default=str) == json.dumps(want["nodes"], default=str)
        assert (got["inputs"], got["outputs"], got["name"]) == (want["inputs"], want["outputs"], want["name"])
        assert list(got["initializers"]) == list(want["initializers"])
        for k, v in want["initializers"].items():
            assert got["initializers"][k].dtype == v.dtype and np.array_equal(got["initializers"][k], v)


def _conv_model():
    r = np.random.RandomState(4)
    model = _model(
        [_node("Conv", ["x", "w", "b"], ["c"], pads=[1, 1, 1, 1]), _node("Relu", ["c"], ["r"]),
         _node("Constant", [], ["k"], value=np.asarray([2.0], F)), _node("Mul", ["r", "k"], ["m"]),
         _node("GlobalAveragePool", ["m"], ["g"]), _node("Flatten", ["g"], ["y"], axis=1)],
        {"w": r.randn(4, 3, 3, 3).astype(F), "b": r.randn(4).astype(F)}, ["x"], ["y"])
    return model


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_directory_converted_by_either_package_runs_in_the_other(tmp_path, writer):
    src = tmp_path / "model.onnx"
    src.write_bytes(_conv_model())
    out = tmp_path / "converted"
    (tonnx if writer == "port" else jonnx).__dict__["convert_onnx_flax"](str(src), str(out))
    assert sorted(os.listdir(out)) == ["MANIFEST.json", "graph.json", "params.npz"]
    entry = json.loads((out / "MANIFEST.json").read_text())["params.npz"]
    assert entry["kind"] == "onnx-flax" and entry["ops"] == sorted({"Conv", "Relu", "Constant", "Mul",
                                                                    "GlobalAveragePool", "Flatten"})
    jspec, jparams = jonnx.load_onnx_graph(str(out))
    want = np.asarray(jonnx.run_graph(jspec, jparams, {"x": jnp.asarray(X)})[0])
    got = tonnx.OnnxGraph.from_dir(str(out), device="cpu")(torch.from_numpy(X))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_both_packages_write_the_same_directory(tmp_path):
    src = tmp_path / "model.onnx"
    src.write_bytes(_conv_model())
    tonnx.convert_onnx_flax(str(src), str(tmp_path / "port"))
    jonnx.convert_onnx_flax(str(src), str(tmp_path / "jax"))
    assert (tmp_path / "port" / "graph.json").read_text() == (tmp_path / "jax" / "graph.json").read_text()
    assert json.loads((tmp_path / "port" / "MANIFEST.json").read_text()) == \
        json.loads((tmp_path / "jax" / "MANIFEST.json").read_text())


def test_the_conversion_cli(tmp_path, capsys):
    from torchmetrics_tpu_torch.convert import __main__ as cli

    src = tmp_path / "model.onnx"
    src.write_bytes(_conv_model())
    assert cli.main(["onnx-flax", str(src), "-o", str(tmp_path / "out")]) == 0
    assert "MANIFEST.json" in capsys.readouterr().out
    assert (tmp_path / "out" / "graph.json").exists()
    # the weight converters read their checkpoint (tests/test_torch_inception.py and
    # test_torch_lpips.py convert real files); hf-flax converts a tiny local snapshot
    for argv in (["inception", str(tmp_path / "x.pth")], ["lpips-backbone", str(tmp_path / "x.pth"), "--net", "vgg"]):
        with pytest.raises(FileNotFoundError):
            cli.main(argv)
    config = dict(chip_smoke.HF_CONFIGS["google/bert_uncased_L-2_H-128_A-2"], vocab_size=400, hidden_size=16,
                  num_attention_heads=2, intermediate_size=24, max_position_embeddings=32)
    src = chip_smoke.write_hf_snapshot(str(tmp_path / "bert"), config, seed=0, words=["hello", "world"])
    assert cli.main(["hf-flax", src, "-o", str(tmp_path / "flax"), "--model-class", "FlaxBertForMaskedLM"]) == 0
    manifest = json.loads((tmp_path / "flax" / "MANIFEST.json").read_text())
    assert manifest["flax_model.msgpack"]["kind"] == "hf-flax"
    assert (tmp_path / "flax" / "vocab.txt").read_text() == (tmp_path / "bert" / "vocab.txt").read_text()
    with pytest.raises(OSError, match="no network access"):
        cli.main(["hf-flax", "m", "-o", str(tmp_path / "o")])
    with pytest.raises(SystemExit):
        cli.main(["no-such-command"])


# ---------------------------------------------------------------------- DNSMOS


def test_the_filterbank_and_window_equal_jax_s_bitwise():
    np.testing.assert_array_equal(tdnsmos._mel_filterbank(16000, 321, 120), jdnsmos._mel_filterbank(16000, 321, 120))
    np.testing.assert_array_equal(tdnsmos._hann(321), jdnsmos._hann(321))


@pytest.mark.parametrize("rows, samples", [(1, 4000), (3, 16000)])
def test_the_mel_front_end_equals_jax_s(rows, samples):
    x = (np.random.RandomState(rows).randn(rows, samples) * 0.3).astype(F)
    want = np.asarray(jdnsmos._melspec_db(jnp.asarray(x)))
    got = tdnsmos._melspec_db(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.fixture()
def fabricated_dir(tmp_path, monkeypatch):
    """P.808- and P.835-shaped graphs at narrow widths: ``model_v8`` and the personalized
    head as raw drops (converted on first use), ``sig_bak_ovr`` converted already."""
    graphs = chip_smoke.dnsmos_graphs(seed=7, p808_widths=(4, 8, 8, 16), sbo_widths=(8, 8, 8))
    root = chip_smoke.dnsmos_dir(str(tmp_path / "dnsmos"), graphs)
    monkeypatch.setenv("TORCHMETRICS_TPU_DNSMOS_DIR", root)
    tdnsmos._load_model.cache_clear()
    jdnsmos._load_model.cache_clear()
    yield root
    tdnsmos._load_model.cache_clear()
    jdnsmos._load_model.cache_clear()


@pytest.mark.parametrize("fs, shape, personalized", [
    (16000, (2, 16000 * 11), False),  # two hops
    (16000, (2, 4000), True),  # shorter than a segment: tiled
    (8000, (3, 30000), False),  # resampled to 16 kHz
    (16000, (2, 1, 150000), True),  # leading dimensions kept
])
def test_dnsmos_equals_jax_on_fabricated_checkpoints(fabricated_dir, fs, shape, personalized):
    x = (np.random.RandomState(sum(shape)).randn(*shape) * 0.1).astype(F)
    want = np.asarray(jdnsmos.deep_noise_suppression_mean_opinion_score(jnp.asarray(x), fs, personalized))
    got = tdnsmos.deep_noise_suppression_mean_opinion_score(torch.from_numpy(x), fs, personalized)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (*shape[:-1], 4)
    np.testing.assert_allclose(got.numpy(), want, atol=DNSMOS_ATOL, rtol=0)
    assert os.path.isfile(os.path.join(fabricated_dir, "model_v8", "graph.json"))


def test_the_class_over_batches_equals_jax(fabricated_dir):
    jm = ja.DeepNoiseSuppressionMeanOpinionScore(16000, False)
    tm = ta.DeepNoiseSuppressionMeanOpinionScore(16000, False, device="cpu")
    r = np.random.RandomState(9)
    for _ in range(2):
        x = (r.randn(2, 20000) * 0.1).astype(F)
        jm.update(jnp.asarray(x))
        tm.update(torch.from_numpy(x))
    assert int(tm.total) == int(jm.total) == 16
    np.testing.assert_allclose(float(tm.sum_score), float(jm.sum_score), atol=DNSMOS_ATOL * 16, rtol=0)
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), atol=DNSMOS_ATOL, rtol=0)
    assert tm._compute_group_params() == jm._compute_group_params()


def test_without_checkpoints_jax_s_module_not_found_error(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHMETRICS_TPU_DNSMOS_DIR", str(tmp_path))
    x = np.zeros(16000, F)
    with pytest.raises(ModuleNotFoundError) as terr:
        tdnsmos.deep_noise_suppression_mean_opinion_score(torch.from_numpy(x), 16000, False)
    with pytest.raises(ModuleNotFoundError) as jerr:
        jdnsmos.deep_noise_suppression_mean_opinion_score(jnp.asarray(x), 16000, False)
    assert str(terr.value) == str(jerr.value)


def test_a_corrupted_converted_directory_is_rebuilt_from_its_raw_drop(fabricated_dir):
    x = torch.from_numpy((np.random.RandomState(10).randn(1, 16000) * 0.1).astype(F))
    before = tdnsmos.deep_noise_suppression_mean_opinion_score(x, 16000, False)
    params = os.path.join(fabricated_dir, "model_v8", "params.npz")
    with open(params, "r+b") as fh:
        fh.truncate(100)
    tdnsmos._load_model.cache_clear()
    with pytest.warns(RuntimeWarning, match="corrupted"):
        after = tdnsmos.deep_noise_suppression_mean_opinion_score(x, 16000, False)
    assert torch.equal(before, after)
    # a converted directory with no raw drop to rebuild from raises
    from torchmetrics_tpu_torch.robust.retry import ResourceIntegrityError

    with open(os.path.join(fabricated_dir, "sig_bak_ovr", "params.npz"), "r+b") as fh:
        fh.truncate(100)
    tdnsmos._load_model.cache_clear()
    with pytest.raises(ResourceIntegrityError, match="corrupted"):
        tdnsmos.deep_noise_suppression_mean_opinion_score(x, 16000, False)
