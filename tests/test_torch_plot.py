"""``plot`` of the PyTorch port against the JAX package's figures.

The battery of ``tests/plotting/test_plot_battery.py`` over the port's exports: every
port metric class that the JAX battery instantiates (the classification family, the
aggregation, regression, image and text metrics) is built in both packages from the same
seeded numpy inputs, updated once and plotted with matplotlib's Agg backend. The two
figures must hold the same data: every line's x/y (float32 values within 1e-6), every
heatmap's image array and every text, title, axis label, tick label, legend entry
and y-limit. Plots from ``compute`` and from explicit values, a collection apart and
together, and a plot onto the caller's axis are covered; without matplotlib ``plot``
raises the JAX package's error.
"""

from __future__ import annotations

import inspect

import matplotlib

matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torchmetrics_tpu as jtm  # noqa: E402
import torchmetrics_tpu_torch as ptm  # noqa: E402
from tests.helpers.instantiation import CASES, bin_cls  # noqa: E402
from torchmetrics_tpu_torch.core.metric import Metric as PortMetric  # noqa: E402

torch.set_num_threads(2)

_SEED = 77
_ATOL = 1e-5  # the parity tolerance of the computed values (PERF.md §2)
_RTOL = 1e-6
# MS-SSIM of 180x180 noise multiplies five scales' float32 contrast terms raised to
# their weights: the two packages' values differ by 3.3e-4 relative there
_RTOL_OF = {"MultiScaleStructuralSimilarityIndexMeasure": 1e-3}

PORT_CLASSES = sorted(
    n for n in ptm.__all__ if inspect.isclass(getattr(ptm, n, None)) and issubclass(getattr(ptm, n), PortMetric)
)
# every port export the JAX battery builds; the rest are structural (Metric,
# CompositionalMetric, BaseAggregator) and covered by the composition cases below
PLOTTED = [n for n in PORT_CLASSES if n in CASES]
CLASSIFICATION = sorted(n for n in ptm.classification.__all__ if n in CASES)

CURVES = ["BinaryROC", "BinaryPrecisionRecallCurve", "MulticlassROC", "MulticlassPrecisionRecallCurve",
          "MultilabelROC", "MultilabelPrecisionRecallCurve"]
CONFMATS = ["BinaryConfusionMatrix", "MulticlassConfusionMatrix", "MultilabelConfusionMatrix", "ConfusionMatrix"]


def _host(x):
    """Tree of JAX arrays or torch tensors -> tree of numpy arrays."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_text(a) -> bool:
    """A string input (or a list or dict of them): the text metrics take it as it is."""
    return isinstance(a, (str, dict)) or (isinstance(a, (list, tuple)) and any(_is_text(x) for x in a))


def _port_args(args):
    return tuple(a if _is_text(a) else torch.as_tensor(np.asarray(a)) for a in args)


# keyword arguments that are JAX functions in ``CASES``, as the port takes them
_PORT_KWARGS = {"PermutationInvariantTraining": {"metric_func": lambda p, t: -torch.mean((p - t) ** 2, dim=-1)}}


def _pair(name):
    """The same metric in both packages, updated once with the same seeded inputs."""
    kwargs, maker = CASES[name]
    jm = getattr(jtm, name)(**kwargs)
    jm.update(*maker(np.random.RandomState(_SEED)))
    pm = getattr(ptm, name)(**{**kwargs, **_PORT_KWARGS.get(name, {})}, device="cpu")
    pm.update(*_port_args(maker(np.random.RandomState(_SEED))))
    return jm, pm


def _figure_data(fig):
    """Everything a reader sees on a figure, axis by axis, as plain data."""
    axes = []
    for ax in fig.axes:
        legend = ax.get_legend()
        axes.append({
            "lines": [(np.asarray(ln.get_xdata(), dtype=np.float64), np.asarray(ln.get_ydata(), dtype=np.float64),
                       ln.get_label(), ln.get_marker(), ln.get_linestyle()) for ln in ax.lines],
            "images": [np.asarray(im.get_array()) for im in ax.images],
            "bars": [(p.get_x(), p.get_width(), p.get_height()) for p in ax.patches],
            "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
            "title": ax.get_title(),
            "labels": (ax.get_xlabel(), ax.get_ylabel()),
            "ticks": ([t.get_text() for t in ax.get_xticklabels()], [t.get_text() for t in ax.get_yticklabels()]),
            "legend": [t.get_text() for t in legend.get_texts()] if legend is not None else None,
            "ylim": ax.get_ylim(),
        })
    return axes


def _assert_same_figures(jout, pout, rtol=_RTOL):
    jfig, pfig = jout[0], pout[0]
    try:
        jdata, pdata = _figure_data(jfig), _figure_data(pfig)
        assert len(jdata) == len(pdata)
        for ja, pa in zip(jdata, pdata):
            assert len(ja["lines"]) == len(pa["lines"])
            for (jx, jy, *jrest), (px, py, *prest) in zip(ja["lines"], pa["lines"]):
                np.testing.assert_allclose(px, jx, atol=_ATOL, rtol=rtol)
                np.testing.assert_allclose(py, jy, atol=_ATOL, rtol=rtol)
                assert prest == jrest
            assert len(ja["images"]) == len(pa["images"])
            for ji, pi in zip(ja["images"], pa["images"]):
                assert pi.dtype.kind == ji.dtype.kind
                np.testing.assert_allclose(pi, ji, atol=_ATOL, rtol=rtol)
            np.testing.assert_allclose(np.asarray(pa["bars"], dtype=np.float64).reshape(-1, 3),
                                       np.asarray(ja["bars"], dtype=np.float64).reshape(-1, 3), atol=_ATOL, rtol=rtol)
            assert pa["texts"] == ja["texts"]
            for key in ("title", "labels", "ticks", "legend"):
                assert pa[key] == ja[key], key
            np.testing.assert_allclose(pa["ylim"], ja["ylim"], atol=_ATOL, rtol=1e-6)
    finally:
        plt.close(jfig)
        plt.close(pfig)


@pytest.mark.parametrize("name", PLOTTED)
def test_plot_from_compute_draws_jax_s_figure(name):
    jm, pm = _pair(name)
    _assert_same_figures(jm.plot(), pm.plot(), rtol=_RTOL_OF.get(name, _RTOL))


@pytest.mark.parametrize("name", ["BinaryAccuracy", "MeanSquaredError", "SumMetric", "MulticlassF1Score"])
def test_plot_of_explicit_single_and_multi_values(name):
    jm, pm = _pair(name)
    jval, pval = jm.compute(), pm.compute()
    _assert_same_figures(jm.plot(jval), pm.plot(pval))
    jout, pout = jm.plot([jval, jval, jval]), pm.plot([pval, pval, pval])
    assert pout[1].get_xlabel() == "Step"
    _assert_same_figures(jout, pout)


@pytest.mark.parametrize("name", CURVES)
def test_curves_draw_jax_s_lines(name):
    jm, pm = _pair(name)
    jout, pout = jm.plot(), pm.plot()
    assert len(pout[1].lines) >= 1
    _assert_same_figures(jout, pout)


@pytest.mark.parametrize("name", ["BinaryROC", "MulticlassROC", "BinaryPrecisionRecallCurve"])
def test_curves_with_a_score_label_as_jax_s(name):
    jm, pm = _pair(name)
    jscore = np.asarray(0.5, np.float32) if name.startswith("Binary") else np.full(4, 0.25, np.float32)
    _assert_same_figures(jm.plot(score=jscore), pm.plot(score=torch.as_tensor(jscore)))


@pytest.mark.parametrize("name", CONFMATS)
def test_confusion_matrix_heatmap_and_texts_equal_jax_s(name):
    jm, pm = _pair(name)
    jout, pout = jm.plot(), pm.plot()
    axes = np.atleast_1d(pout[1]).reshape(-1)
    assert any(len(a.images) >= 1 for a in axes)
    _assert_same_figures(jout, pout)


def test_confusion_matrix_labels_and_no_text_as_jax_s():
    jm, pm = _pair("MulticlassConfusionMatrix")
    labels = ["a", "b", "c", "d"]
    _assert_same_figures(jm.plot(labels=labels, add_text=False), pm.plot(labels=labels, add_text=False))
    with pytest.raises(ValueError, match="labels") as perr:
        pm.plot(labels=labels[:2])
    with pytest.raises(ValueError) as jerr:
        jm.plot(labels=labels[:2])
    assert str(perr.value) == str(jerr.value)


def test_plot_onto_an_existing_axis():
    jm, pm = _pair("BinaryAccuracy")
    pfig, pax = plt.subplots()
    jfig, jax_ = plt.subplots()
    pout, jout = pm.plot(ax=pax), jm.plot(ax=jax_)
    assert pout[1] is pax and pout[0] is pfig
    _assert_same_figures(jout, pout)


def test_collection_plot_apart_and_together():
    r = np.random.RandomState(_SEED)
    preds, target = (np.asarray(a) for a in bin_cls(r))
    jcol = jtm.MetricCollection([jtm.BinaryAccuracy(), jtm.BinaryF1Score()])
    pcol = ptm.MetricCollection([ptm.BinaryAccuracy(device="cpu"), ptm.BinaryF1Score(device="cpu")])
    jcol.update(preds, target)
    pcol.update(torch.as_tensor(preds), torch.as_tensor(target))
    jouts, pouts = jcol.plot(), pcol.plot()
    assert isinstance(pouts, list) and len(pouts) == len(jouts) == 2
    for jout, pout in zip(jouts, pouts):
        _assert_same_figures(jout, pout)
    _assert_same_figures(jcol.plot(together=True), pcol.plot(together=True))


def test_compositional_metric_plot():
    jm = jtm.SumMetric() + 1.0
    pm = ptm.SumMetric(device="cpu") + 1.0
    jm.update(np.asarray([1.0, 2.0], np.float32))
    pm.update(torch.tensor([1.0, 2.0]))
    _assert_same_figures(jm.plot(), pm.plot())


def test_every_classification_export_is_plotted():
    exported = {n for n in ptm.classification.__all__ if inspect.isclass(getattr(ptm, n, None))}
    assert exported and exported <= set(PLOTTED), sorted(exported - set(PLOTTED))
    assert set(CLASSIFICATION) == exported


def test_without_matplotlib_plot_raises_jax_s_error(monkeypatch):
    import torchmetrics_tpu.utils.plot as jplot
    import torchmetrics_tpu_torch.utils.plot as pplot

    monkeypatch.setattr(pplot, "_MATPLOTLIB_AVAILABLE", False)
    monkeypatch.setattr(jplot, "_MATPLOTLIB_AVAILABLE", False)
    jm, pm = _pair("MulticlassConfusionMatrix")
    for call in (lambda m: m.plot(), lambda m: super(type(m), m).plot()):
        with pytest.raises(ModuleNotFoundError) as perr:
            call(pm)
        with pytest.raises(ModuleNotFoundError) as jerr:
            call(jm)
        assert str(perr.value) == str(jerr.value) == jplot._error_msg
    jc, pc = _pair("BinaryROC")
    with pytest.raises(ModuleNotFoundError, match="matplotlib is required"):
        pc.plot()
