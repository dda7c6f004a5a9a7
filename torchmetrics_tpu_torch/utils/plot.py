"""Plotting support for ``Metric.plot()``, the JAX package's ``utils/plot.py``.

Optional matplotlib dependency: without it every entry point raises the JAX
package's ``ModuleNotFoundError``. All data is copied to host numpy before
plotting (a card tensor through ``.cpu()``), so the figures hold the same lines,
images and texts as the JAX package's for the same values.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

from torchmetrics_tpu_torch.utils.imports import _MATPLOTLIB_AVAILABLE

if _MATPLOTLIB_AVAILABLE:
    import matplotlib
    import matplotlib.pyplot as plt

    _AX_TYPE = matplotlib.axes.Axes
    _PLOT_OUT_TYPE = Tuple[plt.Figure, matplotlib.axes.Axes]
else:  # pragma: no cover
    _AX_TYPE = object
    _PLOT_OUT_TYPE = tuple

_error_msg = "matplotlib is required for plotting but is not installed."


def _get_col_row_split(n: int) -> Tuple[int, int]:
    """Smallest grid (rows, cols) that fits ``n`` plots."""
    nsq = np.sqrt(n)
    if int(nsq) == nsq:
        return int(nsq), int(nsq)
    if np.floor(nsq) * np.ceil(nsq) >= n:
        return int(np.floor(nsq)), int(np.ceil(nsq))
    return int(np.ceil(nsq)), int(np.ceil(nsq))


def trim_axs(axs, nb: int):
    axs = np.asarray(axs).reshape(-1)
    for ax in axs[nb:]:
        ax.remove()
    return axs[:nb]


def _to_np(x):
    if isinstance(x, dict):
        return {k: _to_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_np(v) for v in x]
    if hasattr(x, "detach") and hasattr(x, "cpu"):  # a torch tensor, on the card or not
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_single_or_multi_val(
    val,
    ax: Optional[Any] = None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Plot a single scalar result, a per-class vector, or a sequence over steps."""
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(_error_msg)
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.get_figure()

    val = _to_np(val)
    if isinstance(val, dict):
        for i, (k, v) in enumerate(val.items()):
            v = np.atleast_1d(v)
            if v.size == 1:
                ax.plot(i, float(v.reshape(-1)[0]), "o", label=k)
            else:
                ax.plot(v, label=k)
        ax.legend()
    elif isinstance(val, list):
        steps = np.arange(len(val))
        arr = np.stack([np.atleast_1d(v) for v in val])
        for c in range(arr.shape[1]):
            label = f"{legend_name or 'class'} {c}" if arr.shape[1] > 1 else (name or "metric")
            ax.plot(steps, arr[:, c], marker="o", label=label)
        ax.legend()
        ax.set_xlabel("Step")
    else:
        arr = np.atleast_1d(val)
        if arr.size == 1:
            ax.plot([0], [float(arr.reshape(-1)[0])], "o", label=name or "metric")
        elif arr.ndim >= 2:
            # multi-group values (e.g. per-class stat scores [C, 5]): one point
            # cluster per leading index (reference ``utilities/plot.py:98-110``)
            for i, row in enumerate(arr.reshape(arr.shape[0], -1)):
                ax.plot([i] * row.size, row, "o", linestyle="None",
                        label=f"{legend_name or 'group'} {i}")
        else:
            ax.bar(np.arange(arr.size), arr, label=name or "metric")
        ax.legend()
    if lower_bound is not None or upper_bound is not None:
        ax.set_ylim(lower_bound, upper_bound)
    if name:
        ax.set_title(name)
    ax.grid(True, alpha=0.3)
    return fig, ax


def plot_confusion_matrix(
    confmat,
    ax: Optional[Any] = None,
    add_text: bool = True,
    labels: Optional[Sequence[Union[str, int]]] = None,
    cmap: Optional[str] = None,
):
    """Heatmap plot of a ``[C, C]`` (or ``[N, 2, 2]`` multilabel) confusion matrix."""
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(_error_msg)
    confmat = _to_np(confmat)
    if confmat.ndim == 3:  # multilabel [N, 2, 2]
        nb, n_classes = confmat.shape[0], 2
        rows, cols = _get_col_row_split(nb)
    else:
        nb, n_classes, rows, cols = 1, confmat.shape[0], 1, 1

    if labels is not None and confmat.ndim != 3 and len(labels) != n_classes:
        raise ValueError("Expected number of elements in `labels` to match number of classes.")
    fig, axs = plt.subplots(nrows=rows, ncols=cols) if ax is None else (ax.get_figure(), ax)
    axs = trim_axs(axs, nb) if nb > 1 else [axs]
    for i in range(nb):
        cm = confmat[i] if confmat.ndim == 3 else confmat
        ax_ = axs[i]
        im = ax_.imshow(cm, cmap=cmap or "viridis")
        ticks = labels if (labels is not None and confmat.ndim != 3) else np.arange(cm.shape[0])
        ax_.set_xticks(np.arange(cm.shape[0]))
        ax_.set_yticks(np.arange(cm.shape[0]))
        ax_.set_xticklabels(ticks)
        ax_.set_yticklabels(ticks)
        ax_.set_xlabel("Predicted class")
        ax_.set_ylabel("True class")
        if add_text:
            for ii in range(cm.shape[0]):
                for jj in range(cm.shape[1]):
                    v = cm[ii, jj]
                    txt = f"{v:.2f}" if np.issubdtype(cm.dtype, np.floating) else str(int(v))
                    ax_.text(jj, ii, txt, ha="center", va="center")
    fig.colorbar(im, ax=axs[-1] if nb > 1 else axs[0])
    return fig, axs[0] if nb == 1 else axs


def plot_curve(
    curve,
    score=None,
    ax: Optional[Any] = None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Plot a (x, y, thresholds) style curve (ROC / PR)."""
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(_error_msg)
    x, y = _to_np(curve[0]), _to_np(curve[1])
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.get_figure()
    if isinstance(x, list) or (hasattr(x, "ndim") and np.asarray(x, dtype=object).ndim and isinstance(x, list)):
        for i, (xi, yi) in enumerate(zip(x, y)):
            label = f"{legend_name or 'class'} {i}"
            if score is not None:
                label += f" (score={float(_to_np(score)[i]):.3f})"
            ax.plot(np.asarray(xi), np.asarray(yi), label=label)
    elif np.asarray(x).ndim == 2:
        for i in range(np.asarray(x).shape[0]):
            label = f"{legend_name or 'class'} {i}"
            if score is not None:
                label += f" (score={float(_to_np(score)[i]):.3f})"
            ax.plot(x[i], y[i], label=label)
    else:
        label = name or "curve"
        if score is not None:
            label += f" (score={float(_to_np(score)):.3f})"
        ax.plot(x, y, label=label)
    if label_names:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    ax.legend()
    ax.grid(True, alpha=0.3)
    return fig, ax
