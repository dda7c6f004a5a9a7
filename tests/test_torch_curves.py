"""Binary curves of the port (PR curve, ROC, AUROC) held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both packages (helpers shared
with ``test_torch_functional.py``). Integer results match exactly; float results
within 1e-6 (the two packages sum in different orders); binned threshold grids
bitwise. The multiclass curves are in ``test_torch_curves_multiclass.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
from test_torch_functional import _binary_inputs, both  # noqa: E402

THRESHOLDS = {"none": None, "int": 11, "list": [0.9, 0.1, 0.5, 0.25, 0.75, 0.0, 1.0]}


@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", ["binary_precision_recall_curve", "binary_roc", "binary_auroc"])
def test_binary_curves(fn, thresholds, ignore_index):
    preds, target = _binary_inputs(15, ignore_index, multidim=False)
    # ties: scores that sit exactly on grid thresholds
    preds[:8] = np.float32(0.5)
    preds[8:12] = np.float32(0.1)
    both(getattr(jf, fn), getattr(tf, fn), preds, target, thresholds=THRESHOLDS[thresholds],
         ignore_index=ignore_index)


@pytest.mark.parametrize("thresholds", [None, 100])
@pytest.mark.parametrize("max_fpr", [0.3, 1.0])
def test_binary_auroc_max_fpr(thresholds, max_fpr):
    preds, target = _binary_inputs(16, None, kind="logits", multidim=False)
    both(jf.binary_auroc, tf.binary_auroc, preds, target, thresholds=thresholds, max_fpr=max_fpr)


def test_binned_threshold_grid_is_bitwise():
    preds, target = _binary_inputs(20, None, multidim=False)
    for num in (42, 100, 200):
        _, _, want = jf.binary_precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), thresholds=num)
        _, _, got = tf.binary_precision_recall_curve(torch.from_numpy(preds), torch.from_numpy(target), thresholds=num)
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
