"""The port's ``utils/serialization.py`` and ``utils/imports.py`` against the JAX
package's: the same tree gives the same flat keys and the same ``.npz`` bytes, each
package loads what the other saved (card tensors are copied to the host first), and
the optional-dependency flags carry JAX's names and values."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torchmetrics_tpu.utils.imports as jimports
import torchmetrics_tpu.utils.serialization as jser
import torchmetrics_tpu_torch.utils.imports as pimports
import torchmetrics_tpu_torch.utils.serialization as pser

torch.set_num_threads(2)


def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {
        "encoder": {"w": r.randn(3, 4).astype(np.float32), "b": r.randn(4).astype(np.float32),
                    "deep": {"idx": r.randint(0, 9, (5,)).astype(np.int32), "flag": np.asarray(True)}},
        "head": r.randn(2, 2).astype(np.float64),
        "scalar": np.asarray(3, dtype=np.int64),
    }


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key])
        else:
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("as_torch", [False, True])
def test_flatten_and_unflatten_as_jax(as_torch):
    tree = _tree()
    flat_p = pser.flatten_tree(_torch_tree(tree) if as_torch else tree)
    flat_j = jser.flatten_tree(tree)
    assert list(flat_p) == list(flat_j)
    for key in flat_j:
        assert flat_p[key].dtype == flat_j[key].dtype and np.array_equal(flat_p[key], flat_j[key])
    _assert_trees_equal(pser.unflatten_tree(flat_p), jser.unflatten_tree(flat_j))


@pytest.mark.parametrize("writer", ["jax", "port", "port_torch"])
def test_each_package_loads_the_other_s_npz(tmp_path, writer):
    tree = _tree(1)
    path = str(tmp_path / "weights")  # no extension: both append .npz
    if writer == "jax":
        written = jser.save_tree_npz(path, tree)
    else:
        written = pser.save_tree_npz(path, _torch_tree(tree) if writer == "port_torch" else tree)
    assert written == path + ".npz" and os.path.isfile(written)
    _assert_trees_equal(jser.load_tree_npz(written), tree)
    _assert_trees_equal(pser.load_tree_npz(written), tree)


def test_npz_archives_hold_the_same_members_and_bytes(tmp_path):
    tree = _tree(2)
    jpath = jser.save_tree_npz(str(tmp_path / "j.npz"), tree)
    ppath = pser.save_tree_npz(str(tmp_path / "p.npz"), _torch_tree(tree))
    import zipfile

    with zipfile.ZipFile(jpath) as jz, zipfile.ZipFile(ppath) as pz:
        assert jz.namelist() == pz.namelist()
        for name in jz.namelist():
            assert jz.read(name) == pz.read(name), name


def test_separator_in_a_key_rejected_as_jax():
    with pytest.raises(ValueError) as jerr:
        jser.flatten_tree({"a/b": np.zeros(1)})
    with pytest.raises(ValueError) as perr:
        pser.flatten_tree({"a/b": torch.zeros(1)})
    assert str(perr.value) == str(jerr.value)


def test_import_flags_carry_jax_s_names_and_values():
    flags = sorted(n for n in vars(jimports) if n.startswith("_") and n.endswith("_AVAILABLE"))
    assert "_MATPLOTLIB_AVAILABLE" in flags
    for name in flags + ["_PYTHON_GREATER_EQUAL_3_11"]:
        assert getattr(pimports, name) == getattr(jimports, name), name


def test_snapshot_weight_stamp_as_jax(tmp_path):
    for name in ("model.safetensors", "pytorch_model.bin", "notes.txt"):
        (tmp_path / name).write_bytes(b"x" * 7)
    assert pimports.snapshot_weight_stamp(str(tmp_path)) == jimports.snapshot_weight_stamp(str(tmp_path))
    assert pimports.snapshot_weight_stamp(str(tmp_path / "missing")) == ()
