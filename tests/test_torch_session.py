"""The port's session plane held against the JAX package's: metric checkpoints,
session bundles (checkpoint, verify, delta chains, continuous policy, restore),
leases, fencing and failover.

Counterparts of ``tests/core/test_checkpoint.py``, ``tests/core/test_fence.py`` and
``tests/core/test_migrate.py`` (``TestZeroLossRoundTrip``, ``TestBundleRejection``,
``TestSessionStateRoundTrip``, ``TestPathTraversal``, ``TestDeltaChains``,
``TestContinuousPolicy``, ``TestOperatorCLI``; the multiplexer's cases wait for its
slice). Each scenario runs in both packages on the same seeded numpy batches and
what it observes must be the same: integers exactly, floats within 1e-5.

Session bundles are one on-disk format for both packages, so the last tests move
sessions between them: a session the JAX package checkpoints mid-stream is restored
and finished by the port and equals JAX's unmigrated control, and a bundle the port
writes passes JAX's ``verify_bundle`` and restores in JAX. Wall clocks are passed in
(``now=``) or the cadence's last stamp is moved back; no test sleeps.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.engine.migrate as jmigrate  # noqa: E402
import torchmetrics_tpu.obs.alerts as jalerts  # noqa: E402
import torchmetrics_tpu.obs.lineage as jlineage  # noqa: E402
import torchmetrics_tpu.obs.scope as jscope  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu.obs.values as jvalues  # noqa: E402
import torchmetrics_tpu.robust.fence as jfence  # noqa: E402
import torchmetrics_tpu.utils.checkpoint as jckpt  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.engine.migrate as tmigrate  # noqa: E402
import torchmetrics_tpu_torch.obs.alerts as talerts  # noqa: E402
import torchmetrics_tpu_torch.obs.lineage as tlineage  # noqa: E402
import torchmetrics_tpu_torch.obs.scope as tscope  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
import torchmetrics_tpu_torch.obs.values as tvalues  # noqa: E402
import torchmetrics_tpu_torch.robust.fence as tfence  # noqa: E402
import torchmetrics_tpu_torch.utils.checkpoint as tckpt  # noqa: E402
from torchmetrics_tpu import MetricCollection as JCollection  # noqa: E402
from torchmetrics_tpu.aggregation import CatMetric as JCat  # noqa: E402
from torchmetrics_tpu.engine import MetricPipeline as JPipeline  # noqa: E402
from torchmetrics_tpu.engine import PipelineConfig as JConfig  # noqa: E402
from torchmetrics_tpu.regression import MeanSquaredError as JMSE  # noqa: E402
from torchmetrics_tpu_torch import Metric  # noqa: E402
from torchmetrics_tpu_torch import MetricCollection as TCollection  # noqa: E402
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer  # noqa: E402
from torchmetrics_tpu_torch.engine import MetricPipeline as TPipeline  # noqa: E402
from torchmetrics_tpu_torch.engine import PipelineConfig as TConfig  # noqa: E402

ATOL = 1e-5


class MeanSquaredError(Metric):
    """The JAX package's ``MeanSquaredError`` (one output), under its name."""

    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs):
        super().__init__(**{"device": "cpu", **kwargs})
        self.add_state("sum_squared_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds, target):
        diff = preds.to(torch.float32) - target.to(torch.float32)
        self.sum_squared_error = self.sum_squared_error + (diff * diff).sum()
        self.total = self.total + preds.numel()

    def compute(self):
        return self.sum_squared_error / self.total


class CatMetric(Metric):
    """The JAX package's ``CatMetric(capacity=...)``: a ``MaskedBuffer`` of values."""

    full_state_update = True

    def __init__(self, capacity, **kwargs):
        super().__init__(**{"device": "cpu", **kwargs})
        self.add_state("value", MaskedBuffer.create(capacity), dist_reduce_fx="cat")

    def update(self, value):
        self.value = self.value.append(value.to(torch.float32).reshape(-1))

    def compute(self):
        return self.value.values()


def _jax_cat(capacity):
    return JCat(capacity=capacity, nan_strategy="disable")


JAX = SimpleNamespace(
    name="jax", arr=jnp.asarray, migrate=jmigrate, fence=jfence, scope=jscope, alerts=jalerts, values=jvalues,
    lineage=jlineage, trace=jtrace, ckpt=jckpt, Pipeline=JPipeline, Config=JConfig, Policy=jmigrate.CheckpointPolicy,
    Collection=JCollection, mse=JMSE, cat=_jax_cat,
    acc=lambda **k: jc.MulticlassAccuracy(num_classes=4, average="micro", validate_args=False, **k),
    f1=lambda: jc.MulticlassF1Score(num_classes=4, average="macro", validate_args=False),
    auroc=lambda: jc.MulticlassAUROC(num_classes=4, thresholds=10, validate_args=False),
    calib=lambda: jc.MulticlassCalibrationError(num_classes=4, n_bins=5, validate_args=False),
    bauroc=lambda: jc.BinaryAUROC(),
)
TORCH = SimpleNamespace(
    name="torch", arr=lambda a: torch.as_tensor(np.asarray(a)), migrate=tmigrate, fence=tfence, scope=tscope,
    alerts=talerts, values=tvalues, lineage=tlineage, trace=ttrace, ckpt=tckpt, Pipeline=TPipeline, Config=TConfig,
    Policy=tmigrate.CheckpointPolicy, Collection=TCollection, mse=MeanSquaredError, cat=CatMetric,
    acc=lambda **k: tc.MulticlassAccuracy(num_classes=4, average="micro", validate_args=False, device="cpu", **k),
    f1=lambda: tc.MulticlassF1Score(num_classes=4, average="macro", validate_args=False, device="cpu"),
    auroc=lambda: tc.MulticlassAUROC(num_classes=4, thresholds=10, validate_args=False, device="cpu"),
    calib=lambda: tc.MulticlassCalibrationError(num_classes=4, n_bins=5, validate_args=False, device="cpu"),
    bauroc=lambda: tc.BinaryAUROC(device="cpu"),
)
PACKAGES = (JAX, TORCH)


@pytest.fixture(autouse=True)
def _clean():
    for P in PACKAGES:
        P.trace.disable()
        P.trace.get_recorder().clear()
        P.values.disable()
        P.values.get_log().clear()
        P.scope.reset()
        P.fence.install_watchdog(None)
        P.alerts.uninstall()
    yield
    for P in PACKAGES:
        P.trace.disable()
        P.trace.get_recorder().clear()
        P.values.disable()
        P.values.get_log().clear()
        P.scope.reset()
        P.fence.install_watchdog(None)
        P.alerts.uninstall()


# --------------------------------------------------------------------- helpers


def _class_batches(P, n, batch=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(P.arr(rng.rand(batch, classes).astype(np.float32)), P.arr(rng.randint(0, classes, batch)))
            for _ in range(n)]


def _pair_batches(P, n, size=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(P.arr(rng.rand(size).astype(np.float32)), P.arr(rng.rand(size).astype(np.float32))) for _ in range(n)]


def _cat_batches(P, n, size=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(P.arr(rng.rand(size).astype(np.float32)),) for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _value(x):
    """A computed value as numpy (dicts and tuples kept)."""
    if isinstance(x, dict):
        return {k: _value(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_value(v) for v in x]
    return _np(x)


def _assert_same(a, b, where="obs"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{where}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{where}: shape {a.shape} != {b.shape}"
        if np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), atol=ATOL, rtol=0, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=ATOL), f"{where}: {a} != {b}"
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _bits(value):
    arr = _np(value)
    return (str(arr.dtype), arr.tobytes())


def _raises(fn, exc, match=None):
    """The exception type name and whether ``match`` is in its message."""
    try:
        fn()
    except exc as err:
        return (type(err).__name__, match is None or match in str(err))
    return None


def _reseal(path, schema=None):
    """Recompute a bundle's integrity record after an edit (a valid-looking impostor)."""
    digest = tckpt.file_tree_digest(path, exclude=("INTEGRITY.json",))
    record = {"version": 1, "sha256": digest}
    if schema is not None:
        record["schema"] = schema
    with open(os.path.join(path, "INTEGRITY.json"), "w", encoding="utf-8") as fh:
        json.dump(record, fh)


def _edit_manifest(path, mutate, reseal=True, schema=None):
    manifest_file = os.path.join(path, "MANIFEST.json")
    with open(manifest_file, encoding="utf-8") as fh:
        manifest = json.load(fh)
    mutate(manifest)
    with open(manifest_file, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, sort_keys=True, indent=2)
    if reseal:
        _reseal(path, schema)


def _flip(path, offset=12):
    with open(path, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1) or b"\x00"
        fh.seek(offset)
        fh.write(bytes([byte[0] ^ 0xFF]))


def _bundle(P, tmp_path, n_fed=4, tenant="rej", fuse=2, seed=0):
    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=fuse, tenant=tenant))
    for b in _class_batches(P, n_fed, seed=seed):
        pipe.feed(*b)
    path = str(tmp_path / P.name / "bundle")
    P.migrate.checkpoint_session(pipe, path)
    pipe.close()
    return path


def _cat_session(P, tmp_path, tenant, every_batches=1, lease_seconds=30.0):
    policy = P.Policy(directory=str(tmp_path / P.name / tenant), every_batches=every_batches, full_every=4,
                      keep=16, segment_bytes=4096)
    return P.Pipeline(P.cat(1 << 12), P.Config(fuse=1, tenant=tenant, checkpoint=policy,
                                               lease_seconds=lease_seconds))


def _feed(P, pipe, n, seed=0, size=6):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        pipe.feed(P.arr(rng.rand(size).astype(np.float32)))


# ------------------------------------------------------------ metric checkpoints


def _ckpt_roundtrips(P, tmp_path):
    root = tmp_path / P.name
    out = {}
    rng = np.random.RandomState(7)
    metric = P.acc()
    for _ in range(3):
        metric.update(P.arr(rng.rand(16, 4).astype(np.float32)), P.arr(rng.randint(0, 4, 16)))
    path = P.ckpt.save_checkpoint(metric, str(root / "scalar"))
    restored = P.acc()
    P.ckpt.load_checkpoint(restored, path)
    batch = (P.arr(rng.rand(16, 4).astype(np.float32)), P.arr(rng.randint(0, 4, 16)))
    out["scalar"] = (_value(restored.compute()), restored.update_count)
    metric.update(*batch)
    restored.update(*batch)
    out["resumed"] = (_value(restored.compute()), _value(metric.compute()))
    auroc = P.bauroc()  # unbinned: ragged list states
    p, t = rng.rand(32).astype(np.float32), rng.randint(0, 2, 32)
    for i in range(0, 32, 8):
        auroc.update(P.arr(p[i:i + 8]), P.arr(t[i:i + 8]))
    path = P.ckpt.save_checkpoint(auroc, str(root / "list"))
    out["list"] = _value(P.ckpt.load_checkpoint(P.bauroc(), P.ckpt.save_checkpoint(auroc, str(root / "list"))).compute())
    empty = P.ckpt.load_checkpoint(P.bauroc(), P.ckpt.save_checkpoint(P.bauroc(), str(root / "empty")))
    out["empty"] = (empty.update_count, len(empty.preds))
    cat = P.cat(16)
    cat.update(P.arr(np.array([1.0, 2.0, 3.0], dtype=np.float32)))
    back = P.ckpt.load_checkpoint(P.cat(16), P.ckpt.save_checkpoint(cat, str(root / "buffer")))
    out["buffer"] = [_value(back.compute())]
    back.update(P.arr(np.array([4.0], dtype=np.float32)))
    out["buffer"].append(_value(back.compute()))
    col = P.Collection({"acc": P.acc(), "mse": P.mse()})
    col["acc"].update(P.arr(rng.rand(8, 4).astype(np.float32)), P.arr(rng.randint(0, 4, 8)))
    col["mse"].update(P.arr(rng.rand(8).astype(np.float32)), P.arr(rng.rand(8).astype(np.float32)))
    path = P.ckpt.save_checkpoint(col, str(root / "col"))
    fresh = P.Collection({"acc": P.acc(), "mse": P.mse()})
    P.ckpt.load_checkpoint(fresh, path)
    out["collection"] = _value(fresh.compute())
    out["into_metric"] = _raises(lambda: P.ckpt.load_checkpoint(P.acc(), path), ValueError, "MetricCollection")
    out["missing_entry"] = _raises(lambda: P.ckpt.load_checkpoint(P.Collection({"f1": P.f1()}), path), KeyError, "f1")
    mse = P.mse()
    mse.update(P.arr(np.array([1.0], dtype=np.float32)), P.arr(np.array([1.0], dtype=np.float32)))
    path = P.ckpt.save_checkpoint(mse, str(root / "cache"))
    live = P.mse()
    live.update(P.arr(np.array([0.0], dtype=np.float32)), P.arr(np.array([10.0], dtype=np.float32)))
    out["cache"] = [float(live.compute())]
    P.ckpt.load_checkpoint(live, path)
    out["cache"].append(float(live.compute()))
    return out


def test_metric_checkpoints_round_trip_as_jax_does(tmp_path):
    """``tests/core/test_checkpoint.py``: scalar, list, empty-list, buffer and
    collection states out and back into fresh metrics, resuming alike."""
    _assert_same(_ckpt_roundtrips(JAX, tmp_path), _ckpt_roundtrips(TORCH, tmp_path))


def test_a_port_metric_checkpoint_is_atomic_and_verified(tmp_path):
    """The port writes the session-bundle layout (no orbax): a tampered file, a
    missing record or a symlink raises; a save interrupted between its renames is
    recovered from the displaced sibling; a second save swaps in whole."""
    metric = TORCH.acc()
    for b in _class_batches(TORCH, 2):
        metric.update(*b)
    path = tckpt.save_checkpoint(metric, str(tmp_path / "ckpt"))
    assert sorted(os.listdir(path)) == ["INTEGRITY.json", "MANIFEST.json", "state.npz"]
    tckpt.save_checkpoint(metric, path)  # overwrite: no .old/.tmp sibling is left
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    displaced = str(tmp_path / "ckpt.old.123.abcd.0")
    os.rename(path, displaced)
    with pytest.warns(RuntimeWarning, match="recovering"):
        assert tckpt.load_checkpoint(TORCH.acc(), path).update_count == 2
    os.rename(displaced, path)
    _flip(os.path.join(path, "state.npz"), 40)
    with pytest.raises(tckpt.CheckpointIntegrityError, match="integrity check"):
        tckpt.load_checkpoint(TORCH.acc(), path)
    tckpt.save_checkpoint(metric, path)
    os.remove(os.path.join(path, "INTEGRITY.json"))
    with pytest.raises(tckpt.CheckpointIntegrityError, match="INTEGRITY.json"):
        tckpt.load_checkpoint(TORCH.acc(), path)
    tckpt.save_checkpoint(metric, path)
    os.symlink(str(tmp_path), os.path.join(path, "evil"))
    with pytest.raises(tckpt.CheckpointIntegrityError, match="symlink"):
        tckpt.load_checkpoint(TORCH.acc(), path)


# ---------------------------------------------------------------- zero loss


def _zero_loss(P, tmp_path, factory, batches_fn, cut):
    batches = batches_fn(P)
    control = factory(P)
    cpipe = P.Pipeline(control, P.Config(fuse=4, tenant="ctl"))
    for b in batches:
        cpipe.feed(*b)
    cpipe.close()
    origin = factory(P)
    pipe = P.Pipeline(origin, P.Config(fuse=4, tenant="mig"))
    for b in batches[:cut]:
        pipe.feed(*b)
    P.migrate.checkpoint_session(pipe, str(tmp_path / P.name / "bundle"))
    pipe.close()
    restored = factory(P)
    pipe2, manifest = P.migrate.restore_session(restored, str(tmp_path / P.name / "bundle"))
    for b in batches[cut:]:
        pipe2.feed(*b)
    pipe2.close()
    want, got = control.compute(), restored.compute()
    bitwise = (_bits(want) == _bits(got)) if not isinstance(want, dict) else \
        all(_bits(want[k]) == _bits(got[k]) for k in want)
    return {"cursor": manifest["cursor"]["batches_ingested"], "members": sorted(manifest["members"]),
            "value": _value(got), "bitwise_control": bitwise}


ZERO_LOSS = {
    "accuracy": (lambda P: P.acc(), lambda P: _class_batches(P, 10), 6),
    "mse": (lambda P: P.mse(), lambda P: _pair_batches(P, 10), 6),
    "collection": (lambda P: P.Collection({"acc": P.acc(), "f1": P.f1(), "auroc": P.auroc(), "calib": P.calib()}),
                   lambda P: _class_batches(P, 9, seed=3), 5),
}


@pytest.mark.parametrize("case", sorted(ZERO_LOSS))
def test_restored_session_is_bitwise_its_unmigrated_control_as_in_jax(case, tmp_path):
    want, got = (_zero_loss(P, tmp_path, *ZERO_LOSS[case]) for P in PACKAGES)
    _assert_same(want, got, case)
    assert got["bitwise_control"] and want["bitwise_control"]


def _drain_and_tail(P, tmp_path):
    out = {}
    batches = _class_batches(P, 5)
    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=8))
    for b in batches:
        pipe.feed(*b)  # 5 < fuse: the chunk is still open
    manifest = P.migrate.checkpoint_session(pipe, str(tmp_path / P.name / "drained"))
    out["drained"] = (manifest["cursor"], metric.update_count)
    pipe.close()
    batches = _class_batches(P, 8, seed=1)
    control = P.acc()
    for b in batches:
        control.update(*b)
    origin = P.acc()
    pipe = P.Pipeline(origin, P.Config(fuse=4))
    for b in batches[:6]:
        pipe.feed(*b)
    manifest = P.migrate.checkpoint_session(pipe, str(tmp_path / P.name / "tail"), tail=batches[6:])
    pipe.close()
    restored = P.acc()
    pipe2, _ = P.migrate.restore_session(restored, str(tmp_path / P.name / "tail"))
    pipe2.close()
    out["tail"] = (manifest["cursor"]["tail_batches"], manifest["tail"], _bits(restored.compute()) ==
                   _bits(control.compute()), _value(restored.compute()))
    for item in (out["drained"][0], ):
        item["lineage"] = {k: v for k, v in item["lineage"].items() if k != "epoch"}
    return out


def test_drain_dispatches_the_open_chunk_and_the_caller_tail_rides_as_in_jax(tmp_path):
    want, got = _drain_and_tail(JAX, tmp_path), _drain_and_tail(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["tail"][2]


# ---------------------------------------------------------------- rejection


def _rejections(P, tmp_path):
    root = tmp_path / P.name
    out = {"missing": _raises(lambda: P.migrate.verify_bundle(str(root / "nope")),
                              P.migrate.SessionBundleError, "No session bundle")}
    path = _bundle(P, tmp_path)
    _flip(os.path.join(path, "state.npz"))
    target = P.acc()
    rows_before = len(P.scope.get_registry())
    out["flipped"] = _raises(lambda: P.migrate.restore_session(target, path), P.migrate.SessionBundleError,
                             "integrity check")
    out["untouched"] = (target.update_count, len(P.scope.get_registry()) - rows_before)
    path = _bundle(P, tmp_path)
    text = open(os.path.join(path, "MANIFEST.json")).read()
    with open(os.path.join(path, "MANIFEST.json"), "w") as fh:
        fh.write(text[: len(text) // 2])
    out["truncated"] = _raises(lambda: P.migrate.restore_session(P.acc(), path), P.migrate.SessionBundleError,
                               "integrity check")
    path = _bundle(P, tmp_path)
    os.remove(os.path.join(path, "INTEGRITY.json"))
    out["no_record"] = _raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError,
                               "no INTEGRITY.json")
    path = _bundle(P, tmp_path)
    _edit_manifest(path, lambda m: m.update(schema_version=P.migrate.SESSION_SCHEMA + 1))
    out["schema"] = _raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError, "schema")
    path = _bundle(P, tmp_path)
    out["wrong_class"] = _raises(lambda: P.migrate.restore_session(P.mse(), path), P.migrate.SessionBundleError,
                                 "MulticlassAccuracy")
    with open(os.path.join(path, "extra.bin"), "wb") as fh:
        fh.write(b"\x00")
    out["smuggled"] = _raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError,
                              "integrity check")
    path = _bundle(P, tmp_path)
    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=2, tenant="rej2"))
    for b in _class_batches(P, 2, seed=9):
        pipe.feed(*b)
    P.migrate.checkpoint_session(pipe, path)
    pipe.close()
    manifest = P.migrate.verify_bundle(path)
    out["overwrite"] = (manifest["tenant"], manifest["cursor"]["batches_ingested"],
                        sorted(os.listdir(os.path.dirname(path))))
    return out


def test_bad_bundles_are_refused_as_jax_refuses_them(tmp_path):
    want, got = _rejections(JAX, tmp_path), _rejections(TORCH, tmp_path)
    _assert_same(want, got)
    assert all(v is not None and v[1] for k, v in got.items() if k not in ("untouched", "overwrite"))


def _path_traversal(P, tmp_path):
    root = tmp_path / P.name
    out = {}
    path = _bundle(P, tmp_path)
    outside = root / "outside.txt"
    outside.write_text("secret")
    os.symlink(str(outside), os.path.join(path, "evil"))
    target = P.acc()
    out["file"] = (_raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError, "symlink"),
                   _raises(lambda: P.migrate.restore_session(target, path), P.migrate.SessionBundleError, "symlink"),
                   target.update_count)
    shutil.rmtree(path)
    path = _bundle(P, tmp_path)
    (root / "outside_dir").mkdir()
    (root / "outside_dir" / "x.bin").write_bytes(b"\x00")
    os.symlink(str(root / "outside_dir"), os.path.join(path, "evil_dir"))
    out["dir"] = _raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError, "symlink")
    tree = root / "tree"
    tree.mkdir()
    (tree / "ok.bin").write_bytes(b"\x01")
    os.symlink(str(root / "elsewhere"), str(tree / "link"))
    out["utils"] = _raises(lambda: P.ckpt.file_tree_digest(str(tree)), P.ckpt.CheckpointIntegrityError, "symlink")
    shutil.rmtree(path)
    path = _bundle(P, tmp_path)
    _edit_manifest(path, lambda m: m.update(base={"name": "../../etc", "bundle_id": "x"}))
    out["base_name"] = _raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError, "base")
    return out


def test_path_traversal_is_refused_as_jax_refuses_it(tmp_path):
    want, got = _path_traversal(JAX, tmp_path), _path_traversal(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["file"][0][1] and got["dir"][1] and got["utils"][1] and got["base_name"][1]


# ------------------------------------------------------ session state round trip


def _session_state(P, tmp_path):
    root = tmp_path / P.name
    out = {}
    clock = [1000.0]
    log = P.values.ValueLog()
    engine = P.alerts.AlertEngine(rules=[
        P.alerts.AlertRule(name="nan-watch", kind="non_finite", metric="MeanSquaredError"),
        P.alerts.AlertRule(name="slow-burn", kind="threshold", series="engine.batches", above=0.5, for_seconds=30.0),
    ], value_log=log, clock=lambda: clock[0])
    log.record("MeanSquaredError", "0", "value", 3, float("nan"), wall=999.0)
    P.trace.get_recorder().inc("engine.batches", 2.0)
    engine.evaluate()
    metric = P.mse()
    pipe = P.Pipeline(metric, P.Config(fuse=2, tenant="alerts-t", alert_engine=engine))
    for b in _pair_batches(P, 3):
        pipe.feed(*b)
    P.migrate.checkpoint_session(pipe, str(root / "alerts"), value_log=log)
    pipe.close()
    clock2 = [clock[0] + 10.0]
    log2 = P.values.ValueLog()
    engine2 = P.alerts.AlertEngine(value_log=log2, clock=lambda: clock2[0])
    pipe2, _ = P.migrate.restore_session(P.mse(), str(root / "alerts"), alert_engine=engine2, value_log=log2)
    states = {a["rule"]: (a["state"], a["since"]) for a in engine2.active()}
    P.trace.get_recorder().inc("engine.batches", 2.0)
    clock2[0] = 1031.0
    out["alerts"] = (sorted(r.name for r in engine2.rules()), states,
                     [(t["rule"], t["to"]) for t in engine2.evaluate() if t["rule"] == "slow-burn"])
    pipe2.close()

    log = P.values.ValueLog()
    engine = P.alerts.AlertEngine(value_log=log)
    pipe = P.Pipeline(P.mse(), P.Config(fuse=2, tenant="values-t", alert_engine=engine, alert_every=1))
    for b in _pair_batches(P, 5):
        pipe.feed(*b)
    pipe.flush()
    origin = [(r["leaf"], [tuple(p) for p in r["points"]]) for r in log.series() if r["tenant"] == "values-t"]
    P.migrate.checkpoint_session(pipe, str(root / "values"), value_log=log)
    pipe.close()
    log2 = P.values.ValueLog()
    pipe2, _ = P.migrate.restore_session(P.mse(), str(root / "values"), value_log=log2)
    restored = [(r["leaf"], [tuple(p) for p in r["points"]]) for r in log2.series() if r["tenant"] == "values-t"]
    out["values"] = (restored == origin, [[p[0] for p in pts] for _, pts in restored])
    pipe2.close()

    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=2, tenant="deg-t"))
    for b in _class_batches(P, 3):
        pipe.feed(*b)
    metric.sync_degraded = True
    P.migrate.checkpoint_session(pipe, str(root / "degraded"))
    pipe.close()
    restored_metric = P.acc()
    pipe2, manifest = P.migrate.restore_session(restored_metric, str(root / "degraded"))
    out["degraded"] = (restored_metric.sync_degraded, manifest["robust"])
    pipe2.close()

    metric = P.acc(error_policy="quarantine")
    pipe = P.Pipeline(metric, P.Config(fuse=2, tenant="rob-t", flight_records=16))
    batches = _class_batches(P, 4)
    poisoned = (P.arr(np.full((16, 4), np.nan, np.float32)), batches[0][1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b in batches[:2] + [poisoned] + batches[2:]:
            pipe.feed(*b)
        pipe.flush()
    P.migrate.checkpoint_session(pipe, str(root / "robust"))
    pipe.close()
    robust = P.acc(error_policy="quarantine")
    pipe2, _ = P.migrate.restore_session(robust, str(root / "robust"))
    out["robust"] = (robust.updates_quarantined, robust.updates_ok, robust.update_count)
    pipe2.close()

    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=2, tenant="fl-t", flight_records=8))
    for b in _class_batches(P, 5):
        pipe.feed(*b)
    pipe.flush()
    origin_records, origin_report = pipe.flight_records(), pipe.report()
    P.migrate.checkpoint_session(pipe, str(root / "flight"))
    pipe.close()
    pipe2, _ = P.migrate.restore_session(P.acc(), str(root / "flight"))
    ring = pipe2.flight_records()
    report = pipe2.report()
    pipe2.feed(*_class_batches(P, 1, seed=7)[0])
    out["flight"] = ([r["batch_index"] for r in ring] == [r["batch_index"] for r in origin_records],
                     (report.batches, report.dispatches, origin_report.batches, origin_report.dispatches),
                     (pipe2.report().batches, pipe2.flight_records()[-1]["batch_index"]))
    pipe2.close()

    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=2, tenant="reg-t"))
    for b in _class_batches(P, 4):
        pipe.feed(*b)
    pipe.flush()
    P.migrate.checkpoint_session(pipe, str(root / "registry"))
    pipe.close()
    origin_row = next(r for r in P.scope.get_registry().rows() if r["tenant"] == "reg-t")
    P.scope.reset()  # another process: a pristine registry
    pipe2, _ = P.migrate.restore_session(P.acc(), str(root / "registry"))
    row = next(r for r in P.scope.get_registry().rows() if r["tenant"] == "reg-t")
    out["registry"] = (origin_row["updates"], row["updates"], row["active_pipelines"],
                       row["first_seen_unix"] <= origin_row["first_seen_unix"])
    pipe2.close()
    return out


def test_session_state_round_trips_as_in_jax(tmp_path):
    """Alert machines resume with their dwell clocks, value timelines keep their step
    anchors, ``sync_degraded``, the guard counters, the flight ring, the report and
    the registry row continue across the move."""
    want, got = _session_state(JAX, tmp_path), _session_state(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["alerts"][2] == [("slow-burn", "firing")] and got["values"][0]


def test_history_restore_merges_by_timestamp_as_in_jax():
    snapshot = {"rules": [], "alerts": [], "history": [
        {"rule": "r", "series": "s", "from": "inactive", "to": "firing", "at": 50.0},
        {"rule": "r", "series": "s", "from": "firing", "to": "resolved", "at": 60.0}]}
    outs = []
    for P in PACKAGES:
        engine = P.alerts.AlertEngine()
        engine._history.append({"rule": "r", "series": "s", "from": "inactive", "to": "firing", "at": 200.0})
        engine.restore_state(json.loads(json.dumps(snapshot)))
        outs.append(([r["at"] for r in engine.history()], engine.fire_resolve_times()))
    _assert_same(outs[0], outs[1])
    assert outs[1][0] == [50.0, 60.0, 200.0]


# ------------------------------------------------------------------ delta chains


def _build_chain(P, tmp_path, n_batches=9, every=2, full_every=8):
    directory = str(tmp_path / P.name / "stream")
    metric = P.cat(1 << 14)
    pipe = P.Pipeline(metric, P.Config(fuse=2, tenant="chain-t", checkpoint=P.Policy(
        directory=directory, every_batches=every, full_every=full_every, keep=64, segment_bytes=4096)))
    batches = _cat_batches(P, n_batches)
    for b in batches:
        pipe.feed(*b)
    pipe.flush()
    bundles = sorted(name for name in os.listdir(directory) if name.startswith("bundle-"))
    return directory, bundles, batches, pipe


def _delta_chains(P, tmp_path):
    out = {}
    directory, bundles, batches, pipe = _build_chain(P, tmp_path)
    stats = pipe._checkpointer.stats
    manifests = [json.load(open(os.path.join(directory, name, "MANIFEST.json"))) for name in bundles]
    out["chain"] = (bundles, {k: v["count"] for k, v in stats.items()},
                    stats["delta"]["bytes"] / stats["delta"]["count"] < 0.5 * stats["full"]["bytes"] / stats["full"]["count"],
                    [m["base"] is None for m in manifests],
                    all(m["base"]["bundle_id"] == prev["bundle_id"] and set(m["written"]) < set(m["entries"])
                        for prev, m in zip(manifests, manifests[1:])),
                    [len(m["written"]) for m in manifests], [sorted(m["entries"].items()) for m in manifests])
    pipe.close()
    prefixes = []
    for name in bundles:
        target = P.cat(1 << 14)
        restored_pipe, manifest = P.migrate.restore_session(target, os.path.join(directory, name))
        restored_pipe.close()
        control = P.cat(1 << 14)
        for b in batches[:manifest["cursor"]["batches_ingested"]]:
            control.update(*b)
        prefixes.append((manifest["cursor"]["batches_ingested"], _bits(target.compute()) == _bits(control.compute())))
    out["prefixes"] = prefixes
    tampered = []
    for name in bundles:
        for fname in sorted(os.listdir(os.path.join(directory, name))):
            copy_root = str(tmp_path / P.name / f"copy_{name}_{fname}")
            shutil.copytree(directory, copy_root)
            victim = os.path.join(copy_root, name, fname)
            _flip(victim, max(0, os.path.getsize(victim) // 2))
            tampered.append(_raises(lambda: P.migrate.verify_bundle(os.path.join(copy_root, bundles[-1])),
                                    P.migrate.SessionBundleError))
            shutil.rmtree(copy_root)
    out["tampered"] = tampered
    top = os.path.join(directory, bundles[-1])
    compacted = str(tmp_path / P.name / "compacted")
    manifest = P.migrate.compact_chain(top, compacted)
    a, b = P.cat(1 << 14), P.cat(1 << 14)
    pa, _ = P.migrate.restore_session(a, top)
    pb, _ = P.migrate.restore_session(b, compacted)
    pa.close(), pb.close()
    out["compacted"] = (manifest["base"], sorted(manifest["written"]) == sorted(manifest["entries"]),
                        manifest["compacted_from"] == P.migrate.verify_bundle(top)["bundle_id"],
                        _bits(a.compute()) == _bits(b.compute()))
    out["sweep_keeps_chain"] = P.migrate.sweep_bundles(directory, keep=1)
    P.migrate.verify_bundle(top)
    new_pipe, _ = P.migrate.restore_session(P.cat(1 << 14), top)
    new_pipe.feed(*_cat_batches(P, 1, seed=5)[0])
    new_full = P.migrate.checkpoint_session(new_pipe, os.path.join(directory, "bundle-100000"))
    new_pipe.close()
    removed = P.migrate.sweep_bundles(directory, keep=1)
    out["sweep_after_full"] = (new_full["base"], len(removed), sorted(os.listdir(directory)))
    directory, bundles, _, pipe = _build_chain(P, tmp_path / "imposter")
    pipe.close()
    imposter = P.Pipeline(P.cat(1 << 14), P.Config(fuse=2))
    for batch in _cat_batches(P, 2, seed=9):
        imposter.feed(*batch)
    P.migrate.checkpoint_session(imposter, os.path.join(directory, bundles[0]))
    imposter.close()
    out["substituted"] = _raises(lambda: P.migrate.verify_bundle(os.path.join(directory, bundles[-1])),
                                 P.migrate.SessionBundleError, "bundle_id")
    return out


def test_delta_chains_match_jax(tmp_path):
    """Delta bundles write only the changed segments, with the same entry names and
    content hashes as JAX's; every chain prefix restores; a tampered link, a
    substituted base are refused; compaction and the retention sweep as in JAX."""
    want, got = _delta_chains(JAX, tmp_path), _delta_chains(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["chain"][2] and got["chain"][4] and all(ok for _, ok in got["prefixes"])
    assert all(t is not None for t in got["tampered"]) and got["substituted"][1]


# -------------------------------------------------------------- continuous policy


def _continuous(P, tmp_path):
    root = tmp_path / P.name
    out = {"validation": [
        _raises(lambda: P.Policy(directory="/tmp/x", every_batches=0, every_seconds=0), ValueError, "cadence"),
        _raises(lambda: P.Policy(directory="/tmp/x", every_batches=1, full_every=0), ValueError, "full_every"),
        _raises(lambda: P.Policy(directory="/tmp/x", every_batches=1, keep=0), ValueError, "keep"),
        _raises(lambda: P.Policy(directory="/tmp/x", every_batches=1, stale_after_seconds=0), ValueError,
                "stale_after_seconds")]}
    directory = str(root / "cadence")
    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=2, checkpoint=P.Policy(directory=directory, every_batches=2, keep=64)))
    for b in _class_batches(P, 5):
        pipe.feed(*b)
    bundles = sorted(n for n in os.listdir(directory) if n.startswith("bundle-"))
    manifest = P.migrate.verify_bundle(os.path.join(directory, bundles[-1]))
    out["cadence"] = (len(bundles), manifest["cursor"]["batches_ingested"], metric.update_count)
    pipe.close()
    out["closed"] = P.migrate.verify_bundle(P.migrate.latest_valid_bundle(directory))["cursor"]["batches_ingested"]

    directory = str(root / "seconds")
    pipe = P.Pipeline(P.acc(), P.Config(fuse=1, checkpoint=P.Policy(directory=directory, every_seconds=3600.0,
                                                                     keep=64)))
    pipe.feed(*_class_batches(P, 1)[0])
    first = len(os.listdir(directory)) if os.path.isdir(directory) else 0
    pipe._checkpointer._last_time -= 3601.0  # an hour has passed since the last bundle
    pipe.feed(*_class_batches(P, 1, seed=1)[0])
    out["seconds"] = (first, len(os.listdir(directory)))
    pipe.close()

    directory = str(root / "now")
    pipe = P.Pipeline(P.acc(), P.Config(fuse=4, checkpoint=P.Policy(directory=directory, every_batches=1000)))
    pipe.feed(*_class_batches(P, 1)[0])
    out["now"] = (pipe.checkpoint_now() is not None, P.migrate.latest_valid_bundle(directory) is not None)
    pipe.close()

    blocker = root / "blocked"
    blocker.write_text("a file where the directory should be")
    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=1, checkpoint=P.Policy(directory=str(blocker), every_batches=1)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b in _class_batches(P, 4, seed=2):
            pipe.feed(*b)
    out["unwritable"] = (sum("Continuous checkpoint" in str(w.message) for w in caught),
                         pipe._checkpointer.failures, metric.update_count)
    pipe.close()

    directory = str(root / "gauges")
    pipe = P.Pipeline(P.acc(), P.Config(fuse=1, tenant="gauge-t", checkpoint=P.Policy(
        directory=directory, every_batches=1, stale_after_seconds=3600.0)))
    for b in _class_batches(P, 3):
        pipe.feed(*b)
    info = P.scope.record_gauges()
    names = {g["name"] for g in P.trace.get_recorder().snapshot()["gauges"]}
    out["gauges"] = (info["checkpoint_rows"], "checkpoint.last_success_age_seconds" in names,
                     "checkpoint.bundle_bytes" in names, P.scope.checkpoint_status()["gauge-t"]["bundles"])
    pipe.close()
    last = P.scope.checkpoint_status()["gauge-t"]["last_unix"]
    out["closed_promise"] = (P.scope.checkpoint_overdue(now=last + 1e6), P.scope.checkpoint_status()["gauge-t"]["closed"])
    P.trace.get_recorder().clear()
    P.scope.record_gauges()
    out["closed_gauge"] = ("checkpoint.last_success_age_seconds", "gauge-t") in {
        (g["name"], g["labels"].get("tenant")) for g in P.trace.get_recorder().snapshot()["gauges"]}
    pipe2, _ = P.migrate.restore_session(P.acc(), P.migrate.latest_valid_bundle(directory), checkpoint=P.Policy(
        directory=directory, every_batches=1, stale_after_seconds=3600.0))
    pipe2.feed(*_class_batches(P, 1, seed=4)[0])
    out["reopened"] = P.scope.checkpoint_status()["gauge-t"]["closed"]
    pipe2.close()

    P.lineage.enable()
    directory = str(root / "lineage")
    pipe = P.Pipeline(P.acc(), P.Config(fuse=2, tenant="lin-t", checkpoint=P.Policy(directory=directory,
                                                                                      every_batches=2)))
    for b in _class_batches(P, 5):
        pipe.feed(*b)
    covering = [P.lineage.get_index().covering_checkpoint(P.lineage.lookup(pipe.trace_id_for(i))) for i in range(5)]
    out["lineage_watermark"] = [None if c is None else (os.path.basename(c["path"]), c["covered_batches"])
                                for c in covering]
    pipe.close()
    P.lineage.disable()
    P.lineage.reset()

    directory = str(root / "dup")
    pipe = P.Pipeline(P.acc(), P.Config(fuse=2, checkpoint=P.Policy(directory=directory, every_batches=2, keep=64)))
    for b in _class_batches(P, 4):
        pipe.feed(*b)
    n_before = len(os.listdir(directory))
    pipe.close()
    out["no_duplicate"] = (n_before, len(os.listdir(directory)))

    P.scope.adopt("stale-t")
    P.scope.note_checkpoint("stale-t", path="/x", nbytes=10, kind="full", seconds=0.01, stale_after_seconds=5.0)
    P.scope._CHECKPOINTS["stale-t"]["last_unix"] -= 60.0  # the last bundle is a minute old
    engine = P.alerts.AlertEngine(rules=[P.migrate.checkpoint_staleness_rule(5.0, tenant="stale-*")])
    P.scope.record_gauges()
    engine.evaluate()
    out["stale"] = ([(a["rule"], a["tenant"]) for a in engine.firing()], sorted(P.scope.checkpoint_overdue()))
    return out


def test_continuous_checkpoint_policy_matches_jax(tmp_path):
    want, got = _continuous(JAX, tmp_path), _continuous(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["cadence"] == (2, 4, 4) and got["closed"] == 5 and got["seconds"][1] > got["seconds"][0]
    assert got["stale"][0] == [("checkpoint_stale", "stale-t")]
    # the first four batches are covered by the bundle written at the second commit
    assert got["lineage_watermark"] == [("bundle-000001", 4)] * 4 + [None]


# ------------------------------------------------------------ leases and fences


def _leases(P, tmp_path):
    out = {}
    lease = P.fence.mint_lease("t-a", epoch="ep1", ttl_seconds=30.0, now=1000.0)
    row = P.scope.lease_status()["t-a"]
    out["mint"] = ({k: v for k, v in lease.items() if k != "holder"}, row["epoch"], row["holder"] == lease["holder"],
                   bool(row.get("released")), lease["holder"] == P.fence.holder_id())
    out["ttl"] = _raises(lambda: P.fence.mint_lease("t-a", epoch="ep1", ttl_seconds=0.0), ValueError, "ttl_seconds")
    P.fence.renew_lease(lease, "t-a", now=1020.0)
    out["renew"] = (lease["expires_unix"], P.scope.lease_status()["t-a"]["expires_unix"])
    short = P.fence.mint_lease("t-g", epoch="ep9", ttl_seconds=10.0, now=1000.0)
    out["grace"] = [P.fence.lease_expired(short, now=n, grace=g) for n, g in
                    ((1009.0, 0.0), (1011.0, 0.0), (1011.0, 5.0), (1016.0, 5.0))] + \
        [P.fence.lease_expired(None, now=1e12)]
    P.scope.reset()
    for tenant, epoch, ttl in (("t-exp", "ep1", 0.001), ("t-rel", "ep2", 0.001), ("t-fen", "ep3", 0.001),
                               ("t-live", "ep4", 1e6)):
        P.fence.mint_lease(tenant, epoch=epoch, ttl_seconds=ttl, now=1000.0)
    P.scope.note_lease_released("t-rel")
    P.scope.note_fence("ep3", tenant="t-fen")
    out["stale"] = sorted(P.fence.stale_leases(now=2000.0))
    pipe = _cat_session(P, tmp_path, "lease-t")
    row = P.scope.lease_status()["lease-t"]
    live = (row["epoch"] == pipe.lineage_epoch, P.fence.lease_expired(row, now=time.time()))
    pipe.close()
    out["pipeline"] = (live, bool(P.scope.lease_status()["lease-t"].get("released")),
                       "lease-t" in P.fence.stale_leases(now=time.time() + 1e6))
    pipe = _cat_session(P, tmp_path, "renew-t")
    P.scope._LEASES["renew-t"]["renewed_unix"] -= 5.0  # the last renewal was 5 s ago
    before = P.scope.lease_status()["renew-t"]["renewed_unix"]
    _feed(P, pipe, 1)
    path = pipe.checkpoint_now()
    after = P.scope.lease_status()["renew-t"]["renewed_unix"]
    stamp = P.migrate.verify_bundle(path)["lease"]
    out["bundle_renews"] = (after > before, stamp["epoch"] == pipe.lineage_epoch,
                            stamp["holder"] == P.fence.holder_id(), abs(stamp["renewed_unix"] - after) < 1e-6,
                            sorted(stamp))
    directory = pipe.config.checkpoint.directory
    pipe.close()
    scanned = P.fence.scan_bundle_lease(directory)
    out["scan"] = (scanned["epoch"] == pipe.lineage_epoch, scanned["tenant"],
                   P.fence.scan_bundle_lease(str(tmp_path / "nowhere")))
    zombie = P.fence.mint_lease("clob-t", epoch="ep-old", ttl_seconds=30.0)
    P.scope.note_fence("ep-old", tenant="clob-t")
    P.fence.mint_lease("clob-t", epoch="ep-new", ttl_seconds=30.0)
    P.fence.renew_lease(zombie, "clob-t", now=time.time() + 999.0)
    out["clobber"] = P.scope.lease_status()["clob-t"]["epoch"]
    out["epoch_of"] = [P.lineage.epoch_of(i) for i in ("tenant-03-abc123-17", "__local__-deadbeef-0",
                                                        "team-a-shard-9-ep42-3", "no-ordinal-here", "short-1",
                                                        "t--3", "")]
    return out


def test_leases_match_jax(tmp_path):
    want, got = _leases(JAX, tmp_path), _leases(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["stale"] == ["t-exp"] and got["clobber"] == "ep-new" and all(got["bundle_renews"][:4])


def _fence_ledger(P, tmp_path):
    root = tmp_path / P.name
    out = {}
    directory = str(root / "bundles")
    os.makedirs(os.path.join(directory, "bundle-000000"))
    os.makedirs(os.path.join(directory, "bundle-000001.tmp.123.abc"))
    record = P.migrate.fence_epoch(directory, "ep-z", tenant="t-a", holder="host-b", by="host-a", target="host-a")
    payload = json.load(open(os.path.join(directory, "FENCED.json")))
    os.makedirs(os.path.join(directory, "bundle-000002"))
    again = P.migrate.fence_epoch(directory, "ep-z", tenant="t-a")
    out["record"] = ({k: v for k, v in record.items() if k != "fenced_unix"}, payload["version"],
                     payload["fences"]["ep-z"] == record, again["known"], P.scope.is_fenced("ep-z"),
                     P.scope.fence_status()["ep-z"]["target"])
    empty = str(root / "empty")
    out["corrupt"] = [P.migrate.fenced_epochs(empty)]
    os.makedirs(empty)
    with open(os.path.join(empty, "FENCED.json"), "w") as fh:
        fh.write("{not json")
    out["corrupt"].append(P.migrate.fenced_epochs(empty))
    # a zombie: pre-fence bundle, fence, a post-fence write that lands
    pipe = _cat_session(P, tmp_path, "zomb-t")
    directory = pipe.config.checkpoint.directory
    _feed(P, pipe, 2)
    pre = pipe.checkpoint_now()
    P.migrate.fence_epoch(directory, pipe.lineage_epoch, tenant="zomb-t", holder="host-b", by="host-a")
    _feed(P, pipe, 1, seed=1)
    post = pipe.checkpoint_now()
    before = P.scope.fenced_rejected_count()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        selected = P.migrate.latest_valid_bundle(directory)
    out["zombie"] = (os.path.isdir(post), _raises(lambda: P.migrate.verify_bundle(post),
                                                  P.migrate.FencedBundleError, "zombie"),
                     P.migrate.verify_bundle(pre)["lease"]["epoch"] == pipe.lineage_epoch,
                     P.migrate.verify_bundle(post, check_fence=False)["kind"], selected == pre,
                     P.scope.fenced_rejected_count() > before, sum("zombie" in str(w.message) for w in caught))
    epoch = pipe.lineage_epoch
    pipe.close()
    new_pipe, _ = P.migrate.restore_session(P.cat(1 << 12), pre, fresh_epoch=True, checkpoint=P.Policy(
        directory=directory, every_batches=1, segment_bytes=4096))
    _feed(P, new_pipe, 1, seed=2)
    successor = new_pipe.checkpoint_now()
    out["fresh_epoch"] = (new_pipe.lineage_epoch != epoch,
                          P.migrate.verify_bundle(successor)["lease"]["epoch"] == new_pipe.lineage_epoch,
                          P.migrate.latest_valid_bundle(directory) == successor)
    new_pipe.close()
    swept_before = P.scope.fenced_swept_count()
    removed = P.migrate.sweep_bundles(directory, keep=1000)
    out["sweep"] = ([os.path.basename(r) for r in removed] == [os.path.basename(post)],
                    P.scope.fenced_swept_count() - swept_before, os.path.isdir(pre))
    return out


def test_fence_ledger_and_zombie_bundles_match_jax(tmp_path):
    want, got = _fence_ledger(JAX, tmp_path), _fence_ledger(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["record"][3] == ["bundle-000000"] and got["zombie"][1][1] and all(got["fresh_epoch"])


def _failover(P, tmp_path):
    out = {}
    pipe = _cat_session(P, tmp_path, "fo-t")
    directory = pipe.config.checkpoint.directory
    _feed(P, pipe, 3)
    pipe.checkpoint_now()
    old_epoch = pipe.lineage_epoch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        new_pipe, report = P.fence.failover(P.cat(1 << 12), directory, tenant="fo-t", checkpoint=P.Policy(
            directory=directory, every_batches=1, segment_bytes=4096))
    out["failover"] = (report["fenced_epoch"] == old_epoch, report["new_epoch"] == new_pipe.lineage_epoch != old_epoch,
                       report["restored_cursor"], os.path.basename(report["bundle"]) in report["known_bundles"],
                       P.scope.is_fenced(old_epoch), int(_np(new_pipe.metric.compute()).size), sorted(report))
    new_pipe.close()
    pipe.close()
    empty = str(tmp_path / P.name / "empty")
    os.makedirs(empty)
    out["no_lease"] = _raises(lambda: P.fence.failover(P.mse(), empty, tenant="ghost"), RuntimeError,
                              "nothing to fence")
    bundles = str(tmp_path / P.name / "no_bundles")
    os.makedirs(bundles)
    P.fence.mint_lease("gone-t", epoch="ep-gone", ttl_seconds=30.0)
    out["no_bundle"] = _raises(lambda: P.fence.failover(P.mse(), bundles, tenant="gone-t"), RuntimeError,
                               "valid pre-fence bundle")
    return out


def test_failover_matches_jax(tmp_path):
    want, got = _failover(JAX, tmp_path), _failover(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["failover"][0] and got["failover"][1] and got["failover"][2] == 3


def _watched(P, tmp_path, tenant, ttl=30.0, config=None):
    pipe = _cat_session(P, tmp_path, tenant, lease_seconds=ttl)
    directory = pipe.config.checkpoint.directory
    _feed(P, pipe, 2)
    pipe.checkpoint_now()
    dog = P.fence.Watchdog()
    dog.watch(tenant, directory, lambda: P.cat(1 << 12), config or P.fence.WatchdogConfig(restore_overrides={
        "checkpoint": P.Policy(directory=directory, every_batches=1, segment_bytes=4096)}))
    return pipe, directory, dog


def _watchdog(P, tmp_path):
    out = {}
    pipe, _, dog = _watched(P, tmp_path, "wd-t", ttl=30.0)
    now = time.time()
    out["fresh"] = dog.tick(now=now)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        produced = dog.tick(now=now + 999.0)
    out["failed_over"] = ([(r["tenant"], r["fenced_epoch"] == pipe.lineage_epoch, r["restored_cursor"])
                           for r in produced], "wd-t" in dog._watches, len(dog.failovers))
    pipe.close()
    pipe, _, dog = _watched(P, tmp_path, "rel-t")
    pipe.close()
    out["released"] = dog.tick(now=time.time() + 999.0)
    pipe, directory, dog = _watched(P, tmp_path, "fen-t")
    P.scope.note_fence(pipe.lineage_epoch, tenant="fen-t")
    out["fenced"] = dog.tick(now=time.time() + 999.0)
    pipe.close()
    pipe, directory, dog = _watched(P, tmp_path, "fresh-t", config=P.fence.WatchdogConfig(
        require_checkpoint_stale=True, grace=1.0))
    P.scope._LEASES["fresh-t"]["expires_unix"] -= 100.0  # renewals were lost: the lease lapsed
    out["bundles_fresh"] = dog.tick(now=time.time() + 5.0)  # but its last bundle is 5 s old, within ttl + grace
    pipe.close()
    pipe, directory, dog = _watched(P, tmp_path, "err-t")
    dog._watches["err-t"]["metric_factory"] = lambda: P.mse()  # a wrong-spec target: the restore raises
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["error"] = (dog.tick(now=time.time() + 999.0), sum("failed" in str(w.message) for w in caught))
    pipe.close()
    directory = str(tmp_path / P.name / "claims")
    os.makedirs(directory)
    out["claims"] = [P.fence.claim_failover(directory, "ep-1", by="host-a"),
                     P.fence.claim_failover(directory, "ep-1", by="host-b"),
                     P.fence.claim_failover(directory, "ep-new", by="host-b")]
    out["claim"] = {k: v for k, v in json.load(open(os.path.join(directory, P.fence.CLAIM_FILE))).items()
                    if k != "claimed_unix"}
    pipe, directory, dog = _watched(P, tmp_path, "el-t")
    P.fence.claim_failover(directory, pipe.lineage_epoch, by="other-host")
    before = P.scope.failover_yielded_count()
    out["yield"] = (dog.tick(now=time.time() + 999.0), P.scope.failover_yielded_count() - before,
                    P.scope.is_fenced(pipe.lineage_epoch), "el-t" in dog._watches)
    pipe.close()
    return out


def test_watchdog_with_an_injected_clock_matches_jax(tmp_path):
    want, got = _watchdog(JAX, tmp_path), _watchdog(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["failed_over"][0] == [("wd-t", True, 2)] and got["yield"][1] == 1


def _schema_compat(P, tmp_path):
    out = {}
    pipe = _cat_session(P, tmp_path, "compat-t")
    _feed(P, pipe, 3)
    path = pipe.checkpoint_now()
    directory = pipe.config.checkpoint.directory
    pipe.close()

    def strip_lease(manifest):
        manifest["schema_version"] = 2
        manifest.pop("lease", None)

    _edit_manifest(path, strip_lease, schema=2)
    manifest = P.migrate.verify_bundle(path)
    P.scope.reset()
    new_pipe, _ = P.migrate.restore_session(P.cat(1 << 12), path)
    row = P.scope.lease_status()["compat-t"]
    out["schema2"] = (manifest["schema_version"], "lease" in manifest, int(_np(new_pipe.metric.compute()).size),
                      row["epoch"] == new_pipe.lineage_epoch, P.fence.lease_expired(row, now=time.time()))
    new_pipe.close()
    epoch = P.migrate._bundle_epoch(manifest)
    P.migrate.fence_epoch(directory, epoch, tenant="compat-t")
    out["fenceable"] = (epoch == pipe.lineage_epoch, P.migrate.verify_bundle(path)["schema_version"])
    pipe = _cat_session(P, tmp_path, "tamper-t")
    _feed(P, pipe, 2)
    pipe.checkpoint_now()
    path = pipe.checkpoint_now()
    pipe.close()
    _edit_manifest(path, lambda m: m["lease"].update(epoch="forged-epoch", holder="evil-host"), reseal=False)
    before = P.scope.torn_bundle_count()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        selected = P.migrate.latest_valid_bundle(os.path.dirname(path))
    out["tampered"] = (_raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError, "integrity"),
                       selected != path, P.scope.torn_bundle_count() > before)
    _edit_manifest(path, lambda m: m.update(schema_version=99))
    out["unknown"] = _raises(lambda: P.migrate.verify_bundle(path), P.migrate.SessionBundleError, "schema")
    return out


def test_schema_back_compat_matches_jax(tmp_path):
    want, got = _schema_compat(JAX, tmp_path), _schema_compat(TORCH, tmp_path)
    _assert_same(want, got)
    assert got["schema2"][:2] == (2, False) and got["tampered"][0][1]


# -------------------------------------------------------------------- the CLI


def _cli(P, tmp_path, capsys):
    out = {}
    path = _bundle(P, tmp_path, n_fed=3)
    out["intact"] = (P.migrate.main(["verify", path]), "chain depth 1" in capsys.readouterr().out)
    _flip(os.path.join(path, "state.npz"), 10)
    out["corrupt"] = (P.migrate.main(["verify", path]), "CORRUPT" in capsys.readouterr().err)
    directory, bundles, _, pipe = _build_chain(P, tmp_path / "cli")
    pipe.close()
    _flip(os.path.join(directory, bundles[0], "state.npz"), 10)
    out["chain"] = (P.migrate.main(["verify", os.path.join(directory, bundles[-1])]),
                    "CORRUPT" in capsys.readouterr().err)
    out["missing"] = (P.migrate.main(["verify", str(tmp_path / "nope")]), "cannot run" in capsys.readouterr().err)
    return out


def test_operator_cli_matches_jax(tmp_path, capsys):
    want, got = _cli(JAX, tmp_path, capsys), _cli(TORCH, tmp_path, capsys)
    _assert_same(want, got)
    assert got == {"intact": (0, True), "corrupt": (1, True), "chain": (1, True), "missing": (2, True)}
    path = _bundle(TORCH, tmp_path / "entry", n_fed=3)
    proc = subprocess.run([sys.executable, "-m", "torchmetrics_tpu_torch.engine.migrate", "verify", path],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


# ----------------------------------------------------------- across the packages


def _cross_set(P):
    return P.Collection({"acc": P.acc(), "f1": P.f1(), "auroc": P.auroc(), "calib": P.calib()})


def _states(col):
    return {name: {k: _np(v) for k, v in m.state_dict(persistent_only=False).items()}
            for name, m in col.items(keep_base=True)}


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_a_session_moves_between_the_packages_and_equals_the_unmigrated_control(direction, tmp_path):
    """One package checkpoints a tenant session mid-stream (with an alert engine, a
    caller tail and a continuous policy); the bundle passes the other package's
    ``verify_bundle`` (and its CLI), the other restores it, replays the tail, feeds
    the rest and computes: integers exactly, floats within 1e-5 of the origin
    package's unmigrated control, its report, registry row and value timelines
    continued."""
    src, dst = (JAX, TORCH) if direction == "jax_to_torch" else (TORCH, JAX)
    rng = np.random.RandomState(11)
    raw = [(rng.rand(16, 4).astype(np.float32), rng.randint(0, 4, 16).astype(np.int32)) for _ in range(11)]
    control = _cross_set(src)
    cpipe = src.Pipeline(control, src.Config(fuse=4))
    for p, t in raw:
        cpipe.feed(src.arr(p), src.arr(t))
    cpipe.close()

    engine = src.alerts.AlertEngine(rules=[src.alerts.AlertRule(name="nf", kind="non_finite")],
                                    value_log=src.values.ValueLog())
    origin = _cross_set(src)
    policy = src.Policy(directory=str(tmp_path / "stream"), every_batches=2, full_every=2, keep=8)
    pipe = src.Pipeline(origin, src.Config(fuse=4, tenant="moving", alert_engine=engine, checkpoint=policy))
    for p, t in raw[:6]:
        pipe.feed(src.arr(p), src.arr(t))
    bundle = str(tmp_path / "bundle")
    manifest = src.migrate.checkpoint_session(pipe, bundle, tail=[(src.arr(p), src.arr(t)) for p, t in raw[6:8]])
    pipe.close()

    assert dst.migrate.verify_bundle(bundle)["bundle_id"] == manifest["bundle_id"]
    assert dst.migrate.main(["verify", bundle, "--quiet"]) == 0
    stream = str(tmp_path / "stream")
    latest = dst.migrate.latest_valid_bundle(stream)
    assert latest == src.migrate.latest_valid_bundle(stream) and dst.migrate.verify_bundle(latest)["base"] is not None

    dst.scope.reset()
    engine2 = dst.alerts.AlertEngine(value_log=dst.values.ValueLog())
    restored = _cross_set(dst)
    pipe2, got_manifest = dst.migrate.restore_session(restored, bundle, alert_engine=engine2,
                                                      value_log=engine2._log())
    assert pipe2.report().batches == 8 and pipe2.lineage_epoch == manifest["cursor"]["lineage"]["epoch"]
    row = next(r for r in dst.scope.get_registry().rows() if r["tenant"] == "moving")
    assert row["updates"] == manifest["registry"]["updates"]
    assert [r.name for r in engine2.rules()] == ["nf"]
    carried = [s for s in engine2._log().series() if s["tenant"] == "moving"]
    assert carried and all(s["points"][-1][0] == 6 for s in carried)
    for p, t in raw[8:]:
        pipe2.feed(dst.arr(p), dst.arr(t))
    pipe2.close()
    assert pipe2.report().batches == 11 and pipe2.report().processed_batches() == 11
    _assert_same(_states(control), _states(restored), "states")
    _assert_same(_value(control.compute()), _value(restored.compute()), "values")


def test_both_packages_write_the_same_bundle_entries_for_the_same_session(tmp_path):
    """The same batches folded by both packages give bundles with the same JSON
    skeleton, the same entry names, the same segment split and the same SHA-256 of
    every entry's bytes."""
    manifests = []
    for P in PACKAGES:
        col = P.Collection({"acc": P.acc(), "cat": P.cat(1 << 15), "auroc": P.bauroc()})
        rng = np.random.RandomState(5)
        for _ in range(3):
            p = rng.rand(16).astype(np.float32)
            col["acc"].update(P.arr(rng.rand(16, 4).astype(np.float32)), P.arr(rng.randint(0, 4, 16)))
            col["cat"].update(P.arr(p))
            col["auroc"].update(P.arr(p), P.arr(rng.randint(0, 2, 16)))
        pipe = P.Pipeline(col, P.Config(fuse=2))
        manifests.append(P.migrate.checkpoint_session(pipe, str(tmp_path / P.name)))
        pipe.close()
    for key in ("entries", "written", "state_skeleton", "members", "metric_class", "collection", "kind",
                "schema_version", "config"):
        _assert_same(manifests[0][key], manifests[1][key], key)
    assert any(".p" in k for k in manifests[1]["entries"])  # the buffer was split into segments


def test_a_bundle_that_needs_admission_is_refused_naming_the_mux_slice(tmp_path):
    """JAX bundles whose session used admission (a non-default ``max_deferred``, a
    deferred backlog) or are a multiplexer's tenant slice restore only with the
    multiplexer slice."""
    path = _bundle(JAX, tmp_path, n_fed=4)
    for mutate in (lambda m: m["config"].update(max_deferred=8),
                   lambda m: m["cursor"].update(deferred_tail=2),
                   lambda m: m.update(mux_slice=True)):
        copy = str(tmp_path / "copy")
        shutil.copytree(path, copy)
        _edit_manifest(copy, mutate)
        target = TORCH.acc()
        with pytest.raises(NotImplementedError, match="mux"):
            tmigrate.restore_session(target, copy)
        assert target.update_count == 0
        shutil.rmtree(copy)
    pipe, manifest = tmigrate.restore_session(TORCH.acc(), path)  # the default knob restores
    assert manifest["config"]["max_deferred"] == 1024 and pipe.report().batches == 4
    pipe.close()
    with pytest.raises(NotImplementedError, match="mux"):
        tmigrate.checkpoint_session(pipe, str(tmp_path / "slice"), tenant="acme")
