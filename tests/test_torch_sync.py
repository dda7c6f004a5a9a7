"""Cross-process sync of the port on a real two-process ``torch.distributed`` world.

The counterpart of ``tests/multiproc/test_two_process_sync.py``: two worker processes
join one gloo world over ``tcp://localhost`` and run the port's actual sync stack, with
no fakes. A worker imports only torch and the port (it runs this file's
``_worker``; the JAX imports live inside the tests). Each rank takes its share of
seeded numpy data and writes what it saw after the sync; the test then holds both
ranks' results against the JAX package over all of the data in one process:
SUM/MEAN/MAX/MIN leaves, a ragged CAT with one empty rank, ``MaskedBuffer``
compaction, the ragged list gather, the host payload gather, a sharded F1, the
unbinned PR curve (buffered, and with lists where one rank saw nothing), a metric on
a ``process_group`` of its own, ``forward`` with ``dist_sync_on_step``, and a
``MetricCollection`` whose compute groups each sync once (the workers count the
``all_gather`` calls). A hung world is killed by ``communicate(timeout=...)``.

Integers must be equal; floats agree within ``ATOL`` = 1e-6. Then ``MaskedBuffer``
itself against the JAX package's ``core/buffer.py``: append, overflow and
``concat_gathered``.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from torchmetrics_tpu_torch.core.buffer import MaskedBuffer  # noqa: E402

ATOL = 1e-6
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N_PER_RANK = 40
C = 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ shared data


def _f1_data():
    rng = np.random.default_rng(0)
    return rng.integers(0, C, size=2 * N_PER_RANK), rng.integers(0, C, size=2 * N_PER_RANK)


def _curve_data():
    rng = np.random.default_rng(1)
    return rng.random(2 * N_PER_RANK).astype(np.float32), rng.integers(0, 2, size=2 * N_PER_RANK)


def _empty_rank_curve_data():
    return (np.random.default_rng(42).random(30).astype(np.float32),
            np.random.default_rng(43).integers(0, 2, 30))


def _collection_data(steps: int = 4, n: int = 24):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        logits = rng.standard_normal((n, C)).astype(np.float32)
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, n).astype(np.int32)))
    return out


def _collection_metrics(c, **kw):
    """``chip_smoke.py``'s ImageNet set at C=5 (``c``: a package's classification module)."""
    kw["validate_args"] = False
    return {
        "accuracy_top1": c.MulticlassAccuracy(C, average="micro", **kw),
        "accuracy_macro": c.MulticlassAccuracy(C, average="macro", **kw),
        "f1_macro": c.MulticlassF1Score(C, average="macro", **kw),
        "precision_macro": c.MulticlassPrecision(C, average="macro", **kw),
        "recall_macro": c.MulticlassRecall(C, average="macro", **kw),
        "confusion_matrix": c.MulticlassConfusionMatrix(C, **kw),
        "jaccard_macro": c.MulticlassJaccardIndex(C, average="macro", **kw),
        "matthews": c.MulticlassMatthewsCorrCoef(C, **kw),
        "cohen_kappa": c.MulticlassCohenKappa(C, **kw),
        "calibration_error_b15": c.MulticlassCalibrationError(C, n_bins=15, **kw),
        "auroc_t100": c.MulticlassAUROC(C, thresholds=100, **kw),
        "pr_curve_micro_t200": c.MulticlassPrecisionRecallCurve(C, average="micro", thresholds=200, **kw),
    }


# ----------------------------------------------------------------- the worker


def _to_json(x):
    if isinstance(x, dict):
        return {k: _to_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_json(v) for v in x]
    if isinstance(x, torch.Tensor):
        return {"dtype": str(x.dtype).removeprefix("torch."), "shape": list(x.shape), "values": x.flatten().tolist()}
    return x


def _worker(rank: int, port: int, out_path: str) -> None:
    """One rank of the two-process world: every check runs on both ranks, in one order."""
    import torch.distributed as dist

    import torchmetrics_tpu_torch.classification as tc
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.parallel import (
        Reduction,
        allgather_host_payloads,
        allgather_ragged_arrays,
        gather_all_tensors,
        sync_state,
        world_size,
    )

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    gathers = []
    all_gather = dist.all_gather
    dist.all_gather = lambda *a, **k: gathers.append(1) or all_gather(*a, **k)
    out = {"world": world_size()}

    local = torch.tensor(float(rank + 1))
    counts = torch.tensor([rank, 10 * rank + 1], dtype=torch.int32)
    res = sync_state({"s": local, "m": local, "mx": local, "mn": local, "i": counts},
                     {"s": Reduction.SUM, "m": Reduction.MEAN, "mx": Reduction.MAX, "mn": Reduction.MIN,
                      "i": Reduction.SUM})
    out["scalar_reductions"] = res

    rows = 2 if rank == 0 else 3
    x = (100.0 * rank + torch.arange(rows * 4, dtype=torch.float32)).reshape(rows, 4)
    out["ragged_cat_trailing_dims"] = sync_state({"c": [x[:1], x[1:]]}, {"c": Reduction.CAT})["c"]

    state = {"c": [torch.arange(6, dtype=torch.int32).reshape(3, 2)]} if rank == 0 else {"c": []}
    out["empty_rank_shape_dtype_adoption"] = sync_state(state, {"c": Reduction.CAT})["c"]

    buf = MaskedBuffer.create(4).append(torch.tensor([1.0 + 10 * rank, 2.0 + 10 * rank]))
    merged = sync_state({"v": buf}, {"v": Reduction.CAT})["v"]
    out["masked_buffer_compaction"] = {"capacity": merged.capacity, "count": merged.count, "values": merged.values()}

    arrays = ([torch.full((2, 4), 0.5), torch.full((1, 4), 5.5)] if rank == 0 else [torch.full((3, 4), 7.5)])
    out["allgather_ragged_arrays"] = allgather_ragged_arrays(arrays, ndim=2)
    out["gather_all_tensors"] = gather_all_tensors(torch.tensor([float(rank)]))
    out["allgather_host_payloads"] = [p.decode() for p in allgather_host_payloads(b"rank" * (rank + 1))]

    preds, target = _f1_data()
    mine = slice(rank * N_PER_RANK, (rank + 1) * N_PER_RANK)
    f1 = tc.MulticlassF1Score(num_classes=C, average="macro", device="cpu")
    f1.update(torch.as_tensor(preds[mine]), torch.as_tensor(target[mine]))
    out["f1_sharded_equals_alldata"] = f1.compute()

    group = dist.new_group(ranks=[0, 1])
    f1 = tc.MulticlassF1Score(num_classes=C, average="macro", device="cpu", process_group=group)
    f1.update(torch.as_tensor(preds[mine]), torch.as_tensor(target[mine]))
    out["explicit_process_group"] = f1.compute()

    # forward's batch value covers both ranks' batches; the global state stays local
    acc = tc.MulticlassAccuracy(num_classes=C, average="macro", device="cpu", dist_sync_on_step=True)
    out["dist_sync_on_step_forward"] = acc(torch.as_tensor(preds[mine]), torch.as_tensor(target[mine]))

    p, t = _curve_data()
    curve = tc.BinaryPrecisionRecallCurve(thresholds=None, buffer_capacity=64, device="cpu")
    curve.update(torch.as_tensor(p[mine]), torch.as_tensor(t[mine]))
    out["unbinned_prc_sharded_equals_alldata"] = curve.compute()

    p_all, t_all = _empty_rank_curve_data()
    curve = tc.BinaryPrecisionRecallCurve(thresholds=None, device="cpu")
    if rank == 0:  # rank 1 saw no data
        curve.update(torch.as_tensor(p_all), torch.as_tensor(t_all))
    out["empty_rank_end_to_end_prc"] = curve.compute()

    for grouped in (True, False):
        col = MetricCollection(_collection_metrics(tc, device="cpu"), compute_groups=grouped)
        for step, (probs, labels) in enumerate(_collection_data()):
            if step % 2 == rank:  # alternate batches
                col.update(torch.as_tensor(probs), torch.as_tensor(labels))
        del gathers[:]
        values = col.compute()
        key = "collection_grouped" if grouped else "collection_ungrouped"
        out[key] = {"values": values, "all_gathers": len(gathers),
                    "groups": [list(g) for g in col.compute_groups.values()],
                    "states_per_metric": {k: len(m._defaults) for k, m in col.items()}}

    dist.destroy_process_group()
    with open(f"{out_path}.{rank}.json", "w") as fh:
        json.dump(_to_json(out), fh)
    print(f"WORKER {rank} OK", flush=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' results, from one two-process world."""
    out = str(tmp_path_factory.mktemp("sync") / "result")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import test_torch_sync as t;"
            " t._worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])")
    procs = [
        subprocess.Popen([sys.executable, "-c", code, HERE, str(rank), str(port), out],
                         env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the two-process world hung (rendezvous or a collective)")
    for rank, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    results = []
    for rank in range(2):
        with open(f"{out}.{rank}.json") as fh:
            results.append(json.load(fh))
    return results


def _tensor(record) -> np.ndarray:
    return np.asarray(record["values"], dtype=record["dtype"].replace("bool", "bool_")).reshape(record["shape"])


def _assert_same(want, got, where: str) -> None:
    """``want``: numpy / JAX values; ``got``: a worker's JSON record of tensors."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(got, dict) and "dtype" in got:
        want, got = np.asarray(want), _tensor(got)
        assert got.shape == want.shape, f"{where}: {got.shape} != {want.shape}"
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=where)
        else:
            assert got.dtype == want.dtype, f"{where}: {got.dtype} != {want.dtype}"
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


@functools.lru_cache(maxsize=None)  # each rank's test reads the same reference
def _jax_reference(case: str):
    """What the JAX package gives over all of the data, in one process."""
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu import MetricCollection

    if case == "scalar_reductions":
        return {"s": np.float32(3.0), "m": np.float32(1.5), "mx": np.float32(2.0), "mn": np.float32(1.0),
                "i": np.asarray([1, 12], dtype=np.int32)}
    if case == "ragged_cat_trailing_dims":
        return np.concatenate([np.arange(8, dtype=np.float32).reshape(2, 4),
                               100.0 + np.arange(12, dtype=np.float32).reshape(3, 4)])
    if case == "empty_rank_shape_dtype_adoption":
        return np.arange(6, dtype=np.int32).reshape(3, 2)
    if case == "masked_buffer_compaction":
        return {"capacity": 8, "count": 4, "values": np.asarray([1.0, 2.0, 11.0, 12.0], np.float32)}
    if case == "allgather_ragged_arrays":
        return [np.full((2, 4), 0.5, np.float32), np.full((1, 4), 5.5, np.float32), np.full((3, 4), 7.5, np.float32)]
    if case == "gather_all_tensors":
        return [np.asarray([0.0], np.float32), np.asarray([1.0], np.float32)]
    if case == "allgather_host_payloads":
        return ["rank", "rankrank"]
    if case == "f1_sharded_equals_alldata":
        preds, target = _f1_data()
        m = jc.MulticlassF1Score(num_classes=C, average="macro", distributed_available_fn=lambda: False)
        m.update(jnp.asarray(preds), jnp.asarray(target))
        return np.asarray(m.compute())
    if case == "explicit_process_group":
        return _jax_reference("f1_sharded_equals_alldata")
    if case == "dist_sync_on_step_forward":
        preds, target = _f1_data()
        m = jc.MulticlassAccuracy(num_classes=C, average="macro", distributed_available_fn=lambda: False)
        m.update(jnp.asarray(preds), jnp.asarray(target))
        return np.asarray(m.compute())
    if case == "unbinned_prc_sharded_equals_alldata":
        p, t = _curve_data()
        m = jc.BinaryPrecisionRecallCurve(thresholds=None, buffer_capacity=128, distributed_available_fn=lambda: False)
        m.update(jnp.asarray(p), jnp.asarray(t))
        return [np.asarray(v) for v in m.compute()]
    if case == "empty_rank_end_to_end_prc":
        p, t = _empty_rank_curve_data()
        m = jc.BinaryPrecisionRecallCurve(thresholds=None, distributed_available_fn=lambda: False)
        m.update(jnp.asarray(p), jnp.asarray(t))
        return [np.asarray(v) for v in m.compute()]
    col = MetricCollection(_collection_metrics(jc), compute_groups=case == "collection_grouped")
    for probs, labels in _collection_data():
        col.update(jnp.asarray(probs), jnp.asarray(labels))
    values = {k: [np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v)
              for k, v in col.compute().items()}
    return {"values": values, "groups": [list(g) for g in col.compute_groups.values()]}


CASES = ["scalar_reductions", "ragged_cat_trailing_dims", "empty_rank_shape_dtype_adoption",
         "masked_buffer_compaction", "allgather_ragged_arrays", "gather_all_tensors", "allgather_host_payloads",
         "f1_sharded_equals_alldata", "explicit_process_group", "dist_sync_on_step_forward",
         "unbinned_prc_sharded_equals_alldata", "empty_rank_end_to_end_prc",
         "collection_grouped", "collection_ungrouped"]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_jax_on_all_the_data(world, case, rank):
    got = world[rank]
    assert got["world"] == 2
    want = _jax_reference(case)
    if case.startswith("collection"):
        _assert_same(want["values"], got[case]["values"], f"rank {rank} {case}")
        assert got[case]["groups"] == want["groups"]
    else:
        _assert_same(want, got[case], f"rank {rank} {case}")


def test_each_compute_group_syncs_once(world):
    """A grouped ``compute`` syncs each group's leader once: one ``all_gather`` per
    state of each leader, against one per state of every metric ungrouped."""
    for rank in range(2):
        grouped, ungrouped = world[rank]["collection_grouped"], world[rank]["collection_ungrouped"]
        states = grouped["states_per_metric"]
        assert grouped["all_gathers"] == sum(states[g[0]] for g in grouped["groups"])
        assert ungrouped["all_gathers"] == sum(states.values())
        assert grouped["all_gathers"] < ungrouped["all_gathers"]


# ------------------------------------------------- MaskedBuffer against core/buffer.py


def _jax_buffer():
    from torchmetrics_tpu.core.buffer import MaskedBuffer as JaxMaskedBuffer

    return JaxMaskedBuffer


@pytest.mark.parametrize("item_shape, dtype", [((), "float32"), ((3,), "float32"), ((), "int32"), ((), "bool")])
def test_masked_buffer_append_matches_jax(item_shape, dtype):
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    batches = [(rng.rand(n, *item_shape) * 10).astype(dtype) for n in (3, 0, 4, 1)]
    jbuf = _jax_buffer().create(10, item_shape, getattr(jnp, dtype if dtype != "bool" else "bool_"))
    tbuf = MaskedBuffer.create(10, item_shape, getattr(torch, dtype))
    for b in batches:
        jbuf, tbuf = jbuf.append(jnp.asarray(b)), tbuf.append(torch.as_tensor(b))
    assert tbuf.count == int(jbuf.count) == 8 and tbuf.capacity == jbuf.capacity
    np.testing.assert_array_equal(tbuf.data.numpy(), np.asarray(jbuf.data))
    np.testing.assert_array_equal(tbuf.mask.numpy(), np.asarray(jbuf.mask))
    np.testing.assert_array_equal(tbuf.values().numpy(), np.asarray(jbuf.values()))
    first = tbuf.data
    tbuf.append(torch.as_tensor(batches[-1]))
    assert tbuf.data is first and tbuf.count == 8  # an append returns a new buffer


def test_masked_buffer_overflow_raises_as_jax_does():
    import jax.numpy as jnp

    jbuf = _jax_buffer().create(4).append(jnp.ones(3))
    tbuf = MaskedBuffer.create(4).append(torch.ones(3))
    with pytest.raises(ValueError, match="MaskedBuffer overflow") as jerr:
        jbuf.append(jnp.ones(2))
    with pytest.raises(ValueError, match="MaskedBuffer overflow") as terr:
        tbuf.append(torch.ones(2))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("counts", [(2, 3, 0), (0, 0, 0), (4, 4, 4), (1, 0, 4)])
def test_masked_buffer_concat_gathered_matches_jax(counts):
    import jax.numpy as jnp

    rng = np.random.RandomState(sum(counts))
    data = rng.rand(len(counts), 4, 2).astype(np.float32)
    want = _jax_buffer().create(4, (2,)).concat_gathered(jnp.asarray(data), jnp.asarray(counts, dtype=jnp.int32))
    got = MaskedBuffer.create(4, (2,)).concat_gathered(torch.as_tensor(data), counts)
    assert got.count == int(want.count) and got.capacity == want.capacity
    np.testing.assert_array_equal(got.values().numpy(), np.asarray(want.values()))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    with pytest.raises(ValueError, match="overflowed before sync"):
        MaskedBuffer.create(4).concat_gathered(torch.zeros(2, 4), [5, 0])


BUFFERED = {
    "binary_prc": lambda m, **k: m.BinaryPrecisionRecallCurve(ignore_index=-1, **k),
    "binary_auroc": lambda m, **k: m.BinaryAUROC(ignore_index=-1, **k),
    "binary_ap": lambda m, **k: m.BinaryAveragePrecision(ignore_index=-1, **k),
    "multiclass_prc": lambda m, **k: m.MulticlassPrecisionRecallCurve(C, ignore_index=-1, **k),
    "multiclass_prc_micro": lambda m, **k: m.MulticlassPrecisionRecallCurve(C, average="micro", **k),
    "multiclass_auroc": lambda m, **k: m.MulticlassAUROC(C, ignore_index=-1, **k),
}


def _buffered_batches(name: str, steps: int = 3, n: int = 16):
    rng = np.random.RandomState(len(name))
    out = []
    for _ in range(steps):
        if name.startswith("binary"):
            preds = rng.rand(n).astype(np.float32)
            target = rng.randint(0, 2, n)
        else:
            logits = rng.randn(n, C).astype(np.float32)
            preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
            target = rng.randint(0, C, n)
        target = np.where(rng.rand(n) < 0.2, -1, target) if "micro" not in name else target
        out.append((preds, target.astype(np.int32)))
    return out


@pytest.mark.parametrize("name", sorted(BUFFERED))
def test_buffered_curve_states_match_jax(name):
    """``buffer_capacity`` keeps unbinned states in MaskedBuffers: the same values as the
    JAX package, the same ``state_dict`` (``data`` and ``count``), and a JAX state loads."""
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu_torch.classification as tc
    from torchmetrics_tpu_torch.convert import load_jax_state

    capacity = 48 * (C if "micro" in name else 1)
    jm = BUFFERED[name](jc, buffer_capacity=capacity)
    tm = BUFFERED[name](tc, buffer_capacity=capacity, device="cpu")
    batches = _buffered_batches(name)
    for preds, target in batches[:2]:
        want, got = jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.as_tensor(preds), torch.as_tensor(target))
        _assert_same(_np_tree(want), _to_json(got), f"{name} forward")
    state = {k: {"data": np.asarray(v["data"]), "count": np.asarray(v["count"])}
             for k, v in jm.state_dict(persistent_only=False).items()}
    got_state = tm.state_dict(persistent_only=False)
    assert sorted(got_state) == sorted(state)
    for k, v in state.items():
        assert int(got_state[k]["count"]) == int(v["count"])
        np.testing.assert_array_equal(got_state[k]["data"].numpy(), v["data"])
    loaded = load_jax_state(BUFFERED[name](tc, buffer_capacity=capacity, device="cpu"), state)
    preds, target = batches[2]
    for m in (jm, tm, loaded):
        m.update(jnp.asarray(preds) if m is jm else torch.as_tensor(preds),
                 jnp.asarray(target) if m is jm else torch.as_tensor(target))
    want = _np_tree(jm.compute())
    _assert_same(want, _to_json(tm.compute()), f"{name} compute")
    _assert_same(want, _to_json(loaded.compute()), f"{name} loaded")
    with pytest.raises(ValueError, match="MaskedBuffer overflow"):
        tm.update(torch.as_tensor(np.concatenate([preds] * 4)), torch.as_tensor(np.concatenate([target] * 4)))


def _np_tree(x):
    if isinstance(x, (list, tuple)):
        return [_np_tree(v) for v in x]
    return np.asarray(x)
