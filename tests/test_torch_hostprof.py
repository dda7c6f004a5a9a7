"""The port's host-path sampling profiler (``obs/hostprof.py``) held against the JAX package's.

- ``classify``: every stack of the JAX battery (``tests/core/test_hostprof.py``) and the
  port runtime's own seam stacks (the same relative file names: ``engine/pipeline.py``,
  ``engine/mux.py``, ``obs/scope.py``, ``obs/lineage.py``) get the same seam in both
  packages — except the C boundary (``dispatch-wait``), where each package names its
  own native entry: JAX an innermost ``/jax/`` or ``/jaxlib/`` frame or a
  ``block_until_ready`` caller, the port an innermost ``/torch/`` frame, a graph replay
  in ``core/jit.py``, a ctypes launch in ``ops/kernels.py``, a captured count read back
  in ``core/metric.py``, or a ``synchronize``/``item``/``cpu`` caller. That rule is
  pinned here on injected stacks, in both directions (ROADMAP Queue 3).
- ``sample_once`` with injected frames, tenants, spans and clock: the breakdowns, the
  tenant tables, the floor report, the collapsed stacks, the timeline's seam counts,
  the stats and the gauges of both packages are equal.
- the live sampler starts, samples and stops without leaking a thread, and
  ``profile_session`` brackets it; no case asserts a wall time.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.obs.hostprof as jhostprof  # noqa: E402
import torchmetrics_tpu.obs.scope as jscope  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu_torch.obs.hostprof as thostprof  # noqa: E402
import torchmetrics_tpu_torch.obs.profile as tprofile  # noqa: E402
import torchmetrics_tpu_torch.obs.scope as tscope  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402

SIDES = {
    "jax": SimpleNamespace(hostprof=jhostprof, scope=jscope, trace=jtrace),
    "port": SimpleNamespace(hostprof=thostprof, scope=tscope, trace=ttrace),
}


@pytest.fixture(autouse=True)
def _clean():
    for side in SIDES.values():
        side.trace.disable()
        side.trace.get_recorder().clear()
        side.scope.reset()
        side.hostprof.install(None)
    yield
    for side in SIDES.values():
        installed = side.hostprof.get_profiler()
        if installed is not None and installed.running:
            installed.stop()
        side.hostprof.install(None)
        side.scope.reset()
        side.trace.disable()
        side.trace.get_recorder().clear()


_PIPE = "torchmetrics_tpu_torch/engine/pipeline.py"
_MUX = "torchmetrics_tpu_torch/engine/mux.py"
_SCOPE = "torchmetrics_tpu_torch/obs/scope.py"
_LINEAGE = "torchmetrics_tpu_torch/obs/lineage.py"
_JIT = "torchmetrics_tpu_torch/core/jit.py"
_KERNELS = "torchmetrics_tpu_torch/ops/kernels.py"
_METRIC = "torchmetrics_tpu_torch/core/metric.py"
_JAX = "site-packages/jax/_src/pjit.py"
_TORCH = "site-packages/torch/cuda/__init__.py"

# stacks are innermost-first (file, func) pairs, what the sampler extracts from a frame
SHARED_STACKS = {
    "device_put": [(_JAX, "device_put"), (_PIPE, "_dispatch_chunk")],
    "stack_rows": [(_PIPE, "_stack_rows"), (_PIPE, "_dispatch_chunk")],
    "mux_stack_probe": [(_MUX, "_stack_probe"), (_MUX, "feed")],
    "tree_flatten_under_engine": [(_JIT, "tree_flatten"), (_PIPE, "feed")],
    "partition_static_leaves": [(_JIT, "partition_static_leaves"), (_MUX, "_dispatch_group")],
    "would_admit": [(_SCOPE, "would_admit"), (_PIPE, "feed")],
    "charge": [(_SCOPE, "charge"), (_MUX, "feed")],
    "admit": [(_SCOPE, "admit"), (_PIPE, "_admit_batch"), (_PIPE, "feed")],
    "lineage_mint": [(_LINEAGE, "mint"), (_PIPE, "feed")],
    "commit": [(_PIPE, "_commit"), (_PIPE, "_dispatch_chunk")],
    "engine_commit": [("torchmetrics_tpu_torch/collections.py", "_engine_commit"), (_PIPE, "_dispatch_chunk")],
    "dispatch_chunk": [(_PIPE, "_dispatch_chunk"), (_PIPE, "feed")],
    "mux_flush": [(_MUX, "flush")],
    "pipeline_drain": [(_PIPE, "drain")],
    "mux_replay_rows": [(_MUX, "_replay_rows")],
    "feed": [(_PIPE, "feed"), ("driver.py", "main")],
    "replay_under_engine": [(_JIT, "replay"), (_PIPE, "_dispatch_chunk")],
    "torch_under_engine": [(_TORCH, "synchronize"), (_PIPE, "_wait_inflight")],
    "serving_socketserver": [("x.py", "helper"), ("lib/socketserver.py", "handle")],
    "serving_http": [("x.py", "helper"), ("lib/http/server.py", "handle")],
    "serving_obs_server": [("x.py", "helper"), ("torchmetrics_tpu_torch/obs/server.py", "handle")],
    "serving_beats_admission": [(_SCOPE, "would_admit"), ("torchmetrics_tpu_torch/obs/server.py", "render_metrics"),
                                ("lib/socketserver.py", "process_request_thread")],
    "idle_wait": [("lib/threading.py", "wait")],
    "idle_queue": [("lib/queue.py", "get")],
    "idle_select": [("lib/selectors.py", "select")],
    "driver_replay": [("torchmetrics_tpu_torch/chaos/replay.py", "replay")],
    "driver_bench": [("bench.py", "_chaos_main")],
    "unknown": [("mymodel.py", "train_step")],
    "empty": [],
}

SPAN_CASES = {
    "ingest": ["engine.ingest"],
    "dispatch": ["engine.ingest", "engine.dispatch"],
    "mux": ["engine.mux"],
    "metric": ["metric.update"],
    "server": ["server.request"],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(SHARED_STACKS))
def test_classify_runtime_seams_as_jax_does(case):
    stack = SHARED_STACKS[case]
    assert thostprof.classify(stack) == jhostprof.classify(stack)


@pytest.mark.parametrize("spans", sorted(SPAN_CASES))
def test_span_context_fallback_as_jax_does(spans):
    stack = [("some/helper.py", "munge")]
    assert thostprof.classify(stack, SPAN_CASES[spans]) == jhostprof.classify(stack, SPAN_CASES[spans])


# the C boundary: each package's own native entries (a documented difference)
PORT_BOUNDARY = {
    "innermost_torch_frame": [(_TORCH, "synchronize"), ("mymodel.py", "step")],
    "torch_tensor_method": [("site-packages/torch/_tensor.py", "__format__"), ("mymodel.py", "log")],
    "graph_replay": [(_JIT, "replay"), (_JIT, "__call__"), ("mymodel.py", "step")],
    "kernel_launch": [(_KERNELS, "_launch"), (_KERNELS, "confusion_matrix"), ("mymodel.py", "step")],
    "buffer_count_readback": [(_METRIC, "_host_buffers"), (_METRIC, "_dispatch_update_inner")],
    "synchronize_caller": [("mymodel.py", "synchronize")],
    "item_caller": [("mymodel.py", "item")],
    "cpu_caller": [("mymodel.py", "cpu"), ("mymodel.py", "step")],
}
JAX_BOUNDARY = {
    "innermost_jax_frame": [(_JAX, "_pjit_call"), ("mymodel.py", "step")],
    "innermost_jaxlib_frame": [("site-packages/jaxlib/xla_client.py", "execute"), ("mymodel.py", "step")],
    "block_until_ready_caller": [("mymodel.py", "step"), ("mymodel.py", "block_until_ready")],
}


@pytest.mark.parametrize("case", sorted(PORT_BOUNDARY))
def test_port_c_boundary_is_dispatch_wait(case):
    stack = PORT_BOUNDARY[case]
    assert thostprof.classify(stack) == "dispatch-wait"
    assert jhostprof.classify(stack) == "other"  # JAX's rule names its own entries


@pytest.mark.parametrize("case", sorted(JAX_BOUNDARY))
def test_jax_c_boundary_is_not_the_ports(case):
    stack = JAX_BOUNDARY[case]
    assert jhostprof.classify(stack) == "dispatch-wait"
    assert thostprof.classify(stack) == "other"


def test_torch_frame_only_counts_innermost():
    # an outer torch frame (a Module.__call__ around user code) is not the C boundary
    stack = [("mymodel.py", "forward"), ("site-packages/torch/nn/modules/module.py", "_call_impl")]
    assert thostprof.classify(stack) == "other"


def test_vocabulary_is_jax_vocabulary():
    assert thostprof.SEAMS == jhostprof.SEAMS
    assert thostprof.EXCLUDED_BUCKETS == jhostprof.EXCLUDED_BUCKETS
    assert thostprof.PYTHON_FLOOR_SEAMS == jhostprof.PYTHON_FLOOR_SEAMS
    assert thostprof._ENGINE_FILES == jhostprof._ENGINE_FILES
    assert thostprof._IDLE_FILES == jhostprof._IDLE_FILES
    assert thostprof._DRIVER_FILES == jhostprof._DRIVER_FILES
    assert thostprof._SERVING_FILES == jhostprof._SERVING_FILES
    assert sorted(thostprof.__all__) == sorted(jhostprof.__all__)


# ------------------------------------------------------------------ sampling unit

# each scenario: a list of sample_once calls (frames, tenants, spans, now)
SAMPLE_SCENARIOS = {
    "tenant_attribution": [({1: [(_PIPE, "feed")], 2: [(_PIPE, "_dispatch_chunk")]}, {1: "acme", 2: "acme"}, {}, 0.0)] * 3,
    "serving_never_billed": [({1: SHARED_STACKS["serving_beats_admission"], 2: [(_PIPE, "feed")]},
                              {1: "acme", 2: "acme"}, {}, 0.0)],
    "idle_and_driver_excluded": [({1: [(_PIPE, "feed")], 2: [("lib/threading.py", "wait")], 3: [("bench.py", "main")],
                                   4: [("mymodel.py", "step")]}, {}, {}, 0.0)],
    "owner_and_path_from_spans": [(
        {1: [(_PIPE, "_dispatch_chunk")], 2: [(_MUX, "_stack_probe"), (_MUX, "feed")]}, {},
        {1: [("engine.dispatch", {"pipeline": "MeanSquaredError"})], 2: [("engine.mux", {"mux": "MulticlassAccuracy"})]},
        t) for t in (0.0, 0.1)],
    "floor_vs_dispatch": [({1: SHARED_STACKS["stack_rows"], 2: SHARED_STACKS["device_put"],
                            3: [(_PIPE, "_dispatch_chunk")], 4: [(_PIPE, "_dispatch_chunk")]}, {}, {}, 0.0)],
    "timeline_rotates": [({1: [(_PIPE, "feed")]}, {1: "t"}, {}, t) for t in (0.0, 0.1, 0.3, 0.6, 0.61, 1.2)],
    "many_tenants_bounded": [({1: [(_PIPE, "feed")]}, {1: f"tenant-{i}"}, {}, 0.0) for i in range(6)],
    "many_stacks_bounded": [({1: [(f"m{i}.py", "f")]}, {}, {}, 0.0) for i in range(6)],
    "span_fallback": [({1: [("helper.py", "munge")]}, {1: "z"}, {1: [("engine.ingest", {"pipeline": "P"})]}, 0.0)],
}


def _play(name, scenario):
    side = SIDES[name]
    p = side.hostprof.HostProfiler(rate_hz=10.0, max_stacks=4, max_cells=4, recorder=side.trace.TraceRecorder())
    own = threading.get_ident()
    for frames, tenants, spans, now in SAMPLE_SCENARIOS[scenario]:
        p.sample_once(frames={**frames, own: [(_PIPE, "feed")]}, tenants=tenants, spans=spans, now=now)
    floor = p.floor_report()
    floor["per_metric"] = {k: {f: v for f, v in row.items() if f.startswith("sampled_")}
                           for k, row in floor["per_metric"].items() if any(f.startswith("sampled_") for f in row)}
    rec = side.trace.TraceRecorder()
    p.record_gauges(rec)
    report = p.report(top=3)
    for key in ("floor", "duration_seconds", "self_overhead_percent", "running"):
        report.pop(key)
    return {
        "stats": p.stats(),
        "breakdown": p.breakdown(),
        "breakdown_serving": p.breakdown(include_serving=True),
        "breakdown_tenants": {t: p.breakdown(tenant=t) for t in ("acme", "t", "z", "tenant-0", "ghost")},
        "attributed": p.attributed_percent(),
        "tenant_breakdown": p.tenant_breakdown(),
        "floor": floor,
        "floor_scoped": sorted(p.floor_report(tenant="acme")),
        "collapsed": p.collapsed(),
        "collapsed_top": p.collapsed(top=1),
        "timeline": [bucket["seams"] for bucket in p.timeline()],
        "gauges": sorted((g["name"], sorted(g["labels"].items()), g["value"]) for g in rec.snapshot()["gauges"]
                         if g["name"] != "hostprof.self_overhead_percent"),
        "report": report,
    }


@pytest.mark.parametrize("scenario", sorted(SAMPLE_SCENARIOS))
def test_sample_once_tables_match_jax(scenario):
    assert _play("port", scenario) == _play("jax", scenario)


def test_collapsed_file_is_written_atomically(tmp_path):
    p = thostprof.HostProfiler(rate_hz=10.0, recorder=ttrace.TraceRecorder())
    p.sample_once(frames={1: [("a.py", "f")]}, tenants={}, spans={}, now=0.0)
    path = str(tmp_path / "flame.txt")
    assert p.write_collapsed(path) == path
    assert (tmp_path / "flame.txt").read_text() == "a:f 1\n"
    assert [x.name for x in tmp_path.iterdir()] == ["flame.txt"]


# ------------------------------------------------------------------ cross-thread hooks


def test_thread_spans_and_tenants_reach_the_sampler():
    """A live span and tenant scope on another thread are what ``sample_once`` joins."""
    ttrace.enable()
    entered, release = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with tscope.scope("acme"), ttrace.span("engine.ingest", pipeline="P"):
            seen["tid"] = threading.get_ident()
            entered.set()
            release.wait(5.0)

    tscope.track_thread_tenants(True)
    thread = threading.Thread(target=worker)
    thread.start()
    try:
        assert entered.wait(5.0)
        spans = ttrace.get_recorder().thread_spans()
        tenants = tscope.thread_tenants()
        assert spans[seen["tid"]][-1][0] == "engine.ingest"
        assert tenants[seen["tid"]] == "acme"
        p = thostprof.HostProfiler(rate_hz=10.0)
        p.sample_once(frames={seen["tid"]: [("helper.py", "munge")]}, now=0.0)
        assert p.tenant_breakdown() == {"acme": {"ingest": 0.1}}
    finally:
        release.set()
        thread.join()
        tscope.track_thread_tenants(False)
    assert seen["tid"] not in tscope.thread_tenants()
    assert seen["tid"] not in ttrace.get_recorder().thread_spans()


def test_thread_tenants_stay_off_unless_tracked():
    with tscope.scope("acme"):
        assert tscope.thread_tenants() == {}
    tscope.track_thread_tenants(True)
    with tscope.scope("acme"):
        with tscope.session("acme"):
            assert tscope.thread_tenants() == {threading.get_ident(): "acme"}
        assert tscope.thread_tenants() == {threading.get_ident(): "acme"}
    assert tscope.thread_tenants() == {}
    tscope.reset()
    assert tscope._TRACK_THREAD_TENANTS is False


# ----------------------------------------------------------------------- live


def test_live_sampler_starts_samples_and_stops_without_a_leak():
    before = {t.ident for t in threading.enumerate()}
    p = thostprof.HostProfiler(rate_hz=500.0)
    p.start()
    assert p.running and tscope._TRACK_THREAD_TENANTS
    assert p.start() is p  # idempotent while running
    deadline = threading.Event()
    for _ in range(200):
        if p.stats()["samples"]:
            break
        deadline.wait(0.01)
    p.stop()
    assert not p.running and not tscope._TRACK_THREAD_TENANTS
    assert {t.ident for t in threading.enumerate()} <= before
    assert p.stats()["samples"] > 0 and p.stats()["sample_errors"] == 0


def test_sampling_context_and_profile_session_install_and_restore():
    with thostprof.sampling(rate_hz=100.0) as p:
        assert thostprof.get_profiler() is p and p.running
    assert thostprof.get_profiler() is None and not p.running
    with tprofile.profile_session(rate_hz=100.0) as session:
        assert session["device"] is False and session["host"].running
        assert thostprof.get_profiler() is session["host"]
    assert thostprof.get_profiler() is None and not session["host"].running
    with tprofile.profile_session(host=False) as session:
        assert session == {"device": False, "host": None}


def test_nonpositive_rate_is_refused_as_jax_refuses_it():
    for side in SIDES.values():
        with pytest.raises(ValueError, match="Expected `rate_hz` to be positive, got 0"):
            side.hostprof.HostProfiler(rate_hz=0)
