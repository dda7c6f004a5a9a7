"""Streaming evaluation engine of the port: fused chunks on CUDA graphs, prefetch, warmup.

Counterpart of ``torchmetrics_tpu/engine``:

- :class:`~torchmetrics_tpu_torch.engine.pipeline.MetricPipeline` — consumes a batch
  iterator with host→device **prefetch**, a **bounded in-flight window** (never a
  synchronise per step), and **micro-batch fusion**: N same-signature batches
  advance the state with one CUDA-graph replay, chunk lengths padded to a small set
  of buckets with masked tails so the variant count stays bounded. Error policies
  still apply per fused chunk, with degrade-to-per-batch replay isolating poisoned
  batches.
- :mod:`~torchmetrics_tpu_torch.engine.warmup` — the warmup manifest of what a warmup
  pass captured; there is no persistent cache (a CUDA graph cannot be written out).

- :mod:`~torchmetrics_tpu_torch.engine.migrate` — **live-session checkpoint/restore
  and continuous crash-consistent checkpointing**: a running pipeline session is
  drained, checkpointed into a session bundle (the JAX package's format, letter for
  letter) and restored elsewhere, bit-identical; a
  :class:`~torchmetrics_tpu_torch.engine.migrate.CheckpointPolicy` writes delta
  bundles at chunk-commit boundaries, and after an unplanned death
  :func:`~torchmetrics_tpu_torch.engine.migrate.latest_valid_bundle` +
  :func:`~torchmetrics_tpu_torch.engine.migrate.restore_session` recover the session.

The tenant multiplexer (``engine/mux.py``) comes with its slice.

Quick start::

    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    pipe = MetricPipeline(metric, PipelineConfig(fuse=8, prefetch=2))
    pipe.warmup(example_preds, example_target)       # capture before the loop
    pipe.run((p, t) for p, t in eval_loader)         # fused, prefetched
    value = metric.compute()
"""

from torchmetrics_tpu_torch.engine.migrate import (
    SESSION_SCHEMA,
    CheckpointPolicy,
    SessionBundleError,
    checkpoint_session,
    checkpoint_staleness_rule,
    compact_chain,
    latest_valid_bundle,
    restore_session,
    sweep_bundles,
    verify_bundle,
)
from torchmetrics_tpu_torch.engine.pipeline import FLIGHT_DIR_ENV, MetricPipeline, PipelineConfig, PipelineReport
from torchmetrics_tpu_torch.engine.warmup import (
    CACHE_ENV_VAR,
    build_manifest,
    configure_compile_cache,
    configured_cache_dir,
    load_manifest,
    persistent_cache_stats,
    pow2_buckets,
    save_manifest,
)

__all__ = [
    "CACHE_ENV_VAR",
    "FLIGHT_DIR_ENV",
    "SESSION_SCHEMA",
    "CheckpointPolicy",
    "MetricPipeline",
    "PipelineConfig",
    "PipelineReport",
    "SessionBundleError",
    "build_manifest",
    "checkpoint_session",
    "checkpoint_staleness_rule",
    "compact_chain",
    "configure_compile_cache",
    "configured_cache_dir",
    "latest_valid_bundle",
    "load_manifest",
    "persistent_cache_stats",
    "pow2_buckets",
    "restore_session",
    "save_manifest",
    "sweep_bundles",
    "verify_bundle",
]
