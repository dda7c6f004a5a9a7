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

The tenant multiplexer (``engine/mux.py``) and live-session checkpoint and migration
(``engine/migrate.py``) come with their slices.

Quick start::

    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    pipe = MetricPipeline(metric, PipelineConfig(fuse=8, prefetch=2))
    pipe.warmup(example_preds, example_target)       # capture before the loop
    pipe.run((p, t) for p, t in eval_loader)         # fused, prefetched
    value = metric.compute()
"""

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
    "MetricPipeline",
    "PipelineConfig",
    "PipelineReport",
    "build_manifest",
    "configure_compile_cache",
    "configured_cache_dir",
    "load_manifest",
    "persistent_cache_stats",
    "pow2_buckets",
    "save_manifest",
]
