"""Warmup manifests for the streaming evaluation engine.

Counterpart of ``torchmetrics_tpu/engine/warmup.py``. The JAX package pays its XLA
compiles before the hot loop and writes them to a persistent compilation cache; the
port pays its captures before the loop (:meth:`MetricPipeline.warmup
<torchmetrics_tpu_torch.engine.pipeline.MetricPipeline.warmup>` captures every fused
shape-bucket variant and the per-batch path through
:meth:`StaticLeafJit.warmup <torchmetrics_tpu_torch.core.jit.StaticLeafJit.warmup>`).

- The **warmup manifest** records what a warmup pass captured — one entry per
  (function, shape-bucket) variant with its capture wall time and whether it was
  fresh — and round-trips through :func:`save_manifest` / :func:`load_manifest`
  (atomic writes via ``utils/fileio``).
- **No persistent cache.** A CUDA graph lives in its process and cannot be written
  to disk, so :func:`configure_compile_cache`, :func:`configured_cache_dir` and
  :func:`persistent_cache_stats` keep the JAX package's signatures and report that
  there is none (``dir`` None, zero requests); a restarted process captures again.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from torchmetrics_tpu_torch.utils.fileio import atomic_write_text

__all__ = [
    "CACHE_ENV_VAR",
    "MANIFEST_SCHEMA",
    "build_manifest",
    "configure_compile_cache",
    "configured_cache_dir",
    "load_manifest",
    "persistent_cache_stats",
    "pow2_buckets",
    "save_manifest",
]


def pow2_buckets(cap: int) -> tuple:
    """The engine's bucket ladder: powers of two up to (and including) ``cap``, with
    ``cap`` itself always the top bucket, so that the variant count stays
    ``O(log cap)`` per signature."""
    if cap < 1:
        raise ValueError(f"Expected `cap` >= 1, got {cap}")
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(int(cap))
    return tuple(out)


# the JAX package's variable naming a persistent cache; the port reads it nowhere
CACHE_ENV_VAR = "TM_TPU_COMPILE_CACHE"
MANIFEST_SCHEMA = 1


def configure_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """The JAX package points its persistent compilation cache at ``cache_dir``. A CUDA
    graph cannot be persisted, so this configures nothing and returns ``None``."""
    return None


def configured_cache_dir() -> Optional[str]:
    """The persistent cache's directory: ``None``, there is none."""
    return None


def persistent_cache_stats() -> Dict[str, Any]:
    """Persistent-cache accounting, in the JAX package's keys: no directory, no entries,
    no requests."""
    return {"dir": None, "entries": 0, "requests": 0, "hits": 0, "misses": 0}


def build_manifest(entries: List[Dict[str, Any]], cache_dir: Optional[str] = None) -> Dict[str, Any]:
    """Assemble a warmup manifest from per-variant entries.

    Each entry comes from :meth:`StaticLeafJit.warmup` plus the pipeline's bucket and
    shape annotations; the manifest adds the schema, the backend, the (absent) cache
    directory and the capture-time total. The JAX package's estimated flops and bytes
    come from XLA's cost analysis, which the port has no counterpart of: ``None``.
    """
    fresh = [e for e in entries if e.get("fresh")]
    return {
        "schema_version": MANIFEST_SCHEMA,
        "created_unix": time.time(),
        "backend": "cuda graphs",
        "cache_dir": cache_dir,
        "entries": list(entries),
        "variants": len(entries),
        "fresh_compiles": len(fresh),
        "total_compile_seconds": round(sum(float(e.get("seconds", 0.0)) for e in fresh), 6),
        "estimated_flops": None,
        "estimated_bytes": None,
    }


def save_manifest(manifest: Dict[str, Any], path: str) -> str:
    """Atomically write ``manifest`` as JSON; returns the absolute path."""
    return atomic_write_text(path, json.dumps(manifest, indent=2, sort_keys=True) + "\n")


def load_manifest(path: str) -> Dict[str, Any]:
    """Load a manifest written by :func:`save_manifest`, validating the schema."""
    with open(path, "r", encoding="utf-8") as fh:
        manifest = json.load(fh)
    if not isinstance(manifest, dict) or manifest.get("schema_version") != MANIFEST_SCHEMA:
        raise ValueError(
            f"{path!r} is not a warmup manifest (schema_version"
            f" {manifest.get('schema_version') if isinstance(manifest, dict) else None!r},"
            f" expected {MANIFEST_SCHEMA})"
        )
    return manifest
