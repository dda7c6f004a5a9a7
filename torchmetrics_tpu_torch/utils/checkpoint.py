"""Checkpoint and resume for metrics and collections, atomically installed.

Counterpart of ``torchmetrics_tpu/utils/checkpoint.py``. Every state — including
non-persistent ones, mid-epoch — is written as a host tree and restored into a
freshly constructed metric of the same spec: one subtree per metric (collections nest
by metric name) holding ``states`` plus ``update_count``, so a restored metric
resumes exactly where the checkpoint was taken.

The JAX package writes that tree with orbax; orbax imports JAX, so the port writes
the layout of the JAX package's session bundles instead (``engine/migrate.py``), which
both packages read without JAX: ``state.npz`` (the tree's arrays), ``MANIFEST.json``
(the JSON skeleton naming each array) and ``INTEGRITY.json`` (a SHA-256 digest over
every file). Saves build the whole directory under a temp name and swap it into place
with directory renames (:func:`atomic_install_dir`), so a process preempted
mid-checkpoint leaves the old checkpoint or the new one, never a hybrid; loads verify
the digest and raise :class:`CheckpointIntegrityError` on any mismatch.
:func:`file_tree_digest` rejects symlinks and entries that escape the root, so a
crafted checkpoint cannot make a reader touch bytes outside it.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import _ROBUST_STATE_KEY, Metric
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "CheckpointIntegrityError",
    "atomic_install_dir",
    "file_tree_digest",
    "load_checkpoint",
    "save_checkpoint",
]

_INTEGRITY_NAME = "INTEGRITY.json"
_MANIFEST_NAME = "MANIFEST.json"
_STATE_NAME = "state.npz"
_CHECKPOINT_KIND = "tm_tpu_checkpoint"
# displaced .old./.tmp. siblings younger than this may belong to a live
# concurrent save and are never swept (see atomic_install_dir)
_STALE_SIBLING_AGE_S = 3600.0
# leaves larger than this are split into fixed segments by the session bundles'
# encoder (engine/migrate.py); a plain checkpoint writes every leaf whole
DEFAULT_SEGMENT_BYTES = 1 << 16


class CheckpointIntegrityError(RuntimeError):
    """The checkpoint on disk is truncated, tampered, or half-written."""


def _to_host(value: Any) -> Any:
    """Numpy copies of a ``state_dict`` value (a tensor, a list of them, or a
    ``MaskedBuffer``'s ``{data, count}``)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, list):
        return [_to_host(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    return np.asarray(value)


def _host_states(metric: Metric) -> Dict[str, Any]:
    """All states (not just persistent ones) as a host tree of numpy arrays, keyed as
    the JAX package keys them."""
    out: Dict[str, Any] = {}
    states = metric.state_dict(persistent_only=False)
    # the order of a JAX state dict after a jitted update (a pytree's dicts are
    # sorted by key), the guard counters last: both packages then number the
    # bundle's leaves alike
    keys = sorted(k for k in states if k != _ROBUST_STATE_KEY) + [k for k in states if k == _ROBUST_STATE_KEY]
    for key in keys:
        value = _to_host(states[key])
        if isinstance(value, list):
            # index dicts keep the ordering explicit (and an empty list a container)
            out[key] = {"__list__": {str(i): v for i, v in enumerate(value)}}
        elif isinstance(value, dict):  # state_dict's MaskedBuffer wire format
            out[key] = {"__masked_buffer__": value}
        else:
            out[key] = value
    return {"states": out, "update_count": np.asarray(metric.update_count)}


def _restore_states(metric: Metric, tree: Dict[str, Any]) -> None:
    if not isinstance(tree, dict) or "states" not in tree:
        raise ValueError(
            "Checkpoint tree is not a single-metric checkpoint (no 'states' entry) —"
            " was this saved from a MetricCollection? Load it into a collection instead."
        )
    states = tree.get("states", {}) or {}
    payload: Dict[str, Any] = {}
    if _ROBUST_STATE_KEY in states:  # update-guard counters ride along
        payload[_ROBUST_STATE_KEY] = states[_ROBUST_STATE_KEY]
    for key in metric._defaults:
        if key not in states:
            # an orbax tree (JAX) drops empty containers: restore as empty
            if isinstance(metric._defaults[key], list):
                payload[key] = []
            continue
        value = states[key]
        if isinstance(value, dict) and "__list__" in value:
            items = value["__list__"] or {}
            payload[key] = [items[k] for k in sorted(items, key=int)]
        elif isinstance(value, dict) and "__masked_buffer__" in value:
            payload[key] = value["__masked_buffer__"]
        else:
            payload[key] = value
    metric.load_state_dict(payload)  # also drops any stale compute cache
    count = tree.get("update_count")
    if count is not None:
        metric._update_count = int(count)


def _tree_of(target: Union[Metric, Any]) -> Dict[str, Any]:
    if isinstance(target, Metric):
        return _host_states(target)
    # MetricCollection (or any name->Metric mapping)
    return {name: _host_states(m) for name, m in target.items()}


def _encode_tree(tree: Any, segment_bytes: int = DEFAULT_SEGMENT_BYTES) -> Tuple[Any, Dict[str, np.ndarray]]:
    """Split a host tree (nested dicts, numpy leaves) into a JSON skeleton + an npz
    array payload.

    Leaves become ``{"__leaf__": "s<N>"}`` placeholders, numbered in the tree's
    order; the skeleton keeps empty containers. Leaves larger than ``segment_bytes``
    (``0`` disables) are split into fixed 1-D segments (``s<N>.p0``, ``s<N>.p1``,
    ...) whose placeholder carries ``segments``/``dtype``/``shape`` for reassembly —
    the session bundles' delta writer skips the segments that did not change. The
    names and the split are the JAX package's, so both write the same entries.
    """
    arrays: Dict[str, np.ndarray] = {}
    counter = [0]

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        arr = np.asarray(node)
        key = f"s{counter[0]}"
        counter[0] += 1
        if segment_bytes and arr.dtype != object and arr.nbytes > segment_bytes:
            flat = np.ascontiguousarray(arr).reshape(-1)
            per = max(1, segment_bytes // max(1, arr.itemsize))
            n_seg = (flat.size + per - 1) // per
            for i in range(n_seg):
                arrays[f"{key}.p{i}"] = flat[i * per : (i + 1) * per]
            return {
                "__leaf__": key,
                "segments": n_seg,
                "dtype": str(arr.dtype),
                "shape": [int(s) for s in arr.shape],
            }
        arrays[key] = arr
        return {"__leaf__": key}

    return walk(tree), arrays


def _decode_tree(skeleton: Any, arrays: Dict[str, np.ndarray]) -> Any:
    def walk(node: Any) -> Any:
        if (
            isinstance(node, dict)
            and isinstance(node.get("__leaf__"), str)
            and (set(node) == {"__leaf__"} or "segments" in node)
        ):
            key = node["__leaf__"]
            if "segments" in node:
                parts = [arrays[f"{key}.p{i}"] for i in range(int(node["segments"]))]
                flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
                return flat.reshape(tuple(node.get("shape") or ()))
            return arrays[key]
        return {key: walk(value) for key, value in node.items()}

    return walk(skeleton)


def _tree_digest(tree: Any) -> str:
    """Deterministic SHA-256 over every leaf (path, dtype, shape, bytes)."""
    digest = hashlib.sha256()

    def _walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for key in sorted(node):
                _walk(f"{prefix}/{key}", node[key])
            return
        leaf = np.asarray(node)
        digest.update(prefix.encode())
        digest.update(str(leaf.dtype).encode())
        digest.update(str(leaf.shape).encode())
        digest.update(np.ascontiguousarray(leaf).tobytes())

    _walk("", tree)
    return digest.hexdigest()


def atomic_install_dir(tmp: str, path: str, tag: str) -> str:
    """Swap a fully-materialized temp directory into place at ``path``.

    The hardened half of the temp-dir+rename writer, shared by metric checkpoints
    and live-session bundles (:mod:`torchmetrics_tpu_torch.engine.migrate`): a
    displace-then-rename loop (a concurrent saver can install a new dir at ``path``
    between our displace and rename — displace again and retry rather than
    stranding the fully-written tmp), then a sweep of stale ``.old.*`` / ``.tmp.*``
    siblings old enough that no live save owns them. ``tmp`` must be fully written
    (integrity record included) before this is called.
    """
    displaced = []
    for attempt in range(3):
        old = f"{path}.old.{tag}.{attempt}"
        try:
            if os.path.exists(path):
                os.rename(path, old)
                displaced.append(old)
            os.rename(tmp, path)
            break
        except OSError:
            if attempt == 2:
                raise
    for old in displaced:
        shutil.rmtree(old, ignore_errors=True)
    # a successful swap supersedes siblings leaked by earlier preempted saves
    # under other pids — but another process may be mid-save to the same path
    # right now, so only sweep dirs old enough that no live save owns them
    cutoff = time.time() - _STALE_SIBLING_AGE_S
    for stale in glob.glob(f"{path}.old.*") + glob.glob(f"{path}.tmp.*"):
        try:
            if os.path.getmtime(stale) < cutoff:
                shutil.rmtree(stale, ignore_errors=True)
        except OSError:
            pass  # vanished under us (another sweeper won the race)
    return path


def file_tree_digest(root: str, exclude: tuple = ()) -> str:
    """Deterministic SHA-256 over every file under ``root`` (relpath + bytes).

    Files are walked in sorted relative-path order and hashed as (path, content),
    so a truncated, tampered, renamed or missing file flips the digest. ``exclude``
    names relative paths to skip — the integrity record itself.

    Path-traversal hardening: a symlink (file or directory, wherever it points) or a
    relative path escaping the root raises :class:`CheckpointIntegrityError` instead
    of being followed, so a crafted tree fails loudly before anything reads it.
    """
    digest = hashlib.sha256()
    excluded = {str(e).replace(os.sep, "/") for e in exclude}
    real_root = os.path.realpath(root)
    entries = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for dname in dirnames:
            if os.path.islink(os.path.join(dirpath, dname)):
                rel = os.path.relpath(os.path.join(dirpath, dname), root).replace(os.sep, "/")
                raise CheckpointIntegrityError(
                    f"Bundle at {root} contains a symlinked directory {rel!r} — bundles"
                    " hold only regular files; a link could point a restore outside the"
                    " bundle root, so this tree is rejected."
                )
        for fname in filenames:
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            if rel in excluded:
                continue
            if os.path.islink(full):
                raise CheckpointIntegrityError(
                    f"Bundle at {root} contains a symlink {rel!r} — bundles hold only"
                    " regular files; a link could point a restore outside the bundle"
                    " root, so this tree is rejected."
                )
            if rel.startswith("..") or not os.path.realpath(full).startswith(real_root + os.sep):
                raise CheckpointIntegrityError(
                    f"Bundle at {root} contains an entry {rel!r} that escapes the bundle root — rejected."
                )
            entries.append((rel, full))
    for rel, full in sorted(entries):
        digest.update(rel.encode())
        with open(full, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                digest.update(chunk)
    return digest.hexdigest()


def save_checkpoint(target: Union[Metric, Any], path: str) -> str:
    """Write ``target``'s full state (mid-epoch included) to ``path``.

    ``target`` is a :class:`Metric` or a ``MetricCollection``. Returns the absolute
    checkpoint path. Overwrites an existing checkpoint at the same path — atomically:
    the new checkpoint is fully materialized (arrays, skeleton, integrity record)
    under a temp directory first, then swapped in with renames.
    """
    path = os.path.abspath(path)
    tree = _tree_of(target)
    skeleton, arrays = _encode_tree(tree, segment_bytes=0)
    # tag beyond the pid: containerized hosts commonly share pid 1, and two hosts
    # saving to the same shared-storage path must never collide on tmp
    tag = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
    tmp = f"{path}.tmp.{tag}"
    try:
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, _STATE_NAME), **arrays)
        manifest = {"kind": _CHECKPOINT_KIND, "version": 1, "state_skeleton": skeleton,
                    "tree_sha256": _tree_digest(tree)}
        with open(os.path.join(tmp, _MANIFEST_NAME), "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, sort_keys=True, indent=2)
        digest = file_tree_digest(tmp, exclude=(_INTEGRITY_NAME,))
        with open(os.path.join(tmp, _INTEGRITY_NAME), "w", encoding="utf-8") as fh:
            json.dump({"version": 1, "sha256": digest}, fh)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return atomic_install_dir(tmp, path, tag)


def _recover_displaced(path: str) -> Optional[str]:
    """Newest ``<path>.old.<tag>``/``<path>.tmp.<tag>`` sibling with an integrity record.

    A preemption between :func:`save_checkpoint`'s two directory renames leaves no
    checkpoint at ``path`` but a complete one displaced under a tagged name.
    """
    stamped = []
    for candidate in glob.glob(f"{path}.old.*") + glob.glob(f"{path}.tmp.*"):
        try:
            stamped.append((os.path.getmtime(candidate), candidate))
        except OSError:
            pass  # vanished under us (a concurrent save's stale-sibling sweep)
    for _, candidate in sorted(stamped, reverse=True):
        if os.path.isfile(os.path.join(candidate, _INTEGRITY_NAME)):
            return candidate
    return None


def _restore_verified(path: str) -> Dict[str, Any]:
    """The host tree at ``path``, after its integrity record verified."""
    if not os.path.exists(path):
        displaced = _recover_displaced(path)
        if displaced is None:
            raise FileNotFoundError(f"No checkpoint at {path} (and no displaced sibling to recover)")
        rank_zero_warn(
            f"No checkpoint at {path}, but a save interrupted mid-swap left a complete"
            f" one at {displaced}; recovering from it. Re-save to normalize the path.",
            RuntimeWarning,
        )
        path = displaced
    integrity_path = os.path.join(path, _INTEGRITY_NAME)
    try:
        with open(integrity_path, encoding="utf-8") as fh:
            recorded = json.load(fh)
    except (OSError, ValueError) as err:
        raise CheckpointIntegrityError(
            f"Checkpoint at {path} has a missing or unreadable {_INTEGRITY_NAME} ({err}) —"
            " restore from an older checkpoint."
        ) from err
    digest = file_tree_digest(path, exclude=(_INTEGRITY_NAME,))
    if digest != recorded.get("sha256"):
        raise CheckpointIntegrityError(
            f"Checkpoint at {path} failed its integrity check (recorded"
            f" {str(recorded.get('sha256'))[:12]}…, recomputed {digest[:12]}…) —"
            " the data was corrupted after the save; restore from an older checkpoint."
        )
    try:
        with open(os.path.join(path, _MANIFEST_NAME), encoding="utf-8") as fh:
            manifest = json.load(fh)
        with np.load(os.path.join(path, _STATE_NAME)) as payload:
            arrays = {key: payload[key] for key in payload.files}
        tree = _decode_tree(manifest["state_skeleton"], arrays)
    except Exception as err:
        raise CheckpointIntegrityError(f"Checkpoint at {path} verifies but is unreadable: {err}") from err
    if manifest.get("kind") != _CHECKPOINT_KIND:
        raise CheckpointIntegrityError(f"Directory at {path} verifies but is not a metric checkpoint")
    return tree


def load_checkpoint(target: Union[Metric, Any], path: str) -> Union[Metric, Any]:
    """Restore states saved by :func:`save_checkpoint` into ``target`` (in place).

    ``target`` must be constructed with the same spec (same metric classes and
    arguments) as the checkpointed one. Verifies the integrity record and raises
    :class:`CheckpointIntegrityError` on corruption. Returns ``target``.
    """
    restored = _restore_verified(os.path.abspath(path))
    if isinstance(target, Metric):
        _restore_states(target, restored)
        return target
    for name, metric in target.items():
        if name not in restored:
            raise KeyError(f"Checkpoint at {path} has no entry for metric {name!r}")
        _restore_states(metric, restored[name])
    return target
