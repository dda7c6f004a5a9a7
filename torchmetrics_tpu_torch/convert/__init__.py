"""Conversions into the port: JAX state carried across, and the checkpoint kit.

Counterpart of ``torchmetrics_tpu/convert/__init__.py``, beside the port's own
``jax_state`` (``load_jax_state``, ``jax_state_to_torch``, ``nested_state_dict``).
``sha256_file`` and ``_record_manifest`` write the same ``MANIFEST.json`` as the JAX
package. ONNX graphs convert with ``convert.onnx_torch.convert_onnx_flax`` into the
directory format both packages read (``python -m torchmetrics_tpu_torch.convert
onnx-flax``). ``convert_inception``, ``convert_lpips_backbone`` and
``convert_hf_flax`` convert weights for the model-based metrics, which come with
the model-based item of ROADMAP Queue 1; until then they raise.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

from torchmetrics_tpu_torch.convert.jax_state import jax_state_to_torch, load_jax_state, nested_state_dict

MANIFEST_NAME = "MANIFEST.json"


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def _record_manifest(out_path: str, entry: Dict[str, Any]) -> str:
    """Merge ``entry`` into the MANIFEST.json beside ``out_path`` (keyed by output)."""
    manifest_path = os.path.join(os.path.dirname(os.path.abspath(out_path)), MANIFEST_NAME)
    manifest: Dict[str, Any] = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as fh:
            manifest = json.load(fh)
    manifest[os.path.basename(out_path)] = entry
    with open(manifest_path, "w") as fh:
        json.dump(manifest, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return manifest_path


def _model_based(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"`torchmetrics_tpu_torch.convert.{name}` converts weights for the model-based metrics, which are"
        " not ported yet; it comes with the model-based item of ROADMAP Queue 1."
    )


def convert_inception(checkpoint: str, out: str) -> str:
    """torch-fidelity FID Inception-v3 ``.pth`` -> flat ``.npz`` (the model-based item of ROADMAP Queue 1)."""
    raise _model_based("convert_inception")


def convert_lpips_backbone(checkpoint: str, net_type: str, out: str) -> str:
    """torchvision backbone ``.pth`` -> flat LPIPS-pyramid ``.npz`` (the model-based item of ROADMAP Queue 1)."""
    raise _model_based("convert_lpips_backbone")


def convert_hf_flax(model_path: str, out_dir: str, model_class: Optional[str] = None) -> str:
    """Local HF snapshot -> flax ``save_pretrained`` directory (the model-based item of ROADMAP Queue 1)."""
    raise _model_based("convert_hf_flax")


__all__ = [
    "MANIFEST_NAME", "convert_hf_flax", "convert_inception", "convert_lpips_backbone", "jax_state_to_torch",
    "load_jax_state", "nested_state_dict", "sha256_file",
]
