"""Conversions into the port: JAX state carried across, and the checkpoint kit.

Counterpart of ``torchmetrics_tpu/convert/__init__.py``, beside the port's own
``jax_state`` (``load_jax_state``, ``jax_state_to_torch``, ``nested_state_dict``).
``sha256_file`` and ``_record_manifest`` write the same ``MANIFEST.json`` as the JAX
package. ONNX graphs convert with ``convert.onnx_torch.convert_onnx_flax`` into the
directory format both packages read (``python -m torchmetrics_tpu_torch.convert
onnx-flax``). ``convert_inception`` and ``convert_lpips_backbone`` write the JAX
package's flat ``.npz`` layout and manifest entry, so a file converted by either package
loads in the other; ``convert_hf_flax`` raises until the text and multimodal
model-based metrics are ported.
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


def convert_inception(checkpoint: str, out: str) -> str:
    """torch-fidelity FID Inception-v3 ``.pth`` -> flat flax-pytree ``.npz``.

    The JAX package's layout (HWIO kernels, ``params``/``batch_stats``): the file loads
    through ``InceptionFeatureExtractor(weights_path=out)`` (or
    $TORCHMETRICS_TPU_INCEPTION_WEIGHTS) in either package.
    """
    import torch

    from torchmetrics_tpu_torch.image._inception_net import _flax_variables_from_torch_fidelity
    from torchmetrics_tpu_torch.utils.serialization import save_tree_npz

    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    out = save_tree_npz(out, _flax_variables_from_torch_fidelity(state))
    _record_manifest(
        out,
        {
            "kind": "fid-inception-v3",
            "source": os.path.basename(checkpoint),
            "source_sha256": sha256_file(checkpoint),
            "sha256": sha256_file(out),
        },
    )
    return out


def convert_lpips_backbone(checkpoint: str, net_type: str, out: str) -> str:
    """torchvision backbone ``.pth`` -> flat LPIPS-pyramid ``.npz``.

    ``net_type``: ``alex`` (alexnet-owt), ``vgg`` (vgg16), or ``squeeze``
    (squeezenet1_1). The emitted npz (the JAX package's layout) is picked up from the
    $TORCHMETRICS_TPU_LPIPS_BACKBONES directory as ``{net_type}.npz`` by either package.
    """
    import torch

    from torchmetrics_tpu_torch.functional.image._lpips_backbones import convert_torchvision_backbone
    from torchmetrics_tpu_torch.utils.serialization import save_tree_npz

    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    params = convert_torchvision_backbone(state, net_type)
    out = save_tree_npz(out, params)
    _record_manifest(
        out,
        {
            "kind": f"lpips-backbone-{net_type}",
            "source": os.path.basename(checkpoint),
            "source_sha256": sha256_file(checkpoint),
            "sha256": sha256_file(out),
        },
    )
    return out


def convert_hf_flax(model_path: str, out_dir: str, model_class: Optional[str] = None) -> str:
    """Local HF snapshot -> flax ``save_pretrained`` directory, for BERTScore, InfoLM,
    CLIP score and CLIP-IQA, which are not ported yet: it raises."""
    raise NotImplementedError(
        "`torchmetrics_tpu_torch.convert.convert_hf_flax` converts weights for the text and multimodal"
        " model-based metrics (BERTScore, InfoLM, CLIP score, CLIP-IQA), which are not ported yet; they"
        " come with the text and multimodal item of ROADMAP Queue 1."
    )


__all__ = [
    "MANIFEST_NAME", "convert_hf_flax", "convert_inception", "convert_lpips_backbone", "jax_state_to_torch",
    "load_jax_state", "nested_state_dict", "sha256_file",
]
