"""Conversions into the port: JAX state carried across, and the checkpoint kit.

Counterpart of ``torchmetrics_tpu/convert/__init__.py``, beside the port's own
``jax_state`` (``load_jax_state``, ``jax_state_to_torch``, ``nested_state_dict``).
``sha256_file`` and ``_record_manifest`` write the same ``MANIFEST.json`` as the JAX
package. ONNX graphs convert with ``convert.onnx_torch.convert_onnx_flax`` into the
directory format both packages read (``python -m torchmetrics_tpu_torch.convert
onnx-flax``). ``convert_inception`` and ``convert_lpips_backbone`` write the JAX
package's flat ``.npz`` layout and manifest entry, so a file converted by either package
loads in the other; ``convert_hf_flax`` writes the JAX package's flax snapshot directory
(``flax_model.msgpack``, written without ``flax`` or ``msgpack``) from any local snapshot,
and ``hf_flax_params_to_torch`` carries a Flax parameter tree into the port's modules.
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


# the files beside the weights that ``transformers``' tokenizers and processors read
HF_SIDE_FILES = (
    "tokenizer.json", "tokenizer_config.json", "special_tokens_map.json", "added_tokens.json", "vocab.txt",
    "vocab.json", "merges.txt", "preprocessor_config.json", "processor_config.json",
)
_MASKED_LM_CLASSES = ("FlaxAutoModelForMaskedLM", "FlaxBertForMaskedLM", "FlaxRobertaForMaskedLM")
_BASE_CLASSES = ("FlaxAutoModel", "FlaxBertModel", "FlaxRobertaModel", "FlaxCLIPModel")


def _hf_target(config: Dict[str, Any], model_class: Optional[str]) -> str:
    """``base``, ``masked_lm`` or ``clip``: what ``model_class`` (a ``transformers`` Flax
    class name; ``FlaxAutoModel`` when None) builds for ``config``."""
    from torchmetrics_tpu_torch.utils.hf.encoders import SUPPORTED_ENCODERS, unsupported_model_type

    model_type = config.get("model_type")
    if model_type not in SUPPORTED_ENCODERS + ("clip",):
        raise unsupported_model_type(model_type)
    name = model_class or "FlaxAutoModel"
    if name not in _MASKED_LM_CLASSES + _BASE_CLASSES:
        raise NotImplementedError(
            f"`{name}` is not a class the port converts for; it converts {', '.join(_BASE_CLASSES + _MASKED_LM_CLASSES)}."
        )
    if model_type == "clip":
        if name not in ("FlaxAutoModel", "FlaxCLIPModel"):
            raise ValueError(f"`{name}` cannot be built from a CLIP config.")
        return "clip"
    if name == "FlaxCLIPModel":
        raise ValueError(f"`FlaxCLIPModel` cannot be built from a `{model_type}` config.")
    return "masked_lm" if name in _MASKED_LM_CLASSES else "base"


def _port_module(config: Dict[str, Any], target: str):
    from torchmetrics_tpu_torch.utils.hf.clip import CLIPModel
    from torchmetrics_tpu_torch.utils.hf.encoders import MaskedLM, TransformerEncoder

    return {"clip": CLIPModel, "masked_lm": MaskedLM, "base": TransformerEncoder}[target](config)


def hf_flax_params_to_torch(params: Dict[str, Any], config: Dict[str, Any]) -> Dict[str, Any]:
    """A ``transformers`` Flax parameter tree (numpy arrays) of BERT, RoBERTa, a BERT or
    RoBERTa masked LM, or CLIP, as the ``state_dict`` of the port's module for ``config``
    (``utils/hf``): Dense kernels transposed to ``[out, in]``, the patch convolution to
    OIHW, ``embedding``/``scale`` named ``weight``. A tree with a masked-LM head
    (``cls``, ``lm_head``) gives the masked LM's names."""
    from torchmetrics_tpu_torch.utils.hf.encoders import load_weights
    from torchmetrics_tpu_torch.utils.hf.snapshot import flax_tree_to_torch

    if config.get("model_type") == "clip":
        target = "clip"
    else:
        target = "masked_lm" if ("cls" in params or "lm_head" in params) else "base"
        _hf_target(config, None)
    module = load_weights(_port_module(config, target), flax_tree_to_torch(params), f"{config.get('model_type')}.")
    return module.state_dict()


def _flax_names(state: Dict[str, Any], config: Dict[str, Any], target: str) -> Dict[str, Any]:
    """The tensors of ``state`` (``transformers`` PyTorch names) that the Flax class of
    ``target`` holds, under that class's names."""
    prefix = f"{config['model_type']}."
    out = {}
    for name, tensor in state.items():
        if name.endswith("position_ids") or ".decoder." in name or name.startswith("cls.seq_relationship"):
            continue  # buffers, the tied decoder and BERT's next-sentence head
        if target == "clip":
            out[name] = tensor
            continue
        base = name[len(prefix):] if name.startswith(prefix) else name
        head = base.startswith(("cls.", "lm_head."))
        if target == "base" and not head:
            out[base] = tensor
        elif target == "masked_lm" and (head or not base.startswith("pooler.")):
            out[base if head else prefix + base] = tensor
    return out


def convert_hf_flax(model_path: str, out_dir: str, model_class: Optional[str] = None) -> str:
    """Local HF snapshot -> flax ``save_pretrained`` directory, the directory the JAX
    package's ``convert_hf_flax`` writes and the BERTScore/InfoLM/CLIP metrics of both
    packages accept as ``model_name_or_path``.

    The snapshot's weights (any format ``utils/hf/snapshot.py`` reads) are checked by
    loading them into the port's module for ``model_class`` (``FlaxAutoModel`` when None;
    ``FlaxBertForMaskedLM``, ``FlaxRobertaForMaskedLM`` or ``FlaxAutoModelForMaskedLM``
    keep the masked-LM head, ``FlaxCLIPModel`` names CLIP), then written as
    ``flax_model.msgpack`` in flax's format with ``config.json`` (its ``architectures``
    naming the class, as ``save_pretrained`` does). The tokenizer and processor files are
    copied over, and a ``MANIFEST.json`` entry of kind ``hf-flax`` records the weights'
    SHA-256."""
    import shutil

    from torchmetrics_tpu_torch.utils.hf.encoders import load_weights
    from torchmetrics_tpu_torch.utils.hf.snapshot import (
        FLAX_WEIGHTS_NAME,
        load_state_dict,
        msgpack_dumps,
        read_config,
        require_local_snapshot,
        torch_to_flax_tree,
    )

    require_local_snapshot(model_path)
    config = read_config(model_path)
    target = _hf_target(config, model_class)
    state = _flax_names(load_state_dict(model_path), config, target)
    load_weights(_port_module(config, target), state, f"{config['model_type']}.")
    os.makedirs(out_dir, exist_ok=True)
    weights = os.path.join(out_dir, FLAX_WEIGHTS_NAME)
    with open(weights, "wb") as fh:
        fh.write(msgpack_dumps(torch_to_flax_tree(state)))
    prefix = {"bert": "Bert", "roberta": "Roberta", "clip": "CLIP"}[config["model_type"]]
    config = dict(config, architectures=[prefix + {"base": "Model", "masked_lm": "ForMaskedLM", "clip": "Model"}[target]])
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2, sort_keys=True)
        fh.write("\n")
    for name in HF_SIDE_FILES:
        src = os.path.join(model_path, name)
        if os.path.isfile(src) and os.path.abspath(src) != os.path.abspath(os.path.join(out_dir, name)):
            shutil.copyfile(src, os.path.join(out_dir, name))
    _record_manifest(weights, {"kind": "hf-flax", "source": os.path.abspath(model_path), "sha256": sha256_file(weights)})
    return out_dir


__all__ = [
    "MANIFEST_NAME", "convert_hf_flax", "convert_inception", "hf_flax_params_to_torch", "convert_lpips_backbone", "jax_state_to_torch",
    "load_jax_state", "nested_state_dict", "sha256_file",
]
