"""Optional-dependency feature flags, with the JAX package's names.

The port's own copy of the JAX package's ``utils/imports.py`` flags: each tells
whether an optional package can be imported here, without importing it. The
plotting plane reads ``_MATPLOTLIB_AVAILABLE``; the other flags keep the JAX
names for the slices that will need them. ``load_flax_with_pt_fallback`` stays
behind: the port loads no Flax model.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import sys
from typing import Tuple


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


_JAX_AVAILABLE = _package_available("jax")
_FLAX_AVAILABLE = _package_available("flax")
_MATPLOTLIB_AVAILABLE = _package_available("matplotlib")
_SCIPY_AVAILABLE = _package_available("scipy")
_SKLEARN_AVAILABLE = _package_available("sklearn")
_TRANSFORMERS_AVAILABLE = _package_available("transformers")
_NLTK_AVAILABLE = _package_available("nltk")
_REGEX_AVAILABLE = _package_available("regex")
_TORCH_AVAILABLE = _package_available("torch")
_ORBAX_AVAILABLE = _package_available("orbax.checkpoint")
_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
_GAMMATONE_AVAILABLE = _package_available("gammatone")
_ONNXRUNTIME_AVAILABLE = _package_available("onnxruntime")
_PYCOCOTOOLS_AVAILABLE = _package_available("pycocotools")
_TORCHVISION_AVAILABLE = _package_available("torchvision")
_SENTENCEPIECE_AVAILABLE = _package_available("sentencepiece")
_TQDM_AVAILABLE = _package_available("tqdm")
_MECAB_AVAILABLE = _package_available("MeCab")
_IPADIC_AVAILABLE = _package_available("ipadic")
_MECAB_KO_DIC_AVAILABLE = _package_available("mecab_ko_dic")

_PYTHON_GREATER_EQUAL_3_11 = sys.version_info >= (3, 11)
_LATEX_AVAILABLE = shutil.which("latex") is not None


def snapshot_weight_stamp(model_name_or_path: str) -> Tuple[Tuple[str, int, int], ...]:
    """(name, mtime, size) of every weights file in a local snapshot dir, so model
    caches keyed on it reload when the checkpoint on disk is replaced. Cache-by-name
    (hub ids) stamps as empty."""
    import glob

    if not os.path.isdir(model_name_or_path):
        return ()
    stamps = []
    for pattern in ("flax_model*.msgpack", "pytorch_model*.bin", "model*.safetensors"):
        for path in sorted(glob.glob(os.path.join(model_name_or_path, pattern))):
            stat = os.stat(path)
            stamps.append((os.path.basename(path), stat.st_mtime_ns, stat.st_size))
    return tuple(stamps)
