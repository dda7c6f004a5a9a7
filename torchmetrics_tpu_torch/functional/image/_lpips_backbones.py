"""LPIPS backbones: AlexNet / VGG16 / SqueezeNet1.1 feature pyramids.

Counterpart of ``torchmetrics_tpu/functional/image/_lpips_backbones.py``. Each pyramid
is an ``nn.Module`` whose state dict is torchvision's ``features.*`` convolutions
(``alexnet``, ``vgg16``, ``squeezenet1_1``), and whose convolutions run in full float32
on :func:`~torchmetrics_tpu_torch.utils.compute._conv2d_full_float32`, never on cuDNN.
The pyramid functions (``alexnet_pyramid(params, img)`` ...) take such a state dict.

The weights file format is the JAX package's: a flat ``.npz`` of the pyramid's
parameter tree in HWIO layout (``python -m torchmetrics_tpu_torch.convert
lpips-backbone``), or the torchvision ``.pth`` itself; a file converted by either
package loads in the other. :func:`load_lpips_backbone_params` returns that tree,
as JAX's does, and :func:`lpips_backbone_params_from_jax` turns it into the port's
state dict. No weights are downloaded: a missing file raises.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.utils.compute import Conv2dFullFloat32, _conv2d_full_float32

Tensor = torch.Tensor

_BACKBONES_ENV_VAR = "TORCHMETRICS_TPU_LPIPS_BACKBONES"

# per-level channel widths of each backbone's feature pyramid — must line up with
# the bundled linear heads (reference lpips.py:36-43)
LPIPS_CHANNELS: Dict[str, Tuple[int, ...]] = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}

# (in, out, kernel, stride, padding) of every ``features.N`` convolution
_ALEX_CONVS = {0: (3, 64, 11, 4, 2), 3: (64, 192, 5, 1, 2), 6: (192, 384, 3, 1, 1), 8: (384, 256, 3, 1, 1),
               10: (256, 256, 3, 1, 1)}
# torchvision cfg "D": (conv indices per stage), a 2x2 pool before every stage but the first
_VGG_STAGES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_VGG_WIDTHS = (64, 128, 256, 512, 512)
# SqueezeNet1.1's fire modules: index -> (in, squeeze, expand1x1 = expand3x3)
_FIRES = {3: (64, 16, 64), 4: (128, 16, 64), 6: (128, 32, 128), 7: (256, 32, 128), 9: (256, 48, 192),
          10: (384, 48, 192), 11: (384, 64, 256), 12: (512, 64, 256)}


def _conv(params: Mapping[str, Tensor], name: str, x: Tensor, stride: int = 1, padding: int = 0) -> Tensor:
    """NCHW conv of the OIHW ``{name}.weight`` plus ``{name}.bias``."""
    pad = ((padding, padding), (padding, padding))
    return _conv2d_full_float32(x, params[f"{name}.weight"], params[f"{name}.bias"], (stride, stride), pad)


def _max_pool(x: Tensor, window: int, stride: int, ceil_mode: bool = False) -> Tensor:
    """Max pool over NCHW spatial dims; ``ceil_mode`` pads the bottom and right with
    -inf until the last window fits, as JAX's ``reduce_window`` does (torch's
    ``ceil_mode=True``)."""
    extra = []
    for size in x.shape[2:]:
        out = -(-(size - window) // stride) + 1 if ceil_mode else 0
        extra.append(max(0, (out - 1) * stride + window - size) if ceil_mode else 0)
    if any(extra):
        x = F.pad(x, (0, extra[1], 0, extra[0]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def alexnet_pyramid(params: Mapping[str, Tensor], img: Tensor) -> List[Tensor]:
    """AlexNet relu1..relu5 feature pyramid (NCHW in and out).

    Layer schedule matches torchvision ``alexnet().features`` (conv k11s4p2, pool3s2,
    conv k5p2, pool, 3x conv k3p1) with taps after each ReLU block, as sliced by the
    reference's ``Alexnet`` wrapper.
    """
    x = torch.relu(_conv(params, "features.0", img, stride=4, padding=2))
    f1 = x
    x = _max_pool(x, 3, 2)
    x = torch.relu(_conv(params, "features.3", x, padding=2))
    f2 = x
    x = _max_pool(x, 3, 2)
    x = torch.relu(_conv(params, "features.6", x, padding=1))
    f3 = x
    x = torch.relu(_conv(params, "features.8", x, padding=1))
    f4 = x
    x = torch.relu(_conv(params, "features.10", x, padding=1))
    return [f1, f2, f3, f4, x]


def vgg16_pyramid(params: Mapping[str, Tensor], img: Tensor) -> List[Tensor]:
    """VGG16 relu{1_2,2_2,3_3,4_3,5_3} feature pyramid (NCHW in and out)."""
    x, taps = img, []
    for stage_num, conv_ids in enumerate(_VGG_STAGES):
        if stage_num:
            x = _max_pool(x, 2, 2)
        for idx in conv_ids:
            x = torch.relu(_conv(params, f"features.{idx}", x, padding=1))
        taps.append(x)
    return taps


def _fire(params: Mapping[str, Tensor], name: str, x: Tensor) -> Tensor:
    """SqueezeNet Fire module: squeeze 1x1 -> relu -> concat(expand1x1, expand3x3)."""
    s = torch.relu(_conv(params, f"{name}.squeeze", x))
    e1 = torch.relu(_conv(params, f"{name}.expand1x1", s))
    e3 = torch.relu(_conv(params, f"{name}.expand3x3", s, padding=1))
    return torch.cat([e1, e3], dim=1)


def squeezenet_pyramid(params: Mapping[str, Tensor], img: Tensor) -> List[Tensor]:
    """SqueezeNet1.1 7-level feature pyramid (NCHW in and out).

    Slice boundaries follow the reference's ``SqueezeNet`` wrapper over torchvision's
    1.1 ``features`` indexing: taps after features[0:2], [2:5], [5:8], [8:10],
    [10:11], [11:12], [12:13].
    """
    x = torch.relu(_conv(params, "features.0", img, stride=2))
    f1 = x
    x = _max_pool(x, 3, 2, ceil_mode=True)
    x = _fire(params, "features.3", x)
    x = _fire(params, "features.4", x)
    f2 = x
    x = _max_pool(x, 3, 2, ceil_mode=True)
    x = _fire(params, "features.6", x)
    x = _fire(params, "features.7", x)
    f3 = x
    x = _max_pool(x, 3, 2, ceil_mode=True)
    x = _fire(params, "features.9", x)
    f4 = x
    x = _fire(params, "features.10", x)
    f5 = x
    x = _fire(params, "features.11", x)
    f6 = x
    x = _fire(params, "features.12", x)
    return [f1, f2, f3, f4, f5, f6, x]


_PYRAMIDS: Dict[str, Callable[[Mapping[str, Tensor], Tensor], List[Tensor]]] = {
    "alex": alexnet_pyramid,
    "vgg": vgg16_pyramid,
    "squeeze": squeezenet_pyramid,
}


def _conv_layer(c_in: int, c_out: int, kernel: int, stride: int = 1, padding: int = 0) -> Conv2dFullFloat32:
    return Conv2dFullFloat32(c_in, c_out, (kernel, kernel), (stride, stride), ((padding, padding),) * 2)


class Fire(torch.nn.Module):
    """SqueezeNet's Fire module (torchvision's ``squeeze``/``expand1x1``/``expand3x3``)."""

    def __init__(self, c_in: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = _conv_layer(c_in, squeeze, 1)
        self.expand1x1 = _conv_layer(squeeze, expand, 1)
        self.expand3x3 = _conv_layer(squeeze, expand, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        return _fire(dict(self.named_parameters(prefix="m")), "m", x)


class LpipsPyramid(torch.nn.Module):
    """The ``net_type`` backbone's feature pyramid as a module: ``features`` holds
    torchvision's convolutions (its state dict is torchvision's ``features.*``), and
    ``forward(img)`` returns the NCHW taps. Parameters are made empty; load a state dict
    (:func:`lpips_backbone_params_from_jax`) or :meth:`init_random`."""

    def __init__(self, net_type: str) -> None:
        super().__init__()
        if net_type not in _PYRAMIDS:
            raise ValueError(f"Argument `net_type` must be one of {tuple(_PYRAMIDS)}, but got {net_type}")
        self.net_type = net_type
        if net_type == "alex":
            layers = {str(i): _conv_layer(a, b, k, s, p) for i, (a, b, k, s, p) in _ALEX_CONVS.items()}
        elif net_type == "vgg":
            layers, c_in = {}, 3
            for conv_ids, width in zip(_VGG_STAGES, _VGG_WIDTHS):
                for idx in conv_ids:
                    layers[str(idx)] = _conv_layer(c_in, width, 3, padding=1)
                    c_in = width
        else:
            layers = {"0": _conv_layer(3, 64, 3, stride=2)}
            layers.update({str(i): Fire(*spec) for i, spec in _FIRES.items()})
        self.features = torch.nn.ModuleDict(layers)

    def init_random(self, generator: torch.Generator) -> "LpipsPyramid":
        """He-normal weights and zero biases drawn from ``generator`` (throughput runs:
        the scores mean nothing)."""
        for name, value in self.state_dict(keep_vars=True).items():
            if name.endswith("weight"):
                fan_in = value[0].numel()
                value.data.copy_(torch.randn(value.shape, generator=generator) * (2.0 / fan_in) ** 0.5)
            else:
                value.data.zero_()
        return self

    def forward(self, img: Tensor) -> List[Tensor]:
        return _PYRAMIDS[self.net_type](dict(self.named_parameters()), img)


# torchvision download filenames (hash-suffixed, varies across releases) for the
# env-dir search and error messages
_CHECKPOINT_HINTS: Dict[str, str] = {
    "alex": "alexnet-owt-*.pth",
    "vgg": "vgg16-*.pth",
    "squeeze": "squeezenet1_1-*.pth",
}


def convert_torchvision_backbone(state_dict: Mapping[str, Any], net_type: str) -> Dict[str, Any]:
    """Convert a torchvision state dict (OIHW convs; numpy or tensor values) to the
    pyramid's parameter tree in the JAX package's layout (HWIO kernels, numpy).

    Only the ``features.*`` convolutions are kept (the classifier head is unused by
    LPIPS). Works on any mapping of name -> array.
    """
    if net_type not in _PYRAMIDS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_PYRAMIDS)}, but got {net_type}")
    params: Dict[str, Any] = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        if parts[0] != "features":
            continue
        value = value.detach().cpu().numpy() if isinstance(value, Tensor) else np.asarray(value)
        if net_type == "squeeze" and len(parts) == 4:
            # features.N.{squeeze,expand1x1,expand3x3}.{weight,bias}
            node = params.setdefault(f"features.{parts[1]}", {}).setdefault(parts[2], {})
        elif len(parts) == 3:
            node = params.setdefault(f"features.{parts[1]}", {})
        else:
            continue
        if parts[-1] == "weight":
            node["kernel"] = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif parts[-1] == "bias":
            node["bias"] = value
    _validate_backbone_params(params, net_type)
    return params


def _validate_backbone_params(params: Dict[str, Any], net_type: str) -> None:
    """Shape-check the converted tree against the known channel layout."""
    channels = LPIPS_CHANNELS[net_type]
    probes = {
        "alex": ["features.0", "features.3", "features.6", "features.8", "features.10"],
        "vgg": ["features.2", "features.7", "features.14", "features.21", "features.28"],
        "squeeze": ["features.0", "features.4", "features.7", "features.9",
                    "features.10", "features.11", "features.12"],
    }[net_type]
    missing = [p for p in probes if p not in params]
    if net_type == "squeeze":
        # fire modules must have converted as nested squeeze/expand trees — a flat
        # conv node here means the checkpoint was a different architecture
        missing += [
            f"{p}.expand3x3" for p in probes[1:]
            if p in params and "expand3x3" not in params[p]
        ]
    if missing:
        raise ValueError(
            f"Converted `{net_type}` backbone is missing layers {missing} — is the"
            " checkpoint a torchvision state dict for this architecture?"
        )
    if net_type == "squeeze":
        got = (params["features.0"]["kernel"].shape[-1],) + tuple(
            2 * params[p]["expand3x3"]["kernel"].shape[-1] for p in probes[1:]
        )
    else:
        got = tuple(params[p]["kernel"].shape[-1] for p in probes)
    if got != channels:
        raise ValueError(
            f"Converted `{net_type}` backbone has per-level channels {got},"
            f" expected {channels} — wrong architecture or truncated checkpoint."
        )


def lpips_backbone_params_from_jax(params: Mapping[str, Any], net_type: str) -> Dict[str, Tensor]:
    """The port's state dict (torchvision's ``features.*`` names, OIHW float32 tensors on
    the CPU) from the JAX package's pyramid parameter tree (HWIO kernels, the tree a
    converted ``.npz`` holds)."""
    _validate_backbone_params(dict(params), net_type)
    state: Dict[str, Tensor] = {}

    def put(prefix: str, node: Mapping[str, Any]) -> None:
        state[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(node["kernel"], dtype=np.float32).transpose(3, 2, 0, 1)))  # HWIO -> OIHW
        state[f"{prefix}.bias"] = torch.from_numpy(np.asarray(node["bias"], dtype=np.float32).copy())

    for layer, node in params.items():
        if "kernel" in node:
            put(layer, node)
        else:
            for sub, leaf in node.items():
                put(f"{layer}.{sub}", leaf)
    return state


def resolve_lpips_backbone_path(net_type: str, path: Optional[str] = None) -> str:
    """Resolve the concrete weights file for ``net_type``.

    Resolution order: explicit ``path`` -> ``$TORCHMETRICS_TPU_LPIPS_BACKBONES``
    directory containing ``{alex,vgg,squeeze}.npz`` or the torchvision ``.pth``.
    Exposed separately so callers that cache loaded backbones can key on the
    resolved file, not on the mutable env var.
    """
    if net_type not in _PYRAMIDS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_PYRAMIDS)}, but got {net_type}")
    if path is None:
        import glob

        root = os.environ.get(_BACKBONES_ENV_VAR)
        if root:
            for pattern in (f"{net_type}.npz", _CHECKPOINT_HINTS[net_type]):
                hits = sorted(glob.glob(os.path.join(root, pattern)))
                if hits:
                    path = hits[0]
                    break
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            f"No pretrained `{net_type}` LPIPS backbone weights found. Provide the"
            f" torchvision checkpoint ({_CHECKPOINT_HINTS[net_type]}) or a converted"
            f" `.npz` via the `weights_path` argument, or point {_BACKBONES_ENV_VAR}"
            " at a directory containing it. This environment cannot download weights."
        )
    return path


def _load_pth_backbone(path: str, net_type: str) -> Dict[str, Any]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torchvision_backbone(state, net_type)


def load_lpips_backbone_params(net_type: str, path: Optional[str] = None) -> Dict[str, Any]:
    """Load (and convert if needed) the ``net_type`` backbone parameters, as the JAX
    package's tree (HWIO kernels, numpy).

    ``.npz`` files are loaded with plain numpy; ``.pth`` via ``torch.load`` and
    converted on the fly. See :func:`resolve_lpips_backbone_path` for resolution.

    A corrupted/truncated ``.npz`` (e.g. a conversion interrupted by preemption)
    falls back to the raw torchvision ``.pth`` sitting in the same directory when
    one is available, and writes the ``.npz`` anew; otherwise it raises
    ``ResourceIntegrityError`` naming the file instead of scoring with garbage weights.
    """
    from torchmetrics_tpu_torch.robust.retry import ResourceIntegrityError

    path = resolve_lpips_backbone_path(net_type, path)
    if path.endswith(".npz"):
        from torchmetrics_tpu_torch.utils.serialization import load_tree_npz

        try:
            params = load_tree_npz(path)
            _validate_backbone_params(params, net_type)
            return params
        except Exception as err:
            import glob

            from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

            hits = sorted(glob.glob(os.path.join(os.path.dirname(path), _CHECKPOINT_HINTS[net_type])))
            if not hits:
                raise ResourceIntegrityError(
                    f"LPIPS `{net_type}` backbone weights at {path} are corrupted ({err})"
                    " and no raw torchvision checkpoint is present to rebuild from."
                    " Re-run `python -m torchmetrics_tpu_torch.convert lpips-backbone` on the"
                    " original checkpoint."
                ) from err
            rank_zero_warn(
                f"LPIPS `{net_type}` backbone weights at {path} are corrupted ({err});"
                f" rebuilding from the raw checkpoint {hits[0]}.",
                RuntimeWarning,
            )
            params = _load_pth_backbone(hits[0], net_type)
            # write the npz anew (atomically) so later processes load the clean file;
            # a read-only weights directory keeps the in-memory fallback
            from torchmetrics_tpu_torch.utils.fileio import atomic_open
            from torchmetrics_tpu_torch.utils.serialization import flatten_tree

            try:
                with atomic_open(path, "wb") as fh:
                    np.savez(fh, **flatten_tree(params))
            except OSError:
                pass
            return params
    return _load_pth_backbone(path, net_type)


def make_lpips_feature_fn(
    net_type: str,
    params: Optional[Dict[str, Any]] = None,
    weights_path: Optional[str] = None,
    device: Optional[Any] = None,
) -> LpipsPyramid:
    """Build the named-backbone ``feature_fn`` for the LPIPS scoring machinery: the
    pyramid module on ``device`` (the CPU when None), mapping a *pre-scaled* NCHW batch
    (the LPIPS scaling layer is applied by the caller) to the backbone's feature
    pyramid. ``params`` is the JAX-layout tree of :func:`load_lpips_backbone_params`."""
    if params is None:
        params = load_lpips_backbone_params(net_type, weights_path)
    net = LpipsPyramid(net_type)
    net.load_state_dict(lpips_backbone_params_from_jax(params, net_type))
    return net.to(device if device is not None else "cpu").eval()
