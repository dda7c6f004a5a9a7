"""The FID Inception-v3 feature extractor.

Counterpart of ``torchmetrics_tpu/image/_inception_net.py`` (torch-fidelity's
``inception-v3-compat``, the TF-ported network every published FID number uses). The
network is ``nn.Module``s whose state dict is torch-fidelity's (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``, ...), so a locally provided
``pt_inception-2015-12-05-6726825d.pth`` loads as it is; a ``.npz`` converted by either
package (``python -m torchmetrics_tpu_torch.convert inception``, the JAX package's flat
flax layout) loads through :func:`inception_params_from_jax`. Nothing is downloaded.

Every convolution runs in full float32 on
:func:`~torchmetrics_tpu_torch.utils.compute._conv2d_full_float32` (im2col and a product;
a 1x1 convolution a direct product), never on cuDNN, whose float32 convolutions may take
TF32. Batch norm is frozen (``eps=1e-3``), computed as flax computes it. The network
stops at the deepest tap it was asked for.

Without weights the JAX package warns and initialises flax at ``PRNGKey(0)``; the port
warns with the same words and draws He-normal weights from ``torch.Generator`` seeded
0, so random-weight features differ between the packages (tests carry JAX's parameters
across with :func:`inception_params_from_jax`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.image.utils import _on_device
from torchmetrics_tpu_torch.utils.compute import Conv2dFullFloat32, _matmul_full_float32

Tensor = torch.Tensor

_WEIGHTS_ENV_VAR = "TORCHMETRICS_TPU_INCEPTION_WEIGHTS"

# the taps in network order, and the feature sizes the extractor accepts
_TAPS = ("64", "192", "768", "2048", "logits", "logits_unbiased")

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


class FrozenBatchNorm2d(torch.nn.Module):
    """Batch norm with running statistics (``weight``, ``bias``, ``running_mean``,
    ``running_var``): ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, flax's
    ``BatchNorm(use_running_average=True)`` order."""

    def __init__(self, channels: int, eps: float = 1e-3) -> None:
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = torch.nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: Tensor) -> Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class BasicConv2d(torch.nn.Module):
    """Conv (no bias) + frozen batch-norm (eps 1e-3) + ReLU."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Tuple[int, int],
        strides: Tuple[int, int] = (1, 1),
        padding: Padding = ((0, 0), (0, 0)),
    ) -> None:
        super().__init__()
        self.conv = Conv2dFullFloat32(in_channels, out_channels, kernel_size, strides, padding, bias=False)
        self.bn = FrozenBatchNorm2d(out_channels)

    def forward(self, x: Tensor) -> Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _max_pool(x: Tensor, window: int = 3, stride: int = 2) -> Tensor:
    return F.max_pool2d(x, window, stride)


def _avg_pool3(x: Tensor) -> Tensor:
    """3x3 stride-1 average pool, SAME padding, padding excluded from the count."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class _Dense(torch.nn.Module):
    """``x @ weight.T + bias`` in full float32 (``torch.nn.Linear``'s state dict)."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(out_features, in_features), requires_grad=False)
        self.bias = torch.nn.Parameter(torch.zeros(out_features), requires_grad=False)

    def forward(self, x: Tensor) -> Tensor:
        return _matmul_full_float32(x, self.weight.T) + self.bias


_P1 = ((1, 1), (1, 1))
_P17 = ((0, 0), (3, 3))  # a (1, 7) kernel
_P71 = ((3, 3), (0, 0))  # a (7, 1) kernel
_P13 = ((0, 0), (1, 1))
_P31 = ((1, 1), (0, 0))


class InceptionA(torch.nn.Module):
    def __init__(self, in_channels: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_channels, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=((2, 2), (2, 2)))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=_P1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=_P1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, (1, 1))

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(torch.nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, (3, 3), strides=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=_P1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), strides=(2, 2))

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(torch.nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_channels, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=_P17)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=_P71)
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=_P17)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=_P17)
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1))

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(torch.nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), strides=(2, 2))
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=_P17)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=_P71)
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), strides=(2, 2))

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(torch.nn.Module):
    def __init__(self, in_channels: int, pool_mode: str) -> None:
        super().__init__()
        self.pool_mode = pool_mode  # "avg" (Mixed_7b) or "max" (FID-compat Mixed_7c)
        self.branch1x1 = BasicConv2d(in_channels, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_channels, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=_P13)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=_P31)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=_P1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=_P13)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=_P31)
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1))

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        # SAME max pooling pads with -inf, as F.max_pool2d's implicit padding does
        bp = _avg_pool3(x) if self.pool_mode == "avg" else F.max_pool2d(x, 3, 1, padding=1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class FIDInceptionV3(torch.nn.Module):
    """The FID-compat Inception-v3 trunk with the standard feature taps.

    ``forward`` takes ``(B, 3, 299, 299)`` floats in [-1, 1] (the caller resizes and
    remaps) and returns the taps of ``features_list``, stopping after the deepest."""

    def __init__(self, features_list: Sequence[str] = ("2048",)) -> None:
        super().__init__()
        self.features_list = tuple(str(f) for f in features_list)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), strides=(2, 2))
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=_P1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = _Dense(2048, 1008)

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        last = max((_TAPS.index(f) for f in self.features_list if f in _TAPS), default=-1)
        feats: Dict[str, Tensor] = {}

        def done(tap: str, value: Tensor) -> bool:
            feats[tap] = value
            return _TAPS.index(tap) >= last

        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        if not done("64", x.mean(dim=(2, 3))):
            x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
            if not done("192", x.mean(dim=(2, 3))):
                for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                              self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
                    x = block(x)
                if not done("768", x.mean(dim=(2, 3))):
                    x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
                    x = x.mean(dim=(2, 3))  # global average pool -> (B, 2048)
                    if not done("2048", x):
                        logits = self.fc(x)
                        feats["logits"] = logits
                        # the layer is affine, so fc(0) is its bias: JAX's ``logits - fc(0)``
                        feats["logits_unbiased"] = logits - self.fc.bias
        return {k: feats[k] for k in self.features_list if k in feats}

    def init_random(self, generator: torch.Generator) -> "FIDInceptionV3":
        """He-normal convolutions and a normal ``fc`` (std 1/sqrt(2048)) drawn from
        ``generator``; identity batch norms and a zero ``fc`` bias (throughput runs: the
        scores mean nothing)."""
        for name, value in self.state_dict(keep_vars=True).items():
            if name.endswith("conv.weight"):
                value.data.copy_(torch.randn(value.shape, generator=generator) * (2.0 / value[0].numel()) ** 0.5)
            elif name == "fc.weight":
                value.data.copy_(torch.randn(value.shape, generator=generator) / value.shape[1] ** 0.5)
        return self


def _tf1_axis(in_size: int, out_size: int) -> np.ndarray:
    """``[lo, hi, frac]`` of one axis of the TF1 resize, in float32 as JAX computes them
    (``src = dst * scale``, no half-pixel shift)."""
    scale = np.float32(in_size / out_size)
    src = np.arange(out_size, dtype=np.float32) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = src - lo.astype(np.float32)
    return np.stack([lo.astype(np.float32), hi.astype(np.float32), frac])


def _resize_bilinear_tf1(imgs: Tensor, out_h: int, out_w: int) -> Tensor:
    """TF1-style bilinear resize of NCHW images (align_corners=False, src = dst*scale, no
    antialias), matching torch-fidelity's ``interpolate_bilinear_2d_like_tensorflow1x``:
    JAX's gathers and lerps, not ``F.interpolate``'s half-pixel rule."""
    _, _, in_h, in_w = imgs.shape
    y = _on_device(_tf1_axis, (in_h, out_h), imgs.device)
    x = _on_device(_tf1_axis, (in_w, out_w), imgs.device)
    y_lo, y_hi, y_frac = y[0].long(), y[1].long(), y[2]
    x_lo, x_hi, xf = x[0].long(), x[1].long(), x[2]
    rows_lo = imgs[:, :, y_lo]
    rows_hi = imgs[:, :, y_hi]
    top = rows_lo[..., x_lo] * (1 - xf) + rows_lo[..., x_hi] * xf
    bottom = rows_hi[..., x_lo] * (1 - xf) + rows_hi[..., x_hi] * xf
    yf = y_frac[:, None]
    return top * (1 - yf) + bottom * yf


class InceptionFeatureExtractor(torch.nn.Module):
    """Callable feature extractor: uint8/float images -> pooled inception features.

    Args:
        feature: which tap to return — 64, 192, 768, 2048 or ``"logits_unbiased"``.
        params: the port's state dict (torch-fidelity's names; :func:`load_torch_fidelity_weights`,
            or :func:`inception_params_from_jax` of the JAX package's flax variables), or
            None for random initialization (throughput benchmarking only).
        normalize: if True, inputs are floats in [0, 1]; else uint8 in [0, 255].
        mesh: the JAX package's device mesh; the port runs on ``device``, so it must be None.
        device: where the network lives (the CPU when None); images are moved there.
    """

    def __init__(
        self,
        feature: Any = 2048,
        params: Optional[Mapping[str, Any]] = None,
        weights_path: Optional[str] = None,
        normalize: bool = False,
        mesh: Optional[Any] = None,
        device: Optional[Any] = None,
    ) -> None:
        super().__init__()
        if mesh is not None:
            raise ValueError(
                "Argument `mesh` is the JAX package's device mesh; the port extracts on the metric's device."
            )
        self.feature_key = str(feature)
        self.num_features = int(feature) if str(feature).isdigit() else 1008
        self.normalize = normalize
        self.net = FIDInceptionV3(features_list=(self.feature_key,))

        weights_path = weights_path or os.environ.get(_WEIGHTS_ENV_VAR)
        self._random_weights = False
        if params is not None:
            self.net.load_state_dict(params)
        elif weights_path:
            self.net.load_state_dict(load_torch_fidelity_weights(weights_path))
        else:
            from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

            rank_zero_warn(
                "No pretrained inception weights were provided (set"
                f" `weights_path` or the {_WEIGHTS_ENV_VAR} env var to the torch-fidelity"
                " checkpoint). The extractor runs with RANDOM weights — scores are"
                " meaningless, only throughput is representative."
            )
            self.net.init_random(torch.Generator().manual_seed(0))
            self._random_weights = True
        self.to(device if device is not None else "cpu").eval()

    def _preprocess(self, imgs: Tensor) -> Tensor:
        imgs = torch.as_tensor(imgs).to(self.net.fc.weight.device)
        if imgs.ndim == 3:
            imgs = imgs[None]
        if not (imgs.shape[1] == 3 and imgs.shape[-1] != 3):  # NHWC -> NCHW
            imgs = imgs.permute(0, 3, 1, 2)
        if self.normalize:
            # the reference quantizes to uint8 first ((imgs * 255).byte(), fid.py:364)
            imgs = torch.floor(imgs.to(torch.float32) * 255.0)
        imgs = imgs.to(torch.float32)
        if tuple(imgs.shape[2:]) != (299, 299):
            imgs = _resize_bilinear_tf1(imgs, 299, 299)
        return (imgs - 128.0) / 128.0

    @torch.no_grad()
    def forward(self, imgs: Tensor) -> Tensor:
        return self.net(self._preprocess(imgs))[self.feature_key].to(torch.float32)


def _flax_variables_from_torch_fidelity(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's flax variables (``params`` with HWIO kernels, ``batch_stats``;
    numpy) from a torch-fidelity state dict: the tree a converted ``.npz`` holds."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    def assign(tree: Dict[str, Any], keys: Sequence[str], value: np.ndarray) -> None:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    for name, tensor in state.items():
        value = tensor.detach().cpu().numpy() if isinstance(tensor, Tensor) else np.asarray(tensor)
        parts = name.split(".")
        if parts[-2] == "conv" and parts[-1] == "weight":
            assign(params, [*parts[:-1], "kernel"], value.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        elif parts[-2] == "bn":
            mapping = {"weight": "scale", "bias": "bias"}
            if parts[-1] in mapping:
                assign(params, [*parts[:-1], mapping[parts[-1]]], value)
            elif parts[-1] == "running_mean":
                assign(batch_stats, [*parts[:-1], "mean"], value)
            elif parts[-1] == "running_var":
                assign(batch_stats, [*parts[:-1], "var"], value)
        elif parts[0] == "fc":
            if parts[-1] == "weight":
                assign(params, ["fc", "kernel"], value.transpose(1, 0))
            else:
                assign(params, ["fc", "bias"], value)
    return {"params": params, "batch_stats": batch_stats}


def inception_params_from_jax(variables: Mapping[str, Any]) -> Dict[str, Tensor]:
    """The port's state dict (torch-fidelity's names, float32 tensors on the CPU) from the
    JAX package's flax variables (``{"params", "batch_stats"}``; HWIO kernels, ``fc``'s
    kernel ``[2048, 1008]``), as numpy arrays or anything ``np.asarray`` reads."""
    state: Dict[str, Tensor] = {}

    def tensor(value: Any, *axes: int) -> Tensor:
        array = np.asarray(value, dtype=np.float32)
        return torch.from_numpy(np.ascontiguousarray(array.transpose(*axes) if axes else array.copy()))

    def walk(node: Mapping[str, Any], path: Tuple[str, ...], stats: Mapping[str, Any]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,), (stats or {}).get(key, {}))
                continue
            prefix = ".".join(path)
            if path[-1] == "conv" and key == "kernel":
                state[f"{prefix}.weight"] = tensor(value, 3, 2, 0, 1)  # HWIO -> OIHW
            elif path[-1] == "bn":
                state[f"{prefix}.{'weight' if key == 'scale' else 'bias'}"] = tensor(value)
            elif path == ("fc",):
                state[f"fc.{'weight' if key == 'kernel' else 'bias'}"] = tensor(value, 1, 0) if key == "kernel" \
                    else tensor(value)
        if path and path[-1] == "bn":
            state[f"{'.'.join(path)}.running_mean"] = tensor(stats["mean"])
            state[f"{'.'.join(path)}.running_var"] = tensor(stats["var"])

    walk(variables["params"], (), variables["batch_stats"])
    return state


def load_torch_fidelity_weights(path: str) -> Dict[str, Tensor]:
    """Load the FID inception weights from a torch-fidelity ``.pth`` or a converted
    ``.npz``, as the port's state dict.

    ``path`` must point at a locally available ``pt_inception-2015-12-05-*.pth``
    (this environment cannot download it) or the ``.npz`` produced by
    ``python -m torchmetrics_tpu_torch.convert inception`` (or the JAX package's).
    """
    if path.endswith(".npz"):
        from torchmetrics_tpu_torch.utils.serialization import load_tree_npz

        tree = load_tree_npz(path)
        if set(tree) != {"params", "batch_stats"}:
            raise ValueError(
                f"`{path}` is not a converted inception checkpoint (expected top-level"
                f" 'params'/'batch_stats', got {sorted(tree)})"
            )
        return inception_params_from_jax(tree)
    state = torch.load(path, map_location="cpu", weights_only=True)
    # the port's names are torch-fidelity's; counters such as num_batches_tracked are dropped
    return {name: value.to(torch.float32) for name, value in state.items()
            if name.split(".")[-1] in ("weight", "bias", "running_mean", "running_var")}
