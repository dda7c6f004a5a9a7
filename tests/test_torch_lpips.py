"""LPIPS and its three backbones, held against the JAX package on the CPU.

One seeded torchvision-layout state dict per backbone (AlexNet, VGG16, SqueezeNet1.1,
He-normal, as ``tests/image/test_lpips_backbones.py`` builds its random checkpoints) is
converted by each package's own converter; the two trees must be equal, and the
pyramids tap by tap, the LPIPS distances (``normalize``, both reductions, the bundled
heads), the class over several batches (a JAX state dict loaded and updated further)
and every validation message must agree. Also: SqueezeNet's ``ceil_mode`` pool against
``F.max_pool2d(ceil_mode=True)`` at odd sizes, the backbone files converted by either
package loading in the other (with the same ``MANIFEST.json`` entry), the env-var
resolution, the truncated-``.npz`` fallback, and the head copies, byte for byte.

Tolerances: each tap within 1e-5 of its largest magnitude; LPIPS distances within 1e-5
relative (both packages compute in float32; the port's convolutions are im2col products,
JAX's ``conv_general_dilated``); pools and converted trees exactly.
"""

from __future__ import annotations

import filecmp
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from torchmetrics_tpu.functional.image import _lpips_backbones as jb  # noqa: E402
from torchmetrics_tpu.functional.image import lpips as jl  # noqa: E402
from torchmetrics_tpu.image import LearnedPerceptualImagePatchSimilarity as JLPIPS  # noqa: E402
from torchmetrics_tpu_torch.convert import convert_lpips_backbone, load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.functional.image import _lpips_backbones as tb  # noqa: E402
from torchmetrics_tpu_torch.functional.image import lpips as tl  # noqa: E402
from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity as TLPIPS  # noqa: E402
from torchmetrics_tpu_torch.robust.retry import ResourceIntegrityError  # noqa: E402

NETS = ("alex", "vgg", "squeeze")
TAP_TOL = 1e-5
LPIPS_RTOL = 1e-5


def _torchvision_state(net: str, seed: int = 0) -> dict:
    """A torchvision-layout ``features.*`` state dict of numpy arrays (He-normal), plus a
    classifier entry, which both converters drop."""
    shapes = {k: tuple(v.shape) for k, v in tb.LpipsPyramid(net).state_dict().items()}
    rng = np.random.RandomState(seed)
    state = {}
    for name, shape in shapes.items():
        if name.endswith("weight"):
            state[name] = (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))).astype(np.float32)
        else:
            state[name] = (0.01 * rng.randn(*shape)).astype(np.float32)
    state["classifier.1.weight"] = np.zeros((4, 4), np.float32)
    return state


@pytest.fixture(scope="module")
def backbones() -> dict:
    """Per net: the torchvision state and each package's converted tree."""
    out = {}
    for net in NETS:
        state = _torchvision_state(net, seed=NETS.index(net))
        out[net] = (state, jb.convert_torchvision_backbone(state, net), tb.convert_torchvision_backbone(state, net))
    return out


def _images(seed: int, shape=(2, 3, 45, 51)) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


@pytest.mark.parametrize("net", NETS)
def test_both_converters_give_the_same_tree(backbones, net):
    _, jtree, ttree = backbones[net]
    want, got = _flat(jtree), _flat(ttree)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("net", NETS)
def test_pyramid_taps_equal_jax(backbones, net):
    _, jtree, ttree = backbones[net]
    x = _images(1)
    want = jb._PYRAMIDS[net](jtree, jnp.asarray(x))
    got = tb.make_lpips_feature_fn(net, ttree)(torch.from_numpy(x))
    assert len(got) == len(want) == len(tb.LPIPS_CHANNELS[net])
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.shape[1] == tb.LPIPS_CHANNELS[net][level]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TAP_TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("net", NETS)
def test_the_pyramid_module_and_the_function_agree(backbones, net):
    _, _, ttree = backbones[net]
    module = tb.make_lpips_feature_fn(net, ttree)
    x = torch.from_numpy(_images(2, (1, 3, 33, 35)))
    assert sorted(module.state_dict()) == sorted(tb.lpips_backbone_params_from_jax(ttree, net))
    for a, b in zip(module(x), tb._PYRAMIDS[net](module.state_dict(), x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size", [(7, 8), (9, 9), (13, 14), (27, 30), (55, 55)])
def test_ceil_mode_pool_equals_torch_s(size):
    x = torch.randn(2, 3, *size, generator=torch.Generator().manual_seed(size[0]))
    assert torch.equal(tb._max_pool(x, 3, 2, ceil_mode=True), torch.nn.functional.max_pool2d(x, 3, 2, ceil_mode=True))
    want = np.asarray(jb._max_pool(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 3, 2, ceil_mode=True))
    np.testing.assert_array_equal(tb._max_pool(x, 3, 2, ceil_mode=True).permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory, backbones) -> str:
    """``{net}.npz`` of every backbone, written by the port's converter from a ``.pth``."""
    root = tmp_path_factory.mktemp("lpips_backbones")
    for net in NETS:
        pth = root / f"{net}-source.pth"
        torch.save({k: torch.from_numpy(v) for k, v in backbones[net][0].items()}, pth)
        convert_lpips_backbone(str(pth), net, str(root / f"{net}.npz"))
    return str(root)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_lpips_equals_jax(weights_dir, net, normalize, reduction):
    path = os.path.join(weights_dir, f"{net}.npz")
    lo = 0.0 if normalize else -1.0
    a = _images(3) * (0.5 if normalize else 1.0) + (0.5 if normalize else 0.0)
    b = np.clip(a + 0.2 * np.random.RandomState(4).randn(*a.shape).astype(np.float32), lo, 1.0)
    want = float(jl.learned_perceptual_image_patch_similarity(
        jnp.asarray(a), jnp.asarray(b), net, reduction, normalize, weights_path=path))
    got = tl.learned_perceptual_image_patch_similarity(
        torch.from_numpy(a), torch.from_numpy(b), net, reduction, normalize, weights_path=path)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= LPIPS_RTOL * abs(want), (float(got), want)


def test_custom_pyramid_with_uniform_and_given_heads_equals_jax():
    a, b = _images(5, (3, 3, 16, 16)), _images(6, (3, 3, 16, 16))

    def pyramid(img, xp):
        return [img, img[:, :, ::2, ::2] * 2.0, xp.tanh(img[:, :2])]

    heads = [np.linspace(0.1, 1.0, c).astype(np.float32) for c in (3, 3, 2)]
    for head_weights in (None, heads):
        want = jl.learned_perceptual_image_patch_similarity(
            jnp.asarray(a), jnp.asarray(b), feature_fn=lambda x: pyramid(x, jnp), head_weights=head_weights)
        got = tl.learned_perceptual_image_patch_similarity(
            torch.from_numpy(a), torch.from_numpy(b), feature_fn=lambda x: pyramid(x, torch),
            head_weights=None if head_weights is None else [torch.from_numpy(h) for h in head_weights])
        np.testing.assert_allclose(float(got), float(want), rtol=LPIPS_RTOL)


@pytest.mark.parametrize("net", NETS)
def test_the_class_equals_jax_and_carries_a_jax_state(weights_dir, net):
    path = os.path.join(weights_dir, f"{net}.npz")
    batches = [(_images(10 + i, (2, 3, 40, 40)), _images(20 + i, (2, 3, 40, 40))) for i in range(3)]
    for reduction in ("mean", "sum"):
        jm = JLPIPS(net_type=net, reduction=reduction, weights_path=path)
        tm = TLPIPS(net_type=net, reduction=reduction, weights_path=path, device="cpu")
        jm.update(*map(jnp.asarray, batches[0]))
        tm = load_jax_state(tm, jm.state_dict(persistent_only=False))
        for a, b in batches[1:]:
            jm.update(jnp.asarray(a), jnp.asarray(b))
            tm.update(torch.from_numpy(a), torch.from_numpy(b))
        assert int(tm.total) == int(jm.total) == 6 and tm.total.dtype == torch.int32
        np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=LPIPS_RTOL)


def test_validation_messages_equal_jax(weights_dir):
    feature_fn = [lambda x: [x], lambda x: [torch.as_tensor(np.asarray(x))]]
    cases = [dict(net_type="resnet"), dict(reduction="none"), dict(normalize="yes")]
    for kwargs in cases:
        with pytest.raises(ValueError) as want:
            JLPIPS(feature_fn=feature_fn[0], **kwargs)
        with pytest.raises(ValueError) as got:
            TLPIPS(feature_fn=feature_fn[1], device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
    x = np.zeros((1, 3, 8, 8), np.float32)
    with pytest.raises(ValueError) as want:
        jl.learned_perceptual_image_patch_similarity(jnp.asarray(x), jnp.asarray(x), reduction="max",
                                                     feature_fn=feature_fn[0])
    with pytest.raises(ValueError) as got:
        tl.learned_perceptual_image_patch_similarity(torch.from_numpy(x), torch.from_numpy(x), reduction="max",
                                                     feature_fn=lambda t: [t])
    assert str(got.value) == str(want.value)
    for fn in (jl.load_lpips_head_weights, tl.load_lpips_head_weights, jb.resolve_lpips_backbone_path,
               tb.resolve_lpips_backbone_path):
        with pytest.raises(ValueError, match="must be one of"):
            fn("resnet")


def test_a_missing_backbone_raises_jax_s_errors(tmp_path, monkeypatch):
    monkeypatch.setenv(tb._BACKBONES_ENV_VAR, str(tmp_path))
    for net in NETS:
        with pytest.raises(FileNotFoundError) as want:
            jb.resolve_lpips_backbone_path(net)
        with pytest.raises(FileNotFoundError) as got:
            tb.resolve_lpips_backbone_path(net)
        assert str(got.value) == str(want.value)
        with pytest.raises(ModuleNotFoundError, match="LPIPS backbone requires pretrained torchvision weights"):
            TLPIPS(net_type=net, device="cpu")
        x = torch.zeros(1, 3, 8, 8)
        with pytest.raises(ModuleNotFoundError, match="pass\n?.*`feature_fn`"):
            tl.learned_perceptual_image_patch_similarity(x, x, net)


def test_the_env_dir_resolves_npz_then_pth(tmp_path, monkeypatch, backbones):
    monkeypatch.setenv(tb._BACKBONES_ENV_VAR, str(tmp_path))
    pth = tmp_path / "vgg16-397923af.pth"
    torch.save({k: torch.from_numpy(v) for k, v in backbones["vgg"][0].items()}, pth)
    assert tb.resolve_lpips_backbone_path("vgg") == jb.resolve_lpips_backbone_path("vgg") == str(pth)
    got = tb.load_lpips_backbone_params("vgg")
    assert all(np.array_equal(got_v, want_v) for got_v, want_v in
               zip(_flat(got).values(), _flat(backbones["vgg"][2]).values()))
    convert_lpips_backbone(str(pth), "vgg", str(tmp_path / "vgg.npz"))
    assert tb.resolve_lpips_backbone_path("vgg") == jb.resolve_lpips_backbone_path("vgg") == str(tmp_path / "vgg.npz")


def _same_conversion(port_dir, jax_dir, name: str) -> None:
    """Both packages wrote the same archive (names, order, dtypes, values) and the same
    manifest entry; each entry's ``sha256`` is its own file's (a zip stamps its write
    time, so the two hashes differ by it)."""
    from torchmetrics_tpu_torch.convert import sha256_file

    manifests = [json.loads((d / "MANIFEST.json").read_text())[name] for d in (port_dir, jax_dir)]
    for d, entry in zip((port_dir, jax_dir), manifests):
        assert entry["sha256"] == sha256_file(str(d / name))
    assert [{k: v for k, v in m.items() if k != "sha256"} for m in manifests][0] == \
        {k: v for k, v in manifests[1].items() if k != "sha256"}
    with np.load(port_dir / name) as got, np.load(jax_dir / name) as want:
        assert got.files == want.files
        for key in want.files:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_backbone_converted_by_either_package_loads_in_the_other(tmp_path, backbones, writer):
    import torchmetrics_tpu.convert as jconvert

    net = "squeeze"
    pth = tmp_path / "squeezenet1_1-b8a52dc0.pth"
    torch.save({k: torch.from_numpy(v) for k, v in backbones[net][0].items()}, pth)
    paths = {}
    for name, convert in (("port", convert_lpips_backbone), ("jax", jconvert.convert_lpips_backbone)):
        os.makedirs(tmp_path / name, exist_ok=True)
        paths[name] = convert(str(pth), net, str(tmp_path / name / f"{net}.npz"))
    _same_conversion(tmp_path / "port", tmp_path / "jax", f"{net}.npz")
    reader = "jax" if writer == "port" else "port"
    loaded = (jb if reader == "jax" else tb).load_lpips_backbone_params(net, paths[writer])
    want = _flat(backbones[net][1])
    assert sorted(_flat(loaded)) == sorted(want)
    assert all(np.array_equal(v, want[k]) for k, v in _flat(loaded).items())


def test_a_truncated_npz_rebuilds_from_the_pth_beside_it_or_raises(tmp_path, backbones):
    net = "alex"
    npz = tmp_path / "alex.npz"
    npz.write_bytes(b"PK\x03\x04 truncated")
    with pytest.raises(ResourceIntegrityError, match="no raw torchvision checkpoint"):
        tb.load_lpips_backbone_params(net, str(npz))
    torch.save({k: torch.from_numpy(v) for k, v in backbones[net][0].items()}, tmp_path / "alexnet-owt-7be5be79.pth")
    with pytest.warns(RuntimeWarning, match="rebuilding from the raw checkpoint"):
        got = tb.load_lpips_backbone_params(net, str(npz))
    want = _flat(backbones[net][2])
    assert all(np.array_equal(v, want[k]) for k, v in _flat(got).items())
    # the npz was written anew, and both packages load it
    for module in (tb, jb):
        again = module.load_lpips_backbone_params(net, str(npz))
        assert all(np.array_equal(np.asarray(v), want[k]) for k, v in _flat(again).items())


def test_a_wrong_architecture_is_refused_with_jax_s_message(backbones):
    state = dict(backbones["alex"][0])
    narrow = dict(state, **{"features.10.weight": state["features.10.weight"][:128],
                            "features.10.bias": state["features.10.bias"][:128]})
    missing = {k: v for k, v in state.items() if not k.startswith("features.10.")}
    for bad, net, message in ((state, "vgg", "missing layers"), (narrow, "alex", "per-level channels"),
                              (missing, "alex", "missing layers")):
        with pytest.raises(ValueError, match=message) as want:
            jb.convert_torchvision_backbone(bad, net)
        with pytest.raises(ValueError) as got:
            tb.convert_torchvision_backbone(bad, net)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("net", NETS)
def test_the_head_copies_are_jax_s_byte_for_byte(net):
    here = os.path.dirname(tl.__file__)
    theirs = os.path.join(os.path.dirname(jl.__file__), "lpips_models", f"{net}.npz")
    assert filecmp.cmp(os.path.join(here, "lpips_models", f"{net}.npz"), theirs, shallow=False)
    for got, want in zip(tl.load_lpips_head_weights(net), jl.load_lpips_head_weights(net)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_a_metric_owns_its_backbone_and_the_functional_shares_one(weights_dir):
    path = os.path.join(weights_dir, "alex.npz")
    a, b = TLPIPS(weights_path=path, device="cpu"), TLPIPS(weights_path=path, device="cpu")
    assert a.feature_fn is not b.feature_fn
    assert tl._cached_backbone_fn("alex", path) is tl._cached_backbone_fn("alex", path)
