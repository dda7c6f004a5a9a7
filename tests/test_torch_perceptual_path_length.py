"""Perceptual path length, held against the JAX package on the CPU.

Each package gets its own copy of one seeded generator (a 16-wide latent through a
fixed random projection and ``tanh`` to 3 x 24 x 24 images in [-1, 1], its latents
drawn from a numpy ``RandomState``), so both see the same latents and images. Held:
the three interpolations, the antialiased resize against ``jax.image.resize``, PPL with
a callable similarity under every interpolation, with and without the resize, with and
without the discards, conditional generators, the named VGG LPIPS similarity from a
backbone file in ``$TORCHMETRICS_TPU_LPIPS_BACKBONES``, the class, and every message.

Tolerances, at ``epsilon=1e-2``: interpolations within 1e-6; the resize within 1e-6
absolute; distances within 1e-5 relative with a callable similarity and 1e-4 with the
VGG similarity. At JAX's default ``epsilon=1e-4`` within 1e-2: it divides each distance
by 1e-8, so the float32 rounding of two nearly equal images or feature pyramids (a few
1e-7 of them, JAX's products and convolutions against the port's) is ~1e-3 of the
distance in either package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torchmetrics_tpu.image import PerceptualPathLength as JPPL  # noqa: E402
from torchmetrics_tpu_torch.convert import convert_lpips_backbone  # noqa: E402
from torchmetrics_tpu_torch.functional.image._lpips_backbones import LpipsPyramid  # noqa: E402
from torchmetrics_tpu_torch.functional.image.utils import _resize_bilinear  # noqa: E402
from torchmetrics_tpu_torch.image import PerceptualPathLength as TPPL  # noqa: E402

# the modules (each package's ``functional.image`` exports the function under the same name)
jppl = importlib.import_module("torchmetrics_tpu.functional.image.perceptual_path_length")
tppl = importlib.import_module("torchmetrics_tpu_torch.functional.image.perceptual_path_length")

METHODS = ("lerp", "slerp_any", "slerp_unit")
# a step at which a distance is well conditioned in float32 (JAX's default, 1e-4, divides
# two nearly equal images' distance by 1e-8: test_the_default_epsilon_is_as_close_as_float32_allows)
EPS = 1e-2
RTOL = 1e-5
VGG_RTOL = 1e-4
DEFAULT_EPS_RTOL = 1e-2


class _Generator:
    """A seeded stand-in generator for one package (``xp`` is ``jnp`` or ``torch``)."""

    def __init__(self, xp, seed: int = 0, conditional: bool = False, width: int = 16, size: int = 24) -> None:
        self.xp, self.rng, self.conditional, self.width = xp, np.random.RandomState(seed), conditional, width
        self.proj = (np.random.RandomState(100).randn(width, 3 * size * size) / np.sqrt(width)).astype(np.float32)
        self.size = size

    def _wrap(self, a):
        return jnp.asarray(a) if self.xp is jnp else torch.from_numpy(np.ascontiguousarray(a))

    def sample(self, n: int):
        z = self._wrap(self.rng.randn(n, self.width).astype(np.float32))
        if self.conditional:
            return z, self._wrap(self.rng.randint(0, 3, (n,)).astype(np.int32))
        return z

    def __call__(self, z, labels=None):
        proj = self._wrap(self.proj)
        if labels is not None:
            z = z + labels[:, None].astype(z.dtype) if self.xp is jnp else z + labels[:, None].to(z.dtype)
        out = self.xp.tanh(z @ proj)
        return out.reshape(z.shape[0], 3, self.size, self.size)


def _sim(a, b):
    return ((a - b) ** 2).mean(axis=(1, 2, 3)) if isinstance(a, jax.Array) else ((a - b) ** 2).mean(dim=(1, 2, 3))


@pytest.mark.parametrize("method", METHODS)
def test_interpolation_equals_jax(method):
    rng = np.random.RandomState(1)
    a, b = rng.randn(6, 16).astype(np.float32), rng.randn(6, 16).astype(np.float32)
    for eps in (1e-4, 0.3):
        want = np.asarray(jppl._interpolate(jnp.asarray(a), jnp.asarray(b), eps, method))
        got = tppl._interpolate(torch.from_numpy(a), torch.from_numpy(b), eps, method).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="Interpolation method cubic not supported."):
        tppl._interpolate(torch.from_numpy(a), torch.from_numpy(b), 0.1, "cubic")


@pytest.mark.parametrize("in_size, out", [(24, 16), (64, 64), (256, 64), (20, 33)])
def test_the_resize_equals_jax_image_resize(in_size, out):
    x = np.random.RandomState(in_size).uniform(-1, 1, (2, 3, in_size, in_size)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, out, out), "bilinear"))
    np.testing.assert_allclose(_resize_bilinear(torch.from_numpy(x), out, out).numpy(), want, rtol=0, atol=1e-6)


def _both(**kwargs):
    kwargs.setdefault("epsilon", EPS)
    conditional = kwargs.get("conditional", False)
    want = jppl.perceptual_path_length(_Generator(jnp, conditional=conditional), similarity_fn=_sim, **kwargs)
    got = tppl.perceptual_path_length(_Generator(torch, conditional=conditional), similarity_fn=_sim, **kwargs)
    return got, want


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("resize", [None, 16])
def test_ppl_with_a_callable_equals_jax(method, resize):
    got, want = _both(num_samples=40, batch_size=16, interpolation_method=method, resize=resize)
    assert got[2].shape == want[2].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("discards", [(None, None), (0.1, None), (None, 0.8), (0.25, 0.75)])
def test_the_quantile_discards_equal_jax(discards):
    got, want = _both(num_samples=30, batch_size=8, resize=None, lower_discard=discards[0], upper_discard=discards[1])
    assert got[2].shape == want[2].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_a_conditional_generator_equals_jax():
    got, want = _both(num_samples=20, batch_size=10, conditional=True, resize=None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.fixture(scope="module")
def vgg_dir(tmp_path_factory) -> str:
    root = tmp_path_factory.mktemp("ppl_backbones")
    net = LpipsPyramid("vgg").init_random(torch.Generator().manual_seed(5))
    torch.save(net.state_dict(), root / "vgg16-source.pth")
    convert_lpips_backbone(str(root / "vgg16-source.pth"), "vgg", str(root / "vgg.npz"))
    return str(root)


@pytest.mark.parametrize("method", METHODS)
def test_ppl_with_the_named_vgg_similarity_equals_jax(vgg_dir, monkeypatch, method):
    monkeypatch.setenv("TORCHMETRICS_TPU_LPIPS_BACKBONES", vgg_dir)
    kwargs = dict(num_samples=8, batch_size=8, interpolation_method=method, resize=16, epsilon=EPS)
    want = jppl.perceptual_path_length(_Generator(jnp), **kwargs)
    got = tppl.perceptual_path_length(_Generator(torch), **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=VGG_RTOL)


def test_the_default_epsilon_is_as_close_as_float32_allows(vgg_dir, monkeypatch):
    """At JAX's default ``epsilon=1e-4`` each distance is two nearly equal pyramids'
    difference over 1e-8: the float32 rounding of either package moves it by ~1e-3."""
    monkeypatch.setenv("TORCHMETRICS_TPU_LPIPS_BACKBONES", vgg_dir)
    kwargs = dict(num_samples=8, batch_size=8, resize=16)
    want = jppl.perceptual_path_length(_Generator(jnp), **kwargs)
    got = tppl.perceptual_path_length(_Generator(torch), **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=DEFAULT_EPS_RTOL)


def test_the_class_equals_jax(vgg_dir, monkeypatch):
    monkeypatch.setenv("TORCHMETRICS_TPU_LPIPS_BACKBONES", vgg_dir)
    jm = JPPL(num_samples=10, batch_size=5, resize=16, interpolation_method="slerp_any", epsilon=EPS)
    tm = TPPL(num_samples=10, batch_size=5, resize=16, interpolation_method="slerp_any", epsilon=EPS, device="cpu")
    jm.update(generator=_Generator(jnp, seed=3))
    tm.update(generator=_Generator(torch, seed=3))
    for g, w in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=VGG_RTOL)
    got = TPPL(num_samples=10, batch_size=5, resize=None, similarity_fn=_sim, epsilon=EPS, device="cpu")
    got.update(_Generator(torch))
    want = JPPL(num_samples=10, batch_size=5, resize=None, similarity_fn=_sim, epsilon=EPS)
    want.update(_Generator(jnp))
    for g, w in zip(got.compute(), want.compute()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_messages_equal_jax(tmp_path, monkeypatch):
    for kwargs in (dict(num_samples=0), dict(interpolation_method="nearest")):
        with pytest.raises(ValueError) as want:
            JPPL(**kwargs)
        with pytest.raises(ValueError) as got:
            TPPL(device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
    for module in (JPPL(), TPPL(device="cpu")):
        with pytest.raises(NotImplementedError, match="must implement a `sample` method"):
            module.update(generator=object())
        with pytest.raises(RuntimeError, match="No generator was provided"):
            module.compute()
    with pytest.raises(NotImplementedError, match="returning latents and labels"):
        tppl.perceptual_path_length(object(), conditional=True)
    monkeypatch.setenv("TORCHMETRICS_TPU_LPIPS_BACKBONES", str(tmp_path))
    for fn, gen in ((jppl.perceptual_path_length, _Generator(jnp)), (tppl.perceptual_path_length, _Generator(torch))):
        with pytest.raises(ModuleNotFoundError, match="The default `vgg` LPIPS similarity requires"):
            fn(gen, num_samples=2, batch_size=2)
