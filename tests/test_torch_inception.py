"""The FID Inception-v3 and the metrics on it (FID, IS, KID, MiFID), held against the
JAX package on the CPU.

The network's parameters are one seeded torch-fidelity-layout state dict (He-normal
convolutions, random batch-norm statistics and affines, a random ``fc``) saved as a
``.pth``: JAX reads it with its own ``load_torch_fidelity_weights``, the port with its
own, so the two packages run the same weights; ``inception_params_from_jax`` carries
JAX's flax variables back. One JAX forward per input kind (jitted once, every tap) is
shared by the tap tests through a module fixture. Also held: the TF1 resize at odd
sizes, the uint8 and the ``normalize`` paths, FID / IS / KID / MiFID with a callable
and with the net (states, ``compute``, ``reset_real_features``, a JAX FID's states
carried across and going on equal), every validation message, the ``.npz`` converted by
either package loading in the other (with the same ``MANIFEST.json`` entry), the CLI,
and the random-weight warning.

Tolerances: taps within 1e-4 of each tap's largest magnitude (the port's convolutions
are im2col products, JAX's ``conv_general_dilated``; 94 of them in sequence); the TF1
resize bitwise; FID/KID/MiFID/IS from callable features within 1e-5 relative (their host
float64 paths see the same float32 sums within a few ulps); from the net, states within
1e-4 of their largest magnitude and the scores within 1e-3 relative (the features carry
the 1e-6 tap differences into a covariance whose eigenvalues are summed under a square
root); integer counts exactly.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.convert as jconvert  # noqa: E402
import torchmetrics_tpu.image as jc  # noqa: E402
from torchmetrics_tpu.image import _inception_net as jinc  # noqa: E402
import torchmetrics_tpu_torch.image as tc  # noqa: E402
from torchmetrics_tpu_torch.convert import __main__ as cli  # noqa: E402
from torchmetrics_tpu_torch.convert import convert_inception, load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.image import _inception_net as tinc  # noqa: E402

TAPS = ("64", "192", "768", "2048", "logits", "logits_unbiased")
TAP_TOL = 1e-4
SCORE_RTOL = 1e-5
NET_SCORE_RTOL = 1e-3


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def weights(tmp_path_factory) -> dict:
    """The seeded torch-fidelity state dict as a ``.pth``, each package's reading of it."""
    rng = np.random.RandomState(0)
    state = {}
    for name, value in tinc.FIDInceptionV3().state_dict().items():
        shape = tuple(value.shape)
        if name.endswith("conv.weight"):
            array = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("running_var"):
            array = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("bn.weight"):
            array = rng.uniform(0.8, 1.2, shape)
        elif name == "fc.weight":
            array = rng.randn(*shape) / np.sqrt(shape[1])
        else:
            array = 0.05 * rng.randn(*shape)
        state[name] = torch.from_numpy(array.astype(np.float32))
    path = tmp_path_factory.mktemp("inception") / "pt_inception-2015-12-05-6726825d.pth"
    torch.save(state, path)
    return {"pth": str(path), "state": state, "jax": jinc.load_torch_fidelity_weights(str(path)),
            "port": tinc.load_torch_fidelity_weights(str(path))}


class _AllTaps:
    """A JAX extractor's ``net`` that returns every tap (``apply`` is all it needs)."""

    def __init__(self) -> None:
        self.net = jinc.FIDInceptionV3(features_list=TAPS)

    def apply(self, variables, x):
        return {"all": self.net.apply(variables, x)}


def _taps_both(weights: dict, imgs: np.ndarray, normalize: bool):
    jext = jinc.InceptionFeatureExtractor(feature=2048, params=weights["jax"], normalize=normalize)
    jext.net, jext.feature_key = _AllTaps(), "all"
    want = {k: np.asarray(v) for k, v in jext._forward(jext.params, jnp.asarray(imgs)).items()}
    text = tinc.InceptionFeatureExtractor(feature=2048, params=weights["port"], normalize=normalize)
    text.net.features_list = TAPS
    got = {k: v.numpy() for k, v in text.net(text._preprocess(torch.from_numpy(imgs))).items()}
    return got, want


@pytest.fixture(scope="module")
def taps(weights) -> dict:
    rng = np.random.RandomState(1)
    uint8 = rng.randint(0, 256, (2, 3, 45, 37)).astype(np.uint8)
    floats = rng.rand(2, 41, 52, 3).astype(np.float32)  # NHWC, as JAX accepts it too
    return {"uint8": _taps_both(weights, uint8, False), "normalize": _taps_both(weights, floats, True)}


def test_both_packages_read_the_pth_alike(weights):
    carried = tinc.inception_params_from_jax(jax.tree_util.tree_map(np.asarray, weights["jax"]))
    assert sorted(carried) == sorted(weights["port"]) == sorted(tinc.FIDInceptionV3().state_dict())
    for name, value in weights["port"].items():
        assert torch.equal(carried[name], value), name
        assert torch.equal(value, weights["state"][name]), name


@pytest.mark.parametrize("kind", ["uint8", "normalize"])
@pytest.mark.parametrize("tap", TAPS)
def test_every_tap_equals_jax(taps, kind, tap):
    got, want = taps[kind]
    assert got[tap].shape == want[tap].shape and got[tap].dtype == np.float32
    np.testing.assert_allclose(got[tap], want[tap], rtol=0, atol=TAP_TOL * float(np.abs(want[tap]).max()))


def test_logits_unbiased_is_logits_less_fc_of_zero(taps):
    got, _ = taps["uint8"]
    assert not np.array_equal(got["logits"], got["logits_unbiased"])


@pytest.mark.parametrize("feature", [64, 2048, "logits_unbiased"])
def test_the_extractor_returns_its_tap(weights, taps, feature):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (2, 3, 45, 37)).astype(np.uint8)
    params = tinc.inception_params_from_jax(jax.tree_util.tree_map(np.asarray, weights["jax"]))
    got = tinc.InceptionFeatureExtractor(feature=feature, params=params)(torch.from_numpy(imgs))
    assert got.shape == (2, 1008 if feature == "logits_unbiased" else feature)
    np.testing.assert_array_equal(got.numpy(), taps["uint8"][0][str(feature)])


@pytest.mark.parametrize("in_size, out_size", [((45, 37), (299, 299)), ((299, 17), (61, 299)), ((301, 300), (299, 299)),
                                               ((7, 5), (13, 11))])
def test_the_tf1_resize_equals_jax_bitwise(in_size, out_size):
    x = np.random.RandomState(in_size[0]).rand(2, *in_size, 3).astype(np.float32) * 255
    want = np.asarray(jinc._resize_bilinear_tf1(jnp.asarray(x), *out_size))
    got = tinc._resize_bilinear_tf1(torch.from_numpy(x).permute(0, 3, 1, 2), *out_size).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_weights_warn_with_jax_s_words(monkeypatch):
    monkeypatch.delenv(tinc._WEIGHTS_ENV_VAR, raising=False)
    with pytest.warns(UserWarning, match="The extractor runs with RANDOM weights"):
        ext = tinc.InceptionFeatureExtractor(feature=64)
    assert ext._random_weights
    again = tinc.InceptionFeatureExtractor(feature=64)
    for a, b in zip(ext.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)  # seeded: the same random weights every time
    with pytest.raises(ValueError, match="`mesh` is the JAX package's device mesh"):
        tinc.InceptionFeatureExtractor(feature=64, mesh=object())


def test_the_extractor_reads_the_env_var(weights, monkeypatch):
    monkeypatch.setenv(tinc._WEIGHTS_ENV_VAR, weights["pth"])
    ext = tinc.InceptionFeatureExtractor(feature=64)
    assert not ext._random_weights
    assert torch.equal(ext.net.Conv2d_1a_3x3.conv.weight, weights["state"]["Conv2d_1a_3x3.conv.weight"])


# ----------------------------------------------------------------- the metrics


def _features(imgs, xp):
    flat = imgs.reshape(imgs.shape[0], -1)[:, :24]
    return xp.tanh(flat * 3.0 - 1.0) * (1.0 + flat[:, :1])


def _jfeat(imgs):
    return _features(jnp.asarray(imgs, dtype=jnp.float32), jnp)


def _tfeat(imgs):
    return _features(torch.as_tensor(imgs, dtype=torch.float32), torch)


def _batches(seed: int, n: int = 3, size: int = 12):
    rng = np.random.RandomState(seed)
    return [rng.rand(size, 3, 4, 4).astype(np.float32) for _ in range(n)]


def _close(got, want, rtol=SCORE_RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=0)


def test_fid_with_a_callable_equals_jax_and_carries_a_jax_state():
    real, fake = _batches(0), _batches(1)
    jm = jc.FrechetInceptionDistance(feature=_jfeat, num_features=24)
    tm = tc.FrechetInceptionDistance(feature=_tfeat, num_features=24, device="cpu")
    jm.update(jnp.asarray(real[0]), real=True)
    jm.update(jnp.asarray(fake[0]), real=False)
    tm = load_jax_state(tm, jm.state_dict(persistent_only=False))
    for r, f in zip(real[1:], fake[1:]):
        jm.update(jnp.asarray(r), real=True)
        jm.update(jnp.asarray(f), real=False)
        tm.update(torch.from_numpy(r), real=True)
        tm.update(torch.from_numpy(f), real=False)
    for name in ("real_features_sum", "real_features_cov_sum", "fake_features_sum", "fake_features_cov_sum"):
        want = np.asarray(getattr(jm, name))
        np.testing.assert_allclose(_np(getattr(tm, name)), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert int(tm.real_features_num_samples) == int(jm.real_features_num_samples) == 36
    assert tm.real_features_num_samples.dtype == torch.int32
    _close(tm.compute(), jm.compute())


def test_fid_reset_real_features_and_errors_equal_jax():
    real, fake = _batches(2), _batches(3)
    for keep in (True, False):
        jm = jc.FrechetInceptionDistance(feature=_jfeat, reset_real_features=not keep)
        tm = tc.FrechetInceptionDistance(feature=_tfeat, reset_real_features=not keep, device="cpu",
                                         input_img_size=(3, 4, 4))
        assert tm.num_features == 24  # inferred from a dummy batch, as JAX infers it
        jm.update(jnp.asarray(real[0]), real=True)
        tm.update(torch.from_numpy(real[0]), real=True)
        jm.reset(), tm.reset()
        assert int(tm.real_features_num_samples) == int(jm.real_features_num_samples) == (12 if keep else 0)
        jm.update(jnp.asarray(fake[0]), real=False)
        tm.update(torch.from_numpy(fake[0]), real=False)
        if keep:
            _close(tm.compute(), jm.compute())
        else:
            with pytest.raises(RuntimeError, match="More than one sample is required"):
                tm.compute()
    cases = [(dict(feature=100), ValueError), (dict(feature="x"), TypeError), (dict(normalize=1), ValueError),
             (dict(feature=_tfeat, reset_real_features=1, num_features=24), ValueError)]
    for kwargs, error in cases:
        jkwargs = dict(kwargs, feature=_jfeat) if kwargs.get("feature") is _tfeat else kwargs
        with pytest.raises(error) as want:
            jc.FrechetInceptionDistance(**jkwargs)
        with pytest.raises(error) as got:
            tc.FrechetInceptionDistance(device="cpu", **kwargs)
        assert str(got.value) == str(want.value)


def test_inception_score_with_a_callable_equals_jax():
    imgs = _batches(4, n=2, size=20)
    for splits in (1, 3, 10):
        jm, tm = jc.InceptionScore(feature=_jfeat, splits=splits), tc.InceptionScore(feature=_tfeat, splits=splits,
                                                                                     device="cpu")
        for x in imgs:
            jm.update(jnp.asarray(x))
            tm.update(torch.from_numpy(x))
        np.random.seed(7)
        want = jm.compute()
        np.random.seed(7)
        got = tm.compute()
        for g, w in zip(got, want):
            _close(g, w)
    for kwargs, error in [(dict(feature=100), ValueError), (dict(feature=1.5), TypeError), (dict(normalize=0), ValueError)]:
        with pytest.raises(error) as want:
            jc.InceptionScore(**kwargs)
        with pytest.raises(error) as got:
            tc.InceptionScore(device="cpu", **kwargs)
        assert str(got.value) == str(want.value)


def test_kid_with_a_callable_equals_jax_under_one_seed():
    real, fake = _batches(5), _batches(6)
    for keep in (False, True):
        jm = jc.KernelInceptionDistance(feature=_jfeat, subsets=5, subset_size=10, reset_real_features=not keep)
        tm = tc.KernelInceptionDistance(feature=_tfeat, subsets=5, subset_size=10, reset_real_features=not keep,
                                        device="cpu")
        for r, f in zip(real, fake):
            jm.update(jnp.asarray(r), real=True)
            jm.update(jnp.asarray(f), real=False)
            tm.update(torch.from_numpy(r), real=True)
            tm.update(torch.from_numpy(f), real=False)
        np.random.seed(11)
        want = jm.compute()
        np.random.seed(11)
        got = tm.compute()
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-4)
        jm.reset(), tm.reset()
        assert len(tm.real_features) == len(jm.real_features) == (3 if keep else 0)
    cases = [dict(subsets=0), dict(subset_size=-1), dict(degree=0), dict(gamma=1), dict(coef=1),
             dict(reset_real_features=None), dict(normalize=None)]
    for kwargs in cases:
        with pytest.raises(ValueError) as want:
            jc.KernelInceptionDistance(feature=_jfeat, **kwargs)
        with pytest.raises(ValueError) as got:
            tc.KernelInceptionDistance(feature=_tfeat, device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
    jm = jc.KernelInceptionDistance(feature=_jfeat, subset_size=100)
    tm = tc.KernelInceptionDistance(feature=_tfeat, subset_size=100, device="cpu")
    jm.update(jnp.asarray(real[0]), real=True), jm.update(jnp.asarray(fake[0]), real=False)
    tm.update(torch.from_numpy(real[0]), real=True), tm.update(torch.from_numpy(fake[0]), real=False)
    with pytest.raises(ValueError) as want:
        jm.compute()
    with pytest.raises(ValueError) as got:
        tm.compute()
    assert str(got.value) == str(want.value)


def test_mifid_with_a_callable_equals_jax():
    real = _batches(8)
    fake = [np.clip(r + 0.05 * np.random.RandomState(9).randn(*r.shape), 0, 1).astype(np.float32) for r in real]
    for eps in (0.1, 0.5):
        jm = jc.MemorizationInformedFrechetInceptionDistance(feature=_jfeat, cosine_distance_eps=eps)
        tm = tc.MemorizationInformedFrechetInceptionDistance(feature=_tfeat, cosine_distance_eps=eps, device="cpu")
        for r, f in zip(real, fake):
            jm.update(jnp.asarray(r), real=True)
            jm.update(jnp.asarray(f), real=False)
            tm.update(torch.from_numpy(r), real=True)
            tm.update(torch.from_numpy(f), real=False)
        _close(tm.compute(), jm.compute())
    for kwargs in (dict(cosine_distance_eps=0.0), dict(cosine_distance_eps=2.0), dict(reset_real_features=0),
                   dict(feature=63)):
        with pytest.raises(ValueError) as want:
            jc.MemorizationInformedFrechetInceptionDistance(**dict(dict(feature=_jfeat), **kwargs))
        with pytest.raises(ValueError) as got:
            tc.MemorizationInformedFrechetInceptionDistance(device="cpu", **dict(dict(feature=_tfeat), **kwargs))
        assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def net_images():
    rng = np.random.RandomState(12)
    real = [rng.randint(0, 256, (5, 3, 32, 32)).astype(np.uint8) for _ in range(2)]
    fake = [np.clip(r.astype(np.int32) + rng.randint(-40, 41, r.shape), 0, 255).astype(np.uint8) for r in real]
    return real, fake


def _fed(jm, tm, real, fake):
    for r, f in zip(real, fake):
        for imgs, flag in ((r, True), (f, False)):
            jm.update(jnp.asarray(imgs), real=flag)
            tm.update(torch.from_numpy(imgs), real=flag)
    return jm, tm


def test_fid_with_the_net_equals_jax(weights, net_images):
    jm, tm = _fed(jc.FrechetInceptionDistance(feature=64, weights_path=weights["pth"]),
                  tc.FrechetInceptionDistance(feature=64, weights_path=weights["pth"], device="cpu"), *net_images)
    for name in ("real_features_sum", "real_features_cov_sum", "fake_features_sum", "fake_features_cov_sum"):
        want = np.asarray(getattr(jm, name))
        np.testing.assert_allclose(_np(getattr(tm, name)), want, rtol=0, atol=TAP_TOL * np.abs(want).max())
    _close(tm.compute(), jm.compute(), NET_SCORE_RTOL)


def test_kid_and_mifid_with_the_net_equal_jax(weights, net_images):
    jm, tm = _fed(jc.KernelInceptionDistance(feature=64, subsets=4, subset_size=6, weights_path=weights["pth"]),
                  tc.KernelInceptionDistance(feature=64, subsets=4, subset_size=6, weights_path=weights["pth"],
                                             device="cpu"), *net_images)
    np.random.seed(3)
    want = jm.compute()
    np.random.seed(3)
    for g, w in zip(tm.compute(), want):
        _close(g, w, NET_SCORE_RTOL)
    jm, tm = _fed(jc.MemorizationInformedFrechetInceptionDistance(feature=64, weights_path=weights["pth"]),
                  tc.MemorizationInformedFrechetInceptionDistance(feature=64, weights_path=weights["pth"],
                                                                  device="cpu"), *net_images)
    _close(tm.compute(), jm.compute(), NET_SCORE_RTOL)


def test_inception_score_with_the_net_equals_jax(weights, net_images):
    real, _ = net_images
    # the 64 tap (the stem): the logits taps are held by test_every_tap_equals_jax
    jm = jc.InceptionScore(feature=64, splits=2, weights_path=weights["pth"], normalize=True)
    tm = tc.InceptionScore(feature=64, splits=2, weights_path=weights["pth"], normalize=True, device="cpu")
    for imgs in real:
        x = imgs.astype(np.float32) / 255.0
        jm.update(jnp.asarray(x))
        tm.update(torch.from_numpy(x))
    np.random.seed(5)
    want = jm.compute()
    np.random.seed(5)
    for g, w in zip(tm.compute(), want):
        _close(g, w, NET_SCORE_RTOL)


# ------------------------------------------------------------ converted files


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
def test_an_inception_npz_converted_by_either_package_loads_in_the_other(tmp_path, weights, writer):
    paths = {}
    for name, convert in (("port", convert_inception), ("jax", jconvert.convert_inception)):
        os.makedirs(tmp_path / name)
        paths[name] = convert(weights["pth"], str(tmp_path / name / "inception.npz"))
    _same_conversion(tmp_path / "port", tmp_path / "jax", "inception.npz")
    if writer == "port":
        loaded = jinc.load_torch_fidelity_weights(paths["port"])
        want = jax.tree_util.tree_leaves(weights["jax"])
        got = jax.tree_util.tree_leaves(loaded)
        assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(weights["jax"])
        assert all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
    else:
        loaded = tinc.load_torch_fidelity_weights(paths["jax"])
        assert sorted(loaded) == sorted(weights["port"])
        assert all(torch.equal(loaded[k], weights["port"][k]) for k in loaded)


def test_the_cli_converts_inception_and_a_backbone_and_hf_flax_still_raises(tmp_path, weights, capsys):
    assert cli.main(["inception", weights["pth"], "-o", str(tmp_path / "inception.npz")]) == 0
    assert "MANIFEST.json" in capsys.readouterr().out
    assert sorted(tinc.load_torch_fidelity_weights(str(tmp_path / "inception.npz"))) == sorted(weights["port"])
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import LpipsPyramid, load_lpips_backbone_params

    net = LpipsPyramid("alex").init_random(torch.Generator().manual_seed(0))
    torch.save(net.state_dict(), tmp_path / "alexnet-owt-7be5be79.pth")
    out = tmp_path / "alex.npz"
    assert cli.main(["lpips-backbone", str(tmp_path / "alexnet-owt-7be5be79.pth"), "--net", "alex", "-o", str(out)]) == 0
    assert json.loads((tmp_path / "MANIFEST.json").read_text())["alex.npz"]["kind"] == "lpips-backbone-alex"
    assert set(load_lpips_backbone_params("alex", str(out))) == {f"features.{i}" for i in (0, 3, 6, 8, 10)}
    # hf-flax converts now (the test keeps its name): a tiny CLIP snapshot to flax's
    # msgpack, which the port reads back to the same tensors
    import chip_smoke
    from torchmetrics_tpu_torch.utils.hf.snapshot import load_state_dict

    config = json.loads(json.dumps(chip_smoke.HF_CONFIGS["openai/clip-vit-base-patch32"]))
    config["text_config"].update(vocab_size=600, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                 intermediate_size=24)
    config["vision_config"].update(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24,
                                   image_size=32, patch_size=16)
    config["projection_dim"] = 8
    src = chip_smoke.write_hf_snapshot(str(tmp_path / "clip"), config, seed=1, words=["a", "photo"])
    assert cli.main(["hf-flax", src, "-o", str(tmp_path / "o")]) == 0
    got, want = load_state_dict(str(tmp_path / "o")), load_state_dict(src)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="is not a converted inception checkpoint"):
        tinc.load_torch_fidelity_weights(str(out))
