"""CLIPScore and CLIP-IQA in the port against the JAX package, on tiny CLIP snapshots
(2 + 2 layers, width 32, 30 x 30 images from patches of 6) that both packages load from
the same directory.

The images are of other sizes than the processor's (odd, non-square, larger and
smaller), so PIL's bicubic resampling runs: CLIPScore within 1e-4 on the x100 scale,
CLIP-IQA within 1e-5, for the functionals and the classes, one prompt, several
prompts and custom pairs, both pooling rules of CLIP's text tower; JAX's states carried
across; JAX's messages for bad inputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from tests.helpers import hf_snapshots  # noqa: E402
from torchmetrics_tpu.functional.multimodal import clip_image_quality_assessment as jax_iqa  # noqa: E402
from torchmetrics_tpu.functional.multimodal import clip_score as jax_clip_score  # noqa: E402
from torchmetrics_tpu.multimodal import CLIPImageQualityAssessment as JaxIQA  # noqa: E402
from torchmetrics_tpu.multimodal import CLIPScore as JaxCLIPScore  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.functional.multimodal import clip_image_quality_assessment, clip_score  # noqa: E402
from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore  # noqa: E402

pytest.importorskip("transformers")

CAPTIONS = ["a cat sat on the mat", "the blue sky over a dog", "hello world 42", "Über café, naïve!", "sharp photo"]


def _images(n: int, shape=(3, 37, 45), seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, *shape)).astype(np.uint8)


def _close(got, want, atol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], atol)
        return
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    return {eos: hf_snapshots.clip_snapshot(str(root / f"clip{eos}"), seed=eos % 7, eos_token_id=eos, shortest_edge=34)
            for eos in (49407, 2)}


@pytest.mark.parametrize("eos", [49407, 2])
def test_clip_score_equals_jax(clips, eos):
    imgs = _images(4)
    got = clip_score(torch.from_numpy(imgs), CAPTIONS[:4], model_name_or_path=clips[eos], device="cpu")
    want = jax_clip_score(jnp.asarray(imgs), CAPTIONS[:4], model_name_or_path=clips[eos])
    _close(got, want, 1e-4)


def test_clip_score_of_images_of_different_sizes_in_a_list_equals_jax(clips):
    imgs = [_images(1, shape, seed=i)[0] for i, shape in enumerate([(3, 30, 30), (3, 64, 41), (3, 21, 33)])]
    got = clip_score([torch.from_numpy(i) for i in imgs], CAPTIONS[:3], model_name_or_path=clips[2], device="cpu")
    want = jax_clip_score([jnp.asarray(i) for i in imgs], CAPTIONS[:3], model_name_or_path=clips[2])
    _close(got, want, 1e-4)
    single = clip_score(torch.from_numpy(imgs[1]), CAPTIONS[1], model_name_or_path=clips[2], device="cpu")
    _close(single, jax_clip_score(jnp.asarray(imgs[1]), CAPTIONS[1], model_name_or_path=clips[2]), 1e-4)


def test_the_clip_score_class_and_a_carried_jax_state_equal_jax(clips):
    port, jax = CLIPScore(clips[49407], device="cpu"), JaxCLIPScore(clips[49407])
    batches = [(_images(2, seed=5), CAPTIONS[:2]), (_images(3, seed=6), CAPTIONS[2:5])]
    for imgs, caps in batches:
        port.update(torch.from_numpy(imgs), caps)
        jax.update(jnp.asarray(imgs), caps)
    _close(port.compute(), jax.compute(), 1e-4)
    assert int(port.n_samples) == int(jax.n_samples) == 5
    jax = JaxCLIPScore(clips[49407])
    jax.update(jnp.asarray(batches[0][0]), batches[0][1])
    carried = load_jax_state(CLIPScore(clips[49407], device="cpu"), jax.state_dict(persistent_only=False))
    carried.update(torch.from_numpy(batches[1][0]), batches[1][1])
    jax.update(jnp.asarray(batches[1][0]), batches[1][1])
    _close(carried.compute(), jax.compute(), 1e-4)


PROMPT_CASES = {
    "one_prompt": ("quality",),
    "several_prompts": ("quality", "brightness", "sharpness", "natural"),
    "custom_pairs": (("a sharp photo of a cat", "a blurry photo of a dog"), "contrast", ("Good!", "Bad?")),
}


@pytest.mark.parametrize("case", sorted(PROMPT_CASES))
def test_clip_iqa_equals_jax(clips, case):
    imgs = np.random.RandomState(3).rand(3, 3, 40, 33).astype(np.float32)
    got = clip_image_quality_assessment(torch.from_numpy(imgs), clips[49407], 1.0, PROMPT_CASES[case], device="cpu")
    want = jax_iqa(jnp.asarray(imgs), clips[49407], 1.0, PROMPT_CASES[case])
    _close(got, want, 1e-5)


def test_clip_iqa_of_uint8_images_and_a_data_range_equals_jax(clips):
    imgs = _images(2, (3, 29, 31), seed=9)
    got = clip_image_quality_assessment(torch.from_numpy(imgs), clips[2], 255.0, "brightness", device="cpu")
    _close(got, jax_iqa(jnp.asarray(imgs), clips[2], 255.0, "brightness"), 1e-5)
    one = clip_image_quality_assessment(torch.from_numpy(imgs[0]), clips[2], 255.0, device="cpu")
    _close(one, jax_iqa(jnp.asarray(imgs[0]), clips[2], 255.0), 1e-5)


@pytest.mark.parametrize("case", ["one_prompt", "custom_pairs"])
def test_the_clip_iqa_class_and_a_carried_jax_state_equal_jax(clips, case):
    prompts = PROMPT_CASES[case]
    batches = [np.random.RandomState(s).rand(2, 3, 36, 36).astype(np.float32) for s in (11, 12)]
    jax = JaxIQA(clips[49407], prompts=prompts)
    jax.update(jnp.asarray(batches[0]))
    port = load_jax_state(CLIPImageQualityAssessment(clips[49407], prompts=prompts, device="cpu"),
                          jax.state_dict(persistent_only=False))
    jax.update(jnp.asarray(batches[1]))
    port.update(torch.from_numpy(batches[1]))
    _close(port.compute(), jax.compute(), 1e-5)


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_bad_inputs_raise_jax_s_messages(clips):
    d = clips[49407]
    imgs = _images(2)
    assert _message(lambda: clip_score(torch.from_numpy(imgs), ["only one"], d, device="cpu")) == \
        _message(lambda: jax_clip_score(jnp.asarray(imgs), ["only one"], d))
    assert _message(lambda: clip_score([torch.from_numpy(imgs)], ["x"], d, device="cpu")) == \
        _message(lambda: jax_clip_score([jnp.asarray(imgs)], ["x"], d))
    for prompts in ("nope", ["quality"], (("a", "b", "c"),)):
        assert _message(lambda: clip_image_quality_assessment(torch.from_numpy(imgs), d, prompts=prompts,
                                                              device="cpu")) == \
            _message(lambda: jax_iqa(jnp.asarray(imgs), d, prompts=prompts))
    with pytest.raises(OSError, match="local transformers cache and this environment has no network access"):
        CLIPScore("no/such-clip", device="cpu")
    with pytest.raises(OSError, match="local transformers cache and this environment has no network access"):
        clip_image_quality_assessment(torch.from_numpy(imgs), device="cpu")  # "clip_iqa" is not a local directory


def test_the_all_lists_and_class_attributes_equal_jax():
    import torchmetrics_tpu as jtm
    import torchmetrics_tpu.functional as jfunctional
    import torchmetrics_tpu.functional.multimodal as jfm
    import torchmetrics_tpu.multimodal as jm
    import torchmetrics_tpu_torch as ttm
    import torchmetrics_tpu_torch.functional as tfunctional
    import torchmetrics_tpu_torch.functional.multimodal as tfm
    import torchmetrics_tpu_torch.multimodal as tm

    assert tm.__all__ == jm.__all__ and tfm.__all__ == jfm.__all__
    assert sorted(tfunctional.__all__) == sorted(jfunctional.__all__)
    assert set(jtm.__all__) - set(ttm.__all__) == set()
    for name in tm.__all__:
        assert getattr(ttm, name) is getattr(tm, name)
        for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound",
                     "plot_upper_bound"):
            assert getattr(getattr(tm, name), attr, None) == getattr(getattr(jm, name), attr, None), (name, attr)
    assert tfm.clip_score is tfunctional.clip_score and "multimodal" in tfunctional.__all__
