"""The port's snapshot reader, encoders and weight carry-across (``utils/hf``,
``convert``) against the JAX package's ``transformers`` Flax classes.

Each weight format loads to the arrays ``transformers`` loads; BERT's and RoBERTa's
hidden states, their masked-LM logits and CLIP's image and text features are within
1e-5 of their largest magnitude of Flax's (the port's LayerNorm computes its variance
in two passes, Flax's as ``mean(x^2) - mean(x)^2``; at these widths both agree to
~3e-7); a directory converted by either package's ``convert_hf_flax`` runs in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tests.helpers import hf_snapshots  # noqa: E402
from torchmetrics_tpu_torch import convert as tconvert  # noqa: E402
from torchmetrics_tpu_torch.convert import __main__ as cli  # noqa: E402
from torchmetrics_tpu_torch.utils.hf import snapshot  # noqa: E402
from torchmetrics_tpu_torch.utils.hf.clip import load_clip  # noqa: E402
from torchmetrics_tpu_torch.utils.hf.encoders import load_encoder  # noqa: E402

transformers = pytest.importorskip("transformers")
flax_serialization = pytest.importorskip("flax.serialization")

RNG = np.random.RandomState(0)
IDS = RNG.randint(5, 800, (4, 13))
MASK = np.ones_like(IDS)
MASK[1, 9:] = 0
MASK[2, 3:] = 0
MASK[3] = 0  # a row that is all padding stays finite


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("snapshots")
    out = {}
    for kind in ("bert", "roberta"):
        for masked in (False, True):
            name = f"{kind}{'_mlm' if masked else ''}"
            out[name] = hf_snapshots.encoder_snapshot(str(root / name), kind, masked_lm=masked, seed=len(out))
    for eos in (49407, 2):
        out[f"clip_eos{eos}"] = hf_snapshots.clip_snapshot(str(root / f"clip{eos}"), seed=eos, eos_token_id=eos)
    return out


def _ids(kind: str) -> np.ndarray:
    ids = IDS.copy()
    ids[MASK == 0] = 0 if kind.startswith("bert") else 1  # the pad id
    return ids


@pytest.mark.parametrize("name", ["bert", "roberta"])
def test_every_hidden_state_equals_flax(snapshots, name):
    hf = transformers.FlaxAutoModel.from_pretrained(snapshots[name], local_files_only=True)
    ids = _ids(name)
    want = hf(input_ids=ids, attention_mask=MASK, output_hidden_states=True).hidden_states
    got = load_encoder(snapshots[name]).hidden_states(torch.tensor(ids), torch.tensor(MASK))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all() and _rel(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("name", ["bert_mlm", "roberta_mlm"])
def test_masked_lm_logits_equal_flax(snapshots, name):
    hf = transformers.FlaxAutoModelForMaskedLM.from_pretrained(snapshots[name], local_files_only=True)
    ids = _ids(name)
    want = hf(input_ids=ids, attention_mask=MASK).logits
    model = load_encoder(snapshots[name], masked_lm=True)
    got = model(torch.tensor(ids), torch.tensor(MASK)).numpy()
    assert _rel(got, want) <= 1e-5
    # the head on gathered rows gives the same logits as the full product
    hidden = model.encode(torch.tensor(ids), torch.tensor(MASK))[:, 4]
    assert _rel(model.logits(hidden).numpy(), np.asarray(want)[:, 4]) <= 1e-5


@pytest.mark.parametrize("eos", [49407, 2])
def test_clip_text_and_image_features_equal_flax(snapshots, eos):
    d = snapshots[f"clip_eos{eos}"]
    hf = transformers.FlaxCLIPModel.from_pretrained(d, local_files_only=True)
    ids = RNG.randint(0, 1500, (3, 9))
    ids[:, -1] = 1499  # the end-of-text id, the highest
    ids[1, 5:] = 1499
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    pixels = RNG.randn(3, 3, 30, 30).astype(np.float32)
    model = load_clip(d)
    assert _rel(model.get_text_features(torch.tensor(ids), torch.tensor(mask)).numpy(),
                hf.get_text_features(ids, mask)) <= 1e-5
    assert _rel(model.get_image_features(torch.from_numpy(pixels)).numpy(), hf.get_image_features(pixels)) <= 1e-5


# --------------------------------------------------------------------------- formats


@pytest.fixture(scope="module")
def torch_bert(tmp_path_factory):
    """A ``transformers`` PyTorch BertForMaskedLM and its state dict."""
    config = transformers.BertConfig(vocab_size=300, max_position_embeddings=40, **hf_snapshots.SMALL)
    torch.manual_seed(0)
    model = transformers.BertForMaskedLM(config).eval()
    return model, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "safetensors_sharded", "bin_sharded"])
def test_each_torch_weight_format_loads_transformers_arrays(torch_bert, tmp_path, fmt):
    model, state = torch_bert
    shard = "40KB" if fmt.endswith("sharded") else "10GB"
    model.save_pretrained(str(tmp_path), safe_serialization=fmt.startswith("safetensors"), max_shard_size=shard)
    kind, files = snapshot.weight_files(str(tmp_path))
    assert kind == fmt.split("_")[0].replace("bin", "torch") and (len(files) > 1) == fmt.endswith("sharded")
    loaded = snapshot.load_state_dict(str(tmp_path))
    for name, tensor in state.items():
        if name in loaded:
            assert torch.equal(loaded[name], tensor), name
    assert "bert.embeddings.word_embeddings.weight" in loaded
    ids = torch.tensor(IDS % 300)
    want = model(input_ids=ids, attention_mask=torch.tensor(MASK)).logits.detach()
    got = load_encoder(str(tmp_path), masked_lm=True)(ids, torch.tensor(MASK))
    assert _rel(got[MASK == 1].numpy(), want[MASK == 1].numpy()) <= 1e-5


def test_the_flax_msgpack_loads_to_flax_s_own_arrays(snapshots):
    from flax.traverse_util import flatten_dict

    hf = transformers.FlaxAutoModelForMaskedLM.from_pretrained(snapshots["bert_mlm"], local_files_only=True)
    with open(os.path.join(snapshots["bert_mlm"], "flax_model.msgpack"), "rb") as fh:
        tree = snapshot.msgpack_loads(fh.read())
    flat = snapshot.flatten_flax(tree)
    want = {"/".join(k): np.asarray(v) for k, v in flatten_dict(hf.params).items()}
    assert sorted(flat) == sorted(want)
    for key, value in want.items():
        assert flat[key].dtype == value.dtype and np.array_equal(flat[key], value), key


def test_msgpack_written_here_restores_in_flax_and_back(monkeypatch):
    tree = {"a": {"kernel": RNG.randn(3, 4).astype(np.float32), "scale": np.float32(2.5) * np.ones(())},
            "ids": np.arange(7, dtype=np.int32), "big": RNG.randn(1000).astype(np.float32)}
    for module in (snapshot, flax_serialization):
        monkeypatch.setattr(module, "MAX_CHUNK_SIZE", 1024)  # the 4000-byte leaf is chunked
    data = snapshot.msgpack_dumps(tree)
    restored = flax_serialization.msgpack_restore(data)
    mine = snapshot.msgpack_loads(flax_serialization.msgpack_serialize(tree))
    for got in (restored, mine):
        flat, want = snapshot.flatten_flax(got), snapshot.flatten_flax(tree)
        assert sorted(flat) == sorted(want)
        for key in want:
            assert flat[key].shape == want[key].shape and np.array_equal(flat[key], want[key]), key


def test_a_name_that_is_not_a_local_directory_raises_with_jax_s_words():
    with pytest.raises(OSError, match="local.*no network access"):
        snapshot.require_local_snapshot("bert-base-uncased")


def test_an_unsupported_model_type_raises_naming_the_roadmap(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "t5"}))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        load_encoder(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tconvert.convert_hf_flax(str(tmp_path), str(tmp_path / "out"))


# ---------------------------------------------------------------------- carry-across


def test_flax_params_carry_into_the_port_s_modules(snapshots):
    for name, cls in (("bert", transformers.FlaxAutoModel), ("roberta_mlm", transformers.FlaxAutoModelForMaskedLM),
                      ("clip_eos2", transformers.FlaxCLIPModel)):
        hf = cls.from_pretrained(snapshots[name], local_files_only=True)
        params = jax_tree_to_numpy(hf.params)
        config = snapshot.read_config(snapshots[name])
        state = tconvert.hf_flax_params_to_torch(params, config)
        module = load_clip(snapshots[name]) if name.startswith("clip") else \
            load_encoder(snapshots[name], masked_lm=name.endswith("mlm"))
        own = module.state_dict()
        assert sorted(state) == sorted(own)
        for key in own:
            assert torch.equal(state[key], own[key]), key


def jax_tree_to_numpy(tree):
    return {k: jax_tree_to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("model_class", [None, "FlaxBertForMaskedLM", "FlaxCLIPModel"])
def test_a_directory_converted_by_the_port_runs_in_jax(torch_bert, tmp_path, model_class):
    """A PyTorch-only snapshot converted by the port loads in ``transformers``' Flax class
    and gives the outputs of JAX's own ``from_pt`` conversion; the manifest is JAX's."""
    from torchmetrics_tpu.utils.imports import load_flax_with_pt_fallback

    src = tmp_path / "src"
    if model_class == "FlaxCLIPModel":
        config = transformers.CLIPConfig(text_config=dict(hf_snapshots.SMALL, vocab_size=300),
                                         vision_config=dict(hf_snapshots.SMALL, image_size=30, patch_size=6),
                                         projection_dim=16)
        torch.manual_seed(1)
        transformers.CLIPModel(config).save_pretrained(str(src))
    else:
        torch_bert[0].save_pretrained(str(src))
        hf_snapshots.wordpiece_files(str(src))
    out = tconvert.convert_hf_flax(str(src), str(tmp_path / "out"), model_class=model_class)
    cls = getattr(transformers, model_class or "FlaxAutoModel")
    mine = cls.from_pretrained(out, local_files_only=True)
    ref = load_flax_with_pt_fallback(cls, str(src))
    from flax.traverse_util import flatten_dict

    got, want = flatten_dict(mine.params), flatten_dict(ref.params)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=str(key))
    manifest = json.loads((tmp_path / "out" / "MANIFEST.json").read_text())
    assert manifest["flax_model.msgpack"]["kind"] == "hf-flax"
    assert manifest["flax_model.msgpack"]["sha256"] == tconvert.sha256_file(os.path.join(out, "flax_model.msgpack"))
    if model_class is None:
        assert os.path.isfile(os.path.join(out, "vocab.txt"))


def test_a_directory_converted_by_jax_runs_in_the_port(torch_bert, tmp_path):
    from torchmetrics_tpu.convert import convert_hf_flax as jax_convert

    src = tmp_path / "src"
    torch_bert[0].save_pretrained(str(src))
    hf_snapshots.wordpiece_files(str(src))
    out = jax_convert(str(src), str(tmp_path / "jax"), model_class="FlaxBertForMaskedLM")
    model = load_encoder(out, masked_lm=True)
    ids = torch.tensor(IDS % 300)
    want = torch_bert[0](input_ids=ids, attention_mask=torch.tensor(MASK)).logits.detach()
    got = model(ids, torch.tensor(MASK))
    assert _rel(got[MASK == 1].numpy(), want[MASK == 1].numpy()) <= 1e-5


def test_the_hf_flax_subcommand_converts_a_snapshot(torch_bert, tmp_path, capsys):
    src = tmp_path / "src"
    torch_bert[0].save_pretrained(str(src))
    assert cli.main(["hf-flax", str(src), "-o", str(tmp_path / "out"), "--model-class", "FlaxBertForMaskedLM"]) == 0
    assert "MANIFEST.json" in capsys.readouterr().out
    config = json.loads((tmp_path / "out" / "config.json").read_text())
    assert config["architectures"] == ["BertForMaskedLM"]
    assert snapshot.weight_files(str(tmp_path / "out"))[0] == "flax"
