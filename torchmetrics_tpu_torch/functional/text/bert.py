"""BERTScore.

Counterpart of ``torchmetrics_tpu/functional/text/bert.py``: the crc32 whitespace
fallback tokenizer, special-token masking, IDF over the reference corpus, the
embedding pass, greedy cosine matching (one ``blpd,blrd->blpr`` full-float32 product)
and the baseline rescale, with JAX's options and messages.

The encoder is the port's own (``utils/hf``): a local snapshot's weights in the
PyTorch layout of ``transformers``, its WordPiece or byte-level BPE tokenizer, run on
``device`` (``"cuda"`` by default; there is no CPU fallback). The embedding pass sorts
the sentences by length and trims each batch to its longest row: padding is inert
(masked keys, zeroed positions), so the scores equal JAX's bucketed pass. A user
``model`` gets JAX's buckets, a ``user_forward_fn`` the batches at their width, in order.
``user_forward_fn`` receives the port's ``nn.Module``, not a ``transformers`` model.
"""

from __future__ import annotations

import csv
import functools
import math
import os
import zlib
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.checks import _resolve_device
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32
from torchmetrics_tpu_torch.utils.imports import _TQDM_AVAILABLE, snapshot_weight_stamp
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

_DEFAULT_MODEL = "roberta-large"
# rows of the greedy matching's [rows, layers, P, R] product formed at once
_MATCH_ROWS = 256


def _simple_whitespace_tokenizer(
    texts: List[str], max_length: int, pad_to_max_length: bool = False
) -> Dict[str, np.ndarray]:
    """Minimal fallback tokenizer: whitespace tokens hashed to stable ids (crc32), so
    ids agree across calls, processes and packages. Pads to the batch max (or
    ``max_length`` when ``pad_to_max_length``, for cat-synced module states)."""
    ids_list = []
    for text in texts:
        tokens = text.split()[: max_length - 2]
        ids_list.append([1] + [3 + zlib.crc32(tok.encode()) % (2**30) for tok in tokens] + [2])
    seq_len = max_length if pad_to_max_length else max(len(i) for i in ids_list)
    input_ids = np.zeros((len(texts), seq_len), dtype=np.int32)
    attention_mask = np.zeros((len(texts), seq_len), dtype=np.int32)
    for i, ids in enumerate(ids_list):
        input_ids[i, : len(ids)] = ids
        attention_mask[i, : len(ids)] = 1
    return {"input_ids": input_ids, "attention_mask": attention_mask}


def _process_attention_mask_for_special_tokens(attention_mask: np.ndarray) -> np.ndarray:
    """Zero out the [CLS] (first) and [SEP] (last attended) positions."""
    attention_mask = attention_mask.copy()
    attention_mask[:, 0] = 0
    sep_position = np.cumsum(attention_mask - 0.1, axis=-1).argmax(-1)
    attention_mask[np.arange(attention_mask.shape[0]), sep_position] = 0
    return attention_mask


def _get_tokens_idf(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """Inverse document frequencies over the reference corpus."""
    num_sentences = input_ids.shape[0]
    token_counter: Counter = Counter()
    for ids, mask in zip(input_ids, attention_mask):
        token_counter.update(set(ids[mask.astype(bool)].tolist()))
    tokens_idf: Dict[int, float] = defaultdict(lambda: math.log(num_sentences + 1))
    tokens_idf.update(
        {idx: math.log((num_sentences + 1) / (occurrence + 1)) for idx, occurrence in token_counter.items()}
    )
    return tokens_idf


def _check_shape_of_model_output(out: Tensor, input_ids: Tensor) -> None:
    """The model output must be (B, S, D)."""
    bsz, seq_len = input_ids.shape[:2]
    invalid = out.dim() != 3 or tuple(out.shape[:2]) != (bsz, seq_len)
    if invalid:
        raise ValueError(
            "The model output must be `Tensor` of a shape `[batch_size, seq_len, model_dim]`"
            f" i.e. [{bsz}, {seq_len}. , `model_dim`], but got {tuple(out.shape)}."
        )


def _get_progress_bar(iterable, verbose: bool = False):
    """Wrap batches in tqdm when ``verbose``."""
    if not verbose:
        return iterable
    import tqdm.auto

    return tqdm.auto.tqdm(iterable)


class _EncoderForward:
    """``(input_ids, attention_mask) -> (B, S, D)`` hidden states of layer ``num_layers``
    (the last where None), or ``(B, layers + 1, S, D)`` with ``all_layers``; the encoder
    is ``hf_model``."""

    def __init__(self, encoder: torch.nn.Module, num_layers: Optional[int], all_layers: bool) -> None:
        self.hf_model = encoder
        self.num_layers = num_layers
        self.all_layers = all_layers

    def __call__(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        upto = None if (self.all_layers or self.num_layers is None) else self.num_layers
        states = self.hf_model.hidden_states(input_ids, attention_mask, upto=upto)
        if self.all_layers:
            return torch.stack(states, dim=1)
        return states[-1] if upto is None else states[upto]


def _load_model(model_name_or_path: str, num_layers: Optional[int], all_layers: bool = False, device: Any = "cuda"):
    """Cached :func:`_load_model_uncached`, keyed on the snapshot's weight-file stamps so
    an overwritten checkpoint is reloaded, not served stale."""
    device = _resolve_device(device)
    return _load_model_uncached(
        model_name_or_path, num_layers, all_layers, str(device), snapshot_weight_stamp(model_name_or_path)
    )


@functools.lru_cache(maxsize=4)
def _load_model_uncached(model_name_or_path: str, num_layers: Optional[int], all_layers: bool, device: str, _stamp=()):
    """The port's encoder and tokenizer of a local snapshot: ``(forward, tokenizer)``."""
    from torchmetrics_tpu_torch.utils.hf.encoders import load_encoder
    from torchmetrics_tpu_torch.utils.hf.tokenizer import load_tokenizer

    try:
        if not (isinstance(model_name_or_path, str) and os.path.isdir(model_name_or_path)):
            raise FileNotFoundError(model_name_or_path)
        tokenizer = load_tokenizer(model_name_or_path)
        encoder = load_encoder(model_name_or_path)
    except NotImplementedError:
        raise
    except Exception as err:
        raise OSError(
            f"Could not load `{model_name_or_path}` from the local transformers cache and this"
            " environment has no network access. Provide a locally available model path, or pass"
            " a custom `model` callable + `user_tokenizer`."
        ) from err
    layers = encoder.num_hidden_layers
    if num_layers and num_layers > layers:
        raise ValueError(
            f"num_layers={num_layers} is forbidden for {model_name_or_path}. Please use num_layers <= {layers}"
        )
    encoder = encoder.to(device)
    return _EncoderForward(encoder, num_layers, all_layers), tokenizer


def _row_widths(attention_mask: np.ndarray) -> np.ndarray:
    """One past each row's last attended position (at least 1)."""
    seq = attention_mask.shape[1]
    last = seq - np.argmax(attention_mask[:, ::-1] > 0, axis=1)
    return np.where(attention_mask.any(axis=1), last, 1)


def _embed_corpus(
    encoded: Dict[str, np.ndarray],
    model: Callable,
    *,
    device: torch.device,
    all_layers: bool = False,
    user_forward_fn: Optional[Callable] = None,
    idf: bool = False,
    tokens_idf: Optional[Dict[int, float]] = None,
    batch_size: int = 64,
    verbose: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Normalised masked embeddings ``(B, L, S, D)`` and per-token weights ``(B, S)``:
    batched forward, L2 normalisation, the special-token positions zeroed, and idf (or
    uniform) weights normalised over each sentence. ``S`` is the corpus's longest row."""
    input_ids = np.asarray(encoded["input_ids"])
    attention_mask = np.asarray(encoded["attention_mask"])
    n, seq = input_ids.shape
    own = isinstance(model, _EncoderForward) and user_forward_fn is None
    widths = _row_widths(attention_mask)
    width = int(widths.max()) if own else seq
    # the port's encoder: longest rows first, each batch trimmed to its longest row; a
    # user ``model`` sees JAX's buckets (the sequence padded to a multiple of 16, the
    # last batch's rows to a power of two; the pad is sliced off)
    order = np.argsort(-widths, kind="stable") if own else np.arange(n)
    bucket = user_forward_fn is None and not own
    out: Optional[Tensor] = None
    starts = list(range(0, n, batch_size))
    for start in _get_progress_bar(starts, verbose):
        rows = order[start : start + batch_size]
        w = int(widths[rows].max()) if own else width
        ids_np, mask_np = input_ids[rows, :w], attention_mask[rows, :w]
        if bucket:
            extra_rows = (1 << (len(rows) - 1).bit_length()) - len(rows) if len(rows) < batch_size else 0
            pads = ((0, extra_rows), (0, -(-seq // 16) * 16 - seq))
            ids_np, mask_np = np.pad(ids_np, pads), np.pad(mask_np, pads)
        ids_b = torch.as_tensor(ids_np, device=device).long()
        mask_b = torch.as_tensor(mask_np, device=device).long()
        if user_forward_fn is not None:
            if all_layers:
                raise ValueError("The option `all_layers=True` can be used only with default `transformers` models.")
            emb = torch.as_tensor(user_forward_fn(model, {"input_ids": ids_b, "attention_mask": mask_b}))
            emb = emb.to(device=device, dtype=torch.float32)
            _check_shape_of_model_output(emb, ids_b)
            emb = emb[:, None]
        else:
            emb = torch.as_tensor(model(ids_b, mask_b)).to(device=device, dtype=torch.float32)
            if not all_layers:
                _check_shape_of_model_output(emb, ids_b)
                emb = emb[:, None]
            elif emb.dim() != 4 or emb.shape[0] != ids_b.shape[0] or emb.shape[2] != ids_b.shape[1]:
                raise ValueError(
                    "With `all_layers=True` the model must return embeddings of shape"
                    f" (batch_size, num_layers, seq_len, model_dim), but got {tuple(emb.shape)}."
                )
        emb = emb[: len(rows), :, :w]
        if out is None:
            out = emb.new_zeros((n, emb.shape[1], width, emb.shape[3]))
        out[torch.as_tensor(rows, device=device), :, :w] = emb
    assert out is not None
    processed_mask = _process_attention_mask_for_special_tokens(attention_mask)[:, :width]
    keep = torch.as_tensor(processed_mask, device=device).bool()[:, None, :, None]
    out = torch.where(keep, out / torch.linalg.vector_norm(out, dim=-1, keepdim=True), out.new_zeros(()))

    if idf:
        assert tokens_idf is not None
        ids_idf = np.vectorize(lambda t: tokens_idf[int(t)])(input_ids[:, :width])
        weights = ids_idf * processed_mask
    else:
        weights = processed_mask.astype(np.float64)
    weights = weights / weights.sum(-1, keepdims=True)
    return out, torch.as_tensor(weights, dtype=torch.float32, device=device)


def _get_precision_recall_f1(
    preds_embeddings: Tensor,
    target_embeddings: Tensor,
    preds_weights: Tensor,
    target_weights: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy-matched weighted precision/recall/F1 from normalised ``(B, L, S, D)``
    embeddings: the layer axis carried through, the result layer-major and squeezed."""
    precision, recall = [], []
    for start in range(0, preds_embeddings.shape[0], _MATCH_ROWS):
        part = slice(start, start + _MATCH_ROWS)
        cos_sim = _matmul_full_float32(preds_embeddings[part], target_embeddings[part].transpose(-1, -2))
        precision.append((cos_sim.amax(dim=3) * preds_weights[part][:, None, :]).sum(-1))
        recall.append((cos_sim.amax(dim=2) * target_weights[part][:, None, :]).sum(-1))
    p, r = torch.cat(precision), torch.cat(recall)
    f1_score = 2 * p * r / (p + r)
    f1_score = torch.where(torch.isnan(f1_score), torch.zeros_like(f1_score), f1_score)
    return p.T.squeeze(), r.T.squeeze(), f1_score.T.squeeze()


def _get_hash(model_name_or_path: Optional[str] = None, num_layers: Optional[int] = None, idf: bool = False) -> str:
    """The bert-score configuration hash string."""
    return f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"


def _read_csv_from_local_file(baseline_path: str) -> Tensor:
    """Baseline csv/tsv (header row skipped, first column dropped)."""
    with open(baseline_path) as fname:
        csv_file = csv.reader(fname)
        baseline_list = [[float(item) for item in row] for idx, row in enumerate(csv_file) if idx > 0]
    return torch.tensor(baseline_list, dtype=torch.float32)[:, 1:]


def _read_csv_from_url(baseline_url: str) -> Tensor:
    """Baseline csv from a URL, through the robust retry layer (without egress the last
    attempt's error propagates wrapped in ``RetryError``, as in JAX)."""
    from torchmetrics_tpu_torch.robust.retry import fetch_bytes

    raw = fetch_bytes(baseline_url, description=f"BERTScore baseline fetch ({baseline_url})")
    baseline_list = [
        [float(item) for item in row.strip().split(",")]
        for idx, row in enumerate(raw.decode("utf-8").splitlines())
        if idx > 0 and row.strip()
    ]
    return torch.tensor(baseline_list, dtype=torch.float32)[:, 1:]


def _load_baseline(
    lang: str = "en",
    model_name_or_path: Optional[str] = None,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
) -> Optional[Tensor]:
    """The rescale baseline: a local path, a URL, or the upstream bert-score repo's."""
    if baseline_path:
        return _read_csv_from_local_file(baseline_path)
    if baseline_url:
        return _read_csv_from_url(baseline_url)
    if lang and model_name_or_path:
        url_base = "https://raw.githubusercontent.com/Tiiiger/bert_score/master/bert_score/rescale_baseline"
        return _read_csv_from_url(f"{url_base}/{lang}/{model_name_or_path}.tsv")
    rank_zero_warn("Baseline was not successfully loaded. No baseline is going to be used.")
    return None


def _rescale_metrics_with_baseline(
    precision: Tensor,
    recall: Tensor,
    f1_score: Tensor,
    baseline: Tensor,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Affine rescale against the pre-computed baseline."""
    if num_layers is None and all_layers is False:
        num_layers = -1
    all_metrics = torch.stack([precision, recall, f1_score], dim=-1)
    baseline = baseline.to(all_metrics.device)
    baseline_scale = baseline[:, None] if all_layers else baseline[num_layers]
    all_metrics = (all_metrics - baseline_scale) / (1 - baseline_scale)
    return all_metrics[..., 0], all_metrics[..., 1], all_metrics[..., 2]


def _is_tokenized_dict(text: Any) -> bool:
    return isinstance(text, dict) and "input_ids" in text


def _host(value: Any) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, Tensor) else np.asarray(value)


def _score_from_encodings(
    enc_preds: Dict[str, np.ndarray],
    enc_target: Dict[str, np.ndarray],
    model: Callable,
    *,
    device: torch.device,
    all_layers: bool = False,
    user_forward_fn: Optional[Callable] = None,
    idf: bool = False,
    batch_size: int = 64,
    verbose: bool = False,
    baseline: Optional[Tensor] = None,
    num_layers: Optional[int] = None,
) -> Dict[str, Tensor]:
    """Embed both corpora, greedy-match, optionally baseline-rescale."""
    tokens_idf = _get_tokens_idf(enc_target["input_ids"], enc_target["attention_mask"]) if idf else None
    common = dict(device=device, all_layers=all_layers, user_forward_fn=user_forward_fn, idf=idf,
                  tokens_idf=tokens_idf, batch_size=batch_size, verbose=verbose)
    preds_emb, preds_w = _embed_corpus(enc_preds, model, **common)
    target_emb, target_w = _embed_corpus(enc_target, model, **common)

    max_len = max(preds_emb.shape[2], target_emb.shape[2])

    def pad_seq(x: Tensor, axis: int) -> Tensor:
        pad = [0, 0] * (x.dim() - 1 - axis) + [0, max_len - x.shape[axis]]
        return torch.nn.functional.pad(x, pad)

    preds_emb, target_emb = pad_seq(preds_emb, 2), pad_seq(target_emb, 2)
    preds_w, target_w = pad_seq(preds_w, 1), pad_seq(target_w, 1)
    precision, recall, f1_score = _get_precision_recall_f1(preds_emb, target_emb, preds_w, target_w)
    if baseline is not None:
        precision, recall, f1_score = _rescale_metrics_with_baseline(
            precision, recall, f1_score, baseline, num_layers, all_layers
        )
    return {"precision": precision, "recall": recall, "f1": f1_score}


def bert_score(
    preds: Union[str, Sequence[str], Dict[str, Tensor]],
    target: Union[str, Sequence[str], Dict[str, Tensor]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Any = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Union[str, torch.device, None] = "cuda",
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 0,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
    mesh: Optional[Any] = None,
) -> Dict[str, Union[Tensor, List[float], str]]:
    """Compute BERTScore precision/recall/F1 between candidate and reference sentences.

    The JAX package's options: sentences or pre-tokenized ``{"input_ids",
    "attention_mask"}`` dicts; a ``model`` callable ``(input_ids, attention_mask) -> (B,
    S, D)`` (``(B, layers, S, D)`` with ``all_layers``) with ``user_tokenizer``, or
    ``model_name_or_path``, a local snapshot directory (BERT or RoBERTa) run by the port's
    encoder; ``user_forward_fn(model, batch) -> (B, S, D)``; the baseline rescale from
    ``baseline_path`` or ``baseline_url``; ``return_hash``. The model runs on ``device``
    (``"cuda"`` unless the caller asks for ``"cpu"``). ``num_threads`` is accepted and
    ignored, as in JAX; JAX's ``mesh`` is refused.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text import bert_score
        >>> table = torch.randn(1000, 8, generator=torch.Generator().manual_seed(0))
        >>> def toy_model(input_ids, attention_mask):
        ...     return table[input_ids % 1000]
        >>> preds = ["hello there", "general kenobi"]
        >>> target = ["hello there", "master kenobi"]
        >>> score = bert_score(preds, target, model=toy_model, device="cpu")
        >>> float(score["f1"][0]) > 0.99
        True
    """
    del num_threads
    if mesh is not None:
        raise ValueError("`mesh` is a JAX option; the port runs the encoder on `device`, one card.")
    device = _resolve_device(device)
    preds_list = [preds] if isinstance(preds, str) else preds if isinstance(preds, dict) else list(preds)
    target_list = [target] if isinstance(target, str) else target if isinstance(target, dict) else list(target)
    if len(preds_list) != len(target_list):
        raise ValueError("Number of predicted and reference sentences must be the same!")

    if verbose and not _TQDM_AVAILABLE:
        raise ModuleNotFoundError(
            "An argument `verbose = True` requires `tqdm` package be installed. Install with `pip install tqdm`."
        )

    _are_empty_lists = all(isinstance(t, list) and len(t) == 0 for t in (preds_list, target_list))
    _are_valid_lists = all(
        isinstance(t, list) and len(t) > 0 and isinstance(t[0], str) for t in (preds_list, target_list)
    )
    _are_valid_tensors = all(_is_tokenized_dict(t) for t in (preds_list, target_list))

    if _are_empty_lists:
        rank_zero_warn("Predictions and references are empty.")
        output_dict: Dict[str, Union[Tensor, List[float], str]] = {"precision": [0.0], "recall": [0.0], "f1": [0.0]}
        if return_hash:
            output_dict.update({"hash": _get_hash(model_name_or_path, num_layers, idf)})
        return output_dict

    if model is None:
        model, user_tokenizer = _load_model(model_name_or_path or _DEFAULT_MODEL, num_layers, all_layers, device)
        # cap to the encoder's position-embedding budget
        model_max = model.hf_model.config.get("max_position_embeddings")
        if model_max is not None and max_length > model_max:
            max_length = model_max
        if user_forward_fn is not None:
            model = model.hf_model  # user_forward_fn receives the encoder itself

    baseline = _load_baseline(lang, model_name_or_path, baseline_path, baseline_url) if rescale_with_baseline else None

    if _are_valid_tensors:
        enc_preds = {k: _host(preds_list[k]) for k in ("input_ids", "attention_mask")}
        enc_target = {k: _host(target_list[k]) for k in ("input_ids", "attention_mask")}
    elif _are_valid_lists:
        if user_tokenizer is not None:
            enc_p = user_tokenizer(preds_list, padding=True, truncation=True, max_length=max_length, return_tensors="np")
            enc_t = user_tokenizer(target_list, padding=True, truncation=True, max_length=max_length, return_tensors="np")
            enc_preds = {k: _host(enc_p[k]) for k in ("input_ids", "attention_mask")}
            enc_target = {k: _host(enc_t[k]) for k in ("input_ids", "attention_mask")}
        else:
            enc_all = _simple_whitespace_tokenizer(preds_list + target_list, max_length)
            n = len(preds_list)
            enc_preds = {k: v[:n] for k, v in enc_all.items()}
            enc_target = {k: v[n:] for k, v in enc_all.items()}
    else:
        raise ValueError("Invalid input provided.")

    output_dict = _score_from_encodings(
        enc_preds, enc_target, model, device=device,
        all_layers=all_layers, user_forward_fn=user_forward_fn, idf=idf,
        batch_size=batch_size, verbose=verbose, baseline=baseline, num_layers=num_layers,
    )
    if return_hash:
        output_dict.update({"hash": _get_hash(model_name_or_path, num_layers, idf)})
    return output_dict
