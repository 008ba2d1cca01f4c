"""Model registry: resolve a model id to (config, state_dict, tokenizer).

Counterpart of ``mfar_tpu/models/registry.py``:

- ``synthetic[:vocab_size[:hidden_size]]``: a tiny random-init BERT encoder
  (from a seeded ``torch.Generator``) plus a corpus-built word-level
  tokenizer, for offline smoke runs;
- a local HF BERT directory: ``config.json`` plus ``model.safetensors``
  (what ``save_pretrained`` writes by default) or ``pytorch_model.bin``, and
  ``tokenizer.json``;
- the T5/GTR family (:mod:`mfar_tpu_torch.models.t5_encoder`), routed by
  :func:`is_t5_family` as the JAX package routes it: a local T5 directory
  (``config.json`` with ``model_type`` ``t5``/``mt5``, the weights and
  ``tokenizer.json``), the ``t5:<dir>`` spelling of one, and a local
  sentence-transformers GTR directory (``modules.json``, the T5 files at the
  Transformer module's path, ``1_Pooling``, ``2_Dense`` and optionally
  ``3_Normalize``; the first Dense module's ``linear.weight`` becomes the
  projection, and ``normalize`` decides the normalization, as in JAX).  A T5
  directory that holds a ``modules.json`` keeps its sentence-transformers
  stack.

Neither ``transformers`` nor ``sentence_transformers`` is needed: the files
are read directly, and the tokenizer through ``tokenizers``.  Hub ids are
not fetched (there is no network on the serving machines): a model such as
``facebook/contriever-msmarco`` or ``sentence-transformers/gtr-t5-base``
loads once its files sit in a local directory, and a hub id raises
``FileNotFoundError``.  :func:`save_bert_dir`, :func:`save_t5_dir` and
:func:`save_gtr_dir` write such directories from seeded weights, which the
JAX package's ``prepare_model`` loads too.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import torch

from mfar_tpu_torch.models.convert import (
    config_from_hf,
    encoder_state_from_hf_bert,
    hf_bert_state_from_encoder,
    hf_t5_state_from_encoder,
    t5_config_from_hf,
    t5_state_from_hf,
)
from mfar_tpu_torch.models.encoder import EncoderConfig, init_encoder
from mfar_tpu_torch.models.t5_encoder import T5Config
from mfar_tpu_torch.models.tokenizer import HFTokenizer, SimpleVocabTokenizer

LOCAL_LAYOUTS = (
    "a local HF BERT directory (config.json, model.safetensors or pytorch_model.bin, "
    "tokenizer.json), a local T5 directory (config.json with model_type t5/mt5, the "
    "weights, tokenizer.json), t5:<dir>, or a local sentence-transformers GTR directory "
    "(modules.json, the T5 files, 1_Pooling, 2_Dense[, 3_Normalize])"
)


def prepare_model(
    model_id: str,
    normalize: bool = False,
    corpus_texts: Optional[Sequence[str]] = None,
    dtype: torch.dtype = torch.bfloat16,
    max_length: int = 512,
    seed: int = 0,
    with_decoder: bool = False,
    decoder_dir: Optional[str] = None,
):
    """Returns (encoder_config, state_dict, tokenizer); load the state into
    ``build_encoder(config)``.  ``dtype`` is the activation dtype of a
    pretrained model (the synthetic route keeps the tiny config's f32).

    ``with_decoder`` (GTR-T5 ids only, as in JAX) also returns the seq2seq
    graft, (T5Seq2SeqConfig, state_dict) for
    :class:`mfar_tpu_torch.models.t5_decoder.T5Seq2Seq`: this encoder and
    the decoder of the matching ``google-t5/t5-{size}`` checkpoint, read
    from ``decoder_dir`` (by default the local directory of that name)."""
    if is_t5_family(model_id):
        out = _prepare_gtr(model_id, normalize=normalize, max_length=max_length, dtype=dtype)
        if with_decoder:
            return (*out, graft_t5_decoder(model_id, out[0], out[1], decoder_dir))
        return out
    if with_decoder:
        raise ValueError(f"with_decoder is a GTR-T5 surface; got {model_id!r}")

    if model_id.startswith("synthetic"):
        parts = model_id.split(":")
        if corpus_texts is None:
            raise ValueError("the synthetic model needs corpus_texts for its vocab")
        max_vocab = int(parts[1]) if len(parts) > 1 else 32768
        tokenizer = SimpleVocabTokenizer.build(
            corpus_texts, max_vocab=max_vocab, max_length=min(max_length, 128)
        )  # capped at the tiny config's max_position_embeddings
        overrides = {}
        if len(parts) > 2:  # synthetic:vocab:hidden
            hidden = int(parts[2])
            overrides = dict(hidden_size=hidden, intermediate_size=4 * hidden,
                             num_heads=max(4, hidden // 64))
        config = EncoderConfig.tiny(vocab_size=tokenizer.vocab_size, normalize=normalize, **overrides)
        return config, init_encoder(config, seed=seed).state_dict(), tokenizer

    _require_dir(model_id)
    with open(os.path.join(model_id, "config.json")) as f:
        config = config_from_hf(json.load(f), dtype=dtype, normalize=normalize)
    state = encoder_state_from_hf_bert(load_hf_weights(model_id))
    return config, state, load_tokenizer(model_id, max_length)


def _require_dir(path: str) -> None:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local directory: the port loads {LOCAL_LAYOUTS} (no hub "
            f"downloads)"
        )


def load_tokenizer(model_dir: str, max_length: int) -> HFTokenizer:
    """The directory's ``tokenizer.json``, with the JAX package's truncation
    and bucketed padding."""
    path = os.path.join(model_dir, "tokenizer.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{model_dir!r} has no tokenizer.json (the port reads "
                                f"tokenizers from local files only)")
    return HFTokenizer.from_file(path, max_length)


def _prepare_t5_dir(path: str, normalize: bool, max_length: int, dtype: torch.dtype,
                    projection: Optional[torch.Tensor] = None):
    """A local T5 checkpoint directory: its encoder, plus ``projection``
    (a GTR Dense module's ``[out, in]`` weight) when one is given."""
    _require_dir(path)
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    config = t5_config_from_hf(
        hf_config, normalize=normalize, dtype=dtype,
        projection_dim=None if projection is None else projection.shape[0])
    state = t5_state_from_hf(load_hf_weights(path), projection)
    return config, state, load_tokenizer(path, max_length)


def _prepare_gtr(model_id: str, normalize: bool, max_length: int, dtype: torch.dtype):
    """The T5 family: ``t5:<dir>`` and a T5 directory without
    ``modules.json`` load the bare encoder; a sentence-transformers
    directory loads its Transformer module's T5 files and its first Dense
    module as the projection (Pooling is the encoder's mean pooling;
    Normalize is left to ``normalize``, as in JAX)."""
    if model_id.startswith("t5:"):
        return _prepare_t5_dir(model_id[3:], normalize, max_length, dtype)
    _require_dir(model_id)
    modules_path = os.path.join(model_id, "modules.json")
    if not os.path.exists(modules_path):
        if _is_t5_dir(model_id):
            return _prepare_t5_dir(model_id, normalize, max_length, dtype)
        raise FileNotFoundError(f"{model_id!r} holds neither modules.json nor a T5 "
                                f"config.json; the port loads {LOCAL_LAYOUTS}")
    with open(modules_path) as f:
        modules = json.load(f)
    kind = {m["type"].rsplit(".", 1)[-1]: m for m in reversed(modules)}  # first of each
    if "Transformer" not in kind:
        raise ValueError(f"{modules_path} lists no Transformer module")
    projection = None
    if "Dense" in kind:
        projection = load_hf_weights(os.path.join(model_id, kind["Dense"]["path"]))[
            "linear.weight"]
    return _prepare_t5_dir(os.path.join(model_id, kind["Transformer"]["path"]), normalize,
                           max_length, dtype, projection)


def t5_checkpoint_id(model_id: str) -> str:
    """The ``google-t5`` checkpoint whose decoder a GTR-T5 id grafts: the
    size from the id's suffix, ``xl``/``xxl`` as ``3b``/``11b`` (GTR is
    built on the original T5, whose xl/xxl are hosted under those names)."""
    if not model_id.startswith("sentence-transformers/gtr-t5"):
        raise ValueError(f"with_decoder grafting is defined for sentence-transformers/"
                         f"gtr-t5-* ids (got {model_id!r})")
    size = model_id.split("-")[-1]
    size = {"xl": "3b", "xxl": "11b"}.get(size, size)
    return f"google-t5/t5-{size}"


def graft_t5_decoder(model_id: str, encoder_config: T5Config,
                     encoder_state: Dict[str, torch.Tensor], decoder_dir: Optional[str] = None):
    """Graft the (trained) GTR encoder into the full T5 seq2seq stack: the
    decoder and LM head of the ``google-t5/t5-{size}`` checkpoint in the
    local directory ``decoder_dir`` (by default a directory of that name).
    Returns (T5Seq2SeqConfig, state_dict) for ``T5Seq2Seq``."""
    from mfar_tpu_torch.models.t5_decoder import graft_encoder_into_seq2seq

    checkpoint = t5_checkpoint_id(model_id)
    decoder_dir = decoder_dir or checkpoint
    if not os.path.isdir(decoder_dir):
        raise FileNotFoundError(f"the decoder of {checkpoint} loads from a local directory "
                                f"(config.json and the weights; got {decoder_dir!r})")
    with open(os.path.join(decoder_dir, "config.json")) as f:
        hf_config = json.load(f)
    decoder_config = t5_config_from_hf(
        hf_config, num_layers=hf_config.get("num_decoder_layers") or hf_config["num_layers"])
    return graft_encoder_into_seq2seq(encoder_state, load_hf_weights(decoder_dir),
                                      encoder_config, decoder_config)


def load_hf_weights(model_dir: str) -> Dict[str, torch.Tensor]:
    """A HF directory's weights: ``model.safetensors`` when present, else
    ``pytorch_model.bin``."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path, device="cpu")
    return torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                      weights_only=True)


def save_bert_dir(
    path: str,
    config: EncoderConfig,
    state: Dict[str, torch.Tensor],
    words: Sequence[str],
) -> None:
    """Write a local HF BERT directory that :func:`prepare_model` (and the
    JAX package's) loads: ``config.json``, ``pytorch_model.bin`` in
    ``BertModel`` names, and a WordPiece ``tokenizer.json`` whose vocab is
    the BERT specials then ``words`` (whole words; anything else is
    ``[UNK]``).  For offline runs with seeded weights at a real width."""
    from tokenizers import Tokenizer, normalizers, pre_tokenizers, processors
    from tokenizers.models import WordPiece

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "bert", "architectures": ["BertModel"], "hidden_act": "gelu",
            "vocab_size": config.vocab_size, "hidden_size": config.hidden_size,
            "num_hidden_layers": config.num_layers, "num_attention_heads": config.num_heads,
            "intermediate_size": config.intermediate_size,
            "max_position_embeddings": config.max_position_embeddings,
            "type_vocab_size": config.type_vocab_size, "layer_norm_eps": config.layer_norm_eps,
        }, f, indent=1)
    torch.save(hf_bert_state_from_encoder(state), os.path.join(path, "pytorch_model.bin"))

    vocab = {w: i for i, w in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])}
    for w in words:
        vocab.setdefault(w, len(vocab))
    if len(vocab) > config.vocab_size:
        raise ValueError(f"{len(vocab)} tokenizer entries > vocab_size {config.vocab_size}")
    tok = Tokenizer(WordPiece(vocab=vocab, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    tok.save(os.path.join(path, "tokenizer.json"))


def save_t5_dir(
    path: str,
    config: T5Config,
    state: Dict[str, torch.Tensor],
    words: Sequence[str],
    decoder_state: Optional[Dict[str, torch.Tensor]] = None,
) -> None:
    """Write a local HF T5 directory that :func:`prepare_model` (and the JAX
    package's) loads: ``config.json``, ``pytorch_model.bin`` in
    ``T5EncoderModel`` names and a T5-style ``tokenizer.json`` (a Unigram
    model whose pieces are ``<pad>`` 0, ``</s>`` 1, ``<unk>`` 2, then
    ``▁`` + each of ``words`` and single letters and digits, a Metaspace
    pre-tokenizer, ``</s>`` appended).  With ``decoder_state`` (a
    :class:`mfar_tpu_torch.models.t5_decoder.T5Decoder` state_dict of the
    same widths) it is a ``T5ForConditionalGeneration`` checkpoint with the
    LM head tied to the shared embedding (T5 v1.0).  For offline runs with
    seeded weights at a real width."""
    from mfar_tpu_torch.models.t5_decoder import hf_t5_state_from_decoder

    os.makedirs(path, exist_ok=True)
    hf_config = {
        "model_type": "t5",
        "architectures": ["T5ForConditionalGeneration" if decoder_state else "T5EncoderModel"],
        "vocab_size": config.vocab_size, "d_model": config.d_model, "d_kv": config.d_kv,
        "d_ff": config.d_ff, "num_layers": config.num_layers, "num_heads": config.num_heads,
        "relative_attention_num_buckets": config.relative_attention_num_buckets,
        "relative_attention_max_distance": config.relative_attention_max_distance,
        "feed_forward_proj": "gated-gelu" if config.gated_ffn else "relu",
        "layer_norm_epsilon": config.layer_norm_eps, "dropout_rate": config.dropout,
        "is_encoder_decoder": decoder_state is not None, "tie_word_embeddings": True,
        "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0,
    }
    weights = hf_t5_state_from_encoder(state)
    if decoder_state is not None:
        hf_config["num_decoder_layers"] = 1 + max(
            int(k.split(".")[1]) for k in decoder_state if k.startswith("layers."))
        weights.update(hf_t5_state_from_decoder(decoder_state))
        weights["lm_head.weight"] = weights["shared.weight"]
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=1)
    torch.save(weights, os.path.join(path, "pytorch_model.bin"))
    _save_t5_tokenizer(os.path.join(path, "tokenizer.json"), words, config.vocab_size)


def _save_t5_tokenizer(path: str, words: Sequence[str], vocab_size: int) -> None:
    from tokenizers import Tokenizer, decoders, pre_tokenizers, processors
    from tokenizers.models import Unigram

    # whole words score above any spelling of them in letters
    space = "\u2581"  # sentencepiece's word-start mark
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), (space, -2.0)]
    pieces += [(c, -10.0) for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    seen = {p for p, _ in pieces}
    for w in words:
        if space + w not in seen:
            seen.add(space + w)
            pieces.append((space + w, -1.0))
    if len(pieces) > vocab_size:
        raise ValueError(f"{len(pieces)} tokenizer entries > vocab_size {vocab_size}")
    tok = Tokenizer(Unigram(pieces, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>", special_tokens=[("</s>", 1)])
    tok.save(path)


def save_gtr_dir(
    path: str,
    config: T5Config,
    state: Dict[str, torch.Tensor],
    words: Sequence[str],
) -> None:
    """Write a local sentence-transformers GTR directory (the layout of
    ``sentence-transformers/gtr-t5-base``): the T5 files at the root
    (:func:`save_t5_dir`), ``modules.json``, ``1_Pooling`` (mean),
    ``2_Dense`` (the state's ``projection.weight``, no bias, identity
    activation) and ``3_Normalize``."""
    if config.projection_dim is None:
        raise ValueError("a GTR directory needs a projection (config.projection_dim)")
    encoder = {k: v for k, v in state.items() if k != "projection.weight"}
    save_t5_dir(path, config, encoder, words)
    modules = [("", "Transformer"), ("1_Pooling", "Pooling"), ("2_Dense", "Dense"),
               ("3_Normalize", "Normalize")]
    with open(os.path.join(path, "modules.json"), "w") as f:
        json.dump([{"idx": i, "name": str(i), "path": sub,
                    "type": f"sentence_transformers.models.{kind}"}
                   for i, (sub, kind) in enumerate(modules)], f, indent=1)
    with open(os.path.join(path, "sentence_bert_config.json"), "w") as f:
        json.dump({"max_seq_length": 512, "do_lower_case": False}, f)
    for sub, _ in modules[1:]:
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": config.d_model, "pooling_mode_cls_token": False,
                   "pooling_mode_mean_tokens": True, "pooling_mode_max_tokens": False,
                   "pooling_mode_mean_sqrt_len_tokens": False}, f, indent=1)
    with open(os.path.join(path, "2_Dense", "config.json"), "w") as f:
        json.dump({"in_features": config.d_model, "out_features": config.projection_dim,
                   "bias": False,
                   "activation_function": "torch.nn.modules.linear.Identity"}, f, indent=1)
    torch.save({"linear.weight": state["projection.weight"]},
               os.path.join(path, "2_Dense", "pytorch_model.bin"))


def is_t5_family(model_id: str) -> bool:
    """True for the ids ``mfar_tpu.models.registry`` routes to its T5
    encoder family (the train command's optimizer keys on it too: T5 trains
    with Adafactor)."""
    return "gtr-t5" in model_id or model_id.startswith("t5:") or _is_t5_dir(model_id)


def _is_t5_dir(model_id: str) -> bool:
    """A local directory whose config declares a T5-family architecture."""
    cfg_path = os.path.join(model_id, "config.json")
    if not (os.path.isdir(model_id) and os.path.exists(cfg_path)):
        return False
    try:
        with open(cfg_path) as f:
            return json.load(f).get("model_type") in ("t5", "mt5")
    except (OSError, ValueError):
        return False
