"""Model registry: resolve a model id to (config, state_dict, tokenizer).

Counterpart of ``mfar_tpu/models/registry.py`` for two routes:

- ``synthetic[:vocab_size[:hidden_size]]``: a tiny random-init encoder (from
  a seeded ``torch.Generator``) plus a corpus-built word-level tokenizer, for
  offline smoke runs;
- a local HF BERT directory: ``config.json`` plus ``model.safetensors``
  (what ``save_pretrained`` writes by default) or ``pytorch_model.bin``, and
  ``tokenizer.json`` when present.

Hub ids are not fetched (there is no network on the serving machines): a
model such as ``facebook/contriever-msmarco`` loads once its files sit in a
local directory.  T5/GTR ids wait for the T5 encoder's port.
:func:`save_bert_dir` writes such a directory from an encoder state.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from mfar_tpu_torch.models.convert import (
    config_from_hf,
    encoder_state_from_hf_bert,
    hf_bert_state_from_encoder,
)
from mfar_tpu_torch.models.encoder import EncoderConfig, init_encoder
from mfar_tpu_torch.models.tokenizer import HFTokenizer, SimpleVocabTokenizer


def prepare_model(
    model_id: str,
    normalize: bool = False,
    corpus_texts: Optional[Sequence[str]] = None,
    dtype: torch.dtype = torch.bfloat16,
    max_length: int = 512,
    seed: int = 0,
) -> Tuple[EncoderConfig, Dict[str, torch.Tensor], object]:
    """Returns (encoder_config, state_dict, tokenizer); load the state into
    ``Encoder(config)``.  ``dtype`` is the activation dtype of a pretrained
    model (the synthetic route keeps the tiny config's f32)."""
    if is_t5_family(model_id):
        raise NotImplementedError(
            f"{model_id!r} is a T5/GTR model; the T5 encoder family is not "
            f"ported yet (ROADMAP queue A14)"
        )

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

    if not os.path.isdir(model_id):
        raise FileNotFoundError(
            f"{model_id!r} is not a local directory: the port loads HF BERT "
            f"checkpoints from a directory holding config.json and "
            f"model.safetensors or pytorch_model.bin (no hub downloads)"
        )
    with open(os.path.join(model_id, "config.json")) as f:
        config = config_from_hf(json.load(f), dtype=dtype, normalize=normalize)
    state = encoder_state_from_hf_bert(load_hf_weights(model_id))
    tok_json = os.path.join(model_id, "tokenizer.json")
    if os.path.exists(tok_json):
        tokenizer = HFTokenizer.from_file(tok_json, max_length)
    else:
        tokenizer = HFTokenizer.from_pretrained(model_id, max_length)
    return config, state, tokenizer


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


def is_t5_family(model_id: str) -> bool:
    """True for the ids ``mfar_tpu.models.registry`` routes to its T5
    encoder family."""
    if "gtr-t5" in model_id or model_id.startswith("t5:"):
        return True
    cfg_path = os.path.join(model_id, "config.json")
    if not (os.path.isdir(model_id) and os.path.exists(cfg_path)):
        return False
    try:
        with open(cfg_path) as f:
            return json.load(f).get("model_type") in ("t5", "mt5")
    except (OSError, ValueError):
        return False
