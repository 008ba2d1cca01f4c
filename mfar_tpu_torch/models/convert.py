"""Carry weights into the port's encoder and mixer.

- :func:`encoder_state_from_jax`: the Flax parameter tree of
  ``mfar_tpu.models.encoder.Encoder`` (as numpy arrays) -> the state_dict of
  :class:`mfar_tpu_torch.models.encoder.Encoder`.  The Flax tree stacks the
  scanned layers on axis 0 (``layers/layer/<name>/kernel`` is
  ``[L, in, out]``) and stores Dense kernels as ``[in, out]``; torch's
  ``Linear`` wants ``[out, in]`` per layer.
- :func:`encoder_state_from_hf_bert`: a HuggingFace ``BertModel`` state_dict
  -> the same layout (the inverse direction of
  ``mfar_tpu/models/hf_convert.py::convert_hf_bert``), and
  :func:`hf_bert_state_from_encoder` back;
- :func:`config_from_hf`: a HF BERT ``config.json`` (dict) -> EncoderConfig.
- :func:`mixer_from_jax`: the mixer subtree ``{'weight': [E or 1, F]}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mfar_tpu_torch.models.encoder import EncoderConfig

# port layer name -> HF BertLayer submodule
_LAYER_MAP = {
    "attn_q": "attention.self.query",
    "attn_k": "attention.self.key",
    "attn_v": "attention.self.value",
    "attn_o": "attention.output.dense",
    "mlp_in": "intermediate.dense",
    "mlp_out": "output.dense",
    "ln1": "attention.output.LayerNorm",
    "ln2": "output.LayerNorm",
}
_LN_NAMES = ("ln1", "ln2")
_EMB_NAMES = ("word_embeddings", "position_embeddings", "token_type_embeddings")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def encoder_state_from_jax(params: Mapping[str, Any], config: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Flax ``Encoder`` params (numpy leaves) -> port ``Encoder`` state_dict."""
    emb = params["embeddings"]
    sd: Dict[str, torch.Tensor] = {
        f"embeddings.{name}.weight": _t(emb[name]["embedding"]) for name in _EMB_NAMES
    }
    sd["embeddings.ln.weight"] = _t(emb["ln"]["scale"])
    sd["embeddings.ln.bias"] = _t(emb["ln"]["bias"])
    layer = params["layers"]["layer"]
    for i in range(config.num_layers):
        for name in _LAYER_MAP:
            p = layer[name]
            if name in _LN_NAMES:
                sd[f"layers.{i}.{name}.weight"] = _t(p["scale"][i])
            else:  # Flax kernel [in, out] -> torch Linear weight [out, in]
                sd[f"layers.{i}.{name}.weight"] = _t(np.asarray(p["kernel"][i]).T)
            sd[f"layers.{i}.{name}.bias"] = _t(p["bias"][i])
    return sd


def encoder_state_from_hf_bert(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """HF ``BertModel`` state_dict -> port ``Encoder`` state_dict.  HF and
    the port both store Linear weights as ``[out, in]``, so tensors carry
    over by name only; the pooler (unused by mean pooling) is dropped."""
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {
        f"embeddings.{name}.weight": sd[f"embeddings.{name}.weight"] for name in _EMB_NAMES
    }
    out["embeddings.ln.weight"] = sd["embeddings.LayerNorm.weight"]
    out["embeddings.ln.bias"] = sd["embeddings.LayerNorm.bias"]
    n_layers = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer.")
    )
    for i in range(n_layers):
        for ours, theirs in _LAYER_MAP.items():
            for p in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{p}"] = sd[f"encoder.layer.{i}.{theirs}.{p}"]
    return {k: torch.as_tensor(v).float() for k, v in out.items()}


def hf_bert_state_from_encoder(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Port ``Encoder`` state_dict -> HF ``BertModel`` names (no pooler):
    the inverse of :func:`encoder_state_from_hf_bert`, for writing a local
    BERT directory that ``prepare_model`` loads."""
    out: Dict[str, torch.Tensor] = {
        f"embeddings.{name}.weight": state_dict[f"embeddings.{name}.weight"] for name in _EMB_NAMES
    }
    out["embeddings.LayerNorm.weight"] = state_dict["embeddings.ln.weight"]
    out["embeddings.LayerNorm.bias"] = state_dict["embeddings.ln.bias"]
    n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("layers."))
    for i in range(n_layers):
        for ours, theirs in _LAYER_MAP.items():
            for p in ("weight", "bias"):
                out[f"encoder.layer.{i}.{theirs}.{p}"] = state_dict[f"layers.{i}.{ours}.{p}"]
    return out


def config_from_hf(hf_config: Mapping[str, Any], **overrides) -> EncoderConfig:
    """A HF BERT ``config.json`` (as a dict) -> EncoderConfig."""
    return EncoderConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config.get("type_vocab_size", 2),
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-12),
        **overrides,
    )


def mixer_from_jax(mixer_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The Flax mixer subtree ``{'weight': [E or 1, F]}`` -> the same dict
    of f32 tensors (the layout is kept, so the engine reads either)."""
    return {"weight": _t(mixer_params["weight"])}
