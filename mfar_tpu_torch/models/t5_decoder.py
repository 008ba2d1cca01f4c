"""T5 decoder stack + seq2seq graft (the reference's ``with_decoder``).

Counterpart of ``mfar_tpu/models/t5_decoder.py``: a trained GTR-T5 encoder
grafted into the full ``google-t5/t5-{size}`` seq2seq model.  The encoder
(and its token embedding) comes from the retriever; the decoder keeps the
T5 checkpoint's shared embedding and its tied or untied LM head.  The
reference's commands never run it, so this is a library surface: a
teacher-forced decoder (one forward over the whole target sequence, no
incremental decode), f32 logits out of ``cfg.dtype`` matmuls, numerics as
the JAX module's (RMSNorm in f32, logits and softmax in f32, the
probabilities cast to ``cfg.dtype``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from mfar_tpu_torch.models.encoder import _checkpoint, _dropout, dropout_seeds
from mfar_tpu_torch.models.t5_encoder import (
    RMSNorm,
    T5Config,
    T5Encoder,
    T5FFN,
    _dense,
    attend,
    bucket_table,
    init_t5_encoder,
)

_SITES = 8  # dropout sites a decoder layer draws seeds for


def _site(seed: Optional[int], site: int) -> Optional[int]:
    return None if seed is None else seed * _SITES + site


class T5DecoderLayer(nn.Module):
    """Causal self-attention, cross-attention over the encoder's token
    states, FFN; each pre-LN with a residual."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        for prefix in ("self", "cross"):
            for name in "qkv":
                setattr(self, f"{prefix}_{name}", nn.Linear(cfg.d_model, inner, bias=False))
            setattr(self, f"{prefix}_o", nn.Linear(inner, cfg.d_model, bias=False))
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ln2 = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ln3 = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ffn = T5FFN(cfg)

    def _attention(self, x, kv, bias, prefix: str, seed: Optional[int], site: int):
        cfg = self.cfg
        b, s, _ = x.shape
        sk = kv.shape[1]
        q = _dense(x, getattr(self, f"{prefix}_q")).view(b, s, cfg.num_heads, cfg.d_kv)
        k, v = (_dense(kv, getattr(self, f"{prefix}_{n}")).view(b, sk, cfg.num_heads, cfg.d_kv)
                for n in "kv")
        ctx = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias,
                     sm_dtype=torch.float32, rate=cfg.dropout, seed=_site(seed, site))
        ctx = ctx.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.d_kv)
        return _dense(ctx, getattr(self, f"{prefix}_o"))

    def forward(self, hidden, enc_hidden, self_bias, cross_bias, seed: Optional[int] = None):
        rate = self.cfg.dropout
        x = self.ln1(hidden)
        hidden = hidden + _dropout(self._attention(x, x, self_bias, "self", seed, 0), rate,
                                   _site(seed, 1))
        x = self.ln2(hidden)
        hidden = hidden + _dropout(self._attention(x, enc_hidden, cross_bias, "cross", seed, 2),
                                   rate, _site(seed, 3))
        return hidden + _dropout(self.ffn(self.ln3(hidden)), rate, _site(seed, 4))


class T5Decoder(nn.Module):
    """Teacher-forced T5 decoder: causal self-attention with the causal
    relative bias, cross-attention over the encoder's token states; returns
    the final hidden states ``[B, T, d_model]`` in ``cfg.dtype``."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.rel_bias = nn.Parameter(torch.zeros(cfg.relative_attention_num_buckets,
                                                 cfg.num_heads))
        self.layers = nn.ModuleList(T5DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, decoder_input_ids, enc_hidden, enc_mask,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        seq, dev = decoder_input_ids.shape[-1], decoder_input_ids.device
        seeds = dropout_seeds(2 + len(self.layers), self.training and cfg.dropout > 0.0,
                              generator)
        hidden = _dropout(self.token_embed(decoder_input_ids).to(cfg.dtype), cfg.dropout,
                          seeds[0])
        buckets = bucket_table(seq, cfg.relative_attention_num_buckets,
                               cfg.relative_attention_max_distance, bidirectional=False).to(dev)
        pos_bias = self.rel_bias[buckets].permute(2, 0, 1)[None].float()  # [1, H, T, T]
        pos = torch.arange(seq, device=dev)
        causal = torch.where(pos[None, :] > pos[:, None], -1e9, 0.0)  # key after query
        self_bias = pos_bias + causal[None, None]
        cross_bias = torch.where(enc_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        enc_hidden = enc_hidden.to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer, seed in zip(self.layers, seeds[1:-1]):
            args = (hidden, enc_hidden, self_bias, cross_bias, seed)
            hidden = _checkpoint(layer, *args) if remat else layer(*args)
        return _dropout(self.final_ln(hidden), cfg.dropout, seeds[-1])


@dataclasses.dataclass(frozen=True)
class T5Seq2SeqConfig:
    encoder: T5Config
    decoder: T5Config
    tie_lm_head: bool = True  # T5 v1.0: lm_head = shared embedding, scaled logits


class T5Seq2Seq(nn.Module):
    """``T5ForConditionalGeneration``'s forward: the grafted encoder, the
    decoder and the LM head; ``forward`` returns f32 logits ``[B, T, V]``."""

    def __init__(self, cfg: T5Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Encoder(cfg.encoder)
        self.decoder = T5Decoder(cfg.decoder)
        self.lm_head = (None if cfg.tie_lm_head else
                        nn.Linear(cfg.decoder.d_model, cfg.decoder.vocab_size, bias=False))

    def forward(self, input_ids, attention_mask, decoder_input_ids,
                generator: Optional[torch.Generator] = None):
        _, enc_hidden = self.encoder(input_ids, attention_mask, return_tokens=True,
                                     generator=generator)
        dec = self.decoder(decoder_input_ids, enc_hidden, attention_mask, generator).float()
        if self.lm_head is None:
            # v1.0 ties the head to the shared embedding and rescales
            dec = dec * (self.cfg.decoder.d_model ** -0.5)
            return torch.matmul(dec, self.decoder.token_embed.weight.T)
        return F.linear(dec, self.lm_head.weight)


def init_t5_seq2seq(config: T5Seq2SeqConfig, seed: int = 0) -> T5Seq2Seq:
    """Random-init seq2seq on the CPU from seeded generators (the encoder as
    :func:`init_t5_encoder`, the decoder and head at normal(0, 0.02), the
    position-bias table at normal(0, 1), unit RMSNorm scales)."""
    model = T5Seq2Seq(config)
    model.encoder.load_state_dict(init_t5_encoder(config.encoder, seed).state_dict())
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith("encoder."):
                p.normal_(0.0, 1.0 if name.endswith("rel_bias") else 0.02, generator=gen)
        for m in model.decoder.modules():
            if isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
    return model.eval()


# port decoder layer name -> HF T5Block submodule of the decoder
_DEC_LAYER_MAP = {
    **{f"self_{n}": f"layer.0.SelfAttention.{n}" for n in "qkvo"},
    **{f"cross_{n}": f"layer.1.EncDecAttention.{n}" for n in "qkvo"},
    "ln1": "layer.0.layer_norm",
    "ln2": "layer.1.layer_norm",
    "ln3": "layer.2.layer_norm",
}
_DEC_FFN = {False: ("wi", "wo"), True: ("wi_0", "wi_1", "wo")}  # by gated_ffn
_DEC_REL_BIAS = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def _dec_layer_names(gated: bool) -> Dict[str, str]:
    names = dict(_DEC_LAYER_MAP)
    names.update({f"ffn.{n}": f"layer.2.DenseReluDense.{n}" for n in _DEC_FFN[gated]})
    return names


def decoder_state_from_hf(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The decoder of a HF ``T5ForConditionalGeneration`` state_dict ->
    port ``T5Decoder`` state_dict; its token table is ``shared.weight``, or
    the decoder's ``embed_tokens`` where the tied alias is absent."""
    sd = {k.removeprefix("decoder."): v for k, v in state_dict.items()
          if k.startswith("decoder.")}
    gated = "block.0.layer.2.DenseReluDense.wi_0.weight" in sd
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("block."))
    out: Dict[str, Any] = {
        "token_embed.weight": state_dict.get("shared.weight", sd.get("embed_tokens.weight")),
        "rel_bias": sd[_DEC_REL_BIAS],
        "final_ln.weight": sd["final_layer_norm.weight"],
    }
    for i in range(n_layers):
        for ours, theirs in _dec_layer_names(gated).items():
            out[f"layers.{i}.{ours}.weight"] = sd[f"block.{i}.{theirs}.weight"]
    return {k: torch.as_tensor(v).float() for k, v in out.items()}


def hf_t5_state_from_decoder(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Port ``T5Decoder`` state_dict -> HF ``decoder.*`` names: the inverse
    of :func:`decoder_state_from_hf` (the shared table and the LM head are
    the caller's)."""
    gated = "layers.0.ffn.wi_0.weight" in state_dict
    n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("layers."))
    out = {
        "decoder.embed_tokens.weight": state_dict["token_embed.weight"],
        f"decoder.{_DEC_REL_BIAS}": state_dict["rel_bias"],
        "decoder.final_layer_norm.weight": state_dict["final_ln.weight"],
    }
    for i in range(n_layers):
        for ours, theirs in _dec_layer_names(gated).items():
            out[f"decoder.block.{i}.{theirs}.weight"] = state_dict[f"layers.{i}.{ours}.weight"]
    return out


def graft_encoder_into_seq2seq(
    encoder_state: Mapping[str, torch.Tensor],
    full_state_dict: Mapping[str, Any],
    encoder_config: T5Config,
    decoder_config: Optional[T5Config] = None,
) -> Tuple[T5Seq2SeqConfig, Dict[str, torch.Tensor]]:
    """The reference's graft: the (trained) retriever encoder + a T5
    checkpoint's decoder.  The GTR projection is dropped (the seq2seq reads
    token states).  The LM head is untied when the checkpoint's
    ``lm_head.weight`` differs from its shared table (HF lists it even when
    tied).  Returns (config, state_dict) for :class:`T5Seq2Seq`."""
    decoder_config = decoder_config or encoder_config
    decoder = decoder_state_from_hf(full_state_dict)
    untied = "lm_head.weight" in full_state_dict and not torch.equal(
        torch.as_tensor(full_state_dict["lm_head.weight"]).float(),
        decoder["token_embed.weight"])
    config = T5Seq2SeqConfig(
        encoder=dataclasses.replace(encoder_config, projection_dim=None, normalize=False),
        decoder=decoder_config, tie_lm_head=not untied)
    state = {f"encoder.{k}": v for k, v in encoder_state.items() if k != "projection.weight"}
    state.update({f"decoder.{k}": v for k, v in decoder.items()})
    if untied:
        state["lm_head.weight"] = torch.as_tensor(full_state_dict["lm_head.weight"]).float()
    return config, state
