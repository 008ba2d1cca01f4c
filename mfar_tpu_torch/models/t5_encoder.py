"""The T5 encoder family (GTR-T5) in PyTorch.

Counterpart of ``mfar_tpu/models/t5_encoder.py``: a T5 encoder stack with
mean pooling, an optional bias-free dense projection (the GTR head) and an
optional L2 normalize.  What differs from the BERT encoder:

- RMS layer norm (no bias, no mean subtraction), pre-LN residual blocks;
- no position embeddings: a bucketed relative position bias added to the
  attention logits, one ``[1, H, S, S]`` bias shared by every layer;
- no ``1/sqrt(d_kv)`` scaling and no biases on the linear layers;
- a relu FFN (T5 v1.0, GTR) or a gated-gelu FFN (v1.1, tanh gelu).

The numerics follow the JAX module so that the same weights give the same
embeddings: f32 parameters cast to ``cfg.dtype`` at use, the residual stream
in ``cfg.dtype``, RMSNorm in f32 cast back, logits and softmax in
``cfg.softmax_dtype`` with the position bias and an f32 ``-1e9`` mask bias
added, the probabilities cast to ``cfg.dtype`` before the value product,
pooling and the projection in f32.  Attention is the plain product: the JAX
T5 runs no Pallas kernel, so this encoder never reaches K2.

The bucket table is computed on the host in f32 in JAX's order, with the
logarithm correctly rounded to f32, so that it equals JAX's bit for bit
(a bucket boundary sits within one f32 ulp at a distance of 64).

Training (``module.train()``): dropout at one rate, ``dropout``, on the
embedding, the attention probabilities, the attention output, the FFN
output and the final hidden state, with masks from per-(call, layer, site)
seeds drawn from one draw of the caller's ``generator`` (as
:class:`mfar_tpu_torch.models.encoder.Encoder`); ``remat`` recomputes each
layer whole in the backward (JAX: ``nn.remat`` of the scanned layer).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mfar_tpu_torch.models.encoder import _checkpoint, _dropout, _site, dropout_seeds, mean_pool


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    d_kv: int = 64
    d_ff: int = 3072
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout: float = 0.1
    gated_ffn: bool = False  # True for T5 v1.1 (gated gelu)
    remat: bool = False  # recompute layers in the backward (memory for time)
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    softmax_dtype: torch.dtype = torch.float32
    projection_dim: Optional[int] = None  # GTR dense head (d_model -> dim)
    normalize: bool = False

    @classmethod
    def gtr_base(cls, **overrides) -> "T5Config":
        defaults = dict(projection_dim=768)
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **overrides) -> "T5Config":
        defaults = dict(
            vocab_size=256, d_model=32, num_layers=2, num_heads=2, d_kv=16,
            d_ff=64, dtype=torch.float32, dropout=0.0,
        )
        defaults.update(overrides)
        return cls(**defaults)


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int, max_distance: int,
    bidirectional: bool = True,
) -> np.ndarray:
    """T5's log-bucketed relative positions (key - query), on the host:
    bidirectional (the encoder) or causal (the decoder: all buckets cover
    the past, the future clamps to bucket 0).  f32 in JAX's order; the log
    is rounded once from f64, which no f32 library log guarantees."""
    rel = np.asarray(relative_position, dtype=np.int64)
    ret = np.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = (rel > 0).astype(np.int64) * num_buckets
        n = np.abs(rel)
    else:
        n = -np.minimum(rel, 0)
    max_exact = num_buckets // 2
    x = n.astype(np.float32) / np.float32(max_exact) + np.float32(1e-6)
    x = np.log(x.astype(np.float64)).astype(np.float32)
    x = x / np.float32(np.log(max_distance / max_exact)) * np.float32(num_buckets - max_exact)
    val_if_large = np.minimum(max_exact + x.astype(np.int32), num_buckets - 1)
    return ret + np.where(n < max_exact, n, val_if_large)


def bucket_table(seq: int, num_buckets: int, max_distance: int,
                 bidirectional: bool = True) -> torch.Tensor:
    """The ``[S, S]`` int64 bucket of each (query, key) pair."""
    pos = np.arange(seq)
    rel = pos[None, :] - pos[:, None]  # key - query
    return torch.from_numpy(relative_position_bucket(rel, num_buckets, max_distance,
                                                     bidirectional))


class RMSNorm(nn.Module):
    """T5's layer norm: scale by the root mean square, in f32, cast back."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """f32 weight, ``x.dtype`` compute, no bias (Flax ``Dense(use_bias=False)``)."""
    return F.linear(x, layer.weight.to(x.dtype))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *biases: torch.Tensor,
           sm_dtype: torch.dtype, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Plain T5 attention over ``[B, H, S, D]`` views: unscaled logits in
    ``sm_dtype`` plus each additive bias in turn, softmax, the probabilities
    cast to the value dtype (then dropout), the value product."""
    # bf16 products are exact in f32: upcasting before the matmul is the JAX
    # einsum's preferred_element_type
    logits = torch.matmul(q.to(sm_dtype), k.to(sm_dtype).transpose(-1, -2))
    for bias in biases:
        logits = logits + bias.to(sm_dtype)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(_dropout(probs, rate, seed), v)


class T5FFN(nn.Module):
    """relu (``wi``, ``wo``) or gated-gelu (``wi_0``, ``wi_1``, ``wo``)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.gated_ffn
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:  # HF's "gated-gelu" is gelu_new, the tanh approximation
            h = F.gelu(_dense(x, self.wi_0), approximate="tanh") * _dense(x, self.wi_1)
        else:
            h = F.relu(_dense(x, self.wi))
        return _dense(h, self.wo)


class T5Layer(nn.Module):
    """Pre-LN self-attention block then FFN block.  A ``seed`` (training)
    turns dropout on, with masks drawn from it."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.ln1 = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.attn_q = nn.Linear(cfg.d_model, inner, bias=False)
        self.attn_k = nn.Linear(cfg.d_model, inner, bias=False)
        self.attn_v = nn.Linear(cfg.d_model, inner, bias=False)
        self.attn_o = nn.Linear(inner, cfg.d_model, bias=False)
        self.ln2 = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ffn = T5FFN(cfg)

    def forward(
        self,
        hidden: torch.Tensor,  # [B, S, d_model] in cfg.dtype
        pos_bias: torch.Tensor,  # [1, H, S, S] f32
        mask_bias: torch.Tensor,  # [B, 1, 1, S] f32 additive mask
        seed: Optional[int] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = hidden.shape
        x = self.ln1(hidden)
        q, k, v = (_dense(x, lin).view(b, s, cfg.num_heads, cfg.d_kv).transpose(1, 2)
                   for lin in (self.attn_q, self.attn_k, self.attn_v))
        ctx = attend(q, k, v, pos_bias, mask_bias, sm_dtype=cfg.softmax_dtype, rate=cfg.dropout,
                     seed=_site(seed, 0))
        ctx = ctx.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.d_kv)
        hidden = hidden + _dropout(_dense(ctx, self.attn_o), cfg.dropout, _site(seed, 1))
        mlp = self.ffn(self.ln2(hidden))
        return hidden + _dropout(mlp, cfg.dropout, _site(seed, 2))


class T5Encoder(nn.Module):
    """T5 encoder stack + mean pooling (+ GTR projection / normalize) ->
    sentence embeddings ``[B, E]`` (f32); the call shape of
    :class:`mfar_tpu_torch.models.encoder.Encoder` without token types."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        # T5 stores it on block 0; every layer reads it
        self.rel_bias = nn.Parameter(torch.zeros(cfg.relative_attention_num_buckets,
                                                 cfg.num_heads))
        self.layers = nn.ModuleList(T5Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.projection = (nn.Linear(cfg.d_model, cfg.projection_dim, bias=False)
                           if cfg.projection_dim else None)
        self._buckets: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def position_bias(self, seq: int, device: torch.device) -> torch.Tensor:
        """``[1, H, S, S]`` f32 from the learned ``[buckets, H]`` table; the
        bucket table is made once per (length, device)."""
        key = (seq, device)
        if key not in self._buckets:
            self._buckets[key] = bucket_table(
                seq, self.cfg.relative_attention_num_buckets,
                self.cfg.relative_attention_max_distance).to(device)
        return self.rel_bias[self._buckets[key]].permute(2, 0, 1)[None].float()

    def forward(
        self,
        input_ids: torch.Tensor,  # int [B, S]
        attention_mask: torch.Tensor,  # int/float [B, S]
        return_tokens: bool = False,
        generator: Optional[torch.Generator] = None,  # dropout (training): one draw a call
    ):
        cfg = self.cfg
        # seeds for the embedding, each layer and the final hidden state
        seeds = dropout_seeds(2 + len(self.layers), self.training and cfg.dropout > 0.0,
                              generator)
        hidden = _dropout(self.token_embed(input_ids).to(cfg.dtype), cfg.dropout, seeds[0])
        mask_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        pos_bias = self.position_bias(input_ids.shape[-1], input_ids.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer, seed in zip(self.layers, seeds[1:-1]):
            hidden = (_checkpoint(layer, hidden, pos_bias, mask_bias, seed) if remat
                      else layer(hidden, pos_bias, mask_bias, seed))
        hidden = _dropout(self.final_ln(hidden), cfg.dropout, seeds[-1])
        pooled = mean_pool(hidden, attention_mask)
        if self.projection is not None:
            pooled = F.linear(pooled, self.projection.weight)
        if cfg.normalize:
            pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        if return_tokens:
            return pooled, hidden
        return pooled


def init_t5_encoder(config: T5Config, seed: int = 0) -> T5Encoder:
    """Random-init encoder on the CPU from a seeded ``torch.Generator``
    (unit RMSNorm scales, normal(0, 1) position-bias table as Flax's init,
    normal(0, 0.02) elsewhere), for tests and offline runs where no
    pretrained weights exist."""
    gen = torch.Generator().manual_seed(seed)
    model = T5Encoder(config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.normal_(0.0, 1.0 if name == "rel_bias" else 0.02, generator=gen)
        for m in model.modules():
            if isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
    return model.eval()
