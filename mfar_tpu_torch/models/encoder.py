"""Shared text encoder: a Contriever-compatible BERT in PyTorch.

Counterpart of ``mfar_tpu/models/encoder.py``.  The numerics follow the JAX
module so that the same weights give the same embeddings:

- parameters are float32; activations run in ``cfg.dtype`` (bf16 for
  ``contriever_base``, f32 for ``tiny``), each weight cast to it at use, as
  Flax's ``Dense(dtype=..., param_dtype=float32)`` does;
- LayerNorm computes in f32 and casts back to ``cfg.dtype``;
- the attention logits and softmax run in ``cfg.softmax_dtype`` with an
  additive mask of -1e9 in f32; GELU is the exact (erf) form;
- mean pooling runs in f32 over the attention mask.

Attention has the JAX package's two implementations, chosen by
``attention_impl`` with the JAX gate (``mfar_tpu/models/encoder.py:146-157``,
"TPU" read as "CUDA"):

- ``"xla"`` (default): the plain path, two matmuls around a softmax;
- ``"flash"``: kernel K2 (:mod:`mfar_tpu_torch.ops.flash_attention`) with
  segment ids from the attention mask, so valid tokens attend only valid
  ones and pads only pads, at the model's dtype (f32 or bf16) and head dim
  (up to 256).  It needs S >= 128 and S % 128 == 0 and raises
  ``ValueError`` otherwise; on CPU tensors it runs K2's plain version;
- ``"auto"``: K2 on the card whenever S passes that gate, whatever the
  dtype or head dim, else the plain path (as JAX's ``"auto"`` does off a
  TPU).  :func:`use_flash_attention` is the gate.

Pad positions differ between the two (under segment ids pads attend only
pads); valid positions and the pooled embedding do not.

Training (``module.train()``) adds what the JAX module does when it is not
``deterministic``:

- dropout where JAX has it: after the embedding LayerNorm, on the attention
  probabilities of the plain path, and after ``attn_o`` and ``mlp_out``
  (``hidden_dropout`` / ``attention_dropout``, 0.1 by default).  The masks
  come from generators seeded per (call, layer, site) from one draw of the
  ``generator`` the caller passes, so a recomputed layer draws the same
  masks;
- the flash gate's third condition: K2 only while attention dropout is off
  (``"flash"`` raises otherwise, ``"auto"`` takes the plain path);
- ``remat``: recompute layers in the backward with ``torch.utils.checkpoint``
  under JAX's three policies: ``"full"`` (one checkpoint per layer),
  ``"attn_out"`` (two per layer, split at the post-``ln1`` hidden state,
  JAX's ``checkpoint_name("attn_residual")``) and ``"dots"`` (one per layer
  that saves the dense matmuls' outputs and recomputes the rest).

Under tensor parallelism (:func:`mfar_tpu_torch.parallel.tensor_parallel.
shard_module`) a layer holds its rank's heads of ``attn_q/k/v`` and its
share of ``mlp_in``'s outputs (column-parallel, their input through
``copy_to_model``), and the matching input rows of ``attn_o`` and
``mlp_out`` (row-parallel: the partial products summed over the model group
by ``reduce_from_model``, then their bias added once); K2/K2b run on the
rank's heads, ``[B, H / n_model, S, 64]``.  ``word_embeddings`` becomes a
vocab-parallel lookup where the guard shards it.  Where ``n_model`` does not
divide the heads (12 heads at ``n_model`` 8), the attention leaves stay
whole on every rank and only the MLP and the vocabulary shard.  The
attention-probabilities dropout of sharded heads folds the model index into
its seed; every other mask is the same on every rank of a model group.
Remat's recomputed forward issues its model-group sums again in the
backward, on every rank in one order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as ckpt

from mfar_tpu_torch.ops.flash_attention import SEQ_MULTIPLE, flash_attention
from mfar_tpu_torch.parallel.tensor_parallel import (
    column_input,
    model_seed,
    row_output,
    shard_of,
    vocab_embedding,
)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    remat: bool = False  # recompute layers in the backward (memory for time)
    remat_policy: str = "full"  # "full" | "attn_out" | "dots", as in the JAX package
    # "xla" | "flash" | "auto", named as in the JAX package; see the module
    # docstring for what each resolves to here.
    attention_impl: str = "xla"
    softmax_dtype: torch.dtype = torch.float32
    normalize: bool = False  # L2-normalize sentence embeddings

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots", "attn_out"):
            raise ValueError(f"remat_policy {self.remat_policy!r} not in full|dots|attn_out")
        if self.attention_impl not in ("xla", "flash", "auto"):
            raise ValueError(
                f"attention_impl {self.attention_impl!r} not in xla|flash|auto"
            )

    @classmethod
    def contriever_base(cls, **overrides) -> "EncoderConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "EncoderConfig":
        """4-layer toy config for tests and CPU smoke runs."""
        defaults = dict(
            vocab_size=512,
            hidden_size=64,
            num_layers=4,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
            dtype=torch.float32,
        )
        defaults.update(overrides)
        return cls(**defaults)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """f32 parameters, ``x.dtype`` compute (Flax ``Dense`` with dtype)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _row_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``_linear`` of a row-parallel layer: under tensor parallelism the
    rank's partial product is summed over the model group, then the
    (replicated) bias is added once."""
    if shard_of(layer.weight) is None:
        return _linear(x, layer)
    return row_output(F.linear(x, layer.weight.to(x.dtype)), layer.weight) + layer.bias.to(x.dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in f32, cast back to the activation dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(dtype)


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Flax ``Dropout``: keep each entry with probability ``1 - rate`` and
    scale the kept ones by ``1 / (1 - rate)``; the identity when ``seed`` is
    None (deterministic) or the rate is 0.  The mask comes from a generator
    seeded with ``seed``, so the same seed draws the same mask."""
    if seed is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _site(seed: Optional[int], site: int) -> Optional[int]:
    """The seed of one dropout site of a layer (None stays None)."""
    return None if seed is None else seed * 4 + site


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(
        self, input_ids: torch.Tensor, token_type_ids: torch.Tensor, seed: Optional[int] = None
    ) -> torch.Tensor:
        dt = self.cfg.dtype
        pos_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        x = (
            vocab_embedding(input_ids, self.word_embeddings.weight).to(dt)
            + self.position_embeddings(pos_ids).to(dt)
            + self.token_type_embeddings(token_type_ids).to(dt)
        )
        # LayerNorm in f32, dropout, then the activation dtype (as Flax)
        x = F.layer_norm(x.float(), self.ln.normalized_shape, self.ln.weight, self.ln.bias,
                         self.ln.eps)
        return _dropout(x, self.cfg.hidden_dropout, seed).to(dt)


def use_flash_attention(impl: str, seq: int, dropout_active: bool, on_cuda: bool) -> bool:
    """JAX's flash gate (``mfar_tpu/models/encoder.py:146-157``) with "TPU"
    read as "CUDA": K2 needs S >= 128 with S % 128 == 0 and inactive
    attention dropout; ``"auto"`` takes it on the card whenever those hold,
    ``"flash"`` always (on CPU tensors through K2's plain version) and
    raises where they do not.  The dtype and head dim play no part, as in
    JAX: the kernels take both dtypes and every head dim up to 256."""
    seq_ok = seq >= SEQ_MULTIPLE and seq % SEQ_MULTIPLE == 0
    if impl == "flash" and not (seq_ok and not dropout_active):
        raise ValueError(
            f"attention_impl='flash' needs seq % {SEQ_MULTIPLE} == 0 and seq >= "
            f"{SEQ_MULTIPLE} (got {seq}), and inactive attention dropout; use 'auto' for "
            f"automatic fallback"
        )
    return impl == "flash" or (impl == "auto" and seq_ok and not dropout_active and on_cuda)


class TransformerLayer(nn.Module):
    """Post-LN BERT layer (attention -> add&norm -> MLP -> add&norm).  A
    ``seed`` (training) turns dropout on, with masks drawn from it."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.attn_q = nn.Linear(h, h)
        self.attn_k = nn.Linear(h, h)
        self.attn_v = nn.Linear(h, h)
        self.attn_o = nn.Linear(h, h)
        self.ln1 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(h, cfg.intermediate_size)
        self.mlp_out = nn.Linear(cfg.intermediate_size, h)
        self.ln2 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(
        self,
        hidden: torch.Tensor,  # [B, S, H*D]
        mask_bias: torch.Tensor,  # [B, 1, 1, S] f32 additive mask
        segment_ids: torch.Tensor,  # [B, S] int32: 1 valid, 0 pad
        seed: Optional[int] = None,  # dropout masks (training); None: deterministic
    ) -> torch.Tensor:
        return self.mlp_block(self.attention_block(hidden, mask_bias, segment_ids, seed), seed)

    def attention_block(self, hidden, mask_bias, segment_ids, seed=None) -> torch.Tensor:
        """Attention, add and ``ln1``: the post-``ln1`` hidden state (JAX's
        ``attn_residual``)."""
        cfg = self.cfg
        batch, seq, _ = hidden.shape
        head_dim = cfg.hidden_size // cfg.num_heads
        x = column_input(hidden, self.attn_q.weight)
        # [B, S, H*D] -> [B, H, S, D] views (H: this rank's heads)
        q, k, v = (
            _linear(x, lin).view(batch, seq, -1, head_dim).transpose(1, 2)
            for lin in (self.attn_q, self.attn_k, self.attn_v)
        )
        width = q.shape[1] * head_dim
        # the kernel has no dropout: only while attention dropout is inactive
        dropout_active = seed is not None and cfg.attention_dropout != 0.0
        use_flash = use_flash_attention(cfg.attention_impl, seq, dropout_active, hidden.is_cuda)
        if use_flash:
            ctx = flash_attention(q, k, v, segment_ids, 1.0 / head_dim**0.5)
            # a view on the card (the kernel writes [B, S, H, D])
            ctx = ctx.transpose(1, 2).reshape(batch, seq, width)
        else:
            sm = cfg.softmax_dtype
            # bf16 products are exact in f32, so upcasting before the matmul
            # is the JAX einsum's preferred_element_type=softmax_dtype.
            logits = torch.matmul(q.to(sm), k.to(sm).transpose(-1, -2))
            logits = logits / torch.sqrt(torch.tensor(head_dim, dtype=sm))
            logits = logits + mask_bias.to(sm)  # [B, 1, 1, S] additive mask
            probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
            probs = _dropout(probs, cfg.attention_dropout,
                             model_seed(_site(seed, 0), shard_of(self.attn_q.weight)))
            ctx = torch.matmul(probs, v).transpose(1, 2).reshape(batch, seq, width)

        attn_out = _dropout(_row_linear(ctx, self.attn_o), cfg.hidden_dropout, _site(seed, 1))
        return _layer_norm(hidden + attn_out, self.ln1, cfg.dtype)

    def mlp_block(self, hidden: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """MLP, add and ``ln2``."""
        cfg = self.cfg
        x = column_input(hidden, self.mlp_in.weight)
        mlp = F.gelu(_linear(x, self.mlp_in), approximate="none")
        mlp = _dropout(_row_linear(mlp, self.mlp_out), cfg.hidden_dropout, _site(seed, 2))
        return _layer_norm(hidden + mlp, self.ln2, cfg.dtype)


def _save_dense_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy (JAX's ``dots_with_no_batch_dims_saveable``):
    keep the outputs of matmuls without batch dims (the dense layers), and
    recompute the rest (attention scores, elementwise)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dense_matmuls)


def _checkpoint(fn, *args, **kwargs):
    # explicit dropout seeds, so no global RNG state to stash
    return ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


class Encoder(nn.Module):
    """BERT encoder + mean pooling -> sentence embeddings [B, E] (f32)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,  # int [B, S]
        attention_mask: torch.Tensor,  # int/float [B, S]
        token_type_ids: Optional[torch.Tensor] = None,
        return_tokens: bool = False,
        generator: Optional[torch.Generator] = None,  # dropout (training): one draw a call
    ):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        seeds = self._dropout_seeds(generator)
        hidden = self.embeddings(input_ids, token_type_ids, seeds[0])
        mask_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        segment_ids = (attention_mask > 0).to(torch.int32)  # JAX: mask_bias > -1.0
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer, seed in zip(self.layers, seeds[1:]):
            if not remat:
                hidden = layer(hidden, mask_bias, segment_ids, seed)
            elif self.cfg.remat_policy == "attn_out":
                hidden = _checkpoint(layer.attention_block, hidden, mask_bias, segment_ids, seed)
                hidden = _checkpoint(layer.mlp_block, hidden, seed)
            elif self.cfg.remat_policy == "dots":
                hidden = _checkpoint(layer, hidden, mask_bias, segment_ids, seed,
                                     context_fn=_DOTS_CONTEXT)
            else:
                hidden = _checkpoint(layer, hidden, mask_bias, segment_ids, seed)
        pooled = mean_pool(hidden, attention_mask)
        if self.cfg.normalize:
            pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        if return_tokens:
            return pooled, hidden
        return pooled

    def _dropout_seeds(self, generator: Optional[torch.Generator]) -> List[Optional[int]]:
        """One seed for the embeddings and one per layer; all None outside
        training or with both dropout rates at 0."""
        cfg = self.cfg
        active = self.training and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0)
        return dropout_seeds(1 + len(self.layers), active, generator)


def dropout_seeds(n: int, active: bool,
                  generator: Optional[torch.Generator]) -> List[Optional[int]]:
    """``n`` dropout seeds from one draw of ``generator`` (the default
    generator when None), or ``n`` Nones when dropout is not ``active``."""
    if not active:
        return [None] * n
    base = int(torch.randint(0, 2**40, (1,), generator=generator))
    return [base * 64 + i for i in range(n)]


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Attention-mask-weighted mean over the sequence axis, in fp32."""
    mask = attention_mask.float()[..., None]
    summed = (hidden.float() * mask).sum(dim=-2)
    counts = mask.sum(dim=-2).clamp(min=1e-9)
    return summed / counts


def init_encoder(config: EncoderConfig, seed: int = 0) -> Encoder:
    """Random-init encoder on the CPU from a seeded ``torch.Generator``
    (BERT's own init: normal(0, 0.02) weights, zero biases, unit LayerNorm),
    for tests and offline runs where no pretrained weights exist."""
    gen = torch.Generator().manual_seed(seed)
    model = Encoder(config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model.eval()
