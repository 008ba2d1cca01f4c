"""The flagship model: shared encoder + query-conditioned field mixer (+BN).

Counterpart of ``mfar_tpu/train/model.py``: one module with three parameter
groups, ``encoder``, ``mixer`` and ``bn``, the split the two-learning-rate
optimizer needs (:mod:`mfar_tpu_torch.train.optim`).  The mixer's weight
keeps the JAX layout, ``[E, F]`` (query-conditioned) or ``[1, F]`` (global),
so a mixer carries across unchanged
(:func:`mfar_tpu_torch.models.convert.mixer_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from mfar_tpu_torch.models import build_encoder, encoder_dim
from mfar_tpu_torch.parallel.data_parallel import Shard, all_reduce_sum, gather_rows
from mfar_tpu_torch.train.losses import decomposed_simple_loss, hybrid_contrastive_loss


class FieldMixer(nn.Module):
    """softmax(q @ W) field weights, ones-initialized like the reference;
    ``query_cond=False`` learns a single global distribution."""

    def __init__(self, num_fields: int, emb_size: int, query_cond: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(emb_size if query_cond else 1, num_fields))

    def forward(self, components: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        # components: [Q, D, F]; q: [Q, E] -> [Q, D]
        weights = self.weights_of({"weight": self.weight}, q)
        return torch.einsum("qdf,qf->qd", components.float(), weights)

    @staticmethod
    def weights_of(params: Dict, q: Optional[torch.Tensor]) -> torch.Tensor:
        """Softmax field weights from a param dict (serving path)."""
        w = torch.as_tensor(params["weight"]).float()
        if w.shape[0] > 1:
            if q is None:
                # softmax(w[0]) would be the weights conditioned on one
                # arbitrary embedding dimension -- plausible-looking garbage
                raise ValueError(f"query-conditioned mixer ({tuple(w.shape)}) needs q")
            logits = torch.matmul(q.float(), w.to(q.device))
        else:
            rows = q.shape[0] if q is not None else 1
            logits = w[:1].expand(rows, w.shape[1])
        return torch.softmax(logits, dim=-1)


class FieldBatchNorm(nn.Module):
    """Flax ``BatchNorm(axis=-1, momentum=0.9, epsilon=1e-5)`` over the
    field axis of ``[Q, D, F]`` score components.  Training normalizes with
    the batch's mean and *biased* variance (``E[x^2] - E[x]^2``, clipped at 0,
    Flax's fast variance) and moves the running stats toward them by 0.1;
    ``torch.nn.BatchNorm1d`` would store the unbiased variance instead.
    With a :class:`~mfar_tpu_torch.parallel.data_parallel.Shard` the sums
    and the count are summed over the ranks (with their gradients), so the
    statistics, and the running stats on every rank, are the global
    batch's."""

    def __init__(self, num_fields: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(num_fields))
        self.bias = nn.Parameter(torch.zeros(num_fields))
        self.register_buffer("mean", torch.zeros(num_fields))
        self.register_buffer("var", torch.ones(num_fields))

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if self.training:
            flat = x.reshape(-1, x.shape[-1]).float()
            if shard is None:
                mean, mean_sq = flat.mean(dim=0), flat.square().mean(dim=0)
            else:
                f = flat.shape[-1]
                sums = all_reduce_sum(torch.cat([flat.sum(dim=0), flat.square().sum(dim=0),
                                                 flat.new_tensor([flat.shape[0]])]), shard)
                mean, mean_sq = sums[:f] / sums[-1], sums[f : 2 * f] / sums[-1]
            var = (mean_sq - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class MFARModel(nn.Module):
    """Encoder + mixer (+ field batchnorm) with the training loss.  The
    loss runs in training mode under ``model.train()`` (dropout, batch
    statistics) and deterministically under ``model.eval()``."""

    def __init__(
        self,
        encoder_config: Any,  # EncoderConfig (the BERT family) or T5Config
        num_fields: int,  # total fields: dense + sparse, dense first
        query_cond: bool = True,
        use_batchnorm: bool = False,
        temperature: float = 0.05,
        reverse: bool = True,
        in_batch: bool = True,  # False: own-negatives-only simple loss
    ):
        super().__init__()
        self.encoder_config = encoder_config
        self.num_fields = num_fields
        self.temperature = temperature
        self.reverse = reverse
        self.in_batch = in_batch
        self.encoder = build_encoder(encoder_config)
        self.mixer = FieldMixer(num_fields, encoder_dim(encoder_config), query_cond)
        self.bn = FieldBatchNorm(num_fields) if use_batchnorm else None

    def encode(self, input_ids, attention_mask, generator: Optional[torch.Generator] = None):
        return self.encoder(input_ids, attention_mask, generator=generator)

    def normalize_components(self, components: torch.Tensor, shard=None) -> torch.Tensor:
        return components if self.bn is None else self.bn(components, shard)

    def compute_loss(
        self,
        query_tokens: Dict[str, torch.Tensor],
        pos_tokens: Dict[str, Dict[str, torch.Tensor]],  # per dense field key
        neg_tokens: Dict[str, Dict[str, torch.Tensor]],
        sparse_pos: Optional[torch.Tensor] = None,  # [B, B, Fs]
        sparse_neg: Optional[torch.Tensor] = None,  # [B, B*Nn, Fs]
        generator: Optional[torch.Generator] = None,  # dropout draws (training)
        shard: Optional[Shard] = None,  # this rank's rows of a data-parallel batch
    ) -> torch.Tensor:
        """The training-step forward: 1 + 2*|dense fields| encoder passes,
        batched by padded length -- every (query/pos/neg, field) text of one
        width rides one encoder call (the encoder is row-independent).

        With a ``shard`` the tokens are this rank's rows, the BM25 tensors
        the global batch's: the query, positive and negative embeddings are
        all-gathered (with their gradients; the negatives stay doc-major)
        and the loss is this rank's share of the global loss."""
        field_keys = sorted(pos_tokens.keys())
        jobs = [("q", None, query_tokens)]
        jobs += [("pos", fk, pos_tokens[fk]) for fk in field_keys]
        if neg_tokens:
            # all dense fields carry negatives or none do (collate invariant)
            jobs += [("neg", fk, neg_tokens[fk]) for fk in field_keys]

        by_len: Dict[int, list] = {}
        for job in jobs:
            by_len.setdefault(job[2]["input_ids"].shape[-1], []).append(job)
        outputs: Dict[Any, torch.Tensor] = {}
        for group in by_len.values():
            ids = torch.cat([t["input_ids"] for _, _, t in group], dim=0)
            mask = torch.cat([t["attention_mask"] for _, _, t in group], dim=0)
            embs = self.encode(ids, mask, generator)
            start = 0
            for tag, fk, t in group:
                rows = t["input_ids"].shape[0]
                outputs[(tag, fk)] = embs[start : start + rows]
                start += rows

        q = outputs[("q", None)]
        if field_keys:
            pos_embs = torch.stack([outputs[("pos", fk)] for fk in field_keys], dim=1)  # [B, Fd, E]
        else:
            pos_embs = q.new_zeros((q.shape[0], 0, q.shape[-1]))
        if field_keys and neg_tokens:
            b = q.shape[0]
            neg_stack = torch.stack([outputs[("neg", fk)] for fk in field_keys], dim=1)
            # [B*Nn, Fd, E], b-major: row b*Nn+j is item b's j-th negative
            nn_ = neg_stack.shape[0] // b
            neg_embs = neg_stack.reshape(b, nn_, len(field_keys), -1).permute(0, 2, 1, 3)
        else:
            neg_embs = None
            sparse_neg = None

        if not self.in_batch:
            if neg_embs is None:
                raise ValueError("the simple loss (in_batch=False) needs sampled negatives")
            if len(field_keys) != self.num_fields:
                raise ValueError(
                    f"in_batch=False (simple loss) supports dense-only schemas: the mixer "
                    f"spans {self.num_fields} fields but only {len(field_keys)} dense "
                    f"components exist. Drop the sparse fields or use in-batch negatives."
                )
            # own negatives only: nothing crosses the ranks but the mean
            return decomposed_simple_loss(
                q.float(), pos_embs.float(), neg_embs.float(), mix_fn=self.mixer,
                temperature=self.temperature, total=None if shard is None else shard.total,
            )
        q, pos_embs = q.float(), pos_embs.float()
        neg_embs = None if neg_embs is None else neg_embs.float()
        q_all = None
        if shard is not None:
            q_all = gather_rows(q, shard)
            pos_embs = gather_rows(pos_embs, shard)
            neg_embs = None if neg_embs is None else gather_rows(neg_embs, shard)
        return hybrid_contrastive_loss(
            q,
            pos_embs,
            neg_embs,
            sparse_pos,
            sparse_neg,
            mix_fn=self.mixer,
            temperature=self.temperature,
            reverse=self.reverse,
            normalize_fn=lambda comp: self.normalize_components(comp, shard),
            q_all=q_all,
            offset=0 if shard is None else shard.offset,
        )
