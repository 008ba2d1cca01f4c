"""The training loop on one device: epochs, validation, trec eval, early
stop, checkpoints, resume.

Counterpart of ``mfar_tpu/train/trainer.py`` (itself the reference's
Lightning Trainer + callbacks):

- per-epoch train loop over :func:`mfar_tpu_torch.train.train_step.
  train_step`, host batches prepared on a background thread
  (:func:`prefetch`) while the device runs the current step; per-step
  losses stay on the device until the epoch ends;
- proxy validation (the val-set contrastive loss) every epoch, and a full
  trec retrieval eval every ``trec_val_freq`` epochs over a dense corpus
  index rebuilt by the current encoder;
- early stopping on the monitored metric, a checkpoint every epoch (top-k
  by the monitor, ``best.txt``), ``dev_by_iter`` mid-epoch validation and
  ``run_one_iteration``.

Several devices (the JAX trainer's ``mesh``) are ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.schema import sparse_keys
from mfar_tpu_torch.data.types import Corpus, Field
from mfar_tpu_torch.eval.index_build import build_dense_corpus_matrix, make_encode_fn
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.train.checkpoint import CheckpointManager
from mfar_tpu_torch.train.data_pipeline import (
    ContrastiveDataset,
    prefetch,
    strip_meta,
    token_stats,
)
from mfar_tpu_torch.train.train_step import TrainState, eval_loss_step, train_step
from mfar_tpu_torch.utils.logging import MetricsLogger
from mfar_tpu_torch.utils.timing import Timer

PROG_METRICS = (
    "map", "recip_rank", "recall_5", "recall_10", "recall_20", "recall_100",
    "ndcg", "ndcg_cut_10", "Rprec", "success_1",
)
RESULT_KEYS = (
    "success_1", "success_5", "recall_5", "recall_10", "recall_15",
    "recall_20", "ndcg", "ndcg_cut_10", "recip_rank", "map",
)


@dataclasses.dataclass
class TrainerConfig:
    out_dir: str
    max_epochs: int = 50
    patience: int = 10
    trec_val_freq: int = 0
    train_batch_size: int = 16
    dev_batch_size: int = 64
    index_batch_size: int = 256
    seed: int = 0xDEADBEEF
    run_one_iteration: bool = False
    dev_by_iter: bool = False  # validate 5x per epoch (amazon)
    recall_k: int = 100
    top_k: int = 100
    query_max_length: int = 512
    monitor: str = "valid_loss"
    prefix: bool = False
    retrieval_mode: str = "auto"  # auto|exact|rerank (engine serving mode)
    corpus_on_host: bool = False  # the eval engine streams the corpus from host memory
    prefetch_depth: int = 2  # host batches prepared ahead of the device
    prng: str = "rbg"  # the train command's --prng, recorded for --resume


class Trainer:
    def __init__(
        self,
        tokenizer,
        field_info: Dict[str, Field],
        corpus: Corpus,
        train_dataset: ContrastiveDataset,
        val_dataset: ContrastiveDataset,
        dev_queries: Mapping[str, str],
        dev_qrels_path: str,
        config: TrainerConfig,
        sparse_indices: Optional[Dict[str, Any]] = None,
        additional_queries: Optional[Mapping[str, str]] = None,
        additional_qrels_path: Optional[str] = None,
        logger: Optional[MetricsLogger] = None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("training over several devices (mesh) is ROADMAP A15")
        self.tokenizer = tokenizer
        self.field_info = field_info
        self.corpus = corpus
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.dev_queries = dict(dev_queries)
        self.dev_qrels_path = dev_qrels_path
        self.additional_queries = dict(additional_queries or {})
        self.additional_qrels_path = additional_qrels_path
        self.cfg = config
        self.sparse_indices = sparse_indices or {}
        self.logger = logger or MetricsLogger(config.out_dir)
        self.timer = Timer()

        os.makedirs(config.out_dir, exist_ok=True)
        self.ckpt = CheckpointManager(
            config.out_dir, monitor=config.monitor,
            mode=CheckpointManager.monitor_mode(config.monitor),
        )
        self.best_score = 0.0
        self._last_epoch_padding_pct = 0.0
        self.mask: Optional[np.ndarray] = None
        self.masked_fields_string = ""

    # ------------------------------------------------------------------

    def build_engine(self, state: TrainState) -> RetrievalEngine:
        """(Re)index the corpus with the current encoder and assemble the
        retrieval engine."""
        device = next(state.model.parameters()).device
        encode = make_encode_fn(state.model.encoder, device=device)
        dense_fields = {k: f for k, f in self.field_info.items() if f.is_dense}
        with self.timer.phase("index_build"):
            matrix = build_dense_corpus_matrix(
                encode, self.tokenizer, self.corpus, dense_fields,
                batch_size=self.cfg.index_batch_size, prefix=self.cfg.prefix,
            )
        return RetrievalEngine(
            field_info=self.field_info,
            doc_keys=list(self.corpus.keys()),
            encode_fn=encode,
            tokenizer=self.tokenizer,
            mixer_params={"weight": state.model.mixer.weight.detach()},
            dense_matrix=matrix if matrix.size else None,
            # missing indices pass through so the engine raises its own error
            sparse_indices={
                k: self.sparse_indices[k]
                for k in sparse_keys(self.field_info) if k in self.sparse_indices
            },
            query_max_length=self.cfg.query_max_length,
            recall_k=self.cfg.recall_k,
            mask=self.mask,
            mode=self.cfg.retrieval_mode,
            corpus_on_host=self.cfg.corpus_on_host,
            device=device,
        )

    # ------------------------------------------------------------------

    def train_epoch(self, state: TrainState, epoch: int) -> tuple:
        """One epoch over a background-prefetched batch stream; per-step
        losses stay on the device until the epoch ends."""
        losses = []
        val_losses = []
        tokens_real = tokens_total = 0
        n = self.train_dataset.num_batches(self.cfg.train_batch_size)
        if self.cfg.run_one_iteration:
            n = min(n, 1)
        val_every = max(1, n // 5) if self.cfg.dev_by_iter else n + 1
        it = self.train_dataset.epoch_batches(
            self.cfg.train_batch_size, seed=self.cfg.seed + epoch
        )
        for i, batch in enumerate(prefetch(it, depth=self.cfg.prefetch_depth)):
            if i >= n:
                break
            batch = strip_meta(batch)
            ts = token_stats(batch)
            tokens_real += ts["tokens_real"]
            tokens_total += ts["tokens_total"]
            with self.timer.phase("train_step"):
                state, metrics = train_step(state, batch)
            losses.append(metrics["loss"])
            if (i + 1) % val_every == 0 and i + 1 < n:
                val_losses.append(self.validate_proxy(state))
        # the steps ran asynchronously; the device drains here (one fetch)
        with self.timer.phase("train_drain"):
            losses = torch.stack(losses).tolist() if losses else []
        self._last_epoch_padding_pct = (
            100.0 * (1.0 - tokens_real / tokens_total) if tokens_total else 0.0
        )
        return state, float(np.mean(losses)) if losses else 0.0, val_losses

    def validate_proxy(self, state: TrainState) -> float:
        """Cheap validation signal: the val-set contrastive loss, one device
        fetch for all batches."""
        losses = []
        it = self.val_dataset.epoch_batches(
            self.cfg.train_batch_size, seed=0, drop_remainder=False
        )
        for batch in prefetch(it, depth=self.cfg.prefetch_depth):
            with self.timer.phase("val_step"):
                losses.append(eval_loss_step(state, strip_meta(batch)))
            if self.cfg.run_one_iteration:
                break
        with self.timer.phase("val_drain"):
            vals = torch.stack(losses).tolist() if losses else []
        return float(np.mean(vals)) if vals else float("inf")

    def trec_eval(
        self,
        state: TrainState,
        queries: Mapping[str, str],
        qrels_path: str,
        tag: str,
        engine: Optional[RetrievalEngine] = None,
    ) -> Dict[str, float]:
        """Full retrieval eval: retrieve -> qres file -> trec metrics."""
        engine = engine or self.build_engine(state)
        qids = list(queries.keys())
        with self.timer.phase("retrieve"):
            results = engine.retrieve_many(
                [queries[q] for q in qids], top_k=self.cfg.top_k,
                batch_size=self.cfg.dev_batch_size,
            )
        qres_path = os.path.join(self.cfg.out_dir, f"{tag}.qres")
        trec.write_qres(qres_path, engine.to_qres(qids, results))
        with self.timer.phase("trec_eval"):
            return trec.call_trec_eval_and_get_metrics(qrels_path, qres_path)

    # ------------------------------------------------------------------

    def fit(self, state: TrainState, start_epoch: int = 0) -> TrainState:
        cfg = self.cfg
        # loss-like monitors minimize, quality metrics maximize
        sign = 1.0 if CheckpointManager.monitor_mode(cfg.monitor) == "min" else -1.0
        best_monitor = float("inf")
        epochs_without_improvement = 0

        for epoch in range(start_epoch, cfg.max_epochs):
            state, train_loss, mid_val = self.train_epoch(state, epoch)
            valid_loss = self.validate_proxy(state)
            metrics: Dict[str, float] = {
                "train_loss": train_loss,
                "valid_loss": valid_loss,
                # padded fraction of this epoch's token arrays
                "padding_pct": round(self._last_epoch_padding_pct, 2),
            }
            if mid_val:
                metrics["mid_valid_loss"] = float(np.mean(mid_val))

            if cfg.trec_val_freq > 0 and (epoch + 1) % cfg.trec_val_freq == 0:
                dev = self.trec_eval(state, self.dev_queries, self.dev_qrels_path,
                                     f"epoch{epoch}-dev")
                metrics.update({f"dev_{k}": v for k, v in dev.items() if k in PROG_METRICS})
                self.best_score = max(self.best_score, dev.get("ndcg_cut_10", 0.0))
                metrics["best_ndcg_cut_10"] = self.best_score

            self.logger.log(metrics, step=state.step)
            print(
                f"[epoch {epoch}] train_loss={train_loss:.4f} valid_loss={valid_loss:.4f}"
                + (f" dev_ndcg@10={metrics['dev_ndcg_cut_10']:.4f}"
                   if "dev_ndcg_cut_10" in metrics else "")
            )
            self.ckpt.save(epoch, state, metrics, field_info=self.field_info,
                           config=dataclasses.asdict(cfg))

            if cfg.monitor in metrics:
                monitored = sign * metrics[cfg.monitor]
                if monitored < best_monitor - 1e-12:
                    best_monitor = monitored
                    epochs_without_improvement = 0
                else:
                    epochs_without_improvement += 1
                    if epochs_without_improvement >= cfg.patience:
                        print(f"[early stop] no {cfg.monitor} improvement "
                              f"for {cfg.patience} epochs")
                        break
            # a monitor absent this epoch (a trec metric between
            # --trec-val-freq epochs) is skipped, never replaced
            if cfg.run_one_iteration:
                break
        return state

    # ------------------------------------------------------------------

    def mask_field(self, field_idx_list: List[int]) -> None:
        """Zero the scores of the given field indices at eval."""
        names = list(self.field_info.keys())
        self.masked_fields_string = ",".join(names[i] for i in field_idx_list)
        mask = np.ones(len(self.field_info), np.float32)
        mask[np.asarray(field_idx_list, dtype=int)] = 0.0
        self.mask = mask

    def clear_mask(self) -> None:
        self.mask = None
        self.masked_fields_string = ""

    def test(self, state: TrainState, verbose: bool = True) -> Dict[str, Dict[str, float]]:
        """Final eval on dev (+ additional) partitions; appends one line per
        configuration to results_dicts.jsonl."""
        engine = self.build_engine(state)
        out: Dict[str, Dict[str, float]] = {}
        partitions = [("dev", self.dev_queries, self.dev_qrels_path)]
        if self.additional_queries and self.additional_qrels_path:
            partitions.append(("additional", self.additional_queries, self.additional_qrels_path))
        for tag, queries, qrels_path in partitions:
            metrics = self.trec_eval(state, queries, qrels_path, f"final-{tag}", engine=engine)
            out[tag] = metrics
            record = {k: f"{metrics.get(k, 0.0):.3f}" for k in RESULT_KEYS}
            record["masked_fields"] = self.masked_fields_string
            record["additional"] = "test" if tag == "additional" else "val"
            if verbose:
                print("\t".join(RESULT_KEYS))
                print("\t".join(record[k] for k in RESULT_KEYS))
                print(json.dumps(record))
            with open(os.path.join(self.cfg.out_dir, "results_dicts.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
            self.logger.log(
                {f"{'additional' if tag == 'additional' else 'best'}_{k}": v
                 for k, v in metrics.items() if k in PROG_METRICS},
                step=state.step,
            )
        return out
