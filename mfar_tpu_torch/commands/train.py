"""Train a multi-field retriever on one card, or over several: data-parallel,
tensor-parallel, or both.

Counterpart of ``mfar_tpu/commands/train.py``: the same flags and defaults,
plus ``--device`` (``cuda`` by default; ``cpu`` runs on the host):

    python -m mfar_tpu_torch.commands.train --dataset-name mag --data DIR \\
        --out RUN --lexical-index IDX --weights-lr 0.1 [--model-name DIR] \\
        [--run-one-iteration] [--device cpu]

Over several cards, one rank per card (``torchrun --nproc-per-node N -m
mfar_tpu_torch.commands.train ... --multihost pod``, or the
``MFAR_COORDINATOR``/``MFAR_NUM_PROCESSES``/``MFAR_PROCESS_ID`` triple with
``--multihost force``; gloo ranks with ``--device cpu``), ``--mesh auto``
trains data-parallel over the ranks as the JAX command trains on its mesh:
each rank encodes its rows of every global batch and the gradients are
summed (``Trainer``).  ``--n-model`` shards the encoder Megatron-style over
that many ranks (the JAX command's tensor parallelism: each rank of a model
group holds its shard of the sharded leaves and their optimizer state, and
the group runs the same rows); ``--n-replica`` shapes the mesh; the data
axis takes the ranks left, ``ranks // (n_model x n_replica)``, and on a
single-slice mesh shrinks until the batch divides, leaving ranks idle (they
exit at once).  Rank 0 writes every file, checkpoints in the ``n_model`` 1
layout; ``--resume`` and the final test restore rank 0's checkpoints on
every rank.  One process that sees several cards trains on the current one
and says so.

The encoder is built as ``prepare_model`` configures it, so it trains with
plain attention (``"xla"``) and dropout 0.1, as the JAX command does; kernel
K2 and its backward run when the encoder config has
``attention_impl="auto"`` (or ``"flash"``) and attention dropout 0.
``--remat auto`` recomputes layers in the backward for encoders of 8 layers
or more.  Sparse (BM25) fields train as in the JAX command: their indices
load from ``--lexical-index`` (``create_sparse_index``) or are built in
memory, and their scores come from ``--sparse-scores-path``
(``precompute_sparse_scores``) where it covers a batch's queries, else live.
A T5/GTR model (a local T5 or sentence-transformers GTR directory, or
``t5:<dir>``) trains its encoder with Adafactor, as the JAX command does.
The output directory holds
``metrics.jsonl``, ``checkpoints/<epoch>/`` (``state.pt`` + ``meta.json``),
``best.txt``, the dev qres files and ``results_dicts.jsonl``, as the JAX
command's does; ``retrieve --checkpoint-dir`` serves from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Tuple

import torch

from mfar_tpu_torch.commands.common import (
    add_data_args,
    corpus_texts_for_vocab,
    load_corpus,
    load_negative_sampler_index,
    load_or_build_sparse_indices,
    normalize_argv,
    note_one_card,
    resolve_data_dirs,
)
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.negative_sampler import IndexNegativeSampler
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.models.registry import is_t5_family, prepare_model
from mfar_tpu_torch.parallel import multihost
from mfar_tpu_torch.parallel.data_parallel import broadcast_object
from mfar_tpu_torch.parallel.mesh import make_mesh
from mfar_tpu_torch.train.data_pipeline import ContrastiveDataset
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer
from mfar_tpu_torch.train.sparse_cache import read_sparse_scores
from mfar_tpu_torch.train.train_step import init_state
from mfar_tpu_torch.train.trainer import Trainer, TrainerConfig
from mfar_tpu_torch.utils.logging import MetricsLogger
from mfar_tpu_torch.utils.timing import torch_profile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    p.add_argument("--lexical-index", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--temp-dir", default=None, help="accepted for reference CLI parity; unused")
    p.add_argument("--partition", default="val")
    p.add_argument("--additional-partition", default=None)
    p.add_argument("--sparse-scores-path", default=None,
                   help="precomputed BM25 scores of the sparse fields "
                        "(precompute_sparse_scores' output)")
    p.add_argument("--model-name", default="facebook/contriever-msmarco",
                   help="synthetic[:vocab[:hidden]], a local HF BERT or T5 directory, "
                        "t5:<dir>, or a local sentence-transformers GTR directory")
    p.add_argument("--model-path", default=None)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--negative-sampling-params", default="100,50,1",
                   help="n_retrieve,n_bottom,n_sample")
    p.add_argument("--encoder-lr", type=float, default=1e-4)
    p.add_argument("--weights-lr", type=float, required=True)
    p.add_argument("--regularizer", type=float, default=0.0, help="weight decay")
    p.add_argument("--train-batch-size", type=int, default=16)
    p.add_argument("--dev-batch-size", type=int, default=64)
    p.add_argument("--train-max-length", type=int, default=512)
    p.add_argument("--dev-max-length", type=int, default=512)
    p.add_argument("--max-epochs", type=int, default=50)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--seed", type=int, default=0xDEADBEEF)
    p.add_argument("--precision", default="16-mixed", choices=["16-mixed", "bf16", "32", "f32"],
                   help="compute precision: 16-mixed (default) = bf16 activations; 32/f32 "
                        "full-precision encoder compute")
    p.add_argument("--num-gpus", type=int, default=None,
                   help="accepted for reference CLI parity; one device here")
    p.add_argument("--dev-by-iter", dest="dev_by_iter", action="store_true", default=None,
                   help="validate 5x per epoch (default on for amazon, like the reference)")
    p.add_argument("--no-dev-by-iter", dest="dev_by_iter", action="store_false")
    p.add_argument("--logger", default=None, choices=[None, "wandb", "mlflow", "mlflow_local"])
    p.add_argument("--wandb-name", default=None, help="wandb run display name")
    p.add_argument("--wandb-dir", default=None, help="wandb local artifact dir")
    p.add_argument("--freeze-encoder", action="store_true")
    p.add_argument("--experiment-name", default=None)
    p.add_argument("--trec-val-freq", type=int, default=0)
    p.add_argument("--query-cond", dest="query_cond", action="store_true", default=True)
    p.add_argument("--no-query-cond", dest="query_cond", action="store_false")
    p.add_argument("--prefix", action="store_true")
    p.add_argument("--run-one-iteration", action="store_true")
    p.add_argument("--use-batchnorm", action="store_true")
    p.add_argument("--in-batch-negative", dest="in_batch", action="store_true", default=True)
    p.add_argument("--no-in-batch-negative", dest="in_batch", action="store_false",
                   help="own-negatives-only simple loss")
    p.add_argument("--prng", default="rbg", choices=["rbg", "threefry"],
                   help="accepted for the JAX flag set and recorded; dropout draws come "
                        "from a torch.Generator here.  --resume refuses another value")
    p.add_argument("--hidden-dropout", type=float, default=None,
                   help="override encoder hidden dropout (default: model config)")
    p.add_argument("--attention-dropout", type=float, default=None,
                   help="override attention dropout (0 lets an 'auto' encoder take K2)")
    p.add_argument("--softmax-dtype", default="f32", choices=["f32", "bf16"],
                   help="attention softmax dtype of the plain path")
    p.add_argument("--remat", default="auto", choices=["auto", "on", "off"],
                   help="recompute encoder layers in the backward (auto: on for "
                        ">=8-layer encoders)")
    p.add_argument("--recall-k", type=int, default=100)
    p.add_argument("--retrieval-mode", default="auto", choices=["auto", "exact", "rerank"],
                   help="eval serving mode: exact (the default) or rerank")
    p.add_argument("--mesh", default="auto", choices=["auto", "off"],
                   help="auto: data-parallel over every rank when the command runs as "
                        "several processes (one per card); off: one device")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel axis size: the encoder's weights and optimizer state "
                        "shard over this many ranks")
    p.add_argument("--n-replica", type=int, default=1,
                   help="replica-axis size of the mesh (the batch shards over replica x data)")
    p.add_argument("--multihost", default="auto", choices=["auto", "off", "force", "pod"],
                   help="several processes, one per card: force reads MFAR_COORDINATOR, "
                        "MFAR_NUM_PROCESSES and MFAR_PROCESS_ID; pod reads torchrun's "
                        "environment; auto starts on that triple when it is set")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="train batches prepared ahead on the host thread")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --out (model, optimizer, "
                        "batchnorm and generator state)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of training into this dir")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def train_mesh_shape(world: int, n_replica: int, batch: int,
                     n_model: int = 1) -> Tuple[int, int]:
    """(n_data, ranks used) of the training mesh over ``world`` ranks, as
    the JAX command sizes its mesh: the data axis takes ``world // (n_model
    x n_replica)`` ranks and, on a single-slice mesh, shrinks until the
    batch divides (the ranks left over sit idle); shapes that cannot divide
    exit with the JAX command's messages."""
    if n_replica > 1 and world % (n_model * n_replica):
        raise SystemExit(
            f"--n-model {n_model} x --n-replica {n_replica} "
            f"must divide the {world} visible devices for a multi-slice "
            f"mesh"
        )
    n_data = world // (n_model * n_replica)
    if n_data < 1:
        raise SystemExit(
            f"--n-model {n_model} x --n-replica {n_replica} "
            f"needs at least that many devices (have {world})"
        )
    if n_replica == 1:
        while n_data > 1 and batch % n_data:
            n_data -= 1
    if batch % (n_data * n_replica):
        raise SystemExit(
            f"--train-batch-size {batch} must be divisible "
            f"by n_replica x n_data = {n_replica} x {n_data} "
            f"(pick a batch size or mesh shape that divides)"
        )
    return n_data, n_data * n_model * n_replica


def main(argv=None) -> None:
    args = build_parser().parse_args(normalize_argv(argv))
    if multihost.maybe_initialize(args.multihost, args.device):
        print(f"[train] multihost: process {multihost.process_index()}/"
              f"{multihost.process_count()}", flush=True)
    world = multihost.process_count()
    mesh = None
    if args.mesh == "auto" and (world > 1 or args.n_model > 1 or args.n_replica > 1):
        n_data, used = train_mesh_shape(world, args.n_replica, args.train_batch_size,
                                        args.n_model)
        mesh = make_mesh(n_data=n_data, n_model=args.n_model, n_replica=args.n_replica,
                         n_ranks=used)
        note = f" ({world - used} ranks idle: batch {args.train_batch_size})" if used < world else ""
        if multihost.is_primary():
            print(f"[train] mesh: {mesh.shape} over {used}/{world} ranks ({mesh.backend}){note}",
                  flush=True)
        if not mesh.member:
            print(f"[train] rank {multihost.process_index()} is idle{note}", flush=True)
            return
    elif world > 1:
        raise SystemExit("multihost training requires a mesh: pass --mesh auto")
    else:
        note_one_card(args, "train")
    resolve_data_dirs(args)
    if multihost.is_primary():  # rank 0 owns file I/O
        os.makedirs(args.out, exist_ok=True)

    field_info = resolve_fields(args.field_names, args.dataset_name)
    model_name = args.model_path or args.model_name
    neg_params = tuple(int(x) for x in args.negative_sampling_params.split(","))
    dev_by_iter = args.dev_by_iter if args.dev_by_iter is not None \
        else args.dataset_name == "amazon"

    print(json.dumps({
        "model": model_name,
        "dataset": args.dataset_name,
        "fields": {k: f.serialize() for k, f in field_info.items()},
        "encoder_lr": args.encoder_lr,
        "weights_lr": args.weights_lr,
        "trec_val_freq": args.trec_val_freq,
        "seed": args.seed,
        "device": args.device,
        "start_time": time.strftime("%Y-%m-%d %H:%M:%S"),
    }, indent=2))

    corpus = load_corpus(args.corpus, args.dataset_name)
    train_queries = trec.read_queries(os.path.join(args.queries, "train.queries"))
    val_queries = trec.read_queries(os.path.join(args.queries, "val.queries"))
    dev_queries = trec.read_queries(os.path.join(args.queries, f"{args.partition}.queries"))

    config, encoder_state, tokenizer = prepare_model(
        model_name,
        normalize=args.normalize,
        corpus_texts=corpus_texts_for_vocab(corpus, field_info)
        if model_name.startswith("synthetic") else None,
    )
    remat = {"auto": config.num_layers >= 8, "on": True, "off": False}[args.remat]
    # the JAX command's overrides: each only where the config has the field
    # (T5 has one dropout rate, which --hidden-dropout sets, and no
    # attention dropout)
    overrides = {"remat": remat}
    if args.precision in ("32", "f32") and hasattr(config, "dtype"):
        overrides["dtype"] = torch.float32  # bf16 ("16-mixed") is the default
    if args.hidden_dropout is not None:
        overrides["hidden_dropout" if hasattr(config, "hidden_dropout") else "dropout"] = \
            args.hidden_dropout
    if args.attention_dropout is not None and hasattr(config, "attention_dropout"):
        overrides["attention_dropout"] = args.attention_dropout
    if args.softmax_dtype == "bf16" and hasattr(config, "softmax_dtype"):
        overrides["softmax_dtype"] = torch.bfloat16
    config = dataclasses.replace(config, **overrides)

    sparse_indices = load_or_build_sparse_indices(corpus, field_info, args.lexical_index)
    neg_index = load_negative_sampler_index(corpus, args.lexical_index, args.dataset_name)
    sampler = IndexNegativeSampler(neg_index, *neg_params)
    sparse_scores = None
    if args.sparse_scores_path and sparse_indices:
        t0 = time.time()
        sparse_scores = read_sparse_scores(args.sparse_scores_path, field_info)
        print(f"Read sparse scores in {time.time() - t0:.1f}s")

    model = MFARModel(
        encoder_config=config,
        num_fields=len(field_info),
        query_cond=args.query_cond,
        use_batchnorm=args.use_batchnorm,
        temperature=args.temperature,
        in_batch=args.in_batch,
    )
    optimizer = make_optimizer(
        encoder_lr=args.encoder_lr,
        weights_lr=args.weights_lr,
        weight_decay=args.regularizer,
        freeze_encoder=args.freeze_encoder,
        use_adafactor=is_t5_family(model_name),
    )
    seed = args.seed % (2**31)
    state = init_state(model, optimizer, seed=seed, device=args.device)
    state.model.encoder.load_state_dict(encoder_state)  # pretrained (or seeded) weights

    def dataset(queries, qrels_file, max_len):
        return ContrastiveDataset(
            queries, corpus, trec.QRels.from_file(os.path.join(args.queries, qrels_file)),
            sampler, field_info, tokenizer, query_max_length=max_len, prefix=args.prefix,
            sparse_score_cache=sparse_scores, sparse_indices=sparse_indices,
        )

    cfg = TrainerConfig(
        out_dir=args.out,
        max_epochs=args.max_epochs,
        patience=args.patience,
        trec_val_freq=args.trec_val_freq,
        train_batch_size=args.train_batch_size,
        dev_batch_size=args.dev_batch_size,
        seed=seed,
        run_one_iteration=args.run_one_iteration,
        dev_by_iter=dev_by_iter,
        recall_k=args.recall_k,
        query_max_length=args.dev_max_length,
        prefix=args.prefix,
        retrieval_mode=args.retrieval_mode,
        prefetch_depth=max(1, args.prefetch_depth),
        prng=args.prng,
    )
    logger = MetricsLogger(args.out, backend=args.logger, run_name=args.experiment_name,
                           wandb_name=args.wandb_name, wandb_dir=args.wandb_dir)
    logger.log_hyperparams(vars(args))

    additional_queries = additional_qrels = None
    if args.additional_partition:
        additional_queries = trec.read_queries(
            os.path.join(args.queries, f"{args.additional_partition}.queries"))
        additional_qrels = os.path.join(args.queries, f"{args.additional_partition}.qrels")

    trainer = Trainer(
        tokenizer=tokenizer, field_info=field_info, corpus=corpus,
        train_dataset=dataset(train_queries, "train.qrels", args.train_max_length),
        val_dataset=dataset(val_queries, "val.qrels", args.dev_max_length),
        dev_queries=dev_queries,
        dev_qrels_path=os.path.join(args.queries, f"{args.partition}.qrels"),
        config=cfg, sparse_indices=sparse_indices, additional_queries=additional_queries,
        additional_qrels_path=additional_qrels, logger=logger, mesh=mesh,
    )

    start_epoch = 0
    latest = trainer.ckpt_step_broadcast("latest") if args.resume else None
    if latest is not None:
        # meta.json is on rank 0's disk; every rank must reach the same
        # verdict (a rank-0-only exit would leave the others in the restore)
        saved = ""
        if multihost.is_primary():
            saved = trainer.ckpt.restore_meta(latest).get("config", {}).get("prng") or ""
        if mesh is not None:
            saved = broadcast_object(saved, mesh)
        if saved and saved != args.prng:
            raise SystemExit(
                f"checkpoint {latest} was trained with --prng {saved}; resuming with "
                f"--prng {args.prng} would change the run's recorded randomness -- "
                f"pass --prng {saved}"
            )
        state = trainer.restore_broadcast(latest, state)
        start_epoch = latest + 1
        print(f"Resumed from checkpoint {latest} (epoch {start_epoch})")

    print(f"Starting training on {args.device}: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    with torch_profile(args.profile_dir):
        state = trainer.fit(state, start_epoch=start_epoch)

    # reload the best checkpoint, on every rank, for the final test
    best = trainer.ckpt_step_broadcast("best")
    if best is not None:
        state = trainer.restore_broadcast(best, state)
        print(f"[train] rank {multihost.process_index()}: restored the best checkpoint "
              f"{best} for the test", flush=True)
    trainer.test(state)
    if multihost.is_primary():
        trainer.ckpt.write_best_txt()
    logger.close()
    print(f"[timing] {trainer.timer.report()}")


if __name__ == "__main__":
    main()
