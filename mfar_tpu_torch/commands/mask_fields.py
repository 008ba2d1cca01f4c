"""Field-ablation evaluation of a trained checkpoint.

Counterpart of ``mfar_tpu/commands/mask_fields.py`` (reference:
mfar/commands/mask_fields.py:20-171): reload the best
checkpoint of a train run (``{checkpoint_dir}/best.txt``), run a baseline
test, then -- unless ``--debug`` -- re-test with each field masked, all
sparse fields masked, all dense fields masked, and both scorers of each
field name masked.  Results append to ``{out}/results_dicts.jsonl``, one
line per configuration with its ``masked_fields``:

    python -m mfar_tpu_torch.commands.mask_fields --dataset-name mag --data DIR \\
        --field-names all_dense,all_sparse --lexical-index IDX --out ABL \\
        --checkpoint-dir RUN [--model-name DIR] [--device cpu]

The checkpoint's model state (encoder, mixer, batchnorm) is what the tests
read; its optimizer state is not needed.  Over several processes (one rank
per card, ``--multihost pod|force``) ``--mesh auto`` serves each test on the
mesh and rank 0 writes the results.  ``--corpus-on-host`` keeps each test's
corpus in host memory and streams it to the device per scan.
"""

from __future__ import annotations

import argparse
import os
import time

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
from mfar_tpu_torch.models.registry import prepare_model
from mfar_tpu_torch.parallel import multihost
from mfar_tpu_torch.parallel.mesh import mesh_from_flag
from mfar_tpu_torch.train.checkpoint import (
    check_field_compatibility,
    load_model_state,
    read_best_dir,
)
from mfar_tpu_torch.train.data_pipeline import ContrastiveDataset
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer
from mfar_tpu_torch.train.train_step import init_state
from mfar_tpu_torch.train.trainer import Trainer, TrainerConfig
from mfar_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    p.add_argument("--lexical-index", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--partition", default="val")
    p.add_argument("--additional-partition", default=None)
    p.add_argument("--model-name", default="facebook/contriever-msmarco",
                   help="synthetic[:vocab[:hidden]], a local HF BERT or T5 directory, "
                        "t5:<dir>, or a local sentence-transformers GTR directory")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--dev-batch-size", type=int, default=64)
    p.add_argument("--dev-max-length", type=int, default=512)
    p.add_argument("--temp-dir", default=None, help="accepted for reference CLI parity; unused")
    p.add_argument("--precision", default="16-mixed", choices=["16-mixed", "bf16", "32", "f32"],
                   help="accepted for reference CLI parity (bf16 default)")
    p.add_argument("--num-gpus", type=int, default=None,
                   help="accepted for reference CLI parity; one device here")
    p.add_argument("--seed", type=int, default=0xDEADBEEF)
    p.add_argument("--recall-k", type=int, default=100)
    p.add_argument("--use-batchnorm", action="store_true")
    p.add_argument("--query-cond", dest="query_cond", action="store_true", default=True)
    p.add_argument("--no-query-cond", dest="query_cond", action="store_false")
    p.add_argument("--prefix", action="store_true")
    p.add_argument("--retrieval-mode", default="auto", choices=["auto", "exact", "rerank"])
    p.add_argument("--corpus-on-host", action="store_true",
                   help="keep the test corpus in host memory, streamed per scan")
    p.add_argument("--mesh", default="auto", choices=["auto", "off"],
                   help="auto: shard each test's corpus over every rank; off: one device")
    p.add_argument("--multihost", default="auto", choices=["auto", "off", "force", "pod"],
                   help="several processes, one per card (see retrieve --multihost)")
    p.add_argument("--debug", action="store_true", help="baseline only, skip the ablation sweep")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(normalize_argv(argv))
    if multihost.maybe_initialize(args.multihost, args.device):
        print(f"[mask_fields] multihost: process {multihost.process_index()}/"
              f"{multihost.process_count()}", flush=True)
    mesh = mesh_from_flag(args.mesh, "mask_fields")
    if mesh is None:
        note_one_card(args, "mask_fields")
    resolve_data_dirs(args)
    if multihost.is_primary():
        os.makedirs(args.out, exist_ok=True)

    field_info = resolve_fields(args.field_names, args.dataset_name)
    corpus = load_corpus(args.corpus, args.dataset_name)
    dev_queries = trec.read_queries(os.path.join(args.queries, f"{args.partition}.queries"))

    config, encoder_state, tokenizer = prepare_model(
        args.model_name,
        normalize=args.normalize,
        corpus_texts=corpus_texts_for_vocab(corpus, field_info)
        if args.model_name.startswith("synthetic") else None,
    )
    sparse_indices = load_or_build_sparse_indices(corpus, field_info, args.lexical_index)
    neg_index = load_negative_sampler_index(corpus, args.lexical_index, args.dataset_name)
    sampler = IndexNegativeSampler(neg_index)

    model = MFARModel(
        encoder_config=config,
        num_fields=len(field_info),
        query_cond=args.query_cond,
        use_batchnorm=args.use_batchnorm,
    )
    state = init_state(model, make_optimizer(encoder_lr=1e-4, weights_lr=1e-1), seed=0,
                       device=args.device)
    state.model.encoder.load_state_dict(encoder_state)

    best_dir = read_best_dir(args.checkpoint_dir)
    check_field_compatibility(best_dir, field_info)
    print(f"PATH IS: {best_dir}")
    state.model.load_state_dict(load_model_state(best_dir))

    qrels_path = os.path.join(args.queries, f"{args.partition}.qrels")
    dummy_ds = ContrastiveDataset(
        dev_queries, corpus, trec.QRels.from_file(qrels_path), sampler, field_info, tokenizer,
    )
    cfg = TrainerConfig(
        out_dir=args.out, dev_batch_size=args.dev_batch_size,
        recall_k=args.recall_k, prefix=args.prefix,
        retrieval_mode=args.retrieval_mode,
        corpus_on_host=args.corpus_on_host,
        query_max_length=args.dev_max_length,
        seed=args.seed % (2**31),
    )
    additional_queries = additional_qrels = None
    if args.additional_partition:
        additional_queries = trec.read_queries(
            os.path.join(args.queries, f"{args.additional_partition}.queries"))
        additional_qrels = os.path.join(args.queries, f"{args.additional_partition}.qrels")
    trainer = Trainer(
        tokenizer=tokenizer, field_info=field_info, corpus=corpus,
        train_dataset=dummy_ds, val_dataset=dummy_ds,
        dev_queries=dev_queries, dev_qrels_path=qrels_path,
        config=cfg, sparse_indices=sparse_indices,
        additional_queries=additional_queries, additional_qrels_path=additional_qrels,
        logger=MetricsLogger(args.out), mesh=mesh,
    )

    print(f"Starting re-testing of {best_dir}: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    print("Baseline Evaluation")
    trainer.test(state, verbose=False)
    if args.debug:
        return

    fields = list(field_info.values())
    for idx in range(len(fields)):
        trainer.mask_field([idx])
        trainer.test(state, verbose=False)

    sparse_idx = [i for i, f in enumerate(fields) if f.is_sparse]
    if sparse_idx:
        trainer.mask_field(sparse_idx)
        trainer.test(state, verbose=False)
    else:
        print("No sparse fields")

    dense_idx = [i for i, f in enumerate(fields) if f.is_dense]
    if dense_idx:
        trainer.mask_field(dense_idx)
        trainer.test(state, verbose=False)
    else:
        print("No dense fields")

    for name in sorted({f.name for f in fields}):
        trainer.mask_field([i for i, f in enumerate(fields) if f.name == name])
        trainer.test(state, verbose=False)


if __name__ == "__main__":
    main()
