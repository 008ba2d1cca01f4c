"""Shared CLI bootstrap for the port: corpus + model + dense and sparse
indices from flags.

Counterpart of ``mfar_tpu/commands/common.py`` for the engine and the
trainer, with the JAX command's whole engine flag set.  ``--checkpoint-dir``
reads the port's own checkpoints (:mod:`mfar_tpu_torch.train.checkpoint`;
the JAX package's are orbax: ``python -m tools.jax_checkpoint_to_torch``
converts them).  ``--mesh auto`` serves on a
mesh over the world's ranks when the command runs as several processes (one
per card: ``torchrun`` with ``--multihost pod``, or the ``MFAR_*``
environment with ``--multihost force``), shaped by ``--n-model``,
``--n-replica`` and ``--corpus-per-slice`` as in the JAX package, over any placement of
the corpus (``--quantize int8``, ``--corpus-on-host``); one process serves
on one device.  ``--pallas-cross-row`` sends the one-device K1 route through
K1x, the cross-row schedule, and changes nothing where JAX's flag changes
nothing.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields, sparse_keys
from mfar_tpu_torch.data.types import Corpus, Field
from mfar_tpu_torch.parallel import multihost
from mfar_tpu_torch.sparse.bm25 import BM25Index
from mfar_tpu_torch.train.checkpoint import (
    check_field_compatibility,
    load_model_state,
    read_best_dir,
)


def normalize_argv(argv):
    """Accept the reference's underscore flag spelling (``--encoder_lr``) by
    rewriting flag-shaped tokens to argparse's hyphenated names; nothing
    after a bare ``--`` is touched."""
    if argv is None:
        argv = sys.argv[1:]
    flag_re = re.compile(r"^--[A-Za-z0-9][A-Za-z0-9_-]*($|=)")
    out = []
    literal = False
    for tok in argv:
        if literal:
            pass
        elif tok == "--":
            literal = True
        elif isinstance(tok, str) and flag_re.match(tok):
            flag, sep, value = tok.partition("=")
            tok = flag.replace("_", "-") + sep + value
        out.append(tok)
    return out


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset-name", required=True, help="mag | prime | amazon | whatsthatbook")
    p.add_argument("--data", default=None, help="directory with corpus + queries (sets both)")
    p.add_argument("--queries", default=None)
    p.add_argument("--corpus", default=None)
    p.add_argument("--field-names", default="all_dense", help="field micro-DSL, comma separated")


def resolve_data_dirs(args) -> None:
    if args.data:
        args.queries = args.data
        args.corpus = args.data
    if not (args.queries and args.corpus):
        raise SystemExit("pass --data or both --queries and --corpus")


def load_corpus(corpus_dir: str, dataset_name: str) -> Corpus:
    return Corpus.from_pairs(trec.read_corpus(os.path.join(corpus_dir, "corpus")), dataset_name)


def corpus_texts_for_vocab(corpus: Corpus, field_info: Dict[str, Field], queries=None):
    texts = []
    pairs = list(corpus.pairs())
    seen_names = set()
    for f in field_info.values():
        if f.name in seen_names:
            continue
        seen_names.add(f.name)
        texts += [t for _, t in format_documents(pairs, f.name, f.dataset)]
    if queries:
        texts += list(queries)
    return texts


def load_or_build_sparse_indices(
    corpus: Corpus, field_info: Dict[str, Field], lexical_index: Optional[str]
) -> Dict[str, BM25Index]:
    """Per-sparse-field BM25 indices: loaded from ``--lexical-index`` where
    it holds ``{field_key}_sparse_index``, else built in memory."""
    from mfar_tpu_torch.eval.index_build import build_sparse_indices

    out: Dict[str, BM25Index] = {}
    missing: Dict[str, Field] = {}
    for fk in sparse_keys(field_info):
        path = lexical_index and os.path.join(lexical_index, f"{fk}_sparse_index")
        if path and os.path.isdir(path):
            out[fk] = BM25Index.load(path)
        else:
            missing[fk] = field_info[fk]
    if missing:
        out.update(build_sparse_indices(corpus, missing))
    return out


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The serving-engine flags, names and defaults as in the JAX package."""
    p.add_argument("--model-name", default="facebook/contriever-msmarco",
                   help="synthetic[:vocab[:hidden]], a local HF BERT or T5 directory, "
                        "t5:<dir>, or a local sentence-transformers GTR directory")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a train run's --out: serve its best checkpoint's encoder "
                        "and mixer (the port's checkpoints)")
    p.add_argument("--dense-index", default=None, help="prebuilt .npz/.npy from encode_corpus")
    p.add_argument("--lexical-index", default=None,
                   help="directory of prebuilt BM25 indices ({field}_sparse_index, "
                        "from create_sparse_index); missing ones are built in memory")
    p.add_argument("--recall-k", type=int, default=100)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--quantize", default=None, choices=[None, "int8"],
                   help="int8 corpus: int8 rows and an f32 scale a row, half of "
                        "bf16's memory, at the quantization's score error")
    p.add_argument("--use-pallas-gather", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="rerank stage-2 gather through the CUDA kernel K1. auto "
                        "(default): K1 on the card (raising on a corpus it "
                        "cannot read); on: always; off: the plain gather")
    p.add_argument("--pallas-cross-row", action="store_true",
                   help="rerank stage 2 through K1x, K1's cross-row schedule (each warp "
                        "walks a span of all candidates in one order, the next row in "
                        "flight); no effect on a mesh, an int8 or host corpus, or exact "
                        "mode; refused with --use-pallas-gather off")
    p.add_argument("--corpus-on-host", action="store_true",
                   help="keep the dense corpus in host memory (RAM or the --dense-index "
                        ".npy memmap) and stream it to the card per scan: a corpus "
                        "beyond device memory, at the copies' rate; composes with "
                        "--quantize int8")
    p.add_argument("--dense-topk", default="exact", choices=["exact", "approx"],
                   help="accepted for the JAX flag set; selection is exact here")
    p.add_argument("--dense-dtype", default="bf16", choices=["bf16", "f32"],
                   help="device dtype of the corpus matrix (bf16 halves its memory)")
    p.add_argument("--mode", default="auto", choices=["auto", "exact", "rerank"],
                   help="exact (the default) scores the full corpus, hybrid fields "
                        "included; rerank is the reference-compatible recall+rerank "
                        "pipeline")
    p.add_argument("--mesh", default="auto", choices=["auto", "off"],
                   help="auto: shard the corpus over every rank (one process per card) "
                        "and serve with distributed top-k; off: one device")
    p.add_argument("--n-model", type=int, default=1,
                   help="model-axis size of the mesh (its ranks repeat the serving work)")
    p.add_argument("--n-replica", type=int, default=1,
                   help="replica-axis size (required for --corpus-per-slice query-batch "
                        "sharding to engage)")
    p.add_argument("--corpus-per-slice", action="store_true",
                   help="a full corpus per replica, sharded over its data axis; the "
                        "replicas serve disjoint slices of each query batch")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def note_one_card(args, label: str) -> None:
    """``--mesh auto`` in one process that sees several cards runs on the
    current one: say so, and how to start one rank per card."""
    if (args.mesh == "auto" and torch.device(args.device).type == "cuda"
            and not multihost.is_multiprocess()):
        n_cards = torch.cuda.device_count()
        if n_cards > 1:
            print(f"[{label}] --mesh auto: {n_cards} visible cards, running on one; start "
                  f"one rank per card with torchrun --nproc-per-node {n_cards} ... "
                  f"--multihost pod, or with MFAR_COORDINATOR, MFAR_NUM_PROCESSES and "
                  f"MFAR_PROCESS_ID ... --multihost force", flush=True)


def requested_mesh(args, label: str):
    """The serving mesh the flags ask for: over every rank under ``--mesh
    auto`` when the world holds several, else None (one device).  A forced
    K1 gather (``--use-pallas-gather on``) serves on one device, as in the
    JAX package."""
    from mfar_tpu_torch.parallel.mesh import mesh_from_flag

    mesh = None
    if getattr(args, "use_pallas_gather", "auto") != "on":
        mesh = mesh_from_flag(args.mesh, label, n_model=args.n_model, n_replica=args.n_replica)
    if mesh is None:
        note_one_card(args, label)
    return mesh


def build_engine(args, label: str = "engine"):
    """Assemble a ready-to-serve RetrievalEngine from the flag block: corpus,
    model or checkpoint, dense matrix (prebuilt or encoded now) and the
    sparse fields' BM25 indices.  ``label`` names the command in its log
    lines."""
    from mfar_tpu_torch.eval.index_build import (
        build_dense_corpus_matrix,
        load_dense_matrix,
        make_encode_fn,
    )
    from mfar_tpu_torch.eval.retrieval import RetrievalEngine
    from mfar_tpu_torch.models import build_encoder
    from mfar_tpu_torch.models.registry import prepare_model

    use_pallas_gather = {"on": True, "off": False}.get(args.use_pallas_gather, "auto")
    RetrievalEngine.check_gather_flags(use_pallas_gather, args.pallas_cross_row)
    mesh = requested_mesh(args, label)
    resolve_data_dirs(args)
    field_info = resolve_fields(args.field_names, args.dataset_name)
    corpus = load_corpus(args.corpus, args.dataset_name)
    config, state, tokenizer = prepare_model(
        args.model_name, normalize=args.normalize,
        corpus_texts=corpus_texts_for_vocab(corpus, field_info)
        if args.model_name.startswith("synthetic") else None,
    )
    mixer_params = {"weight": np.ones((1, len(field_info)), np.float32)}
    if args.checkpoint_dir:
        state, mixer_params = load_checkpoint_weights(args.checkpoint_dir, field_info)
    encoder = build_encoder(config)
    encoder.load_state_dict(state)
    encode = make_encode_fn(encoder, device=args.device, mesh=mesh)

    dense_fields = {k: f for k, f in field_info.items() if f.is_dense}
    if args.dense_index:
        matrix, keys = load_dense_matrix(args.dense_index)
        if keys != list(corpus.keys()):
            raise ValueError("dense index keys do not match the corpus")
    else:
        matrix = build_dense_corpus_matrix(encode, tokenizer, corpus, dense_fields)

    return RetrievalEngine(
        field_info=field_info,
        doc_keys=list(corpus.keys()),
        encode_fn=encode,
        tokenizer=tokenizer,
        mixer_params=mixer_params,
        dense_matrix=matrix if matrix.size else None,
        sparse_indices=load_or_build_sparse_indices(corpus, field_info, args.lexical_index),
        recall_k=args.recall_k,
        use_pallas_gather=use_pallas_gather,
        mode=args.mode,
        dense_topk=args.dense_topk,
        quantize=args.quantize,
        corpus_on_host=args.corpus_on_host,
        # int8 quantizes the f32 matrix itself
        dense_dtype=torch.bfloat16 if args.dense_dtype == "bf16" and not args.quantize
        else None,
        device=args.device,
        mesh=mesh,
        corpus_per_slice=args.corpus_per_slice,
        pallas_cross_row=args.pallas_cross_row,
    )


def load_checkpoint_weights(
    checkpoint_dir: str, field_info: Dict[str, Field]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The best checkpoint of a train run's ``--out`` (``best.txt``): its
    encoder state_dict and mixer params, after checking that it was trained
    on these fields."""
    best_dir = read_best_dir(checkpoint_dir)
    check_field_compatibility(best_dir, field_info)
    model_state = load_model_state(best_dir)
    encoder = {k[len("encoder."):]: v for k, v in model_state.items()
               if k.startswith("encoder.")}
    return encoder, {"weight": model_state["mixer.weight"]}


def load_negative_sampler_index(
    corpus: Corpus, lexical_index: Optional[str], dataset_name: str
) -> BM25Index:
    """The whole-document BM25 index used for hard-negative mining: loaded
    from ``--lexical-index`` when it holds one, else built in memory."""
    path = lexical_index and os.path.join(lexical_index, "single_sparse_sparse_index")
    if path and os.path.isdir(path):
        return BM25Index.load(path)
    pairs = format_documents(corpus.pairs(), "single", dataset_name)
    return BM25Index.create(pairs, name="single")
