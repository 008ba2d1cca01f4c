"""Shared CLI bootstrap for the port: corpus + model + dense index from flags.

Counterpart of ``mfar_tpu/commands/common.py`` for the dense single-device
engine and the trainer.  ``--checkpoint-dir`` reads the port's own
checkpoints (:mod:`mfar_tpu_torch.train.checkpoint`; the JAX package's are
orbax, ROADMAP A10).  Not here yet: the mesh flags (A15) and sparse indices
(A8).
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
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.data.types import Corpus, Field
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


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The dense serving-engine flags (names as in the JAX package)."""
    p.add_argument("--model-name", default="facebook/contriever-msmarco",
                   help="synthetic[:vocab[:hidden]] or a local HF BERT directory")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a train run's --out: serve its best checkpoint's encoder "
                        "and mixer (the port's checkpoints)")
    p.add_argument("--dense-index", default=None, help="prebuilt .npz/.npy from encode_corpus")
    p.add_argument("--recall-k", type=int, default=100)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--use-pallas-gather", nargs="?", const="on", default="auto",
                   choices=["auto", "on", "off"],
                   help="rerank stage-2 gather through the CUDA kernel K1. auto "
                        "(default): K1 on the card (raising on a corpus it "
                        "cannot read); on: always; off: the plain gather")
    p.add_argument("--dense-topk", default="exact", choices=["exact", "approx"],
                   help="accepted for the JAX flag set; selection is exact here")
    p.add_argument("--dense-dtype", default="bf16", choices=["bf16", "f32"],
                   help="device dtype of the corpus matrix (bf16 halves its memory)")
    p.add_argument("--mode", default="auto", choices=["auto", "exact", "rerank"],
                   help="exact (the default) scores the full corpus; rerank is "
                        "the reference-compatible recall+rerank pipeline")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def build_engine(args):
    """Assemble a ready-to-serve RetrievalEngine from the flag block."""
    from mfar_tpu_torch.eval.index_build import (
        build_dense_corpus_matrix,
        load_dense_matrix,
        make_encode_fn,
    )
    from mfar_tpu_torch.eval.retrieval import RetrievalEngine
    from mfar_tpu_torch.models.encoder import Encoder
    from mfar_tpu_torch.models.registry import prepare_model

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
    encoder = Encoder(config)
    encoder.load_state_dict(state)
    encode = make_encode_fn(encoder, device=args.device)

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
        recall_k=args.recall_k,
        use_pallas_gather={"on": True, "off": False}.get(args.use_pallas_gather, "auto"),
        mode=args.mode,
        dense_topk=args.dense_topk,
        dense_dtype=torch.bfloat16 if args.dense_dtype == "bf16" else None,
        device=args.device,
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
