"""Encode the corpus into the per-field dense index matrix on disk.

Counterpart of ``mfar_tpu/commands/encode_corpus.py`` on one device: the
``[N, Fd, E]`` matrix is built once so serving (``retrieve --dense-index``)
starts without re-encoding.

    python -m mfar_tpu_torch.commands.encode_corpus --dataset-name mag \\
        --data DIR --out index.npz [--device cpu] [--model-name DIR]

``--out x.npz`` writes one self-contained file; ``--out x.npy`` streams the
build into a memory-mapped ``.npy`` (host memory stays at a few batches)
plus an ``x.npy.keys`` sidecar.  Either package reads the other's files.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mfar_tpu_torch.commands.common import (
    add_data_args,
    corpus_texts_for_vocab,
    load_checkpoint_weights,
    load_corpus,
    normalize_argv,
    resolve_data_dirs,
)
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval.index_build import (
    build_dense_corpus_matrix,
    make_encode_fn,
    save_dense_matrix,
)
from mfar_tpu_torch.models import build_encoder, encoder_dim
from mfar_tpu_torch.models.registry import prepare_model


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_data_args(p)
    p.add_argument("--out", required=True,
                   help="output path: .npz (default, self-contained) or .npy "
                        "(raw + <out>.keys sidecar; the build streams into the "
                        "file, which serving can memory-map)")
    p.add_argument("--model-name", default="facebook/contriever-msmarco",
                   help="synthetic[:vocab[:hidden]], a local HF BERT or T5 directory, "
                        "t5:<dir>, or a local sentence-transformers GTR directory")
    p.add_argument("--checkpoint-dir", default=None,
                   help="a train run's --out: encode with its best checkpoint's "
                        "encoder (the port's checkpoints)")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--prefix", action="store_true",
                   help="put each field's name in front of its text")
    p.add_argument("--mesh", default="auto", choices=["auto", "off"],
                   help="auto: one device here (several cards are ROADMAP A15)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(normalize_argv(argv))

    if (args.mesh == "auto" and torch.device(args.device).type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            f"--mesh auto with {torch.cuda.device_count()} visible cards: encoding "
            f"over several cards is ROADMAP A15; pass --mesh off or show one card"
        )
    resolve_data_dirs(args)

    field_info = resolve_fields(args.field_names, args.dataset_name)
    dense_fields = {k: f for k, f in field_info.items() if f.is_dense}
    corpus = load_corpus(args.corpus, args.dataset_name)
    config, state, tokenizer = prepare_model(
        args.model_name, normalize=args.normalize,
        corpus_texts=corpus_texts_for_vocab(corpus, field_info)
        if args.model_name.startswith("synthetic") else None,
    )
    if args.checkpoint_dir:
        state, _ = load_checkpoint_weights(args.checkpoint_dir, field_info)
    encoder = build_encoder(config)
    encoder.load_state_dict(state)
    encode = make_encode_fn(encoder, device=args.device)

    out_target = None
    if args.out.endswith(".npy"):
        out_target = np.lib.format.open_memmap(
            args.out, mode="w+", dtype=np.float32,
            shape=(len(corpus), len(dense_fields), encoder_dim(config)),
        )
    matrix = build_dense_corpus_matrix(
        encode, tokenizer, corpus, dense_fields,
        batch_size=args.batch_size, prefix=args.prefix, out=out_target,
    )
    out_path = save_dense_matrix(args.out, matrix, list(corpus.keys()))
    print(f"Encoded {matrix.shape[0]} docs x {matrix.shape[1]} fields x "
          f"{matrix.shape[2]} dims on {args.device} -> {out_path}")


if __name__ == "__main__":
    main()
