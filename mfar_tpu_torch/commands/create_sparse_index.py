"""Build per-field BM25 indices on disk.

Counterpart of ``mfar_tpu/commands/create_sparse_index.py`` (reference:
mfar/commands/create_bm25s_index.py:11-24): for each selected sparse field,
format documents and save the index to
``{output_path}/{field_key}_sparse_index``, in the JAX package's layout
(``native.bin`` from the native engine, else ``impacts.npz``, beside
``meta.json``).  ``train``/``retrieve``/``mask_fields --lexical-index``
read the directory:

    python -m mfar_tpu_torch.commands.create_sparse_index --data-path DIR \\
        --dataset-name mag --output-path IDX
"""

from __future__ import annotations

import argparse

from mfar_tpu_torch.commands.common import normalize_argv
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.sparse.bm25 import BM25Index


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True, help="directory containing the corpus tsv")
    p.add_argument("--dataset-name", required=True)
    p.add_argument("--output-path", required=True)
    p.add_argument("--fields-str", default="all_sparse,single_sparse")
    args = p.parse_args(normalize_argv(argv))

    fields = resolve_fields(args.fields_str, args.dataset_name)
    corpus = list(trec.read_corpus(f"{args.data_path}/corpus"))
    for field_key, field in fields.items():
        index = BM25Index.create(format_documents(corpus, field.name, field.dataset),
                                 name=field.name)
        index.save(f"{args.output_path}/{field_key}_sparse_index")
        print(f"built {field_key}: {len(index.keys)} docs, vocab {index.vocab_size}")


if __name__ == "__main__":
    main()
