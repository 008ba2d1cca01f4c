"""Precompute per-field BM25 scores for training queries.

Counterpart of ``mfar_tpu/commands/precompute_sparse_scores.py`` (reference:
mfar/commands/precompute_bm25s_scores.py:33-87): the candidate doc pool is
the union of train positives and the top-``--n-retrieve`` whole-document
BM25 retrievals per train query; for each sparse field the nonzero scores
restricted to that pool are saved as int32 (qid, doc_id) key pairs +
float16 values ``.npy`` files, the artifact ``train --sparse-scores-path``
reads:

    python -m mfar_tpu_torch.commands.precompute_sparse_scores --data-path DIR \\
        --dataset-name mag --corpus-path DIR --index-path IDX --output-path SCORES
"""

from __future__ import annotations

import argparse
import os

from mfar_tpu_torch.commands.common import normalize_argv
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.data.types import FieldType
from mfar_tpu_torch.sparse.bm25 import BM25Index
from mfar_tpu_torch.train.sparse_cache import save_field_scores


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True, help="directory with train.queries / train.qrels")
    p.add_argument("--dataset-name", required=True)
    p.add_argument("--corpus-path", required=True, help="directory with the corpus tsv")
    p.add_argument("--output-path", required=True)
    p.add_argument("--index-path", required=True, help="dir with single_sparse_sparse_index")
    p.add_argument("--fields-str", default="all_sparse,single_sparse")
    p.add_argument("--n-retrieve", type=int, default=150)
    args = p.parse_args(normalize_argv(argv))

    fields = resolve_fields(args.fields_str, args.dataset_name)
    if any(f.field_type == FieldType.DENSE for f in fields.values()):
        raise ValueError("Dense fields are not supported in this script.")

    corpus = list(trec.read_corpus(f"{args.corpus_path}/corpus"))
    train_queries = trec.read_queries(os.path.join(args.data_path, "train.queries"))
    pos_docs = {
        r.doc_id for r in trec.QRels.from_file(os.path.join(args.data_path, "train.qrels"))
    }
    print(f"Loaded {len(train_queries)} queries, {len(pos_docs)} positive docs")

    neg_index = BM25Index.load(f"{args.index_path}/single_sparse_sparse_index")
    retrieved = neg_index.retrieve_batch(list(train_queries.values()), top_k=args.n_retrieve)
    candidate_keys = set(pos_docs)
    for hits in retrieved:
        candidate_keys.update(key for key, _ in hits)
    print(f"Candidate pool: {len(candidate_keys)} docs")

    os.makedirs(args.output_path, exist_ok=True)
    for field_key, field in fields.items():
        index = BM25Index.create(format_documents(corpus, field.name, field.dataset),
                                 name=field.name)
        index.set_safe_docs({index.key_to_id[k] for k in candidate_keys if k in index.key_to_id})
        print(f"Working on {field_key}...")
        scores = {}
        skipped = []
        for qid, text in train_queries.items():
            if not qid.isdigit():
                # the artifact keys queries by int id; the trainer scores
                # such queries live
                skipped.append(qid)
                continue
            # an all-zero query is still present (an empty row): the trainer
            # takes the cache only when it covers every query of a batch
            scores[int(qid)] = index.get_scores_sparse(text)
        if skipped:
            print(f"  {len(skipped)} non-numeric query ids not cacheable "
                  f"(e.g. {skipped[0]!r}); they will score live at train time")
        save_field_scores(args.output_path, field_key, scores)
        n = sum(len(v) for v in scores.values())
        print(f"{n} scores written to {args.output_path}/{field_key}_*_bm25.npy")


if __name__ == "__main__":
    main()
