"""Download STaRK QA pairs into {partition}.queries / {partition}.qrels.

Counterpart of ``mfar_tpu/commands/stark/download_queries.py``, writing the
same bytes: the train, val, test and test-0.1 partitions; ``--max-docs``
keeps the answer ids below it, for a corpus cut to its first documents, and
a query left with no answer is dropped; an empty train partition raises:

    python -m mfar_tpu_torch.commands.stark.download_queries \\
        --dataset-name mag --out DIR [--max-docs N]

Requires the ``stark_qa`` package and a network; without them use
``mfar_tpu_torch.commands.make_synth_data``.
"""

from __future__ import annotations

import argparse
import json
import os

from mfar_tpu_torch.commands.common import normalize_argv
from mfar_tpu_torch.commands.stark.stark_to_trec import NO_STARK_QA
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.utils.jsonutil import remove_irregularities

PARTITIONS = ["train", "val", "test", "test-0.1"]


def download(dataset_name: str, out: str, max_docs=None) -> None:
    try:
        from stark_qa import load_qa
    except ImportError as e:
        raise SystemExit(NO_STARK_QA) from e

    # coerced once, before any file is written: a bad value fails here, and
    # 0 is falsy (no filtering) as -1 is
    max_docs = None if max_docs is None else int(max_docs)
    if max_docs == -1:
        max_docs = None
    qa = load_qa(name=dataset_name)
    os.makedirs(out, exist_ok=True)
    for partition in PARTITIONS:
        indices = qa.split_indices[partition].tolist()
        n_q = n_a = 0
        with open(os.path.join(out, f"{partition}.queries"), "w") as fq, open(
            os.path.join(out, f"{partition}.qrels"), "w"
        ) as fr:
            for idx in indices:
                row = qa.data.iloc[idx]
                if row.id != idx:
                    raise ValueError(f"row {idx} of the QA table has id {row.id}")
                query = remove_irregularities(row.query)
                answer_ids = set(json.loads(row.answer_ids))
                if max_docs:
                    answer_ids = {a for a in answer_ids if a < max_docs}
                if answer_ids:
                    print(f"{idx}\t{query}", file=fq)
                    n_q += 1
                for a in answer_ids:
                    print(trec.QRels(str(idx), str(a), 1.0), file=fr)
                    n_a += 1
        print(f"Partition {partition}: {n_q} queries, {n_a} judgements")
        if n_q == 0 and partition == "train":
            raise ValueError(f"Partition {partition} has no queries.")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset-name", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-docs", default=None)
    args = p.parse_args(normalize_argv(argv))
    download(args.dataset_name, args.out, args.max_docs)


if __name__ == "__main__":
    main()
