"""Per-field token-length percentiles over a corpus, where the schema's
token budgets come from; prints the same rows as ``scripts/corpus_stats.py``:

    python -m mfar_tpu_torch.scripts.corpus_stats --corpus DS \\
        --dataset-name amazon --field-names all_dense [--tokenizer whitespace|DIR]

``--tokenizer`` is ``whitespace`` or a local model directory holding a
``tokenizer.json`` (no hub download); its count is the unpadded,
untruncated ids of each text, special tokens included.
"""

from __future__ import annotations

import argparse

import numpy as np

from mfar_tpu_torch.data import trec
from mfar_tpu_torch.data.format import format_documents
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.models.registry import load_tokenizer

PERCENTILES = [100.0, 99.9, 99.0, 95.0, 90.0, 75.0, 50.0]


def token_counter(name: str):
    """``text -> number of tokens`` for ``whitespace`` or a local directory
    (any other name raises the registry's ``FileNotFoundError``)."""
    if name == "whitespace":
        return lambda text: len(text.split())
    t = load_tokenizer(name, 1 << 20).tokenizer
    t.no_truncation()
    t.no_padding()
    return lambda text: len(t.encode(text).ids)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", required=True, help="directory containing the corpus tsv")
    p.add_argument("--dataset-name", required=True)
    p.add_argument("--field-names", required=True)
    p.add_argument("--tokenizer", default="whitespace",
                   help="whitespace | a local directory with a tokenizer.json")
    args = p.parse_args(argv)

    field_info = resolve_fields(args.field_names, args.dataset_name)
    pairs = list(trec.read_corpus(f"{args.corpus}/corpus"))
    count = token_counter(args.tokenizer)

    print("field," + ",".join(f"p{p_}" for p_ in PERCENTILES))
    seen_names = set()
    for field in field_info.values():
        if field.name in seen_names:
            continue
        seen_names.add(field.name)
        lengths = [
            count(text) for _, text in format_documents(pairs, field.name, field.dataset)
        ]
        row = [
            int(np.ceil(np.percentile(lengths, p_))) if lengths else 0
            for p_ in PERCENTILES
        ]
        print(f"{field.name}," + ",".join(map(str, row)))
    print(f"{len(pairs)} documents")


if __name__ == "__main__":
    main()
