"""Generate a deterministic synthetic dataset in the reference on-disk layout.

Counterpart of ``mfar_tpu/commands/make_synth_data.py``: a schema-shaped
semi-structured corpus (amazon / mag / prime / whatsthatbook) with
lexically-grounded queries, written as ``corpus`` +
``{train,val,test}.queries`` / ``.qrels``, byte for byte the JAX command's
on the same seed:

    python -m mfar_tpu_torch.commands.make_synth_data --out DIR \\
        --dataset-name mag --n-docs 200
"""

from __future__ import annotations

import argparse

from mfar_tpu_torch.commands.common import normalize_argv


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--dataset-name", default="amazon",
                   choices=["amazon", "mag", "prime", "whatsthatbook"])
    p.add_argument("--n-docs", type=int, default=200)
    p.add_argument("--n-train", type=int, default=50)
    p.add_argument("--n-val", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(normalize_argv(argv))

    from mfar_tpu_torch.data.synth import make_corpus, write_dataset_dir

    corpus = make_corpus(args.dataset_name, args.n_docs, seed=args.seed)
    splits = write_dataset_dir(args.out, corpus, n_train=args.n_train, n_val=args.n_val,
                               seed=args.seed + 1)
    print(f"Wrote {args.n_docs} docs to {args.out}; splits: "
          + ", ".join(f"{k}={len(v)}" for k, v in splits.items()))


if __name__ == "__main__":
    main()
