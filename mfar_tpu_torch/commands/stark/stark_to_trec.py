"""Convert a STaRK semi-structured knowledge base to the corpus tsv format.

Counterpart of ``mfar_tpu/commands/stark/stark_to_trec.py``, writing the
same bytes: walk the SKB graph, attach the configured edge neighbourhoods per
dataset (the two-hop author -> institution join for MAG, per-node-type
grouping for Prime) and emit one ``id\\tjson`` line per candidate document:

    python -m mfar_tpu_torch.commands.stark.stark_to_trec \\
        --dataset-name mag --out DIR [--max-docs N]

Requires the ``stark_qa`` package and a network to download the knowledge
base; without them use ``mfar_tpu_torch.commands.make_synth_data``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from mfar_tpu_torch.commands.common import normalize_argv
from mfar_tpu_torch.utils.jsonutil import remove_irregularities

# dataset -> {edge type: neighbour attribute used as its text}
EDGE_FIELD_DICTS: Dict[str, Dict[str, str]] = {
    "amazon": {"also_buy": "title", "also_view": "title"},
    "mag": {
        "paper___cites___paper": "title",
        "author___writes___paper": "DisplayName",
        "paper___has_topic___field_of_study": "DisplayName",
        "author___affiliated_with___institution": "DisplayName",
    },
    "prime": {
        rel: "name"
        for rel in [
            "ppi", "carrier", "enzyme", "target", "transporter",
            "contraindication", "indication", "off-label use",
            "synergistic interaction", "associated with", "parent-child",
            "phenotype absent", "phenotype present", "side effect",
            "interacts with", "linked to", "expression present",
            "expression absent",
        ]
    },
}

NO_STARK_QA = ("stark_qa is not installed (it downloads the knowledge base over the "
               "network). Use python -m mfar_tpu_torch.commands.make_synth_data for an "
               "offline dataset.")


def convert(dataset_name: str, out: str, max_docs: int = -1) -> None:
    try:
        from stark_qa import load_skb
    except ImportError as e:
        raise SystemExit(NO_STARK_QA) from e

    fields = EDGE_FIELD_DICTS[dataset_name]
    skb = load_skb(name=dataset_name, download_processed=True)
    indices: List[int] = skb.candidate_ids
    if max_docs != -1:
        indices = indices[:max_docs]
    os.makedirs(out, exist_ok=True)

    # Only MAG asks for one node's neighbours again (authors shared across
    # papers); elsewhere a cache would pin every neighbour list for no hit.
    neighbor_cache: Optional[Dict] = {} if dataset_name == "mag" else None

    def neighbors_of(idx, edge_type):
        if neighbor_cache is None:
            return skb.get_neighbor_nodes(idx, edge_type)
        key = (idx, edge_type)
        if key not in neighbor_cache:
            neighbor_cache[key] = skb.get_neighbor_nodes(idx, edge_type)
        return neighbor_cache[key]

    def attr_text(node, edge_type):
        return skb.node_info[node][fields[edge_type]]

    lines = []
    for idx in indices:
        node_info = skb.node_info[idx]
        edge_info: Dict = {}
        for edge_type in skb.edge_type_dict.values():
            if edge_type not in fields and edge_type != "author___writes___paper":
                continue
            if edge_type == "author___writes___paper" and dataset_name == "mag":
                # Two-hop author -> institution join: the author-name list is
                # emitted too, each author keeps only its LAST institution,
                # and authors without one are left out of the join.
                authors = neighbors_of(idx, edge_type)
                edge_info[edge_type] = [
                    name for name in (
                        skb.node_info[a][fields[edge_type]] for a in authors
                    ) if name not in (-1, "-1")
                ]
                joined = {}
                for author in authors:
                    name = skb.node_info[author][fields[edge_type]]
                    if name in (-1, "-1"):
                        continue
                    insts = neighbors_of(author, "author___affiliated_with___institution")
                    if len(insts):
                        joined[name] = [
                            attr_text(insts[-1], "author___affiliated_with___institution")
                        ]
                edge_info["author___affiliated_with___institution"] = joined
            elif edge_type in fields:
                neigh = neighbors_of(idx, edge_type)
                if dataset_name == "prime":
                    # neighbour texts grouped by node type; a relation with no
                    # neighbours is absent (an empty dict would format as a
                    # spurious 'relation: {}' line in every document)
                    grouped: Dict[str, List] = {}
                    for n, ntype in zip(neigh, skb.node_types[neigh].tolist()):
                        grouped.setdefault(skb.node_type_dict[ntype], []).append(
                            attr_text(n, edge_type)
                        )
                    if grouped:
                        edge_info[edge_type] = grouped
                else:
                    texts = (attr_text(n, edge_type) for n in neigh)
                    edge_info[edge_type] = [t for t in texts if t not in (-1, "-1")]
        doc = remove_irregularities({**node_info, **edge_info})
        lines.append(f"{idx}\t{json.dumps(doc, ensure_ascii=False)}")

    with open(os.path.join(out, "corpus"), "w") as f:
        f.write("\n".join(lines))
    print(f"Corpus {dataset_name} has {len(indices)} documents.")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset-name", required=True, choices=list(EDGE_FIELD_DICTS))
    p.add_argument("--out", required=True)
    p.add_argument("--max-docs", type=int, default=-1)
    args = p.parse_args(normalize_argv(argv))
    convert(args.dataset_name, args.out, args.max_docs)


if __name__ == "__main__":
    main()
