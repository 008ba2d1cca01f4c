"""One rank of a gloo world for ``tests/test_torch_parallel.py``.

    python tests/torch_mesh_worker.py RANK WORLD INIT_FILE SPEC OUT_DIR

Every rank rebuilds the same inputs from ``SPEC`` (a ``torch.save`` of numpy
arrays and the encoder's state), joins the world through ``file://INIT_FILE``
and runs every check of the port's mesh once: the routes of
``mfar_tpu_torch.parallel.topk`` on a flat mesh (data = W) and a sliced one
(replica = 2), the index build split over the ranks, and the engine's exact
and rerank routes, dense and hybrid, with a corpus over every rank and one
per slice, on the device in f32 or int8 or in host memory (bf16, int8).  Each rank writes what it computed to ``OUT_DIR/rank<R>.pt``; the
test holds rank 0's against the JAX package and every rank's against rank
0's.  Imports nothing of JAX.
"""

import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


# the engine's corpus placements, by case-name prefix
PLACEMENTS = {None: {}, "int8": dict(quantize="int8"),
              "host": dict(corpus_on_host=True, dense_dtype=torch.bfloat16),
              "host_int8": dict(corpus_on_host=True, quantize="int8")}


def keyed(results):
    return [[(k, float(s)) for k, s in hits] for hits in results]


def block(x, mesh, axes, n=None):
    """This rank's row block of ``x`` (its first ``n`` rows), zero-padded
    past the corpus, as the engine places it."""
    from mfar_tpu_torch.parallel.mesh import shard_rows

    x = x[:n] if n is not None else x
    offset, shard_n = shard_rows(x.shape[0], mesh, axes)
    pad = [0, 0] * (x.ndim - 1) + [0, shard_n * mesh.size(axes) - x.shape[0]]
    return torch.nn.functional.pad(x, pad)[offset : offset + shard_n]


def host_rows(x, mesh, axes, n=None):
    """This rank's real rows of ``x`` (its first ``n`` rows): what a rank of
    a host-streamed corpus holds."""
    from mfar_tpu_torch.parallel.topk import block_rows

    x = x[:n] if n is not None else x
    offset, rows = block_rows(x.shape[0], mesh, axes)
    return x[offset : offset + rows]


def run_routes(spec, mesh, tag, out):
    """Every route of parallel/topk.py on this mesh, on the spec's arrays."""
    from mfar_tpu_torch.parallel import topk
    from mfar_tpu_torch.parallel.mesh import batch_axes

    r = {k: torch.from_numpy(v) for k, v in spec["routes"].items()}
    n, k, f = r["docs"].shape[0], int(spec["k"]), int(spec["num_fields"])
    axes = batch_axes(mesh)
    docs = block(r["docs"], mesh, axes)
    kw = dict(axis=axes, chunk_size=int(spec["chunk"]))
    out[f"{tag}/dense"] = topk.distributed_dense_topk(mesh, r["qflat"], docs, n, k, **kw)
    out[f"{tag}/hybrid"] = topk.distributed_hybrid_topk(mesh, r["qflat"], docs,
                                                        r["sparse"].numpy(), n, k, **kw)
    out[f"{tag}/fused_dense"] = topk.distributed_fused_dense_topk(
        mesh, r["q"], r["W"], r["mask"], docs, n, f, k, **kw)
    out[f"{tag}/fused_hybrid"] = topk.distributed_fused_hybrid_topk_postings(
        mesh, r["q"], r["Wh"], r["maskh"], docs, r["ids"], r["vals"], r["fidx"], n, f, k,
        **kw)
    out[f"{tag}/per_field"] = topk.distributed_per_field_topk(
        mesh, r["q"], docs, n, f, k, **kw)
    out[f"{tag}/cand"] = topk.distributed_candidate_scores(
        mesh, r["q"], docs, r["cand"], f, axis=axes)
    out[f"{tag}/hybrid_postings"] = topk.distributed_hybrid_topk_postings(
        mesh, r["qflat"], docs, r["ids"], r["vals"], n, k, **kw)
    dq, ds = block(r["docs_q"], mesh, axes), block(r["doc_scales"], mesh, axes)
    out[f"{tag}/int8_dense"] = topk.distributed_dense_topk_int8(mesh, r["qflat"], dq, ds, n, k,
                                                                **kw)
    out[f"{tag}/int8_hybrid"] = topk.distributed_hybrid_topk_int8(
        mesh, r["qflat"], dq, ds, r["sparse"].numpy(), n, k, **kw)
    out[f"{tag}/int8_hybrid_postings"] = topk.distributed_hybrid_topk_postings_int8(
        mesh, r["qflat"], dq, ds, r["ids"], r["vals"], n, k, **kw)
    out[f"{tag}/int8_fused_hybrid"] = topk.distributed_fused_hybrid_topk_postings_int8(
        mesh, r["q"], r["Wh"], r["maskh"], dq, ds, r["ids"], r["vals"], r["fidx"], n, f, k,
        **kw)
    out[f"{tag}/int8_cand"] = topk.distributed_candidate_scores_int8(
        mesh, r["q"], dq, ds, r["cand"], f, axis=axes)
    # the host streams, in chunks of `chunk` rows of each rank's rows
    hd, hq, hs = (host_rows(r[a], mesh, axes) for a in ("docs", "docs_q", "doc_scales"))
    out[f"{tag}/stream_dense"] = topk.distributed_dense_topk_host_streamed(
        mesh, r["qflat"], hd, n, k, **kw)
    out[f"{tag}/stream_hybrid_postings"] = topk.distributed_hybrid_topk_host_streamed(
        mesh, r["qflat"], hd, n, k, post_ids=r["ids"], post_wvals=r["vals"], **kw)
    out[f"{tag}/stream_hybrid"] = topk.distributed_hybrid_topk_host_streamed(
        mesh, r["qflat"], hd, n, k, sparse_comb_host=r["sparse"].numpy(), **kw)
    out[f"{tag}/stream_int8_dense"] = topk.distributed_dense_topk_host_streamed_int8(
        mesh, r["qflat"], hq, hs, n, k, **kw)
    out[f"{tag}/stream_int8_hybrid_postings"] = topk.distributed_hybrid_topk_host_streamed_int8(
        mesh, r["qflat"], hq, hs, n, k, post_ids=r["ids"], post_wvals=r["vals"], **kw)
    out[f"{tag}/stream_int8_hybrid"] = topk.distributed_hybrid_topk_host_streamed_int8(
        mesh, r["qflat"], hq, hs, n, k, sparse_comb_host=r["sparse"].numpy(), **kw)
    # five rows over the ranks: at W = 4 the last block holds padding only
    tiny = int(spec["tiny"])
    out[f"{tag}/tiny_int8_dense"] = topk.distributed_dense_topk_int8(
        mesh, r["qflat"], block(r["docs_q"], mesh, axes, tiny),
        block(r["doc_scales"], mesh, axes, tiny), tiny, k, **kw)
    out[f"{tag}/tiny_stream_dense"] = topk.distributed_dense_topk_host_streamed(
        mesh, r["qflat"], host_rows(r["docs"], mesh, axes, tiny), tiny, k, **kw)
    if mesh.shape["replica"] > 1:
        # a corpus per slice: rows over data only, replicas split the batch
        docs = block(r["docs"], mesh, ("data",))
        kw = dict(axis=("data",), query_axis="replica", chunk_size=int(spec["chunk"]))
        out[f"{tag}/slice_fused_dense"] = topk.distributed_fused_dense_topk(
            mesh, r["q"], r["W"], r["mask"], docs, n, f, k, **kw)
        out[f"{tag}/slice_cand"] = topk.distributed_candidate_scores(
            mesh, r["q"], docs, r["cand"], f, axis=("data",), query_axis="replica")
        dq, ds = block(r["docs_q"], mesh, ("data",)), block(r["doc_scales"], mesh, ("data",))
        out[f"{tag}/slice_int8_fused_hybrid"] = topk.distributed_fused_hybrid_topk_postings_int8(
            mesh, r["q"], r["Wh"], r["maskh"], dq, ds, r["ids"], r["vals"], r["fidx"], n, f, k,
            **kw)
        out[f"{tag}/slice_int8_cand"] = topk.distributed_candidate_scores_int8(
            mesh, r["q"], dq, ds, r["cand"], f, axis=("data",), query_axis="replica")
        out[f"{tag}/slice_stream_hybrid_postings"] = topk.distributed_hybrid_topk_host_streamed(
            mesh, r["qflat"], host_rows(r["docs"], mesh, ("data",)), n, k, post_ids=r["ids"],
            post_wvals=r["vals"], **kw)


def run_engines(spec, flat, sliced, out):
    """The index build over the ranks, then the engine's routes."""
    from mfar_tpu_torch.data.format import format_documents
    from mfar_tpu_torch.data.schema import resolve_fields
    from mfar_tpu_torch.data.synth import make_amazon_corpus
    from mfar_tpu_torch.eval.index_build import build_dense_corpus_matrix, make_encode_fn
    from mfar_tpu_torch.eval.retrieval import RetrievalEngine
    from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig
    from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
    from mfar_tpu_torch.sparse.bm25 import BM25Index

    corpus = make_amazon_corpus(int(spec["n_docs"]))
    tok = SimpleVocabTokenizer.build(spec["vocab_texts"], max_length=64)
    encoder = Encoder(EncoderConfig(**spec["encoder_config"]))
    encoder.load_state_dict(spec["encoder_state"])
    encode = make_encode_fn(encoder, device="cpu", mesh=flat)
    dense_fi = resolve_fields(spec["dense"], "amazon")
    matrix = build_dense_corpus_matrix(encode, tok, corpus, dense_fi, batch_size=16)
    out["matrix"] = matrix
    pairs = list(corpus.pairs())

    def engine(fields, mesh, mixer, placement=None, **kw):
        fi = resolve_fields(fields, "amazon")
        sparse = {fk: BM25Index.create(format_documents(pairs, f.name, "amazon"),
                                       name=f.name, backend="scipy")
                  for fk, f in fi.items() if f.is_sparse}
        return RetrievalEngine(
            field_info=fi, doc_keys=list(corpus.keys()), encode_fn=encode, tokenizer=tok,
            mixer_params={"weight": mixer}, dense_matrix=matrix, sparse_indices=sparse,
            query_max_length=64, recall_k=10, mesh=mesh, device="cpu",
            **PLACEMENTS[placement], **kw)

    queries, dense_q = spec["queries"], spec["dense_postings"]
    dense = engine(spec["dense"], flat, spec["mixer_dense"])
    hybrid = engine(spec["hybrid"], flat, spec["mixer_hybrid"])
    per_slice = engine(spec["hybrid"], sliced, spec["mixer_hybrid"], corpus_per_slice=True)
    cases = [
        ("dense_exact", dense, queries, "exact"),
        ("dense_rerank", dense, queries, "rerank"),
        ("hybrid_postings", hybrid, queries, "exact"),
        ("hybrid_combined", hybrid, dense_q, "exact"),
        ("hybrid_rerank", hybrid, queries, "rerank"),
        ("slice_postings", per_slice, queries, "exact"),
        ("slice_rerank", per_slice, queries, "rerank"),
    ]
    # int8 on the cards, and a corpus in host memory (bf16, int8): each
    # placement's dense and hybrid engines, exact and rerank
    for placement in ("int8", "host", "host_int8"):
        d, h = (engine(spec[fields], flat, spec[f"mixer_{fields}"], placement)
                for fields in ("dense", "hybrid"))
        cases += [(f"{placement}_dense_exact", d, queries, "exact"),
                  (f"{placement}_hybrid_postings", h, queries, "exact"),
                  (f"{placement}_hybrid_combined", h, dense_q, "exact"),
                  (f"{placement}_rerank", d if placement == "host_int8" else h, queries,
                   "rerank")]
    for name, eng, qs, mode in cases:
        got = eng.retrieve_many(qs, top_k=10, mode=mode, batch_size=4)
        out[f"engine/{name}"] = (keyed(got), eng.last_serve_path)


def main() -> None:
    rank, world, init_file, spec_path, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=100))
    from mfar_tpu_torch.parallel.mesh import make_mesh

    spec = torch.load(spec_path, weights_only=False)
    flat = make_mesh()
    sliced = make_mesh(n_replica=2)
    out = {"shapes": (flat.shape, sliced.shape)}
    run_routes(spec, flat, "flat", out)
    run_routes(spec, sliced, "sliced", out)
    run_engines(spec, flat, sliced, out)
    out["modules"] = sorted(sys.modules)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
