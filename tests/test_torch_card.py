"""The port's CUDA kernels and the engine on a card.  Every test here needs a
CUDA device (marker ``cuda``) and skips without one.

This file imports nothing of JAX, so it also runs where only PyTorch is
installed.  On a machine with a card and the CUDA toolkit, from the repo
root (``--noconftest`` because ``tests/conftest.py`` sets JAX up):

    python -m pytest --noconftest tests/test_torch_card.py -q

Tolerance for K1 against its plain version: both multiply the same f32 (or
bf16 upcast to f32) values and sum in f32, in different orders: rtol = atol
= 1e-4.

Tolerance for K2 against its plain version: rtol = atol = 1e-2.  Both round
the output to bf16 (one bf16 ulp is up to 1.6e-2 for outputs in [2, 4)),
and K2 rounds the softmax weights to bf16 for the P.V product (relative
2**-9 per weight) where the plain version stays in f32.

Tolerance for K2b (the backward kernels) against their plain version: rtol
2e-2 and atol 1e-2 of the largest gradient.  The gradients are rounded to
bf16 (2**-8 relative), and the kernels round P and dS to bf16 before
products summed over up to 512 rows, where the plain version stays in f32.

Tolerance for K2's other forwards (the wgmma kernel at another head dim,
the 3xTF32 kernel, either on row maps or on zero-padded copies) and K2b's
other pairs (the wgmma pair at another head dim, the 3xTF32 pair, either
on zero-padded copies) in f32: the output within 2e-5, the logsumexp
within 1e-5, each gradient within 2e-5 of its largest entry (f32-accurate
products on both sides: three TF32 products against f32 matmuls with TF32
off, summed in other orders); in bf16 the K2 and K2b tolerances above.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.eval.index_build import make_encode_fn
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig, init_encoder
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.ops import _build
from mfar_tpu_torch.ops import flash_attention as flash_module
from mfar_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_headdim_dkv,
    flash_attention_bwd_headdim_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_headdim,
    flash_attention_plain,
    flash_attention_rows,
    flash_attention_tf32,
    flash_attention_tf32_bwd_dkv,
    flash_attention_tf32_bwd_dq,
    flash_attention_tf32_rows,
    backward_route,
    forward_route,
    pad_heads,
    _row_dots,
)
from mfar_tpu_torch.ops.scoring import (
    _fold_and_densify,
    _posting_candidates,
    hybrid_topk_host_streamed,
    per_field_candidate_scores,
    rerank_candidates,
)
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.ops.gather_scores import (
    gather_per_field_scores,
    gather_per_field_scores_plain,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

B, N, F, E = 3, 63, 4, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, E)).astype(np.float32)).cuda()
    docs = torch.from_numpy(rng.normal(size=(N, F * E)).astype(np.float32)).cuda().to(dtype)
    ids = torch.from_numpy(rng.integers(0, N, size=(B, c))).cuda()
    ids[0, :4] = 0
    ids[2, -1] = N - 1
    return q, docs, ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 13, 512])
def test_kernel_matches_plain(card, dtype, c):
    q, docs, ids = _inputs(c, dtype)
    before = gather_per_field_scores.launches
    got = gather_per_field_scores(q, docs, ids, F)
    torch.cuda.synchronize()
    assert gather_per_field_scores.launches == before + 1
    want = gather_per_field_scores_plain(q, docs, ids, F)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_out_of_range_ids_score_nan(card):
    q, docs, ids = _inputs(8, torch.float32)
    ids[1, 2] = -1
    ids[1, 5] = N
    got = gather_per_field_scores(q, docs, ids, F).cpu()
    assert torch.isnan(got[1, 2]).all() and torch.isnan(got[1, 5]).all()
    got[1, 2] = got[1, 5] = 0
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 13, 512])
def test_cross_row_kernel_matches_plain_and_k1(card, dtype, c):
    """K1x, the cross-row schedule, against the plain version, and its bits
    against K1's (the same lane assignment, fmaf order and shuffle tree);
    it counts its own launches."""
    q, docs, ids = _inputs(c, dtype)
    before = (gather_per_field_scores.launches, gather_per_field_scores.cross_row_launches)
    got = gather_per_field_scores(q, docs, ids, F, cross_row=True)
    torch.cuda.synchronize()
    assert (gather_per_field_scores.launches,
            gather_per_field_scores.cross_row_launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, gather_per_field_scores_plain(q, docs, ids, F),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got.view(torch.int32),
                       gather_per_field_scores(q, docs, ids, F).view(torch.int32))


def test_cross_row_out_of_range_ids_score_nan(card):
    q, docs, ids = _inputs(8, torch.bfloat16)
    ids[0, 0] = -1
    ids[1, 5] = N
    ids[2, 7] = N + 3
    got = gather_per_field_scores(q, docs, ids, F, cross_row=True).cpu()
    bad = [(0, 0), (1, 5), (2, 7)]
    for i, j in bad:
        assert torch.isnan(got[i, j]).all()
        got[i, j] = 0
    assert torch.isfinite(got).all()


def test_cross_row_refuses_a_row_beyond_shared_memory(card):
    """One warp's two rows and q[b] must fit a block's shared memory."""
    q = torch.zeros(1, 4096, device=card)
    docs = torch.zeros(2, 8 * 4096, device=card)  # 2 x 131072 B f32 rows
    ids = torch.zeros(1, 1, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="K1x"):
        gather_per_field_scores(q, docs, ids, 8, cross_row=True)


def test_misaligned_corpus_raises(card):
    q, docs, ids = _inputs(8, torch.bfloat16)
    flat = torch.empty(N * F * E + 1, dtype=torch.bfloat16, device=card)
    shifted = flat[1:].view(N, F * E)  # starts 2 bytes into the buffer
    shifted.copy_(docs)
    with pytest.raises(ValueError, match="16-byte boundary"):
        gather_per_field_scores(q, shifted, ids, F)


def test_build_is_cached(card):
    for name in _build.SOURCES:
        _build.build(name)
        assert _build.build(name) == ""


def test_engine_rerank_through_k1_matches_plain_gather(card):
    fi = resolve_fields("title_dense,description_dense", "amazon")
    texts = ["red shoe glows", "blue lamp folds", "green table spins", "dark clock sings"]
    tok = SimpleVocabTokenizer.build(texts, max_length=16)
    encode = make_encode_fn(
        init_encoder(EncoderConfig.tiny(vocab_size=tok.vocab_size, hidden_size=128)), device=card
    )
    rng = np.random.default_rng(0)
    kw = dict(field_info=fi, doc_keys=[f"d{i}" for i in range(200)], encode_fn=encode,
              tokenizer=tok, mixer_params={"weight": rng.normal(size=(128, 2)).astype(np.float32)},
              dense_matrix=rng.normal(size=(200, 2, 128)).astype(np.float32), query_max_length=16,
              recall_k=20, dense_dtype=torch.bfloat16)
    k1 = RetrievalEngine(mode="rerank", **kw)
    assert k1.use_gather_kernel and k1.device.type == "cuda"
    plain = RetrievalEngine(mode="rerank", use_pallas_gather=False, **kw)
    before = gather_per_field_scores.launches
    got = k1.retrieve_many(texts * 3, top_k=10, batch_size=4)
    assert gather_per_field_scores.launches == before + 3
    assert k1.last_serve_path == "singlechip-rerank-k1"
    want = plain.retrieve_many(texts * 3, top_k=10, batch_size=4)
    assert plain.last_serve_path == "singlechip-rerank-plain"
    msg = rankings_agree(got, want, 1e-4, 1e-3)
    assert msg is None, msg
    exact = k1.retrieve(texts, top_k=10, mode="exact")
    assert k1.last_serve_path == "singlechip-dense" and [len(h) for h in exact] == [10] * 4

    # the gate ignores the engine's default mode: an exact engine's rerank
    # requests launch K1 as well
    ex = RetrievalEngine(mode="exact", **kw)
    before = gather_per_field_scores.launches
    msg = rankings_agree(ex.retrieve(texts, top_k=10, mode="rerank"), want[:4], 1e-4, 1e-3)
    assert msg is None, msg
    assert gather_per_field_scores.launches == before + 1
    assert ex.last_serve_path == "singlechip-rerank-k1"
    # and "auto" on a CUDA corpus K1 cannot read raises rather than falling back
    with pytest.raises(ValueError, match="K1 gather"):
        RetrievalEngine(mode="rerank", **{**kw, "dense_dtype": torch.float16})

    # pallas_cross_row: stage 2 through K1x, the same lists as through K1
    cross = RetrievalEngine(mode="rerank", pallas_cross_row=True, **kw)
    before = (gather_per_field_scores.launches, gather_per_field_scores.cross_row_launches)
    assert cross.retrieve_many(texts * 3, top_k=10, batch_size=4) == got
    assert (gather_per_field_scores.launches,
            gather_per_field_scores.cross_row_launches) == (before[0], before[1] + 3)
    assert cross.last_serve_path == "singlechip-rerank-k1x"


def test_hybrid_engine_on_the_card_matches_the_cpu(card):
    """Hybrid exact (postings scatter-added with atomics on the card, and
    the combined route) and hybrid rerank through K1 agree with the same
    engine on the CPU, at the engine's tolerance with ties allowed."""
    from mfar_tpu_torch.sparse.bm25 import BM25Index

    fi = resolve_fields("title_dense,title_sparse,description_sparse", "amazon")
    words = [f"w{i}" for i in range(60)]
    rng = np.random.default_rng(0)
    docs = [" ".join(rng.choice(words, size=6)) for _ in range(300)]
    keys = [f"d{i}" for i in range(300)]
    tok = SimpleVocabTokenizer.build(docs, max_length=16)
    enc = init_encoder(EncoderConfig.tiny(vocab_size=tok.vocab_size, hidden_size=128))
    index = {k: BM25Index.create(list(zip(keys, docs[::-1] if "desc" in k else docs)),
                                 backend="scipy") for k in ("title_sparse", "description_sparse")}
    kw = dict(field_info=fi, doc_keys=keys, tokenizer=tok, sparse_indices=index,
              mixer_params={"weight": rng.normal(size=(128, 3)).astype(np.float32)},
              dense_matrix=rng.normal(size=(300, 1, 128)).astype(np.float32),
              query_max_length=16, recall_k=20)
    # each engine its own copy: make_encode_fn moves the module it is given
    gpu = RetrievalEngine(encode_fn=make_encode_fn(copy.deepcopy(enc), device=card), **kw)
    cpu = RetrievalEngine(encode_fn=make_encode_fn(enc, device="cpu"), device="cpu", **kw)
    rare = ["w1 w7", "w3 w50 w9", "w11", "w59 w2"]  # sparse postings
    common = [" ".join(words[:40])] * 4  # postings denser than half the corpus
    for qs, mode, path in ((rare, "exact", "singlechip-hybrid-postings"),
                           (common, "exact", "singlechip-hybrid-combined"),
                           (rare, "rerank", "singlechip-rerank-hybrid-k1")):
        got = gpu.retrieve(qs, top_k=10, mode=mode)
        assert gpu.last_serve_path == path
        msg = rankings_agree(got, cpu.retrieve(qs, top_k=10, mode=mode), 1e-4, 1e-3)
        assert msg is None, (path, msg)


K2_TOL = 1e-2


def _k2_inputs(b, h, s, lengths, seed=0):
    """bf16 q/k/v [B, H, S, 64] on the card and int32 segment ids: 1 for
    the first lengths[i] tokens of row i, 0 for the pad after them."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, 64)).astype(np.float32))
               .cuda().bfloat16() for _ in range(3))
    seg = torch.zeros(b, s, dtype=torch.int32)
    for i, n in enumerate(lengths):
        seg[i, :n] = 1
    return q, k, v, seg.cuda()


# lengths: a full row, 2 valid tokens, and rows whose pad queries meet one
# or more wholly valid (so wholly masked for them) key tiles first
@pytest.mark.parametrize("s,lengths", [(128, [128, 2, 70]), (256, [2, 200, 256, 65, 131])])
def test_k2_matches_plain(card, s, lengths):
    q, k, v, seg = _k2_inputs(len(lengths), 3, s, lengths)
    before = flash_attention.launches
    got = flash_attention(q, k, v, seg, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert got.transpose(1, 2).is_contiguous()  # [B, S, H, D] underneath
    want = flash_attention_plain(q, k, v, seg, 0.125)
    torch.testing.assert_close(got.float(), want.float(), rtol=K2_TOL, atol=K2_TOL)


def test_k2_reads_strided_views(card):
    """q/k/v as the encoder gives them: [B, S, H*D] projections viewed as
    [B, H, S, D], no copy."""
    b, s, h = 2, 128, 4
    rng = np.random.default_rng(3)
    x = [torch.from_numpy(rng.normal(size=(b, s, h * 64)).astype(np.float32)).cuda().bfloat16()
         for _ in range(3)]
    q, k, v = (t.view(b, s, h, 64).transpose(1, 2) for t in x)
    assert not q.is_contiguous()
    seg = torch.ones(b, s, dtype=torch.int32, device=card)
    seg[1, 100:] = 0
    got = flash_attention(q, k, v, seg, 0.125)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), seg, 0.125)
    torch.testing.assert_close(got.float(), want.float(), rtol=K2_TOL, atol=K2_TOL)


def test_k2_refuses_f32_on_the_card(card):
    """(Named when K2 took bf16 only.)  f32 on the card takes the 3xTF32
    kernel, never the bf16 wgmma one, and agrees with the plain version in
    f32."""
    q, k, v, seg = (t.float() if t.is_floating_point() else t
                    for t in _k2_inputs(2, 3, 256, [256, 70]))
    before = (flash_attention.launches, flash_attention_tf32.launches)
    got = flash_attention(q, k, v, seg, 0.125)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_tf32.launches) == \
        (before[0], before[1] + 1)
    assert got.dtype == torch.float32 and got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, seg, 0.125), rtol=0,
                               atol=F32_ATOL)


F32_ATOL, F32_LSE_ATOL, F32_GRAD_REL = 2e-5, 1e-5, 2e-5


def _forward_counts():
    return {"wgmma": flash_attention.launches, "wgmma_headdim": flash_attention_headdim.launches,
            "tf32": flash_attention_tf32.launches, "wgmma_rows": flash_attention_rows.launches,
            "tf32_rows": flash_attention_tf32_rows.launches}


# K2b's pairs (dq, dkv) by backward_route's name
_BWD_PAIRS = {"wgmma": (flash_attention_bwd_dq, flash_attention_bwd_dkv),
              "wgmma_headdim": (flash_attention_bwd_headdim_dq, flash_attention_bwd_headdim_dkv),
              "tf32": (flash_attention_tf32_bwd_dq, flash_attention_tf32_bwd_dkv)}

# each padding route's column multiple: the kernels read 16-byte rows
_PAD_MULTIPLE = {"wgmma_pad": 8, "tf32_pad": 4}


def _padded(route, d):
    """The head dim of a route's inputs to its kernels: D rounded up to the
    padding route's multiple, else D."""
    m = _PAD_MULTIPLE.get(route, 1)
    return -(-d // m) * m


def _backward_counts():
    return {route: (dq.launches, dkv.launches) for route, (dq, dkv) in _BWD_PAIRS.items()}


# the head dim past which a pair runs its wide instances, counted apart
_WIDE_PAST = {"wgmma_headdim": 128, "tf32": 64}


def _wide_counts():
    return {route: (_BWD_PAIRS[route][0].wide_launches, _BWD_PAIRS[route][1].wide_launches)
            for route in _WIDE_PAST}


# Head dims other than 64 in both dtypes: ragged pads and the segment
# layouts, strided dO; the forward on its route (the wgmma kernel at
# another head dim in bf16, the 3xTF32 kernel in f32), the backward on its
# pair through flash_attention_bwd (the wgmma pair at another head dim in
# bf16, past D = 128 in its wide shape; the 3xTF32 pair in f32, past D = 64
# in its wide shape)
@pytest.mark.parametrize("d", [16, 32, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_other_head_dim_kernels_match_plain(card, dtype, d):
    rng = np.random.default_rng(d)
    b, h, s = 3, 2, 256
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32))
                     .cuda().to(dtype).view(b, s, h, d).transpose(1, 2) for _ in range(4))
    seg = torch.tensor([SEG_LAYOUTS["runs"][0], SEG_LAYOUTS["interleaved"][0],
                        [1] * 70 + [0] * 186], dtype=torch.int32, device=card)
    scale = 1.0 / d**0.5
    route = bwd_route = "tf32" if dtype == torch.float32 else "wgmma_headdim"
    assert forward_route(q, k, v) == route and backward_route(q, k, v) == bwd_route
    before = (_forward_counts(), _backward_counts())
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    grads = flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
    torch.cuda.synchronize()
    want_counts = (dict(before[0]), dict(before[1]))
    want_counts[0][route] += 1
    want_counts[1][bwd_route] = tuple(n + 1 for n in before[1][bwd_route])
    assert (_forward_counts(), _backward_counts()) == want_counts
    want = flash_attention_plain(q, k, v, seg, scale)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=F32_ATOL)
        for g, w in zip(grads, flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)):
            torch.testing.assert_close(g, w, rtol=0, atol=F32_GRAD_REL * w.abs().max().item())
    else:
        torch.testing.assert_close(out.float(), want.float(), rtol=K2_TOL, atol=K2_TOL)
        _close_to_largest(grads, flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale))
    torch.testing.assert_close(lse, _masked_lse(q, k, seg, scale), rtol=0, atol=F32_LSE_ATOL)
    for g in grads:
        assert g.dtype == dtype and g.transpose(1, 2).is_contiguous()
    dq, di = _BWD_PAIRS[bwd_route][0](q, k, v, seg, lse, out, dout, scale)
    want_di = _row_dots(out, dout)
    torch.testing.assert_close(di, want_di, rtol=1e-5, atol=1e-5 * want_di.abs().max().item())
    torch.testing.assert_close(dq, grads[0], rtol=0, atol=0)


def test_k2_refuses_a_head_dim_past_256(card):
    q = torch.zeros(1, 1, 128, 257, device=card)
    with pytest.raises(ValueError, match="D=257"):
        flash_attention(q, q, q, torch.ones(1, 128, dtype=torch.int32, device=card), 0.1)


def _route_inputs(dtype, d, layout, seed):
    """[2, 3, 256, d] q/k/v and dO with ragged and interleaved segments:
    the encoder's strided views (``layout`` "encoder"; "encoder_h8": at 8
    heads, whose rows are 16-byte multiples at any D), views that start
    one element into their buffers ("offset"), which TMA cannot read,
    ("padded_rows") views of [B, S, H*d + 2] buffers, whose rows are not
    16 bytes apart, or ("d_strided") views of [B, H, d, S] buffers, whose D
    stride is S."""
    rng = np.random.default_rng(seed)
    b, h, s = 2, 8 if layout == "encoder_h8" else 3, 256

    def one():
        if layout == "d_strided":
            x = rng.normal(size=(b, h, d, s)).astype(np.float32)
            return torch.from_numpy(x).cuda().to(dtype).transpose(-1, -2)
        if layout == "padded_rows":
            x = rng.normal(size=(b, s, h * d + 2)).astype(np.float32)
            return torch.from_numpy(x).cuda().to(dtype)[..., :h * d].view(b, s, h, d) \
                .transpose(1, 2)
        x = torch.from_numpy(rng.normal(size=b * s * h * d + 1).astype(np.float32)).cuda()
        x = x.to(dtype)[1:] if layout == "offset" else x.to(dtype)[:-1]
        return x.view(b, s, h, d).transpose(1, 2)

    q, k, v, dout = (one() for _ in range(4))
    seg = torch.tensor([[1] * 150 + [0] * 106, SEG_LAYOUTS["interleaved"][1]],
                       dtype=torch.int32, device="cuda")
    return q, k, v, seg, dout


# each route's forward against plain at small head dims: the tensor-core
# kernels (the wgmma kernel at 1-4 slabs in bf16, the 3xTF32 kernel at 1-8
# in f32: D = 4, a k step that reads zeros past D; 96, three slabs and
# 32-key steps; 132, 192 and 252, a cluster's halves of 72 / 60, 96 / 96
# and 128 / 124 columns), the same kernels on row maps for heads TMA cannot
# read one by one (bf16 D = 2, 20, 25: odd, 26: TinyBERT's, 126: two slabs;
# f32 D = 2, 26, 62: two slabs, 130: a cluster's; 8 heads a row, the last
# one's box reaching the map's zero fill) and the padding routes for what no map reads (three heads of
# D = 20 bf16 or 26 f32: rows of 120 or 312 bytes; a view off a 16-byte
# boundary; heads side by side past the rows routes' D), on the kernel of
# their zero-padded copies
@pytest.mark.parametrize("dtype,d,layout,route", [
    (torch.bfloat16, 16, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 40, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 136, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 256, "encoder", "wgmma_headdim"),
    (torch.float32, 20, "encoder", "tf32"),
    (torch.float32, 64, "encoder", "tf32"),
    (torch.float32, 136, "encoder", "tf32"),
    (torch.float32, 256, "encoder", "tf32"),
    (torch.float32, 4, "encoder", "tf32"),
    (torch.float32, 96, "encoder", "tf32"),
    (torch.float32, 132, "encoder", "tf32"),
    (torch.float32, 192, "encoder", "tf32"),
    (torch.float32, 252, "encoder", "tf32"),
    (torch.bfloat16, 2, "encoder_h8", "wgmma_rows"),
    (torch.bfloat16, 20, "encoder_h8", "wgmma_rows"),
    (torch.bfloat16, 25, "encoder_h8", "wgmma_rows"),
    (torch.bfloat16, 26, "encoder_h8", "wgmma_rows"),
    (torch.bfloat16, 126, "encoder_h8", "wgmma_rows"),
    (torch.float32, 2, "encoder_h8", "tf32_rows"),
    (torch.float32, 26, "encoder_h8", "tf32_rows"),
    (torch.float32, 62, "encoder_h8", "tf32_rows"),
    (torch.float32, 130, "encoder_h8", "tf32_rows"),
    (torch.bfloat16, 20, "encoder", "wgmma_pad"),
    (torch.float32, 26, "encoder", "tf32_pad"),
    (torch.bfloat16, 64, "offset", "wgmma_pad"),
    (torch.float32, 64, "offset", "tf32_pad"),
    (torch.bfloat16, 250, "encoder_h8", "wgmma_pad"),
    (torch.float32, 254, "encoder_h8", "tf32_pad"),
    (torch.bfloat16, 64, "d_strided", "wgmma_pad"),
    (torch.float32, 32, "d_strided", "tf32_pad"),
], ids=lambda x: str(x).replace("torch.", ""))
def test_forward_routes_match_plain(card, dtype, d, layout, route):
    q, k, v, seg, dout = _route_inputs(dtype, d, layout, seed=d)
    scale = 1.0 / d**0.5
    assert forward_route(q, k, v) == route
    width = _padded(route, d)
    kernel = route if width == d and route not in _PAD_MULTIPLE else forward_route(
        *(pad_heads(t, width) for t in (q, k, v)))
    before, pad_before = _forward_counts(), dict(flash_attention.pad_launches)
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    got = flash_attention(q, k, v, seg, scale)
    torch.cuda.synchronize()
    assert _forward_counts() == dict(before, **{kernel: before[kernel] + 2})
    # the padding routes counted apart too
    assert flash_attention.pad_launches == dict(
        pad_before, **({route: pad_before[route] + 2} if route in _PAD_MULTIPLE else {}))
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    b, h, s = q.shape[:3]  # a view of a [B, S, H, D'] buffer (D' = D off the padding routes)
    assert out.dtype == dtype and out.transpose(1, 2).stride() == (s * h * width, h * width,
                                                                   width, 1)
    want = flash_attention_plain(q, k, v, seg, scale)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=F32_ATOL)
    else:
        torch.testing.assert_close(out.float(), want.float(), rtol=K2_TOL, atol=K2_TOL)
    torch.testing.assert_close(lse, _masked_lse(q, k, seg, scale), rtol=0, atol=F32_LSE_ATOL)
    # a bf16 D = 64 input TMA cannot read trains through the wgmma pair on
    # padded copies (at D = 64 no columns are added), and nothing else
    if layout == "offset" and dtype == torch.bfloat16:
        before = _backward_counts()
        grads = flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
        torch.cuda.synchronize()
        assert _backward_counts() == dict(before, wgmma=tuple(n + 1 for n in before["wgmma"]))
        _close_to_largest(grads, flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale))


# each backward route's pair against the plain backward at small head dims,
# on both sides of the wide shapes' edges (bf16 D = 128, f32 D = 64):
# the wgmma pair at one and two slabs (D = 16, 40: stores that stop inside a
# slab; 72: a second slab of 8 columns), the same pair on zero-padded
# copies of bf16 rows TMA cannot read (D = 26, TinyBERT's, padded to 32;
# 20; 2; 25, an odd D; 126, padded to two slabs; a D = 26 view 2 bytes off
# its buffer; D = 64 with rows 388 bytes apart), the 3xTF32 pair at one and
# two slabs of 32 and on zero-padded copies of f32 rows TMA cannot read
# (D = 26, TinyBERT's, padded to 28; a D = 64 view 4 bytes off its
# buffer), the wide pairs past those edges (bf16 D = 136, 192, 256 and, on
# copies, 130; f32 D = 68, 96, 128, 256 and, on copies, 66); three heads a
# row, so a store past D would run into the next head
@pytest.mark.parametrize("dtype,d,layout,route", [
    (torch.bfloat16, 16, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 40, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 72, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 128, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 26, "encoder", "wgmma_pad"),
    (torch.bfloat16, 20, "encoder", "wgmma_pad"),
    (torch.bfloat16, 2, "encoder", "wgmma_pad"),
    (torch.bfloat16, 25, "encoder", "wgmma_pad"),
    (torch.bfloat16, 126, "encoder", "wgmma_pad"),
    (torch.bfloat16, 26, "offset", "wgmma_pad"),
    (torch.bfloat16, 64, "padded_rows", "wgmma_pad"),
    (torch.bfloat16, 136, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 192, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 256, "encoder", "wgmma_headdim"),
    (torch.bfloat16, 130, "encoder", "wgmma_pad"),
    (torch.float32, 16, "encoder", "tf32"),
    (torch.float32, 20, "encoder", "tf32"),
    (torch.float32, 36, "encoder", "tf32"),
    (torch.float32, 64, "encoder", "tf32"),
    (torch.float32, 68, "encoder", "tf32"),
    (torch.float32, 96, "encoder", "tf32"),
    (torch.float32, 128, "encoder", "tf32"),
    (torch.float32, 256, "encoder", "tf32"),
    (torch.float32, 66, "encoder", "tf32_pad"),
    (torch.float32, 64, "offset", "tf32_pad"),
    (torch.float32, 26, "encoder", "tf32_pad"),
    (torch.bfloat16, 64, "d_strided", "wgmma_pad"),
    (torch.float32, 32, "d_strided", "tf32_pad"),
], ids=lambda x: str(x).replace("torch.", ""))
def test_backward_routes_match_plain(card, dtype, d, layout, route):
    q, k, v, seg, dout = _route_inputs(dtype, d, layout, seed=100 + d)
    scale = 1.0 / d**0.5
    assert backward_route(q, k, v) == route
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    args = [q, k, v, out, dout]
    pair, d8 = route, d
    if route in ("wgmma_pad", "tf32_pad"):  # zero-padded copies, on their own route's pair
        multiple = 8 if route == "wgmma_pad" else 4
        d8 = -(-d // multiple) * multiple
        args = [pad_heads(t, d8) for t in args]
        pair = backward_route(*args[:3])
        assert pair == ("tf32" if route == "tf32_pad" else
                        "wgmma" if d8 == 64 else "wgmma_headdim")
    before, wide_before = _backward_counts(), _wide_counts()
    grads = flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert _backward_counts() == dict(before, **{pair: tuple(n + 1 for n in before[pair])})
    wide = d8 > _WIDE_PAST.get(pair, 256)  # past the edge the wide instances, counted apart
    assert _wide_counts() == dict(
        wide_before, **({pair: tuple(n + 1 for n in wide_before[pair])} if wide else {}))
    want = flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
    if dtype == torch.float32:
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, rtol=0, atol=F32_GRAD_REL * w.abs().max().item())
    else:
        _close_to_largest(grads, want)
    b, h, s = q.shape[:3]
    for g in grads:  # views of [B, S, H, D8] buffers
        assert g.dtype == dtype and g.shape == q.shape
        assert g.transpose(1, 2).stride() == (s * h * d8, h * d8, d8, 1)
    pq, pk, pv, po, pdo = args
    dq, di = _BWD_PAIRS[pair][0](pq, pk, pv, seg, lse, po, pdo, scale)
    want_di = _row_dots(out, dout)
    torch.testing.assert_close(di, want_di, rtol=1e-5, atol=1e-5 * want_di.abs().max().item())
    torch.testing.assert_close(dq[..., :d], grads[0], rtol=0, atol=0)  # no atomics: same bits
    assert not dq[..., d:].any()  # the padded columns' gradients are 0
    _, di_again = _BWD_PAIRS[pair][0](pq, pk, pv, seg, lse, po, pdo, scale)
    assert torch.equal(di, di_again)


# The wide 3xTF32 pair (f32 past D = 64: wgmma on operands split once)
# against the plain backward at every D where its walk changes: 68 (the
# first of four slabs; a k step of 8 half past D; a second 64-column tile
# of the gradients with 4 columns), 80, 96 (slabs wholly past D not
# loaded), 100, 128 (the last of one block a row tile), 132 (the first of a
# cluster of two blocks: 72 and 60 columns), 192 (96 each), 252 and 256,
# and on the "tf32_pad" route's copies at D = 66 (padded to 68); three
# heads a row, so a store past D would run into the next head.  Rows of several segments, interleaved ids, one segment and
# ragged pads (masked and ragged rows), strided dO; the gradients within
# the f32 gate, di, dq's bits on a second run, the wide launches counted.
@pytest.mark.parametrize("d", [68, 80, 96, 100, 128, 132, 192, 252, 256, 66])
def test_wide_3xtf32_pair_matches_plain(card, d):
    rng = np.random.default_rng(700 + d)
    b, h, s = 4, 3, 256
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32))
                     .cuda().view(b, s, h, d).transpose(1, 2) for _ in range(4))
    seg = torch.tensor([SEG_LAYOUTS["runs"][0], SEG_LAYOUTS["interleaved"][0],
                        SEG_LAYOUTS["one_segment"][0], [1] * 131 + [0] * 125],
                       dtype=torch.int32, device=card)
    scale = 1.0 / d**0.5
    route = backward_route(q, k, v)
    assert route == ("tf32_pad" if d == 66 else "tf32")
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    d4 = -(-d // 4) * 4
    args = [q, k, v, out, dout] if route == "tf32" else [pad_heads(t, d4) for t in
                                                         (q, k, v, out, dout)]
    before, wide_before = _backward_counts(), _wide_counts()
    grads = flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert _backward_counts() == dict(before, tf32=tuple(n + 1 for n in before["tf32"]))
    assert _wide_counts() == dict(wide_before, tf32=tuple(n + 1 for n in wide_before["tf32"]))
    for g, w in zip(grads, flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)):
        assert g.shape == q.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0, atol=F32_GRAD_REL * w.abs().max().item())
    pq, pk, pv, po, pdo = args
    dq, di = flash_attention_tf32_bwd_dq(pq, pk, pv, seg, lse, po, pdo, scale)
    want_di = _row_dots(out, dout)
    torch.testing.assert_close(di, want_di, rtol=1e-5, atol=1e-5 * want_di.abs().max().item())
    assert torch.equal(dq[..., :d], grads[0])  # no atomics: the same bits
    assert not dq[..., d:].any()


@pytest.mark.parametrize("dtype,d,width", [(torch.bfloat16, 26, 32), (torch.float32, 26, 28),
                                           (torch.float32, 62, 64)],
                         ids=["bf16", "f32", "f32_d62"])
def test_rows_routes_equal_the_kernel_on_padded_copies(card, dtype, d, width):
    """At [2, 12, 256, 26] (TinyBERT-4L-312D's heads, read as the encoder's
    [B, S, 312] rows; the last head's box reaches the map's zero fill) each
    rows route's output and logsumexp equal, bit for bit at every head, the
    same kernel's through per-head maps on ``pad_heads`` copies (bf16 at
    D = 32, f32 at D = 28: their first 26 columns), at D = 26's scale; so
    too f32 at D = 62, past one slab of 32 columns, on copies at D = 64."""
    rng = np.random.default_rng(d)
    b, h, s = 2, 12, 256
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32)).cuda()
               .to(dtype).view(b, s, h, d).transpose(1, 2) for _ in range(3))
    seg = torch.tensor([SEG_LAYOUTS["runs"][0], [1] * 150 + [0] * 106], dtype=torch.int32,
                       device=card)
    scale = 1.0 / d**0.5
    rows, per_head = ("wgmma_rows", "wgmma_headdim") if dtype == torch.bfloat16 else \
        ("tf32_rows", "tf32")
    padded = [pad_heads(t, width) for t in (q, k, v)]
    assert forward_route(q, k, v) == rows and forward_route(*padded) == per_head
    before = _forward_counts()
    out, lse = flash_attention_fwd(q, k, v, seg, scale)
    got = flash_attention(q, k, v, seg, scale)
    want, want_lse = flash_attention_fwd(*padded, seg, scale)
    torch.cuda.synchronize()
    assert _forward_counts() == dict(before, **{rows: before[rows] + 2,
                                                per_head: before[per_head] + 1})
    assert torch.equal(out, want[..., :d]) and torch.equal(lse, want_lse)
    assert torch.equal(got, out)
    assert out.transpose(1, 2).is_contiguous()  # [B, S, H, D]: the encoder's reshape is a view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_tinybert_width_auto_encoder_reads_rows_in_place(card, dtype):
    """An encoder at TinyBERT_General_4L_312D's width (hidden 312, 12 heads
    of D = 26, intermediate 1200; 2 layers) with "auto" on the card takes
    the rows route once a layer ("wgmma_rows" in bf16, "tf32_rows" in f32),
    never the padding route, and agrees with "xla" on the valid tokens
    and the pooled embedding (bf16: rtol = atol = 5e-2, as the D = 64 test
    below; f32: atol 1e-4, as the f32 test below)."""
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=312, num_heads=12, num_layers=2,
                             intermediate_size=1200, dtype=dtype)
    xla = init_encoder(cfg, seed=26).to(card)
    auto = Encoder(dataclasses.replace(cfg, attention_impl="auto")).to(card).eval()
    auto.load_state_dict(xla.state_dict())
    ids = torch.from_numpy(np.random.default_rng(26).integers(0, 97, size=(3, 128))).to(card)
    mask = torch.ones(3, 128, dtype=torch.int32, device=card)
    mask[1, 30:] = 0
    route = "wgmma_rows" if dtype == torch.bfloat16 else "tf32_rows"
    with torch.inference_mode():
        before = _forward_counts()
        pooled, tokens = auto(ids, mask, return_tokens=True)
        assert _forward_counts() == dict(before, **{route: before[route] + 2})
        want_pooled, want_tokens = xla(ids, mask, return_tokens=True)
    valid = mask.bool()
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 else dict(rtol=0, atol=1e-4)
    torch.testing.assert_close(tokens[valid].float(), want_tokens[valid].float(), **tol)
    torch.testing.assert_close(pooled.float(), want_pooled.float(), **tol)


def test_tensor_core_forwards_refuse_what_tma_cannot_read(card):
    """Called directly, the wgmma and 3xTF32 wrappers (per head and on row
    maps) raise on a layout TMA cannot read; they never hand it to another
    kernel."""
    for dtype, fn in ((torch.bfloat16, flash_attention_headdim),
                      (torch.float32, flash_attention_tf32),
                      (torch.bfloat16, flash_attention_rows),
                      (torch.float32, flash_attention_tf32_rows)):
        q, k, v, seg, _ = _route_inputs(dtype, 32, "offset", seed=5)
        with pytest.raises(ValueError, match="cannot read"):
            fn(q, k, v, seg, 0.2)


def test_f32_auto_encoder_launches_the_tf32_kernel(card):
    """An f32 encoder
    (EncoderConfig.tiny: D = 16) with "auto" on the card takes the 3xTF32
    K2, not plain attention, and agrees with "xla" on the valid tokens and
    the pooled embedding (f32 through two layers, attention summed in
    another order: atol 1e-4)."""
    cfg = EncoderConfig.tiny(vocab_size=97, num_layers=2)
    assert cfg.dtype == torch.float32 and cfg.hidden_size // cfg.num_heads == 16
    xla = init_encoder(cfg, seed=4).to(card)
    auto = Encoder(dataclasses.replace(cfg, attention_impl="auto")).to(card).eval()
    auto.load_state_dict(xla.state_dict())
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 97, size=(3, 128))).to(card)
    mask = torch.ones(3, 128, dtype=torch.int32, device=card)
    mask[1, 30:] = 0
    with torch.inference_mode():
        before = _forward_counts()
        pooled, tokens = auto(ids, mask, return_tokens=True)
        assert _forward_counts() == dict(before, tf32=before["tf32"] + 2)  # one per layer
        want_pooled, want_tokens = xla(ids, mask, return_tokens=True)
    valid = mask.bool()
    torch.testing.assert_close(tokens[valid], want_tokens[valid], rtol=0, atol=1e-4)
    torch.testing.assert_close(pooled, want_pooled, rtol=0, atol=1e-4)


def test_auto_encoder_through_k2_matches_xla(card):
    """A tiny bf16 encoder (hidden 256, 4 heads, D = 64) at S = 128: "auto"
    takes K2 on the card and agrees with "xla" on the valid tokens and the
    pooled embedding.  Tolerance rtol = atol = 5e-2: the hidden states are
    bf16 LayerNorm outputs up to ~5 (one ulp is 3.1e-2 in [4, 8)), and a
    rounding that differs in one layer's attention output carries through
    the next."""
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=256, num_heads=4, num_layers=2,
                             intermediate_size=512, dtype=torch.bfloat16)
    xla = init_encoder(cfg, seed=2).to(card)
    auto = Encoder(dataclasses.replace(cfg, attention_impl="auto")).to(card).eval()
    auto.load_state_dict(xla.state_dict())
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 97, size=(3, 128))).to(card)
    mask = torch.ones(3, 128, dtype=torch.int32, device=card)
    mask[1, 40:] = 0
    mask[2, 2:] = 0
    with torch.inference_mode():
        before = flash_attention.launches
        pooled, tokens = auto(ids, mask, return_tokens=True)
        assert flash_attention.launches == before + 2  # one per layer
        want_pooled, want_tokens = xla(ids, mask, return_tokens=True)
        assert flash_attention.launches == before + 2
    valid = mask.bool()
    torch.testing.assert_close(tokens[valid].float(), want_tokens[valid].float(),
                               rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(pooled, want_pooled, rtol=5e-2, atol=5e-2)


def test_auto_encoder_with_another_head_dim_is_plain(card):
    """(Named when "auto" took plain attention at D != 64.)  Head dim 32
    (hidden 128, 4 heads) in bf16: "auto" now takes K2's wgmma kernel at
    one slab of 64 columns (flash_attention_headdim's count, not the D = 64
    one), and agrees with "xla" on the valid tokens and the pooled
    embedding (bf16 tolerance, as the D = 64 test above)."""
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=128, num_heads=4, num_layers=2,
                             intermediate_size=256, dtype=torch.bfloat16)
    xla = init_encoder(cfg, seed=3).to(card)
    auto = Encoder(dataclasses.replace(cfg, attention_impl="auto")).to(card).eval()
    auto.load_state_dict(xla.state_dict())
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 97, size=(2, 128))).to(card)
    mask = torch.ones(2, 128, dtype=torch.int32, device=card)
    mask[1, 50:] = 0
    with torch.inference_mode():
        before = _forward_counts()
        pooled, tokens = auto(ids, mask, return_tokens=True)
        assert _forward_counts() == dict(before, wgmma_headdim=before["wgmma_headdim"] + 2)
        want_pooled, want_tokens = xla(ids, mask, return_tokens=True)
    valid = mask.bool()
    torch.testing.assert_close(tokens[valid].float(), want_tokens[valid].float(),
                               rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(pooled, want_pooled, rtol=5e-2, atol=5e-2)


def _masked_lse(q, k, seg, scale):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return torch.logsumexp(logits.masked_fill(~same, float("-inf")), -1)


def _close_to_largest(got, want):
    for g, w in zip(got, want):
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=1e-2 * scale)


# lengths 64, 65, 127, 131 and 200: pad queries and keys whose first tiles
# are wholly masked for them; a full row and a row of 2 tokens
@pytest.mark.parametrize("s,lengths", [(128, [128, 2, 65]), (256, [64, 127, 131, 200, 256])])
def test_k2b_matches_plain(card, s, lengths):
    q, k, v, seg = _k2_inputs(len(lengths), 3, s, lengths, seed=5)
    rng = np.random.default_rng(6)
    dout = torch.from_numpy(rng.normal(size=(len(lengths), s, 3 * 64)).astype(np.float32))
    dout = dout.cuda().bfloat16().view(len(lengths), s, 3, 64).transpose(1, 2)  # strided
    out, lse = flash_attention_fwd(q, k, v, seg, 0.125)
    torch.testing.assert_close(lse, _masked_lse(q, k, seg, 0.125), rtol=0, atol=1e-3)
    before = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, seg, out, lse, dout, 0.125)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    for g in got:
        assert g.dtype == torch.bfloat16 and g.transpose(1, 2).is_contiguous()
        assert torch.isfinite(g).all()
    _close_to_largest(got, flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, 0.125))


# the segment layouts of tests/test_torch_flash_bwd.py at [2, 2, 256, 64],
# from the same numpy inputs: several segments, ids that return after
# another segment, alternating ids 0 and 2 against a tile of 1, a row all of
# one segment
SEG_LAYOUTS = {
    "runs": [[2] * 100 + [1] * 100 + [0] * 56, [1] * 70 + [0] * 58 + [1] * 128],
    "interleaved": [[0, 2] * 32 + [1] * 64 + [2] * 128, [0] * 64 + [3] * 64 + [0] * 64 + [3] * 64],
    "one_segment": [[7] * 256, [1] * 200 + [0] * 56],
}


def _layout_inputs(layout, seed=258):
    """bf16 q, k, v, dO [2, 2, 256, 64] on the card and the layout's int32
    segment ids, drawn as tests/test_torch_flash_bwd.py draws them."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(2, 2, 256, 64)).astype(np.float32))
                     .cuda().bfloat16() for _ in range(4))
    seg = torch.tensor(SEG_LAYOUTS[layout], dtype=torch.int32).cuda()
    return q, k, v, seg, dout


@pytest.mark.parametrize("layout", sorted(SEG_LAYOUTS))
def test_k2_segment_layouts_match_plain(card, layout):
    """K2, which skips the key tiles whose segment ids miss a warpgroup's
    rows, against the plain version on the layouts, with and without the
    logsumexp (atol 1e-3: f32 sums of the same f32 exponentials in another
    order and base)."""
    q, k, v, seg, _ = _layout_inputs(layout)
    before = flash_attention.launches
    got = flash_attention(q, k, v, seg, 0.125)
    out, lse = flash_attention_fwd(q, k, v, seg, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    want = flash_attention_plain(q, k, v, seg, 0.125)
    for o in (got, out):
        assert torch.isfinite(o.float()).all()
        torch.testing.assert_close(o.float(), want.float(), rtol=K2_TOL, atol=K2_TOL)
    torch.testing.assert_close(got, out, rtol=0, atol=0)  # the lse changes no output bit
    torch.testing.assert_close(lse, _masked_lse(q, k, seg, 0.125), rtol=0, atol=1e-3)


def test_k2_recompute_on_autograd_thread(card):
    """Under torch.utils.checkpoint (the train step's remat) the backward
    recomputes K2 with the logsumexp on autograd's thread, where the
    kernel's tensor maps need the context made current first; the
    gradients agree with autograd through the plain version."""
    q, k, v, seg, dout = _layout_inputs("runs")
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd_dq.launches)
    out = torch.utils.checkpoint.checkpoint(flash_attention, *leaves, seg, 0.125,
                                            use_reentrant=False)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0], flash_attention_bwd_dq.launches - before[1]) \
        == (2, 1)  # the forward twice
    want = torch.autograd.grad(flash_attention_plain(*leaves, seg, 0.125), leaves, dout)
    _close_to_largest(got, want)


@pytest.mark.parametrize("layout", sorted(SEG_LAYOUTS))
def test_k2b_segment_layouts_match_plain(card, layout):
    """K2b (dq writing di, then dkv) against the plain backward, and dq's di
    against the plain row dots (f32 sums of the same 64 products in another
    order: rtol 1e-5, atol 1e-5 of the largest |di|)."""
    q, k, v, seg, dout = _layout_inputs(layout)
    out, lse = flash_attention_fwd(q, k, v, seg, 0.125)
    got = flash_attention_bwd(q, k, v, seg, out, lse, dout, 0.125)
    torch.cuda.synchronize()
    _close_to_largest(got, flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, 0.125))
    dq, di = flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, 0.125)
    want = _row_dots(out, dout)
    assert di.shape == (2, 2, 256) and di.dtype == torch.float32 and di.is_contiguous()
    torch.testing.assert_close(di, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(dq, got[0], rtol=0, atol=0)  # the same kernel, the same sums


def test_k2b_launches_dq_then_dkv_without_a_torch_op_for_di(card, monkeypatch):
    """One backward launches dq once, then dkv once, with dq's di; no torch
    op computes di (the plain row dots would raise here)."""
    q, k, v, seg, dout = _layout_inputs("runs")
    out, lse = flash_attention_fwd(q, k, v, seg, 0.125)
    order = []
    dq_kernel, dkv_kernel = flash_module._bwd_kernels()

    def recorded(name, fn):
        def call(*args):
            order.append(name)
            return fn(*args)
        return call

    def no_row_dots(*args):
        raise AssertionError("di computed by a torch op")

    monkeypatch.setattr(flash_module, "_bwd_kernels",
                        lambda: (recorded("dq", dq_kernel), recorded("dkv", dkv_kernel)))
    monkeypatch.setattr(flash_module, "_row_dots", no_row_dots)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    flash_attention_bwd(q, k, v, seg, out, lse, dout, 0.125)
    torch.cuda.synchronize()
    assert order == ["dq", "dkv"]
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)


def test_k2b_refuses_a_misaligned_o(card):
    q, k, v, seg, dout = _layout_inputs("one_segment")
    out, lse = flash_attention_fwd(q, k, v, seg, 0.125)
    flat = torch.empty(out.numel() + 1, dtype=out.dtype, device=card)
    shifted = flat[1:].view(out.shape)  # starts 2 bytes into the buffer
    shifted.copy_(out)
    with pytest.raises(ValueError, match="cannot read"):
        flash_attention_bwd(q, k, v, seg, shifted, lse, dout, 0.125)


def test_k2_function_grads_match_plain_autograd(card):
    """flash_attention under autograd (K2 forward with the logsumexp, K2b
    backward) against autograd through the plain version."""
    q, k, v, seg = _k2_inputs(3, 2, 256, [256, 70, 131], seed=7)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    dout = torch.randn(3, 2, 256, 64, device=card).bfloat16()
    got = torch.autograd.grad(flash_attention(*leaves, seg, 0.125), leaves, dout)
    want = torch.autograd.grad(flash_attention_plain(*leaves, seg, 0.125), leaves, dout)
    _close_to_largest(got, want)


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "wgmma_headdim"),
                                          (torch.float32, "tf32")], ids=["bf16", "f32"])
def test_padding_routes_train_through_autograd(card, dtype, kernel):
    """flash_attention under autograd on a contiguous [B, H, S, 26], which
    no map reads: the forward and the backward both on zero-padded copies
    (the forward's output a view of its first 26 columns), one launch each
    of the copies' kernels, against autograd through the plain version."""
    q, k, v, seg, dout = _route_inputs(dtype, 26, "offset", seed=26)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (_forward_counts(), _backward_counts())
    got = torch.autograd.grad(flash_attention(*leaves, seg, 0.2), leaves, dout)
    torch.cuda.synchronize()
    assert _forward_counts() == dict(before[0], **{kernel: before[0][kernel] + 1})
    assert _backward_counts() == dict(before[1], **{kernel: tuple(
        n + 1 for n in before[1][kernel])})
    want = torch.autograd.grad(flash_attention_plain(*leaves, seg, 0.2), leaves, dout)
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=F32_GRAD_REL * w.abs().max().item())
    else:
        _close_to_largest(got, want)


def _tiny_batch(rng, b=4, seq=128, query_seq=16, vocab=97):
    def toks(n, length):
        mask = np.zeros((n, length), np.int64)
        for i in range(n):
            mask[i, : rng.integers(length // 2, length + 1)] = 1
        ids = rng.integers(5, vocab, size=(n, length)) * mask
        return {"input_ids": torch.from_numpy(ids).cuda(),
                "attention_mask": torch.from_numpy(mask).cuda()}

    return {"query": toks(b, query_seq), "pos": {"a": toks(b, seq), "b": toks(b, seq)},
            "neg": {"a": toks(b, seq), "b": toks(b, seq)}}


def test_auto_train_step_matches_xla(card):
    """A tiny bf16 MFARModel (hidden 128, 2 heads, D = 64) at S = 128 with
    attention dropout 0: loss and gradients through K2/K2b ("auto") against
    the plain path ("xla") on the same weights and dropout masks.  Loss
    rtol 1e-2, gradient cosine >= 0.99 (bf16 activations, attention rounded
    at different places)."""
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=128, num_heads=2, num_layers=2,
                             intermediate_size=256, dtype=torch.bfloat16,
                             attention_dropout=0.0, attention_impl="auto", remat=True)
    batch = _tiny_batch(np.random.default_rng(8))
    out = {}
    for impl in ("auto", "xla"):
        torch.manual_seed(0)
        model = MFARModel(dataclasses.replace(cfg, attention_impl=impl), num_fields=2)
        model.encoder.load_state_dict(init_encoder(cfg, seed=9).state_dict())
        model = model.to(card).train()
        before = (flash_attention.launches, flash_attention_bwd_dq.launches)
        loss = model.compute_loss(batch["query"], batch["pos"], batch["neg"],
                                  generator=torch.Generator().manual_seed(3))
        loss.backward()
        launched = (flash_attention.launches - before[0], flash_attention_bwd_dq.launches
                    - before[1])
        assert launched == ((4, 2) if impl == "auto" else (0, 0))  # remat: forward twice
        out[impl] = (loss.item(), torch.cat([p.grad.float().flatten()
                                             for p in model.parameters()]))
    assert out["auto"][0] == pytest.approx(out["xla"][0], rel=1e-2)
    cos = torch.nn.functional.cosine_similarity(out["auto"][1], out["xla"][1], dim=0)
    assert cos.item() >= 0.99


def test_f32_flash_training_input_raises(card):
    """(Named when f32 raised on the card.)  An f32 MFARModel with "flash"
    trains through the 3xTF32 K2 and the 3xTF32 K2b: loss and gradients
    against the plain path on the same weights (f32: loss rtol 1e-5, cosine
    >= 0.9999)."""
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=128, num_heads=2, num_layers=1,
                             intermediate_size=256, attention_impl="flash",
                             attention_dropout=0.0)  # f32 activations
    batch = _tiny_batch(np.random.default_rng(10), query_seq=128)
    out = {}
    for impl in ("flash", "xla"):
        torch.manual_seed(0)
        model = MFARModel(dataclasses.replace(cfg, attention_impl=impl), num_fields=2)
        model.encoder.load_state_dict(init_encoder(cfg, seed=11).state_dict())
        model = model.to(card).train()
        before = (flash_attention_tf32.launches, flash_attention_tf32_bwd_dq.launches,
                  flash_attention_tf32_bwd_dkv.launches, flash_attention_bwd_headdim_dq.launches)
        loss = model.compute_loss(batch["query"], batch["pos"], batch["neg"],
                                  generator=torch.Generator().manual_seed(3))
        loss.backward()
        launched = (flash_attention_tf32.launches - before[0],
                    flash_attention_tf32_bwd_dq.launches - before[1],
                    flash_attention_tf32_bwd_dkv.launches - before[2],
                    flash_attention_bwd_headdim_dq.launches - before[3])
        assert (min(launched[:3]) > 0) == (impl == "flash") and launched[3] == 0, launched
        out[impl] = (loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()]))
    assert out["flash"][0] == pytest.approx(out["xla"][0], rel=1e-5)
    cos = torch.nn.functional.cosine_similarity(out["flash"][1], out["xla"][1], dim=0)
    assert cos.item() >= 0.9999


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_host_stream_back_to_back_matches_device_resident(card, quantize):
    """Batches dispatched back to back over a host-streamed corpus (several
    in flight, as retrieve_many and the daemon dispatch them) agree with
    the device-resident engine of the same arithmetic: each call's chunk
    buffers come from memory the previous call's scan may still use."""
    rng = np.random.default_rng(5)
    n, e = 5000, 64
    words = [f"w{i}" for i in range(200)]
    tok = SimpleVocabTokenizer.build([" ".join(words)], max_length=16)
    cfg = EncoderConfig.tiny(vocab_size=tok.vocab_size, hidden_size=e)
    encode = make_encode_fn(init_encoder(cfg, seed=1), device="cuda")
    fields = resolve_fields("title_dense,description_dense", "amazon")
    matrix = rng.normal(size=(n, 2 * e)).astype(np.float32)
    kw = dict(field_info=fields, doc_keys=[f"d{i}" for i in range(n)], encode_fn=encode,
              tokenizer=tok, mixer_params={"weight": rng.normal(size=(e, 2)).astype(np.float32)},
              dense_matrix=matrix, quantize=quantize, device="cuda")
    queries = [" ".join(rng.choice(words, size=4)) for _ in range(96)]
    resident = RetrievalEngine(**kw).retrieve_many(queries, top_k=20, batch_size=16)
    streamed = RetrievalEngine(corpus_on_host=True, **kw)
    got = streamed.retrieve_many(queries, top_k=20, batch_size=16)
    assert streamed.last_serve_path.startswith("host-stream-dense")
    host = streamed.docs_host if quantize is None else streamed.docs_host_q
    assert host.is_pinned()  # registered pages: the copies read them in place
    msg = rankings_agree(got, resident, 1e-4, 1e-3)
    assert msg is None, msg


def test_t5_encoder_and_adafactor_on_the_card_match_the_cpu(card):
    """A GTR-shaped T5 encoder (2 layers, d_model 128) in f32 on the card
    against the CPU (TF32 off; f32 sums in other orders: atol 1e-5), its
    bf16 forward (within 3e-2 of the largest entry), and Adafactor steps on
    the card against the CPU (within 1e-6)."""
    from mfar_tpu_torch.models import T5Config
    from mfar_tpu_torch.models.t5_encoder import init_t5_encoder
    from mfar_tpu_torch.train.optim import Adafactor, jax_leaves

    cfg = T5Config.tiny(vocab_size=160, d_model=128, d_kv=64, d_ff=256, projection_dim=128)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 160, size=(4, 40)))
    mask = torch.ones_like(ids)
    mask[1, 9:] = 0
    cpu = init_t5_encoder(cfg, seed=1)
    gpu = copy.deepcopy(cpu).to(card)
    with torch.no_grad():
        want = cpu(ids, mask)
        got = gpu(ids.to(card), mask.to(card)).cpu()
        half = init_t5_encoder(dataclasses.replace(cfg, dtype=torch.bfloat16), seed=1).to(card)
        got16 = half(ids.to(card), mask.to(card)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert (got16 - want).abs().max() <= 3e-2 * want.abs().max()

    opts = [Adafactor(jax_leaves(m), lr=1e-3) for m in (cpu, gpu)]
    for _ in range(3):
        for p, q in zip(cpu.parameters(), gpu.parameters()):
            g = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
            p.grad, q.grad = g, g.to(card)
        for opt in opts:
            opt.step()
    for (name, a), b in zip(cpu.state_dict().items(), gpu.state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-6, msg=name)


def test_encoded_queries_do_not_depend_on_their_batch(card):
    """A query's encoded row is the same bits whatever batch it is encoded
    in, at Contriever-base width in bf16 (12 layers, hidden 768): 8 queries
    alone and as the first and the last rows of batches of 16-256 queries
    (``encode_queries`` runs every call at one row count a bucket width)."""
    words = [f"w{i}" for i in range(5000)]
    tok = SimpleVocabTokenizer.build([" ".join(words)], max_length=512)
    cfg = EncoderConfig.contriever_base(vocab_size=tok.vocab_size)
    assert cfg.dtype == torch.bfloat16 and cfg.hidden_size == 768 and cfg.num_layers == 12
    encode = make_encode_fn(init_encoder(cfg, seed=2), device=card)
    rng = np.random.default_rng(25)
    fi = resolve_fields("title_dense,description_dense", "amazon")
    engine = RetrievalEngine(
        field_info=fi, doc_keys=[f"d{i}" for i in range(4096)], encode_fn=encode, tokenizer=tok,
        mixer_params={"weight": rng.normal(size=(768, 2)).astype(np.float32)},
        dense_matrix=rng.normal(size=(4096, 2, 768)).astype(np.float32),
        dense_dtype=torch.bfloat16)
    qs = [" ".join(rng.choice(words, size=8)) for _ in range(256)]
    alone = engine.encode_queries(qs[:8])
    for size in (16, 24, 48, 128, 200, 256):
        assert torch.equal(engine.encode_queries(qs[:size])[:8], alone), size
        assert torch.equal(engine.encode_queries(qs[8:size] + qs[:8])[-8:], alone), size


def _heavy_postings(rng, card, b, m, hit, n_fields=2):
    """[B, M] postings whose values land on ``hit`` documents, many times
    each, with their sparse field."""
    ids = torch.from_numpy(rng.integers(0, hit, size=(b, m)).astype(np.int32)).to(card)
    vals = torch.from_numpy(rng.uniform(0.1, 3.0, size=(b, m)).astype(np.float32)).to(card)
    fidx = torch.from_numpy(rng.integers(0, n_fields, size=(b, m)).astype(np.int8)).to(card)
    return ids, vals, fidx


def test_postings_sums_are_the_same_bits_in_every_run(card):
    """The hybrid postings sum (``_fold_and_densify``, which the postings
    routes and the mesh's run) and the host stream's per-chunk postings
    (``hybrid_topk_host_streamed``) are the same bits in five runs on rows
    whose thousands of postings hit a handful of documents: a scatter-add's
    atomics add them in an order that changes from run to run."""
    rng = np.random.default_rng(7)
    b, n, e = 4, 4096, 64
    q = torch.from_numpy(rng.normal(size=(b, e)).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.normal(size=(e, 4)).astype(np.float32)).to(card)
    ids, vals, fidx = _heavy_postings(rng, card, b, 8192, 6)
    first = _fold_and_densify(q, w, None, n, 2, ids, vals, fidx)[1]
    docs = torch.from_numpy(rng.normal(size=(n, 2 * e)).astype(np.float32))
    qflat = torch.from_numpy(rng.normal(size=(b, 2 * e)).astype(np.float32)).to(card)
    streamed = hybrid_topk_host_streamed(qflat, docs, 50, chunk_size=1024, post_ids=ids,
                                         post_wvals=vals)
    for _ in range(4):
        assert torch.equal(_fold_and_densify(q, w, None, n, 2, ids, vals, fidx)[1], first)
        again = hybrid_topk_host_streamed(qflat, docs, 50, chunk_size=1024, post_ids=ids,
                                          post_wvals=vals)
        assert all(torch.equal(x, y) for x, y in zip(again, streamed))


def test_rerank_mix_gives_a_row_the_same_bits_in_a_batch_of_300(card):
    """Rerank's mix of the field scores (``rerank_candidates``) gives one row
    the same bits alone as first in a batch of 300 (a batched product picks
    its kernel, and so its order of summation, by shape)."""
    rng = np.random.default_rng(8)
    c, f, e = 512, 5, 768
    q = torch.from_numpy(rng.normal(size=(300, e)).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.normal(size=(e, f)).astype(np.float32)).to(card)
    scores = torch.from_numpy(rng.normal(size=(300, c, f)).astype(np.float32)).to(card)
    alone = rerank_candidates(q[:1], scores[:1], None, w, k=100)
    batched = rerank_candidates(q, scores, None, w, k=100)
    assert torch.equal(batched[0][:1], alone[0]) and torch.equal(batched[1][:1], alone[1])


def test_rerank_stage2_dots_give_a_row_the_same_bits_in_a_batch_of_300(card):
    """Rerank's stage-2 dots of gathered bf16 rows (``per_field_candidate_scores``,
    the plain, int8, host and mesh routes') give one row the same bits
    alone as first in a batch of 300."""
    rng = np.random.default_rng(8)
    c, f, e = 128, 5, 768
    q = torch.from_numpy(rng.normal(size=(300, e)).astype(np.float32)).to(card)
    rows = torch.from_numpy(rng.normal(size=(300, c, f, e)).astype(np.float32)).to(card)
    rows = rows.to(torch.bfloat16)
    alone = per_field_candidate_scores(q[:1], rows[:1])
    assert torch.equal(per_field_candidate_scores(q, rows)[:1], alone)


def test_bucketed_postings_give_a_row_the_same_bits_in_a_wider_batch(card):
    """The bucketed op's sums of a document's postings (``_posting_candidates``)
    give a row of 3000 postings the same bits alone as in a batch of 300
    rows whose buckets are up to ten times wider (a cumulative sum's thread
    layout follows the row's length)."""
    rng = np.random.default_rng(9)
    c, n_row, width = 4096, 3000, 30000

    def bucket(m):
        ids = np.full(width, c, np.int64)
        ids[:m] = np.sort(rng.integers(0, 40, size=m))
        vals = np.zeros(width, np.float32)
        vals[:m] = rng.uniform(0.1, 3.0, size=m)
        return ids, vals

    rows = [bucket(n_row)] + [bucket(int(m)) for m in rng.integers(1, width, size=299)]
    bids = torch.from_numpy(np.stack([r[0] for r in rows])).to(card)
    bwv = torch.from_numpy(np.stack([r[1] for r in rows])).to(card)
    s = torch.from_numpy(rng.normal(size=(300, c)).astype(np.float32)).to(card)
    alone = _posting_candidates(s[:1], bids[:1, :n_row], bwv[:1, :n_row], 0)
    batched = _posting_candidates(s, bids, bwv, 0)
    assert all(torch.equal(x[:1, :n_row], y) for x, y in zip(batched, alone))
