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
"""

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
from mfar_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
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
    q, k, v, seg = _k2_inputs(1, 1, 128, [128])
    with pytest.raises(TypeError, match="B2b"):
        flash_attention(q.float(), k.float(), v.float(), seg, 0.125)


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
    """Head dim 32 (hidden 128, 4 heads), which K2 does not take: "auto"
    takes the plain path, launches nothing and equals "xla" exactly."""
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=128, num_heads=4, num_layers=2,
                             intermediate_size=256, dtype=torch.bfloat16)
    xla = init_encoder(cfg, seed=3).to(card)
    auto = Encoder(dataclasses.replace(cfg, attention_impl="auto")).to(card).eval()
    auto.load_state_dict(xla.state_dict())
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 97, size=(2, 128))).to(card)
    mask = torch.ones(2, 128, dtype=torch.int32, device=card)
    mask[1, 50:] = 0
    with torch.inference_mode():
        before = flash_attention.launches
        got = auto(ids, mask)
        assert flash_attention.launches == before
        torch.testing.assert_close(got, xla(ids, mask), rtol=0, atol=0)
