"""The port's T5 encoder family against the JAX package's, on carried
weights (``t5_state_from_jax``) and the same numpy inputs.

- the relative-position bucket tables, bidirectional and causal, bit-equal
  to JAX's for every offset a 512-token sequence has (and beyond);
- ``T5Encoder`` in f32 (relu and gated FFN, with and without the GTR
  projection and normalize, token states too): within 1e-5;
- in bf16: within 3e-2 of the largest entry (two layers of bf16 rounding,
  where one ulp is 2**-8 relative and the two packages round the FFN's
  activation at different points);
- remat gradients equal to no remat with dropout on; a fully padded row
  stays finite;
- the seq2seq graft against ``mfar_tpu.models.t5_decoder`` on the same HF
  state dicts: logits (up to ~40 from HF's random init) within rtol 1e-5,
  atol 1e-5 (f32), and ``prepare_model(...,
  with_decoder=True)`` with JAX's id rule over local directories.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.models.t5_decoder import T5Seq2Seq as JaxSeq2Seq
from mfar_tpu.models.t5_decoder import causal_relative_position_bucket
from mfar_tpu.models.t5_decoder import graft_encoder_into_seq2seq as jax_graft
from mfar_tpu.models.t5_encoder import T5Config as JaxT5Config
from mfar_tpu.models.t5_encoder import T5Encoder as JaxT5Encoder
from mfar_tpu.models.t5_encoder import init_t5_params
from mfar_tpu.models.t5_encoder import relative_position_bucket as jax_bucket
from mfar_tpu_torch.models import T5Config, T5Encoder, build_encoder, encoder_dim
from mfar_tpu_torch.models.convert import t5_state_from_jax
from mfar_tpu_torch.models.registry import (
    prepare_model,
    save_gtr_dir,
    save_t5_dir,
    t5_checkpoint_id,
)
from mfar_tpu_torch.models.t5_decoder import (
    T5Seq2Seq,
    T5Seq2SeqConfig,
    graft_encoder_into_seq2seq,
    init_t5_seq2seq,
)
from mfar_tpu_torch.models.t5_encoder import bucket_table, init_t5_encoder, relative_position_bucket

torch.set_num_threads(1)

ATOL_F32 = 1e-5
BF16_REL = 3e-2
VOCAB = 128


def _inputs(b=3, s=20, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    return ids, mask


def _pair(dtype=torch.float32, **kw):
    """A JAX T5 encoder's params and the port encoder that carries them."""
    jcfg = JaxT5Config.tiny(vocab_size=VOCAB, **kw)
    params = jax.tree.map(np.asarray, init_t5_params(jcfg, seed=1))
    model = T5Encoder(T5Config.tiny(vocab_size=VOCAB, dtype=dtype, **kw)).eval()
    model.load_state_dict(t5_state_from_jax(params))
    return jcfg, params, model


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (16, 64), (32, 256)])
def test_bucket_tables_are_bit_equal_to_jax(bidirectional, buckets, distance):
    fn = jax_bucket if bidirectional else causal_relative_position_bucket
    rel = np.arange(-2047, 2048)
    np.testing.assert_array_equal(
        relative_position_bucket(rel, buckets, distance, bidirectional),
        np.asarray(fn(jnp.asarray(rel), buckets, distance)))
    for s in (1, 5, 8, 16, 64, 128, 512):
        pos = np.arange(s)
        want = np.asarray(fn(jnp.asarray(pos[None, :] - pos[:, None]), buckets, distance))
        np.testing.assert_array_equal(bucket_table(s, buckets, distance, bidirectional).numpy(),
                                      want)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("projection", [None, 24])
def test_encoder_matches_jax_f32(gated, projection):
    jcfg, params, model = _pair(gated_ffn=gated, projection_dim=projection,
                                normalize=projection is not None)
    ids, mask = _inputs()
    want, want_tokens = JaxT5Encoder(jcfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), return_tokens=True)
    with torch.no_grad():
        got, tokens = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                            return_tokens=True)
    assert got.shape == (3, encoder_dim(model.cfg)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), atol=ATOL_F32)


@pytest.mark.parametrize("gated", [False, True])
def test_encoder_matches_jax_bf16(gated):
    jcfg, params, _ = _pair(gated_ffn=gated, projection_dim=24)
    _, _, model = _pair(dtype=torch.bfloat16, gated_ffn=gated, projection_dim=24)
    ids, mask = _inputs()
    want = np.asarray(JaxT5Encoder(dataclasses.replace(jcfg, dtype=jnp.bfloat16)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_padded_rows_and_build_encoder():
    cfg = T5Config.tiny(vocab_size=VOCAB, projection_dim=16)
    model = build_encoder(cfg)
    assert isinstance(model, T5Encoder) and encoder_dim(cfg) == 16
    assert encoder_dim(dataclasses.replace(cfg, projection_dim=None)) == cfg.d_model
    model.load_state_dict(init_t5_encoder(cfg, seed=0).state_dict())
    ids, mask = _inputs()
    mask[2] = 0  # a wholly padded row
    with torch.no_grad():
        out, tokens = model.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                   return_tokens=True)
    assert torch.isfinite(out).all() and torch.isfinite(tokens).all()
    assert torch.equal(out[2], torch.zeros(16))


def test_remat_gradients_equal_no_remat():
    """Dropout on, the same generator seed: remat recomputes each layer with
    the same masks, so the gradients are equal."""
    cfg = T5Config.tiny(vocab_size=VOCAB, dropout=0.1, projection_dim=16)
    ids, mask = _inputs()
    grads = []
    for remat in (False, True):
        model = T5Encoder(dataclasses.replace(cfg, remat=remat))
        model.load_state_dict(init_t5_encoder(cfg, seed=2).state_dict())
        model.train()
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    generator=torch.Generator().manual_seed(5))
        out.square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7, msg=name)
    # dropout is on: the output differs from the deterministic one
    model.eval()
    with torch.no_grad():
        det = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert not torch.allclose(det, out.detach())


def _hf_full(gated):
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.T5Config(
        vocab_size=VOCAB, d_model=32, num_layers=2, num_decoder_layers=3, num_heads=2, d_kv=16,
        d_ff=64, dropout_rate=0.0, feed_forward_proj="gated-gelu" if gated else "relu",
        tie_word_embeddings=not gated,
    )
    torch.manual_seed(1)
    return transformers.T5ForConditionalGeneration(hf_config).eval().state_dict()


@pytest.mark.parametrize("gated", [False, True])
def test_seq2seq_graft_matches_jax(gated):
    """The same HF checkpoint and the same trained encoder through both
    grafts: the projection is dropped, the head tied (v1.0) or untied
    (v1.1), and the teacher-forced logits agree."""
    full = _hf_full(gated)
    jcfg, params, model = _pair(gated_ffn=gated, projection_dim=24)
    jdec = dataclasses.replace(jcfg, num_layers=3)
    jconfig, jparams = jax_graft(params, full, jcfg, jdec)
    config, state = graft_encoder_into_seq2seq(
        model.state_dict(), full, model.cfg, dataclasses.replace(model.cfg, num_layers=3))
    assert config.tie_lm_head == jconfig.tie_lm_head == (not gated)
    assert config.encoder.projection_dim is None and "encoder.projection.weight" not in state
    seq2seq = T5Seq2Seq(config).eval()
    seq2seq.load_state_dict(state)
    ids, mask = _inputs()
    dec = np.random.default_rng(3).integers(0, VOCAB, (3, 6)).astype(np.int32)
    want = JaxSeq2Seq(jconfig).apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(mask),
                                     jnp.asarray(dec))
    with torch.no_grad():
        got = seq2seq(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                      torch.from_numpy(dec).long())
    assert got.shape == (3, 6, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=ATOL_F32)


def test_prepare_model_with_decoder_over_local_dirs(tmp_path, monkeypatch):
    """JAX's id rule (gtr-t5 ids only; the size from the suffix, xl/xxl as
    3b/11b), with the GTR and T5 checkpoints in local directories."""
    assert t5_checkpoint_id("sentence-transformers/gtr-t5-xl") == "google-t5/t5-3b"
    assert t5_checkpoint_id("sentence-transformers/gtr-t5-xxl") == "google-t5/t5-11b"
    words = ["red", "lamp", "glows"]
    cfg = T5Config.tiny(vocab_size=VOCAB, projection_dim=24)
    seq_cfg = T5Seq2SeqConfig(encoder=dataclasses.replace(cfg, projection_dim=None),
                              decoder=cfg)
    t5 = init_t5_seq2seq(seq_cfg, seed=4)
    dec_state = t5.decoder.state_dict()
    dec_state["token_embed.weight"] = t5.encoder.token_embed.weight.detach()  # v1.0 ties them
    monkeypatch.chdir(tmp_path)
    save_t5_dir("google-t5/t5-base", seq_cfg.encoder, t5.encoder.state_dict(), words,
                decoder_state=dec_state)
    save_gtr_dir("sentence-transformers/gtr-t5-base", cfg,
                 init_t5_encoder(cfg, seed=5).state_dict(), words)
    config, state, tok, (s2s_cfg, s2s_state) = prepare_model(
        "sentence-transformers/gtr-t5-base", dtype=torch.float32, max_length=16,
        with_decoder=True)
    assert config.projection_dim == 24 and s2s_cfg.tie_lm_head
    model = T5Seq2Seq(dataclasses.replace(
        s2s_cfg, decoder=dataclasses.replace(s2s_cfg.decoder, dtype=torch.float32)))
    model.load_state_dict(s2s_state)
    for k, v in state.items():
        if k != "projection.weight":
            torch.testing.assert_close(model.encoder.state_dict()[k], v)
    toks = tok.encode_batch(["red lamp glows", "lamp"], 16)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(toks["input_ids"]).long(),
                              torch.from_numpy(toks["attention_mask"]),
                              torch.zeros((2, 4), dtype=torch.long))
    assert logits.shape == (2, 4, VOCAB) and torch.isfinite(logits).all()

    with pytest.raises(ValueError, match="gtr-t5"):
        prepare_model("google-t5/t5-base", with_decoder=True)
    save_gtr_dir("sentence-transformers/gtr-t5-large", cfg,
                 init_t5_encoder(cfg, seed=5).state_dict(), words)
    with pytest.raises(FileNotFoundError, match="google-t5/t5-large"):
        prepare_model("sentence-transformers/gtr-t5-large", with_decoder=True)
