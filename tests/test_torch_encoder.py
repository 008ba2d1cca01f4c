"""The port's encoder against the JAX ``Encoder`` on the same weights, the HF
BERT converter against ``transformers``, and the tokenizer copy against
``mfar_tpu``'s.

Tolerance atol=2e-4, as ``tests/test_encoder.py``'s torch parity: f32 on
both sides, with matmul and LayerNorm reductions in different orders across
four layers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.models import Encoder as JaxEncoder
from mfar_tpu.models import EncoderConfig as JaxConfig
from mfar_tpu.models import T5Config as JaxT5Config
from mfar_tpu.models import encoder_dim as jax_encoder_dim
from mfar_tpu.models.encoder import init_params
from mfar_tpu.models.tokenizer import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu_torch.models import T5Config, T5Encoder, build_encoder, encoder_dim
from mfar_tpu_torch.models.convert import (
    config_from_hf,
    encoder_state_from_hf_bert,
    encoder_state_from_jax,
    mixer_from_jax,
)
from mfar_tpu_torch.models.encoder import (
    Encoder,
    EncoderConfig,
    init_encoder,
    use_flash_attention,
)
from mfar_tpu_torch.models.registry import prepare_model
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer, pad_to_bucket

torch.set_num_threads(1)

ATOL = 2e-4


def _ids_and_mask(vocab, b=4, s=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[2, 8:] = 0
    mask[3, 5:] = 0
    return ids, mask


@pytest.mark.parametrize("normalize", [False, True])
def test_encoder_matches_jax_on_carried_weights(normalize):
    jcfg = JaxConfig.tiny(vocab_size=97, hidden_size=32, num_layers=3, normalize=normalize)
    params = jax.tree.map(np.asarray, init_params(jcfg, seed=0))
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=32, num_layers=3, normalize=normalize)
    model = Encoder(cfg).eval()
    model.load_state_dict(encoder_state_from_jax(params, cfg))

    ids, mask = _ids_and_mask(97)
    want_pooled, want_tokens = JaxEncoder(jcfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), return_tokens=True
    )
    with torch.inference_mode():
        pooled, tokens = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                               return_tokens=True)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=ATOL)


def test_bf16_activations_track_f32():
    """contriever_base numerics (f32 params, bf16 activations) at a tiny
    width: the bf16 encoder stays within bf16 rounding of its f32 self."""
    f32 = EncoderConfig.tiny(vocab_size=97, hidden_size=32, num_layers=2)
    model = init_encoder(f32, seed=1)
    bf = Encoder(dataclasses.replace(f32, dtype=torch.bfloat16)).eval()
    bf.load_state_dict(model.state_dict())
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    ids, mask = _ids_and_mask(97, seed=1)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask))
    with torch.inference_mode():
        a, b = model(*args), bf(*args)
    assert b.dtype == torch.float32  # pooling runs in f32
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=0.1, rtol=0.05)


def test_flash_attention_not_ported_and_auto_is_plain():
    """(Named when K2 was not ported yet.)  "flash" raises below S = 128 and
    off a multiple of 128, as JAX's gate does; "auto" on the CPU is the
    plain path, pads included; an unknown name still raises."""
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=128, num_heads=2, num_layers=2)
    xla = init_encoder(cfg, seed=3)
    flash, auto = (Encoder(dataclasses.replace(cfg, attention_impl=a)).eval()
                   for a in ("flash", "auto"))
    flash.load_state_dict(xla.state_dict())
    auto.load_state_dict(xla.state_dict())
    for s in (64, 120):
        ids, mask = (torch.from_numpy(a) for a in _ids_and_mask(97, s=s))
        with pytest.raises(ValueError, match="seq % 128"):
            flash(ids.long(), mask)
    ids, mask = (torch.from_numpy(a) for a in _ids_and_mask(97, s=128))
    with torch.inference_mode():
        _, got = auto(ids.long(), mask, return_tokens=True)
        _, want = xla(ids.long(), mask, return_tokens=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        EncoderConfig.tiny(attention_impl="pallas")


def test_flash_encoder_matches_jax_xla_on_valid_tokens():
    """The port's "flash" encoder on the CPU (through K2's plain version)
    against the JAX encoder's "xla" path on carried weights, at S = 128 and
    D = 64.  Valid tokens and the pooled embedding agree (atol 2e-4, as
    above); pad positions differ by design: under segment ids pads attend
    only pads (mfar_tpu/models/encoder.py:159-163)."""
    kw = dict(vocab_size=97, hidden_size=128, num_heads=2, num_layers=2)
    jcfg = JaxConfig.tiny(**kw)
    params = jax.tree.map(np.asarray, init_params(jcfg, seed=0))
    cfg = EncoderConfig.tiny(attention_impl="flash", **kw)
    model = Encoder(cfg).eval()
    model.load_state_dict(encoder_state_from_jax(params, cfg))

    ids, mask = _ids_and_mask(97, s=128)
    mask[1, 2:] = 0  # a row of 2 valid tokens
    want_pooled, want_tokens = JaxEncoder(jcfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), return_tokens=True
    )
    with torch.inference_mode():
        pooled, tokens = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                               return_tokens=True)
    valid = mask.astype(bool)
    np.testing.assert_allclose(tokens.numpy()[valid], np.asarray(want_tokens)[valid], atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=ATOL)
    assert not np.allclose(tokens.numpy()[~valid], np.asarray(want_tokens)[~valid], atol=ATOL)


# EncoderConfig.tiny (f32, hidden 64 / 4 heads: D = 16), the synthetic
# models' D = 32 in f32, and D = 32 in bf16 (all-MiniLM-L6-v2's head width).
# f32 at atol 2e-4 as above.  bf16 at atol 5e-2: both frameworks round the
# hidden states to bf16 (one ulp is 1.6e-2 in [2, 4)) at different places,
# and the port's own "xla" path sits 3.1e-2 off JAX's there too.
@pytest.mark.parametrize("kw,dtype,atol", [
    pytest.param({}, "f32", ATOL, id="tiny-f32-D16"),
    pytest.param(dict(hidden_size=64, num_heads=2), "f32", ATOL, id="f32-D32"),
    pytest.param(dict(hidden_size=64, num_heads=2, num_layers=2), "bf16", 5e-2, id="bf16-D32"),
])
def test_flash_encoder_matches_jax_xla_at_other_head_dims(kw, dtype, atol):
    """The port's "flash" encoder on the CPU (K2's plain version, the
    function the card's CUDA-core route computes) against JAX's "xla"
    encoder on carried weights at head dims other than 64: valid tokens
    and the pooled embedding agree."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = JaxConfig.tiny(vocab_size=97, dtype=jdt, **kw)
    params = jax.tree.map(np.asarray, init_params(jcfg, seed=0))
    cfg = EncoderConfig.tiny(vocab_size=97, dtype=tdt, attention_impl="flash", **kw)
    assert cfg.hidden_size // cfg.num_heads in (16, 32)
    model = Encoder(cfg).eval()
    model.load_state_dict(encoder_state_from_jax(params, cfg))
    ids, mask = _ids_and_mask(97, s=128)
    mask[1, 2:] = 0  # a row of 2 valid tokens
    want_pooled, want_tokens = JaxEncoder(jcfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), return_tokens=True
    )
    with torch.inference_mode():
        pooled, tokens = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                               return_tokens=True)
    valid = mask.astype(bool)
    want_tokens = np.asarray(want_tokens.astype(jnp.float32))
    np.testing.assert_allclose(tokens.float().numpy()[valid], want_tokens[valid], atol=atol)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled, np.float32), atol=atol)


def _jax_gate(impl, seq, dropout_active, backend):
    """JAX's gate as ``mfar_tpu/models/encoder.py:146-157`` writes it: the
    flash kernel on a TPU backend at seq % 128 == 0, seq >= 128 with
    inactive attention dropout; "flash" raises where that fails."""
    flash_ok = backend == "tpu" and seq >= 128 and seq % 128 == 0 and not dropout_active
    if impl == "flash" and not flash_ok:
        raise ValueError("attention_impl='flash' needs ...")
    return impl in ("flash", "auto") and flash_ok


@pytest.mark.parametrize("impl", ["xla", "auto", "flash"])
def test_flash_gate_is_jax_gate(impl):
    """The port's gate is JAX's with "TPU" read as "CUDA": seq and the
    dropout state decide it, and it takes no dtype or head dim.  One
    difference by design: "flash" on CPU tensors runs K2's plain version
    where JAX's, off a TPU, raises.  The JAX encoder on this CPU backend
    takes its plain path under "auto", as the port's gate says off the
    card."""
    for seq in (1, 64, 120, 127, 128, 200, 256, 384, 512):
        for dropout_active in (False, True):
            for on_cuda in (False, True):
                backend = "tpu" if on_cuda or impl == "flash" else "cpu"
                try:
                    want = _jax_gate(impl, seq, dropout_active, backend)
                except ValueError:
                    with pytest.raises(ValueError, match="seq % 128"):
                        use_flash_attention(impl, seq, dropout_active, on_cuda)
                    continue
                assert use_flash_attention(impl, seq, dropout_active, on_cuda) is want, \
                    (seq, dropout_active, on_cuda)
    assert jax.default_backend() == "cpu"
    assert use_flash_attention("auto", 128, False, on_cuda=False) is False


def test_build_encoder_and_dim():
    cfg = EncoderConfig.tiny(vocab_size=97, hidden_size=32)
    assert isinstance(build_encoder(cfg), Encoder) and encoder_dim(cfg) == 32
    # the T5 family dispatches on its config type, as in the JAX package
    t5 = T5Config.tiny(projection_dim=24)
    assert isinstance(build_encoder(t5), T5Encoder)
    assert encoder_dim(t5) == 24 == jax_encoder_dim(JaxT5Config.tiny(projection_dim=24))


def test_hf_bert_state_and_registry_dir(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.BertConfig(
        vocab_size=97, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64,
    )
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_config, add_pooling_layer=False).eval()
    ids, mask = _ids_and_mask(97)
    with torch.inference_mode():
        hf_tokens = hf(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    hf_pooled = (hf_tokens * torch.from_numpy(mask)[..., None]).sum(1) / torch.from_numpy(
        mask).sum(1, keepdim=True)

    cfg = config_from_hf(hf_config.to_dict(), dtype=torch.float32)
    model = Encoder(cfg).eval()
    model.load_state_dict(encoder_state_from_hf_bert(hf.state_dict()))
    with torch.inference_mode():
        pooled, tokens = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                               return_tokens=True)
    np.testing.assert_allclose(tokens.numpy(), hf_tokens.numpy(), atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), hf_pooled.numpy(), atol=ATOL)

    # the registry's local-directory route: config.json + pytorch_model.bin
    # plus a word-level tokenizer.json
    hf.save_pretrained(tmp_path, safe_serialization=False)
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {"[UNK]": 1, "red": 5, "shoe": 6}, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    cfg2, state, tok2 = prepare_model(str(tmp_path), dtype=torch.float32, max_length=16)
    assert tok2.encode_batch(["red shoe"])["input_ids"][0, :2].tolist() == [5, 6]
    assert cfg2 == cfg
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state[k], v)


def test_registry_routes():
    cfg, state, tok = prepare_model("synthetic:300:128", corpus_texts=["red shoe glows"] * 3)
    assert cfg.hidden_size == 128 and cfg.dtype == torch.float32
    Encoder(cfg).load_state_dict(state)
    assert tok.vocab_size == 7  # 4 reserved ids + 3 words
    with pytest.raises(FileNotFoundError, match="local sentence-transformers GTR directory"):
        prepare_model("sentence-transformers/gtr-t5-base")
    with pytest.raises(FileNotFoundError, match="local directory"):
        prepare_model("facebook/contriever-msmarco")


def test_mixer_from_jax_keeps_layout():
    w = np.random.default_rng(0).normal(size=(32, 5)).astype(np.float32)
    got = mixer_from_jax({"weight": jnp.asarray(w)})
    assert got["weight"].shape == (32, 5)
    np.testing.assert_array_equal(got["weight"].numpy(), w)


@pytest.mark.parametrize("bucket", [True, False])
def test_tokenizer_copy_matches(bucket):
    texts = ["red shoe glows", "a blue lamp", "", "red shoe " * 40]
    mine = SimpleVocabTokenizer.build(texts, max_length=32)
    theirs = JaxTokenizer.build(texts, max_length=32)
    assert mine.vocab == theirs.vocab
    for max_len in (None, 16):
        a = mine.encode_batch(texts, max_len, bucket=bucket)
        b = theirs.encode_batch(texts, max_len, bucket=bucket)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[key], b[key])
    assert pad_to_bucket(5, 512) == 8
