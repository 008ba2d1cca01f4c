"""The T5/GTR routes of the port's ``prepare_model`` against the JAX
package's, on the same local directories: a T5 directory
(``save_t5_dir``), its ``t5:`` spelling, a sentence-transformers GTR
directory (``save_gtr_dir``, which the JAX side loads through
``sentence_transformers``), one written by ``transformers`` in
safetensors (the tied embedding stored once), and hub ids, which raise.

The same token ids, and embeddings within 1e-5 with both packages at f32;
at bf16 within 3e-2 of the largest entry (as ``test_torch_t5.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfar_tpu.models import build_encoder as jax_build_encoder
from mfar_tpu.models.registry import is_t5_family as jax_is_t5_family
from mfar_tpu.models.registry import prepare_model as jax_prepare_model
from mfar_tpu_torch.models import T5Config, build_encoder
from mfar_tpu_torch.models.registry import (
    is_t5_family,
    load_hf_weights,
    prepare_model,
    save_gtr_dir,
    save_t5_dir,
)
from mfar_tpu_torch.models.t5_encoder import init_t5_encoder

torch.set_num_threads(1)

WORDS = ["the", "red", "lamp", "glows", "blue", "book", "folds", "a"]
TEXTS = ["the red lamp glows", "a blue book folds slowly", "zz9 unknown", "red",
         " ".join(["lamp"] * 40)]
ATOL_F32 = 1e-5
BF16_REL = 3e-2


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("t5dirs")
    cfg = T5Config.tiny(vocab_size=96, gated_ffn=True)
    gtr_cfg = T5Config.tiny(vocab_size=96, projection_dim=24)
    out = {"t5": str(root / "t5"), "gtr": str(root / "gtr")}
    save_t5_dir(out["t5"], cfg, init_t5_encoder(cfg, seed=1).state_dict(), WORDS)
    save_gtr_dir(out["gtr"], gtr_cfg, init_t5_encoder(gtr_cfg, seed=2).state_dict(), WORDS)
    return out


def _embed(port, jax_out, max_length=16):
    """Both packages' embeddings of TEXTS through what prepare_model gave;
    asserts the same token ids."""
    (config, state, tok), (jconfig, jparams, jtok) = port, jax_out
    a, b = tok.encode_batch(TEXTS, max_length), jtok.encode_batch(TEXTS, max_length)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(a[key], b[key])
    model = build_encoder(config).eval()
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(a["input_ids"]).long(),
                    torch.from_numpy(a["attention_mask"])).numpy()
    want = jax_build_encoder(jconfig).apply(
        {"params": jparams}, jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]))
    return got, np.asarray(want)


@pytest.mark.parametrize("spelling", ["dir", "t5:"])
def test_t5_dir_matches_jax(dirs, spelling):
    model_id = dirs["t5"] if spelling == "dir" else f"t5:{dirs['t5']}"
    assert is_t5_family(model_id) and jax_is_t5_family(model_id)
    port = prepare_model(model_id, dtype=torch.float32, max_length=16)
    jax_out = jax_prepare_model(model_id, dtype=jnp.float32, max_length=16)
    config = port[0]
    assert config.gated_ffn and config.projection_dim is None and config.dtype == torch.float32
    assert config.dropout == jax_out[0].dropout
    got, want = _embed(port, jax_out)
    np.testing.assert_allclose(got, want, atol=ATOL_F32)
    # the tokenizer appends </s> and keeps it under truncation
    ids = port[2].encode_batch(TEXTS, 16)["input_ids"]
    assert ids[0, 4] == 1 and ids[4, 15] == 1


@pytest.mark.parametrize("normalize", [False, True])
def test_gtr_dir_matches_jax(dirs, normalize):
    with open(os.path.join(dirs["gtr"], "modules.json")) as f:
        assert [m["path"] for m in json.load(f)] == ["", "1_Pooling", "2_Dense", "3_Normalize"]
    port = prepare_model(dirs["gtr"], normalize=normalize, dtype=torch.float32, max_length=16)
    jax_out = jax_prepare_model(dirs["gtr"], normalize=normalize, dtype=jnp.float32,
                                max_length=16)
    assert port[0].projection_dim == jax_out[0].projection_dim == 24
    assert port[0].normalize == normalize
    got, want = _embed(port, jax_out)
    np.testing.assert_allclose(got, want, atol=ATOL_F32)


def test_gtr_dir_bf16_matches_jax(dirs):
    got, want = _embed(prepare_model(dirs["gtr"], max_length=16),
                       jax_prepare_model(dirs["gtr"], max_length=16))
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_safetensors_tied_embedding(tmp_path):
    """``transformers``' own save in safetensors stores the tied pair
    ``shared``/``encoder.embed_tokens`` once; both packages load it."""
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.T5Config(vocab_size=96, d_model=32, num_layers=2, num_heads=2,
                                      d_kv=16, d_ff=64, dropout_rate=0.0)
    torch.manual_seed(0)
    transformers.T5EncoderModel(hf_config).eval().save_pretrained(tmp_path)
    save_t5_dir(str(tmp_path / "tok"), T5Config.tiny(vocab_size=96),
                init_t5_encoder(T5Config.tiny(vocab_size=96)).state_dict(), WORDS)
    os.replace(tmp_path / "tok" / "tokenizer.json", tmp_path / "tokenizer.json")
    stored = load_hf_weights(str(tmp_path))
    assert "shared.weight" not in stored or "encoder.embed_tokens.weight" not in stored
    got, want = _embed(prepare_model(str(tmp_path), dtype=torch.float32, max_length=16),
                       jax_prepare_model(str(tmp_path), dtype=jnp.float32, max_length=16))
    np.testing.assert_allclose(got, want, atol=ATOL_F32)

    # and a safetensors file holding only the encoder's alias
    from safetensors.torch import save_file

    alias_only = {k: v for k, v in stored.items() if k != "shared.weight"}
    alias_only.setdefault("encoder.embed_tokens.weight", stored.get("shared.weight"))
    save_file({k: v.contiguous() for k, v in alias_only.items()},
              str(tmp_path / "model.safetensors"))
    got2, _ = _embed(prepare_model(str(tmp_path), dtype=torch.float32, max_length=16),
                     jax_prepare_model(str(tmp_path), dtype=jnp.float32, max_length=16))
    np.testing.assert_array_equal(got2, got)


def test_st_stack_kept_and_hub_ids_raise(dirs, tmp_path):
    """A T5 directory with modules.json keeps its sentence-transformers
    stack (the projection loads); hub ids and missing directories raise
    FileNotFoundError naming the local layouts."""
    config, state, _ = prepare_model(dirs["gtr"])
    assert config.projection_dim == 24 and "projection.weight" in state
    for model_id in ("sentence-transformers/gtr-t5-base", "t5:google-t5/t5-base",
                     str(tmp_path / "missing-gtr-t5")):
        assert is_t5_family(model_id) == jax_is_t5_family(model_id)
        with pytest.raises(FileNotFoundError, match="sentence-transformers GTR directory"):
            prepare_model(model_id)
    bert_dir = tmp_path / "bert"
    bert_dir.mkdir()
    (bert_dir / "config.json").write_text(json.dumps({"model_type": "bert"}))
    assert not is_t5_family(str(bert_dir)) and not jax_is_t5_family(str(bert_dir))
    no_tok = tmp_path / "no_tok"
    save_t5_dir(str(no_tok), T5Config.tiny(vocab_size=96),
                init_t5_encoder(T5Config.tiny(vocab_size=96)).state_dict(), WORDS)
    os.remove(no_tok / "tokenizer.json")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        prepare_model(str(no_tok))


def test_with_decoder_is_a_gtr_surface(dirs):
    with pytest.raises(ValueError, match="GTR-T5 surface"):
        prepare_model("synthetic", corpus_texts=["a b"], with_decoder=True)
    with pytest.raises(ValueError, match="gtr-t5"):
        prepare_model(dirs["t5"], with_decoder=True)
    cfg = prepare_model(dirs["t5"])[0]
    assert cfg.dtype == torch.bfloat16  # the pretrained default, as in JAX


def test_tokenizer_encodes_from_several_threads(dirs):
    """Threads encoding at different truncation lengths at once (the
    trainer's prefetch thread beside an index build) get what one thread
    gets; one reconfigured shared tokenizer raised "Already borrowed"."""
    import sys
    import threading

    tok = prepare_model(dirs["t5"], max_length=64)[2]
    texts = [" ".join(["red lamp glows"] * n) for n in range(1, 30)]
    want = {n: tok.encode_batch(texts, n)["input_ids"] for n in (8, 16, 64)}
    errors, done = [], []

    def work(i):
        try:
            for j in range(40):
                n = (8, 16, 64)[(i + j) % 3]
                np.testing.assert_array_equal(tok.encode_batch(texts, n)["input_ids"], want[n])
            done.append(i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert sorted(done) == list(range(16)) and not any(t.is_alive() for t in threads)
