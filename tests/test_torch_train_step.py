"""One train step of the port against the JAX package's, on one tiny
``MFARModel`` whose weights the port takes over (``model_state_from_jax``):
the loss and every parameter's gradient (through the port's plain ``"xla"``
attention and through its ``"flash"`` path, kernel K2 and K2b's plain
versions on the CPU, both against JAX's ``"xla"``: JAX's ``"flash"`` needs a
TPU, and pad positions never reach the loss), one optimizer step for both
groups (and with ``freeze_encoder``), the batchnorm's running stats, the
deterministic eval loss, and the three remat policies against no remat with
dropout on.

The model: hidden 128, 2 heads (head dim 64, as K2 takes), 2 layers, f32,
dropout 0 for the JAX comparisons; queries and one field of 128 tokens and
one field of 256 (two encoder calls, both of which ``"flash"`` takes),
ragged attention masks.

Tolerances (f32, the same arithmetic in other orders: Flax's LayerNorm
takes the one-pass variance E[x^2] - E[x]^2, and scores are scaled by
1/temperature = 20): loss rtol 1e-5; each gradient within 5e-4 of its
leaf's largest entry (measured up to 1.4e-4) plus 1e-6 of the largest
gradient of any leaf (leaves whose gradient is 0 in exact arithmetic, as
the key bias under the softmax, carry rounding noise); parameters after one
AdamW step from the same gradients atol 1e-7; running stats rtol 2e-4 (the
one-pass variance of scores whose variance is ~1e3 cancels in f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mfar_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from mfar_tpu.models.t5_encoder import T5Config as JaxT5Config
from mfar_tpu.train.model import MFARModel as JaxMFARModel
from mfar_tpu.train.optim import make_optimizer as jax_make_optimizer
from mfar_tpu.train.train_step import init_state as jax_init_state
from mfar_tpu.train.train_step import make_eval_loss_step, make_train_step
from mfar_tpu_torch.models.convert import model_state_from_jax
from mfar_tpu_torch.models.encoder import EncoderConfig
from mfar_tpu_torch.models.t5_encoder import T5Config
from mfar_tpu_torch.ops.flash_attention import flash_attention
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer
from mfar_tpu_torch.train.train_step import TrainState, eval_loss_step, to_device, train_step

torch.set_num_threads(1)

B, VOCAB = 4, 64
WIDTHS = {"alpha_dense": 128, "beta_dense": 256}
DIMS = dict(vocab_size=VOCAB, hidden_size=128, num_heads=2, num_layers=2,
            intermediate_size=256, max_position_embeddings=256)


def _batch(seed=0):
    rng = np.random.default_rng(seed)

    def toks(n, width):
        mask = np.zeros((n, width), np.int32)
        for i in range(n):
            mask[i, : rng.integers(2, width + 1)] = 1
        return {"input_ids": (rng.integers(4, VOCAB, size=(n, width)) * mask).astype(np.int32),
                "attention_mask": mask}

    return {"query": toks(B, 128),
            "pos": {fk: toks(B, w) for fk, w in WIDTHS.items()},
            "neg": {fk: toks(B, w) for fk, w in WIDTHS.items()}}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model with batchnorm, its initial state, and one batch's loss,
    gradients and running stats (train=True), plus its eval loss."""
    model = JaxMFARModel(
        encoder_config=JaxEncoderConfig.tiny(**DIMS, hidden_dropout=0.0, attention_dropout=0.0),
        num_fields=2, use_batchnorm=True, temperature=0.05)
    state = jax_init_state(model, jax_make_optimizer(encoder_lr=1e-3, weights_lr=1e-1), seed=0)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(params):
        loss, upd = model.apply(
            {"params": params, "batch_stats": state.batch_stats}, jbatch["query"],
            jbatch["pos"], jbatch["neg"], None, None, train=True,
            method=model.compute_loss, mutable=["batch_stats"])
        return loss, upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    eval_loss = jax.jit(make_eval_loss_step(model))(state, jbatch)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(model=model, state=state, batch=batch, loss=float(loss), grads=to_np(grads),
                stats=to_np(stats), eval_loss=float(eval_loss))


def _port_model(ref, impl="xla", **cfg):
    config = EncoderConfig.tiny(**{**DIMS, "hidden_dropout": 0.0, "attention_dropout": 0.0,
                                   "attention_impl": impl, **cfg})
    model = MFARModel(config, num_fields=2, use_batchnorm=True, temperature=0.05)
    state = jax.tree.map(np.asarray, ref["state"])
    model.load_state_dict(model_state_from_jax(state.params, state.batch_stats))
    return model


def _state(model, **opt):
    spec = make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, **opt)
    return TrainState(model=model, optimizer=spec.build(model), step=0,
                      generator=torch.Generator().manual_seed(0))


def _loss_and_grads(model, batch, generator=None):
    b = to_device(batch, torch.device("cpu"))
    model.train()
    loss = model.compute_loss(b["query"], b["pos"], b["neg"], generator=generator)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_gradients_match_jax(jax_ref, impl):
    model = _port_model(jax_ref, impl)
    before = flash_attention.launches
    loss, grads = _loss_and_grads(model, jax_ref["batch"])
    assert flash_attention.launches == before  # CPU tensors: the plain versions
    assert loss == pytest.approx(jax_ref["loss"], rel=5e-5)
    state = jax.tree.map(np.asarray, jax_ref["state"])
    want = model_state_from_jax(jax_ref["grads"], state.batch_stats)
    assert set(grads) == {k for k in want if k not in ("bn.mean", "bn.var")}
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max() + 1e-6 * top, err_msg=name)
    np.testing.assert_allclose(model.bn.mean.numpy(), jax_ref["stats"]["bn"]["mean"], rtol=1e-5)
    np.testing.assert_allclose(model.bn.var.numpy(), jax_ref["stats"]["bn"]["var"], rtol=2e-4)


@pytest.mark.parametrize("freeze", [False, True])
def test_one_optimizer_step_matches_jax(jax_ref, freeze):
    """AdamW on both groups (encoder lr 1e-3 with weight decay 0.01, head lr
    0.1 with decay 0.01), or the head alone with a frozen encoder: the
    port's optimizer fed JAX's gradients moves every parameter as optax
    does.  Then the port's own train step: its loss and global gradient
    norm against JAX's step, the batchnorm's running stats, and which
    groups moved.  (Parameters after the two steps are not compared entry
    by entry: a first Adam step moves an entry by lr * g / (|g| + 1e-8),
    so entries whose gradient is rounding noise near 0 -- the key bias, the
    batchnorm bias -- move by up to lr in either direction.)"""
    opt = jax_make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, weight_decay=0.01,
                             freeze_encoder=freeze)
    jstate = jax_ref["state"]._replace(opt_state=opt.init(jax_ref["state"].params))
    updates, _ = opt.update(jax_ref["grads"], jstate.opt_state, jstate.params)
    new_params = jax.tree.map(np.asarray, optax.apply_updates(jstate.params, updates))
    stats = jax.tree.map(np.asarray, jstate.batch_stats)
    want = model_state_from_jax(new_params, stats)
    grads = model_state_from_jax(jax_ref["grads"], stats)

    model = _port_model(jax_ref)
    optimizer = make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, weight_decay=0.01,
                               freeze_encoder=freeze).build(model)
    for name, p in model.named_parameters():
        p.grad = grads[name].clone()
    optimizer.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)

    _, metrics = jax.jit(make_train_step(jax_ref["model"], opt))(
        jstate, jax.tree.map(jnp.asarray, jax_ref["batch"]))
    model = _port_model(jax_ref)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state, got = train_step(_state(model, weight_decay=0.01, freeze_encoder=freeze),
                            jax_ref["batch"])
    assert state.step == 1 and all(p.grad is None for p in model.parameters())
    assert got["loss"].item() == pytest.approx(float(metrics["loss"]), rel=5e-5)
    assert got["grad_norm"].item() == pytest.approx(float(metrics["grad_norm"]), rel=5e-4)
    for name in ("bn.mean", "bn.var"):
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   jax_ref["stats"]["bn"][name[3:]], rtol=2e-4)
    moved = {n: not torch.equal(p, start[n]) for n, p in model.state_dict().items()}
    assert moved["mixer.weight"] and moved["bn.scale"]
    assert all(moved[n] != freeze for n in moved if n.startswith("encoder."))


def test_eval_loss_is_deterministic_and_matches_jax(jax_ref):
    state = _state(_port_model(jax_ref))
    first = eval_loss_step(state, jax_ref["batch"]).item()
    assert eval_loss_step(state, jax_ref["batch"]).item() == first
    assert first == pytest.approx(jax_ref["eval_loss"], rel=5e-5)
    assert state.model.bn.mean.abs().max().item() == 0.0  # running stats untouched


@pytest.mark.parametrize("policy", ["full", "attn_out", "dots"])
def test_remat_policies_match_no_remat(jax_ref, policy):
    """Recomputed layers give the loss and gradients of no remat, dropout on
    (hidden and attention 0.1): the recompute draws the same masks."""
    out = {}
    for remat in (False, True):
        model = _port_model(jax_ref, remat=remat, remat_policy=policy, hidden_dropout=0.1,
                            attention_dropout=0.1)
        out[remat] = _loss_and_grads(model, _batch(1), torch.Generator().manual_seed(5))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, rtol=1e-5, atol=1e-7)


def test_dropout_masks_and_the_flash_gate():
    """Dropout is on only in training and draws its masks from the caller's
    generator: the same seed gives the same embeddings, another seed others,
    eval mode none.  "flash" refuses training with attention dropout on (the
    kernel has none), as JAX's gate does; with attention dropout 0 it runs."""
    b = to_device(_batch(2)["pos"]["alpha_dense"], torch.device("cpu"))
    ids, mask = b["input_ids"], b["attention_mask"]
    with_attention_dropout = MFARModel(
        EncoderConfig.tiny(**{**DIMS, "attention_impl": "flash"}), num_fields=2).encoder.train()
    with pytest.raises(ValueError, match="inactive attention dropout"):
        with_attention_dropout(ids, mask, generator=torch.Generator().manual_seed(1))
    model = MFARModel(EncoderConfig.tiny(**{**DIMS, "attention_impl": "flash",
                                            "attention_dropout": 0.0}), num_fields=2).encoder
    model.load_state_dict(with_attention_dropout.state_dict())
    with torch.no_grad():
        ref = model.eval()(ids, mask)
        model.train()
        a, again, other = (model(ids, mask, generator=torch.Generator().manual_seed(seed))
                           for seed in (1, 1, 2))
        torch.testing.assert_close(model.eval()(ids, mask), ref, rtol=0, atol=0)
    torch.testing.assert_close(a, again, rtol=0, atol=0)
    assert not torch.allclose(a, other) and not torch.allclose(a, ref)


@pytest.mark.parametrize("use_batchnorm", [False, True])
def test_hybrid_train_step_matches_jax(use_batchnorm):
    """A hybrid batch: the two dense fields and one BM25 field, whose scores
    ride in ``sparse_pos`` [B, B, 1] and ``sparse_neg`` [B, B*Nn, 1].  The
    port's train step on JAX's initial weights gives JAX's loss and
    gradient norm, and the BM25 scores move both."""
    model = JaxMFARModel(
        encoder_config=JaxEncoderConfig.tiny(**DIMS, hidden_dropout=0.0, attention_dropout=0.0),
        num_fields=3, use_batchnorm=use_batchnorm, temperature=0.05)
    opt = jax_make_optimizer(encoder_lr=1e-3, weights_lr=1e-1)
    jstate = jax_init_state(model, opt, seed=1)
    batch = _batch(3)
    rng = np.random.default_rng(4)
    batch["sparse_pos"] = rng.gamma(2.0, 2.0, size=(B, B, 1)).astype(np.float32)
    batch["sparse_neg"] = rng.gamma(2.0, 2.0, size=(B, B, 1)).astype(np.float32)
    _, want = jax.jit(make_train_step(model, opt))(jstate, jax.tree.map(jnp.asarray, batch))

    def port_step(b):
        config = EncoderConfig.tiny(**{**DIMS, "hidden_dropout": 0.0, "attention_dropout": 0.0})
        port = MFARModel(config, num_fields=3, use_batchnorm=use_batchnorm, temperature=0.05)
        state = jax.tree.map(np.asarray, jstate)
        port.load_state_dict(model_state_from_jax(state.params, state.batch_stats))
        return train_step(_state(port), b)[1]

    got = port_step(batch)
    assert got["loss"].item() == pytest.approx(float(want["loss"]), rel=5e-5)
    assert got["grad_norm"].item() == pytest.approx(float(want["grad_norm"]), rel=5e-4)
    zeroed = port_step({**batch, "sparse_pos": np.zeros_like(batch["sparse_pos"]),
                        "sparse_neg": np.zeros_like(batch["sparse_neg"])})
    assert zeroed["loss"].item() != pytest.approx(got["loss"].item(), rel=1e-3)
    assert zeroed["grad_norm"].item() != pytest.approx(got["grad_norm"].item(), rel=1e-3)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_train_step_matches_jax(gated):
    """A T5 MFARModel (2 layers, d_model 32, the GTR projection to 24),
    dropout 0, JAX's initial weights: the loss and every gradient as in the
    ``xla`` case above, then the port's whole train step with Adafactor on
    the encoder against JAX's (loss, gradient norm, the encoder moved)."""
    jcfg = JaxT5Config.tiny(vocab_size=VOCAB, projection_dim=24, gated_ffn=gated)
    model = JaxMFARModel(encoder_config=jcfg, num_fields=2, temperature=0.05)
    opt = jax_make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, use_adafactor=True)
    jstate = jax_init_state(model, opt, seed=2)
    batch = _batch(5)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(params):
        return model.apply({"params": params}, jbatch["query"], jbatch["pos"], jbatch["neg"],
                           None, None, train=True, method=model.compute_loss)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    _, metrics = jax.jit(make_train_step(model, opt))(jstate, jbatch)

    def port_model():
        port = MFARModel(T5Config.tiny(vocab_size=VOCAB, projection_dim=24, gated_ffn=gated),
                         num_fields=2, temperature=0.05)
        port.load_state_dict(model_state_from_jax(jax.tree.map(np.asarray, jstate.params)))
        return port

    got_loss, got = _loss_and_grads(port_model(), batch)
    assert got_loss == pytest.approx(float(loss), rel=5e-5)
    want = model_state_from_jax(jax.tree.map(np.asarray, grads))
    assert set(got) == set(want)
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=5e-4 * np.abs(w).max() + 1e-6 * top, err_msg=name)

    port = port_model()
    start = {k: v.clone() for k, v in port.state_dict().items()}
    spec = make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, use_adafactor=True)
    state, m = train_step(TrainState(model=port, optimizer=spec.build(port), step=0,
                                     generator=torch.Generator().manual_seed(0)), batch)
    assert m["loss"].item() == pytest.approx(float(metrics["loss"]), rel=5e-5)
    assert m["grad_norm"].item() == pytest.approx(float(metrics["grad_norm"]), rel=5e-4)
    assert all(not torch.equal(v, start[k]) for k, v in port.state_dict().items())
