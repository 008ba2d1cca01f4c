"""The port's loss family (``mfar_tpu_torch.train.losses``) and field
batchnorm against the JAX package's on the same numpy inputs: loss values
and the gradients of every input (embeddings, mixer weight, batchnorm scale
and bias), in f32.  Tolerance rtol 1e-4, atol 1e-5: the same f32
arithmetic, summed in other orders (scores reach 1/temperature = 20)."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mfar_tpu.train import losses as jl
from mfar_tpu.train.model import FieldMixer as JaxMixer
from mfar_tpu_torch.train import losses as tl
from mfar_tpu_torch.train.model import FieldBatchNorm, FieldMixer

torch.set_num_threads(1)

B, FD, NN, E, FS = 4, 3, 2, 8, 2
TEMP = 0.05
TOL = dict(rtol=1e-4, atol=1e-5)


def _data(seed=0, sparse=False):
    rng = np.random.default_rng(seed)
    d = {
        "q": rng.normal(size=(B, E)).astype(np.float32),
        "d_pos": rng.normal(size=(B, FD, E)).astype(np.float32),
        "d_neg": rng.normal(size=(B, FD, NN, E)).astype(np.float32),
        "w": rng.normal(scale=0.3, size=(E, FD + (FS if sparse else 0))).astype(np.float32),
    }
    if sparse:
        d["sparse_pos"] = rng.uniform(0, 5, size=(B, B, FS)).astype(np.float32)
        d["sparse_neg"] = rng.uniform(0, 5, size=(B, B * NN, FS)).astype(np.float32)
    return d


def _leaves(d, names):
    return [torch.tensor(d[n], requires_grad=True) for n in names]


def _set(param, value):
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))
    return param


def _check(jax_value, jax_grads, t_value, t_leaves):
    np.testing.assert_allclose(t_value.item(), float(jax_value), **TOL)
    for t, g in zip(t_leaves, jax_grads):
        got = torch.zeros_like(t) if t.grad is None else t.grad  # an unused input: JAX's 0
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **TOL)


def _jax_mix(w):
    return lambda comp, q: JaxMixer(w.shape[1], w.shape[0]).apply({"params": {"weight": w}}, comp, q)


def _torch_mix(w):
    """The port's FieldMixer holding ``w``; its weight is the gradient leaf."""
    mixer = FieldMixer(w.shape[1], w.shape[0])
    _set(mixer.weight, w)
    return mixer


@pytest.mark.parametrize("in_batch,reverse,with_neg", [
    (True, True, True), (True, False, True), (True, True, False), (False, True, True),
])
def test_contrastive_loss(in_batch, reverse, with_neg):
    d = _data(1)
    d["d_pos"] = d["d_pos"][:, 0]
    d["d_neg"] = d["d_neg"][:, 0]  # [B, Nn, E]
    names = ["q", "d_pos", "d_neg"] if with_neg else ["q", "d_pos"]

    def jf(*args):
        kw = dict(zip(names, args))
        return jl.contrastive_loss(kw["q"], kw["d_pos"], kw.get("d_neg"), TEMP, reverse, in_batch)

    jv, jg = jax.value_and_grad(jf, argnums=tuple(range(len(names))))(
        *(jnp.asarray(d[n]) for n in names))
    leaves = _leaves(d, names)
    kw = dict(zip(names, leaves))
    tv = tl.contrastive_loss(kw["q"], kw["d_pos"], kw.get("d_neg"), TEMP, reverse, in_batch)
    tv.backward()
    _check(jv, jg, tv, leaves)


def test_dense_field_components():
    d = _data(2)
    jp, jn = jl.dense_field_components(*(jnp.asarray(d[n]) for n in ("q", "d_pos", "d_neg")), TEMP)
    tp, tn = tl.dense_field_components(*(torch.from_numpy(d[n]) for n in ("q", "d_pos", "d_neg")),
                                       TEMP)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)  # doc-major negatives
    assert tn.shape == (B, B * NN, FD)


def test_decomposed_simple_loss():
    d = _data(3)
    names = ["q", "d_pos", "d_neg", "w"]

    def jf(q, dp, dn, w):
        return jl.decomposed_simple_loss(q, dp, dn, _jax_mix(w), TEMP)

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3))(*(jnp.asarray(d[n]) for n in names))
    leaves = _leaves(d, names[:3])
    mixer = _torch_mix(d["w"])
    leaves.append(mixer.weight)
    tv = tl.decomposed_simple_loss(*leaves[:3], mixer, TEMP)
    tv.backward()
    _check(jv, jg, tv, leaves)


@pytest.mark.parametrize("reverse", [True, False])
def test_decomposed_contrastive_loss(reverse):
    d = _data(4)
    names = ["q", "d_pos", "d_neg", "w"]

    def jf(q, dp, dn, w):
        return jl.decomposed_contrastive_loss(q, dp, dn, _jax_mix(w), TEMP, reverse)

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3))(*(jnp.asarray(d[n]) for n in names))
    leaves = _leaves(d, names[:3])
    mixer = _torch_mix(d["w"])
    leaves.append(mixer.weight)
    tv = tl.decomposed_contrastive_loss(*leaves[:3], mixer, TEMP, reverse)
    tv.backward()
    _check(jv, jg, tv, leaves)


@pytest.mark.parametrize("reverse,batchnorm,with_neg", [
    (True, True, True), (False, True, True), (True, False, True), (True, True, False),
])
def test_hybrid_contrastive_loss(reverse, batchnorm, with_neg):
    """Sparse components concatenated after the dense ones, the temperature
    on the dense ones only, and (batchnorm) Flax's BatchNorm in training
    mode on both directions: the loss, every gradient, and the running
    stats after its two updates."""
    d = _data(5, sparse=True)
    f = FD + FS
    rng = np.random.default_rng(6)
    d["scale"] = rng.uniform(0.5, 1.5, size=f).astype(np.float32)
    d["bias"] = rng.normal(scale=0.1, size=f).astype(np.float32)
    names = ["q", "d_pos", "d_neg", "w", "scale", "bias"]
    bn = fnn.BatchNorm(axis=-1, momentum=0.9, epsilon=1e-5)

    def jf(q, dp, dn, w, scale, bias):
        stats = {"mean": jnp.zeros(f), "var": jnp.ones(f)}

        def norm(c):
            nonlocal stats
            y, upd = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats},
                              c, use_running_average=False, mutable=["batch_stats"])
            stats = upd["batch_stats"]
            return y

        loss = jl.hybrid_contrastive_loss(
            q, dp, dn if with_neg else None, jnp.asarray(d["sparse_pos"]),
            jnp.asarray(d["sparse_neg"]) if with_neg else None, _jax_mix(w), TEMP, reverse,
            normalize_fn=norm if batchnorm else None)
        return loss, stats

    (jv, stats), jg = jax.value_and_grad(jf, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(d[n]) for n in names))
    mixer = _torch_mix(d["w"])
    field_bn = FieldBatchNorm(f).train()
    leaves = _leaves(d, names[:3]) + [mixer.weight, _set(field_bn.scale, d["scale"]),
                                      _set(field_bn.bias, d["bias"])]
    tv = tl.hybrid_contrastive_loss(
        leaves[0], leaves[1], leaves[2] if with_neg else None,
        torch.from_numpy(d["sparse_pos"]), torch.from_numpy(d["sparse_neg"]) if with_neg else None,
        mixer, TEMP, reverse, normalize_fn=field_bn if batchnorm else None)
    tv.backward()
    if batchnorm:
        _check(jv, jg, tv, leaves)
        np.testing.assert_allclose(field_bn.mean.numpy(), np.asarray(stats["mean"]), **TOL)
        np.testing.assert_allclose(field_bn.var.numpy(), np.asarray(stats["var"]), **TOL)
    else:
        _check(jv, jg[:4], tv, leaves[:4])
        assert leaves[4].grad is None


def test_batchnorm_eval_uses_running_stats():
    """Outside training the field batchnorm normalizes with its running
    statistics and leaves them as they are, as Flax's use_running_average."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mean = rng.normal(size=4).astype(np.float32)
    var = rng.uniform(0.5, 2, size=4).astype(np.float32)
    bn = fnn.BatchNorm(axis=-1, momentum=0.9, epsilon=1e-5)
    want = bn.apply({"params": {"scale": jnp.full(4, 2.0), "bias": jnp.full(4, 0.5)},
                     "batch_stats": {"mean": mean, "var": var}}, x, use_running_average=True)
    field_bn = FieldBatchNorm(4).eval()
    with torch.no_grad():
        field_bn.scale.fill_(2.0)
        field_bn.bias.fill_(0.5)
        field_bn.mean.copy_(torch.from_numpy(mean))
        field_bn.var.copy_(torch.from_numpy(var))
    got = field_bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(field_bn.mean.numpy(), mean)
