"""The port's Adafactor against ``optax.adafactor`` as the JAX package
configures it (``mfar_tpu/train/optim.py``: ``multiply_by_parameter_scale=
False, clipping_threshold=1.0, decay_rate=0.8``, beside the head's AdamW).

A T5 ``MFARModel`` of 2 layers at d_model 128 and d_ff 256 (vocabulary
160), so that its kernels, embedding and projection reach optax's
factoring threshold of 128 while the norms and the position-bias table stay
unfactored.  Both packages take the same gradients (seeded numpy, carried
into the port's layout) for 5 steps; every encoder parameter agrees within
1e-6 (measured 1.2e-7).  The head's AdamW (torch's against optax's, which
round in other orders) is held at 1e-5: 5 steps at lr 0.1 move the mixer
by up to 4e-6 apart.
Steps whose gradients grow on one layer make the block-RMS clip bite: optax
clips each leaf, a whole stack of layers, and optax over per-layer leaves
(what clipping each port tensor alone would give) lands elsewhere.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import optax
from optax._src.factorized import _factored_dims as optax_factored_dims

from mfar_tpu.models.t5_encoder import T5Config as JaxT5Config
from mfar_tpu.train.model import MFARModel as JaxMFARModel
from mfar_tpu.train.optim import make_optimizer as jax_make_optimizer
from mfar_tpu.train.train_step import init_state as jax_init_state
from mfar_tpu_torch.models import T5Config
from mfar_tpu_torch.models.convert import model_state_from_jax, t5_state_from_jax
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import (
    Adafactor,
    GroupedOptimizer,
    _factored_dims,
    jax_leaves,
    make_optimizer,
)

torch.set_num_threads(1)

DIMS = dict(vocab_size=160, d_model=128, num_heads=2, d_kv=64, d_ff=256, projection_dim=128)
LR = dict(encoder_lr=1e-3, weights_lr=1e-1)
STEPS = 5
ATOL = 1e-6
HEAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_model():
    model = JaxMFARModel(encoder_config=JaxT5Config.tiny(**DIMS), num_fields=2,
                         temperature=0.05)
    opt = jax_make_optimizer(use_adafactor=True, **LR)
    state = jax_init_state(model, opt, seed=0)
    return opt, jax.tree.map(np.asarray, state.params)


def _grads(params, step, grow_layer0=False):
    """Seeded gradients shaped like ``params``; with ``grow_layer0`` layer 0
    of every stacked leaf grows 30x a step."""
    rng = np.random.default_rng(100 + step)

    def one(path, p):
        g = rng.normal(size=p.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if grow_layer0 and "'layers'" in name:
            g[0] *= 30.0 ** step
        return g

    return jax.tree_util.tree_map_with_path(one, params)


def _optax_run(opt, params, grow_layer0=False):
    state = opt.init(params)
    for step in range(STEPS):
        updates, state = opt.update(_grads(params, step, grow_layer0), state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params)


def _port_run(params, grow_layer0=False, **opt):
    model = MFARModel(T5Config.tiny(**DIMS), num_fields=2, temperature=0.05)
    model.load_state_dict(model_state_from_jax(params))
    optimizer = make_optimizer(use_adafactor=True, **LR, **opt).build(model)
    for step in range(STEPS):
        grads = model_state_from_jax(_grads(params, step, grow_layer0))
        for name, p in model.named_parameters():
            p.grad = grads[name].clone()
        optimizer.step()
    return model, optimizer


def _assert_params(model, want):
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for name, w in model_state_from_jax(want).items():
        atol = ATOL if name.startswith("encoder.") else HEAD_ATOL
        np.testing.assert_allclose(got[name], w.numpy(), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("grow_layer0", [False, True])
def test_adafactor_matches_optax_over_five_steps(jax_model, grow_layer0):
    opt, params = jax_model
    model, optimizer = _port_run(params, grow_layer0)
    assert isinstance(optimizer, GroupedOptimizer)
    want = _optax_run(opt, params, grow_layer0)
    _assert_params(model, want)
    moved = model_state_from_jax(params)
    assert all(not torch.equal(v, moved[k]) for k, v in model.state_dict().items()
               if k.startswith("encoder."))


def test_per_tensor_clipping_would_differ(jax_model):
    """optax over a tree whose stacked leaves are split into one leaf a
    layer (clipping each port tensor on its own) moves the parameters by
    more than the tolerance; the port, clipping each JAX leaf, does not."""
    _, params = jax_model
    enc_opt = optax.adafactor(1e-3, multiply_by_parameter_scale=False,
                              clipping_threshold=1.0, decay_rate=0.8)
    layers = params["encoder"]["layers"]["layer"]
    n = jax.tree.leaves(layers)[0].shape[0]
    split = lambda t: [jax.tree.map(lambda x: x[i], t) for i in range(n)]  # noqa: E731
    stack = lambda ts: jax.tree.map(lambda *xs: np.stack(xs), *ts)  # noqa: E731

    def run(per_layer):
        enc = dict(params["encoder"])
        tree = {**enc, "layers": split(layers)} if per_layer else enc
        state = enc_opt.init(tree)
        for step in range(STEPS):
            g = _grads(params, step, grow_layer0=True)["encoder"]
            g = {**g, "layers": split(g["layers"]["layer"])} if per_layer else g
            updates, state = enc_opt.update(g, state, tree)
            tree = optax.apply_updates(tree, updates)
        if per_layer:
            tree = {**tree, "layers": {"layer": stack(tree["layers"])}}
        return jax.tree.map(np.asarray, tree)

    joint, per_layer = run(False), run(True)
    gap = max(np.abs(a - b).max() for a, b in zip(jax.tree.leaves(joint["layers"]),
                                                   jax.tree.leaves(per_layer["layers"])))
    assert gap > 100 * ATOL
    model, _ = _port_run(params, grow_layer0=True)
    got = model.encoder.state_dict()
    for name, w in t5_state_from_jax(joint).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(12, 768, 3072), (12, 768, 768), (32128, 768), (768,),
                                   (12, 768), (32, 12), (2, 128, 128), (3, 200, 100, 150)])
def test_factored_dims_match_optax(shape):
    assert _factored_dims(shape, 128) == optax_factored_dims(shape, True, 128)


def test_leaves_group_layers_and_state_round_trips():
    model = MFARModel(T5Config.tiny(**DIMS), num_fields=2)
    leaves = {leaf["name"]: leaf for leaf in jax_leaves(model.encoder)}
    wi = leaves["layers.ffn.wi.weight"]
    assert wi["stacked"] and wi["transposed"] and len(wi["params"]) == 2
    assert not leaves["token_embed.weight"]["transposed"]
    assert not leaves["rel_bias"]["stacked"] and leaves["projection.weight"]["transposed"]
    assert leaves["layers.ln1.weight"]["stacked"] and not leaves["layers.ln1.weight"]["transposed"]

    opt = Adafactor(jax_leaves(model.encoder), lr=1e-3)
    rng = np.random.default_rng(0)

    def step():
        for p in model.encoder.parameters():
            p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
        opt.step()

    step()
    saved = opt.state_dict()
    assert saved["state"][0]["step"] == 1
    other = Adafactor(jax_leaves(model.encoder), lr=1e-3)
    other.load_state_dict(saved)
    for a, b in zip(opt.state.values(), other.state.values()):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))


def test_freeze_encoder_takes_precedence_and_decay_warns():
    model = MFARModel(T5Config.tiny(**DIMS), num_fields=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec = make_optimizer(use_adafactor=True, freeze_encoder=True, weight_decay=0.1, **LR)
    opt = spec.build(model)
    assert isinstance(opt, torch.optim.AdamW)
    assert [g["name"] for g in opt.param_groups] == ["head"]
    with pytest.warns(UserWarning, match="ignored with adafactor"):
        make_optimizer(use_adafactor=True, weight_decay=0.1, **LR)
    with pytest.raises(ValueError, match="weights_lr"):
        make_optimizer(use_adafactor=True)
