"""The port's tensor-parallel rules and state layout on the CPU, without a
process group.

- ``spec_for`` on every parameter of a tiny BERT and a tiny T5 (plain and
  gated FFN) equals JAX's ``param_specs`` on the same tree, at ``n_model``
  2 and 4, with a vocabulary that 4 does not divide and heads that 4 does
  not divide (JAX's spec read through ``model_state_from_jax``: each JAX
  leaf is filled with its index along the sharded axis, so the port tensor
  varies along the axis that carries it);
- ``model_specs`` keeps a layer's attention whole where the heads do not
  divide;
- on a model group of threads (:class:`ThreadMesh`: ``all_gather`` and
  ``all_reduce_sum`` over a barrier, what ``tensor_parallel`` and
  ``Adafactor`` call on a mesh), ``shard_state_dict`` after
  ``gather_state_dict`` is the identity, and Adafactor over shards takes
  the steps of one device (its factored axes from the whole leaf's shape,
  where a shard's shape would choose others).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from mfar_tpu.models import EncoderConfig as JaxEncoderConfig
from mfar_tpu.models.t5_encoder import T5Config as JaxT5Config
from mfar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mfar_tpu.parallel.sharding import param_specs
from mfar_tpu.train.model import MFARModel as JaxMFARModel
from mfar_tpu.train.optim import make_optimizer as jax_make_optimizer
from mfar_tpu.train.train_step import init_state as jax_init_state
from mfar_tpu_torch.models.convert import model_state_from_jax
from mfar_tpu_torch.models.encoder import EncoderConfig
from mfar_tpu_torch.parallel import tensor_parallel as tp
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import Adafactor, _factored_dims, jax_leaves, make_optimizer

torch.set_num_threads(1)

VOCAB = 30  # 2 divides it, 4 does not
JAX_CONFIGS = {
    "bert": JaxEncoderConfig.tiny(vocab_size=VOCAB, hidden_size=48, num_heads=6, num_layers=2,
                                  intermediate_size=96),
    "t5": JaxT5Config.tiny(vocab_size=VOCAB, d_model=32, num_heads=6, d_kv=8, d_ff=64,
                           projection_dim=24),
    "t5_gated": JaxT5Config.tiny(vocab_size=VOCAB, d_model=32, num_heads=6, d_kv=8, d_ff=64,
                                 projection_dim=24, gated_ffn=True),
}


def _axis_tree(params, specs):
    """Each leaf as an array of its shape holding 1 + its index along the
    axis its spec shards over ``model``, or zeros when it replicates."""
    def fill(leaf, spec):
        out = np.zeros(leaf.shape, np.float32)
        for dim, ax in enumerate(spec):
            if ax is not None:
                shape = [1] * leaf.ndim
                shape[dim] = leaf.shape[dim]
                out = out + 1 + np.arange(leaf.shape[dim], dtype=np.float32).reshape(shape)
        return out

    return jax.tree.map(fill, params, specs,
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _varying_axis(t: torch.Tensor):
    if not t.any():
        return None
    (axis,) = [d for d in range(t.dim()) if t.shape[d] > 1 and not torch.equal(
        t, t.narrow(d, 0, 1).expand_as(t))]
    return axis


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("family", list(JAX_CONFIGS))
def test_spec_for_matches_jax_param_specs(family, n_model):
    model = JaxMFARModel(encoder_config=JAX_CONFIGS[family], num_fields=2, temperature=0.05)
    params = jax.tree.map(np.asarray, jax_init_state(
        model, jax_make_optimizer(encoder_lr=1e-3, weights_lr=1e-1), seed=0).params)
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    want = model_state_from_jax(_axis_tree(params, param_specs(params, mesh)))
    whole = model_state_from_jax(params)
    got = {name: tp.spec_for(name, tuple(t.shape), n_model) for name, t in whole.items()}
    assert got == {name: _varying_axis(t) for name, t in want.items()}
    vocab = "encoder.embeddings.word_embeddings.weight" if family == "bert" \
        else "encoder.token_embed.weight"
    assert got[vocab] == (0 if n_model == 2 else None)  # JAX's guard: 30 % 4
    assert got["encoder.layers.1.attn_q.weight"] == 0  # 48 columns divide by 2 and 4
    assert all(got[n] is None for n in got if not n.startswith("encoder.")
               or ".ln" in n or "rel_bias" in n or "projection" in n or "position" in n)


@pytest.mark.parametrize("n_model,whole_attention", [(2, False), (4, True)])
def test_model_specs_keep_attention_whole_where_heads_do_not_divide(n_model, whole_attention):
    model = MFARModel(EncoderConfig.tiny(vocab_size=VOCAB, hidden_size=48, num_heads=6,
                                         num_layers=2, intermediate_size=96), num_fields=2)
    specs = tp.model_specs(model, n_model)
    for name, axis in specs.items():
        if ".attn_" in name:
            assert (axis is None) == (whole_attention or name.endswith("attn_o.bias")), name
        else:
            assert axis == tp.spec_for(name, tuple(dict(model.named_parameters())[name].shape),
                                       n_model), name
    assert specs["encoder.layers.0.mlp_in.weight"] == 0
    assert specs["encoder.layers.0.mlp_out.weight"] == 1


class ThreadMesh:
    """One rank of a model group of ``n`` threads: the mesh calls that
    ``tensor_parallel`` and ``Adafactor`` make, exchanged over a barrier."""

    host_collectives = True

    def __init__(self, n, index, board):
        self.n, self.i, self.board = n, index, board
        self.shape = {"replica": 1, "data": 1, "model": n}

    def size(self, axes):
        return self.n

    def index(self, axes):
        return self.i

    def all_gather(self, axes, t):
        slots, barrier = self.board
        slots[self.i] = t.detach().clone()
        barrier.wait()
        out = [s.clone() for s in slots]
        barrier.wait()
        return out

    def all_reduce_sum(self, axes, t):
        return sum(self.all_gather(axes, t))


def _on_threads(n, fn):
    board = ([None] * n, threading.Barrier(n))
    with ThreadPoolExecutor(n) as ex:
        return list(ex.map(lambda i: fn(ThreadMesh(n, i, board)), range(n)))


def _model(seed=0):
    gen = torch.Generator().manual_seed(seed)  # the threads share torch's global one
    cfg = EncoderConfig.tiny(vocab_size=256, hidden_size=128, num_heads=4, num_layers=2,
                             intermediate_size=512)
    model = MFARModel(cfg, num_fields=2)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.5, generator=gen)
    return model


def _grads(model, seed):
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn(p.shape, generator=gen) for n, p in model.named_parameters()}


def _step(model, opt, grads):
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt.step()


def _adafactor(model):
    return Adafactor(jax_leaves(model.encoder), lr=1e-2)


def test_adafactor_over_shards_takes_one_devices_steps():
    """Two Adafactor steps on a model sharded over 4 threads (the leaves'
    factored statistics and block RMS summed over the group) equal one
    device's; ``mlp_out``'s stack, [2, 512, 128] whole, is [2, 128, 128] a
    rank, whose tie would factor other axes."""
    one = _model()
    opt = _adafactor(one)
    grads = [_grads(one, s) for s in (1, 2)]
    for g in grads:
        _step(one, opt, g)

    def rank(mesh):
        model = tp.shard_module(_model(), mesh)
        opt = _adafactor(model)
        group = next(g for g in opt.param_groups if g["name"] == "layers.mlp_out.weight")
        axis, shard, dims = Adafactor._geometry(group)
        params = dict(model.named_parameters())
        for g in grads:
            _step(model, opt, {n: t if tp.shard_of(params[n]) is None
                               else t.chunk(4, tp.shard_of(params[n]).axis)[mesh.i]
                               for n, t in g.items()})
        return (axis, dims), tp.gather_state_dict(model, opt, mesh)

    for (axis, dims), (model_sd, opt_sd) in _on_threads(4, rank):
        assert axis == 1 and dims == _factored_dims((2, 512, 128), 128) == (2, 1)
        assert _factored_dims((2, 128, 128), 128) != dims
        for name, want in one.state_dict().items():
            torch.testing.assert_close(model_sd[name], want, rtol=1e-5, atol=1e-6, msg=name)
        want_opt = opt.state_dict()
        assert opt_sd["param_groups"] == want_opt["param_groups"]
        for i, entry in want_opt["state"].items():
            for k, v in entry.items():
                torch.testing.assert_close(torch.as_tensor(opt_sd["state"][i][k]),
                                           torch.as_tensor(v), rtol=1e-4, atol=0, msg=(i, k))


@pytest.mark.parametrize("adafactor", [False, True], ids=["adamw", "adafactor"])
def test_shard_then_gather_is_the_identity(adafactor):
    """A stepped one-device state's slices (``shard_state_dict``) join back
    to it (``gather_state_dict``), the model and every moment; a rank holds
    a quarter of each sharded leaf and of its moments."""
    one = _model()
    spec = make_optimizer(encoder_lr=1e-2, weights_lr=1e-1, use_adafactor=adafactor)
    opt = spec.build(one)
    _step(one, opt, _grads(one, 3))
    full_model, full_opt = one.state_dict(), opt.state_dict()

    def rank(mesh):
        model = tp.shard_module(_model(seed=9), mesh)
        opt = spec.build(model)
        model_sd, opt_sd = tp.shard_state_dict(model, opt, mesh, full_model, full_opt)
        model.load_state_dict(model_sd)
        opt.load_state_dict(opt_sd)
        w = dict(model.named_parameters())["encoder.layers.0.mlp_in.weight"]
        moments = opt.optimizers["encoder"].state[w] if adafactor else opt.state[w]
        return w.shape, {k: tuple(v.shape) for k, v in moments.items() if torch.is_tensor(v)}, \
            tp.gather_state_dict(model, opt, mesh)

    for shape, moments, (model_sd, opt_sd) in _on_threads(4, rank):
        assert shape == (128, 128)  # [512, 128] whole
        if adafactor:  # [2, 128, 512] whole: v_col over the split axis 2, v_row whole
            assert moments == {"v_row": (2, 128), "v_col": (2, 128)}
        else:
            assert moments["exp_avg"] == moments["exp_avg_sq"] == (128, 128)
        for name, want in full_model.items():
            assert torch.equal(model_sd[name], want), name

        def same(a, b):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    same(a[k], b[k])
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b

        same(opt_sd, full_opt)


def test_scatter_and_gather_are_each_others_backward():
    """``scatter_to_model`` hands a rank its columns and, backward, joins
    the ranks' gradients (so a replicated table read through each rank's
    columns gets its whole gradient everywhere); ``gather_from_model``
    joins, and hands a rank its part of the gradient back."""
    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(0))

    def rank(mesh):
        leaf = x.clone().requires_grad_()
        part = tp.scatter_to_model(leaf, mesh, 1)
        (part * (mesh.i + 1)).sum().backward()
        mine = part.detach().requires_grad_()
        joined = tp.gather_from_model(mine, mesh, 1)
        (joined * torch.arange(6.0)).sum().backward()
        return part.detach(), leaf.grad, joined.detach(), mine.grad

    for i, (part, grad, joined, part_grad) in enumerate(_on_threads(3, rank)):
        assert torch.equal(part, x[:, 2 * i:2 * i + 2])
        assert torch.equal(grad, torch.tensor([1.0, 1, 2, 2, 3, 3]).expand(5, 6))
        assert torch.equal(joined, x)
        assert torch.equal(part_grad, torch.arange(6.0)[2 * i:2 * i + 2].expand(5, 2))
