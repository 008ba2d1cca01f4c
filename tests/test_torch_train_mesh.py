"""Data-parallel training over several ranks: the port's train step,
``Trainer.fit`` and checkpoints on gloo worlds of W = 2 and W = 4 CPU
processes (``tests/torch_train_mesh_worker.py``, started together once for
the module) against the port on one rank and the JAX package on the same
numpy weights.

Step cases (f32, 2 layers, hidden 32, batch 8 with one negative, dropout
0): dense only; hybrid with ``sparse_pos``/``sparse_neg``; hybrid with
batchnorm (its running stats after the step); ``reverse`` off;
``in_batch=False``; ``freeze_encoder``; a T5 encoder with Adafactor.  On
every rank the global loss, the summed gradients and ``grad_norm`` hold to
one rank's (loss rel 1e-6, ``grad_norm`` rel 1e-5, gradients within 1e-5 of
their leaf's largest entry plus 1e-7 of the largest gradient: the same
arithmetic, the encoder's GEMMs over fewer rows and the sums in another
order; with batchnorm 2e-4 of the leaf's largest, since its one-pass
variance, summed over the ranks, cancels in f32: measured 6.8e-5, and
2.5e-6 of ``grad_norm``) and to JAX's
``make_train_step`` and ``value_and_grad`` on one device (the tolerances of
``tests/test_torch_train_step.py``: loss rel 5e-5, ``grad_norm`` rel 5e-4,
gradients 5e-4 of their leaf's largest entry plus 1e-6 of the largest,
running stats rtol 2e-4); every rank's weights after the step are equal.

``Trainer.fit`` on 2 ranks is held to the JAX trainer's ``fit`` on the
8-device virtual mesh, on ``tests/test_trainer_mesh.py``'s world and
tolerances (mixer rtol 1e-3, atol 1e-4; dev metrics within 1e-6).  Rank 1
writes nothing; ``restore_broadcast`` gives every rank rank 0's last
checkpoint; each rank draws its own dropout masks and a restored state
replays them.  On 4 ranks, validation batches of 6 (ragged over 4) give one
rank's validation loss, and a train batch of 6 raises JAX's message.

Tensor parallelism, on second meshes over the same two worlds: the dense,
batchnorm and T5 (Adafactor) cases on a ``(data 2 x model 2)`` mesh of the 4
ranks, held to one rank of the port (loss rel 1e-5, ``grad_norm`` rel 1e-4,
the joined gradients within 1e-4 of their leaf's largest entry plus 1e-7 of
the largest gradient, the term that covers leaves whose gradient is zero in
exact arithmetic, such as ``attn_k``'s bias) and to JAX's ``value_and_grad``
and ``make_train_step`` under ``jit`` with ``shard_params`` on
``make_mesh(n_data=2, n_model=2)`` over 4 virtual devices (the tolerances
above); every rank's replicated leaves and joined weights after the step
equal, a rank's shards half the leaf, its state's round trip through the
``n_model`` 1 layout exact.  On the 2 ranks a ``(data 1 x model 2)`` ``fit``
is held to the JAX mesh's as the data-parallel one is; its checkpoint has one
rank's keys and shapes and resumes on one rank, and the data-parallel run's
checkpoint (``n_model`` 1) restores into the sharded state.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfar_tpu.data import trec as jax_trec
from mfar_tpu.data.format import format_documents as jax_format_documents
from mfar_tpu.data.negative_sampler import IndexNegativeSampler as JaxSampler
from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields
from mfar_tpu.data.types import Corpus as JaxCorpus
from mfar_tpu.eval.index_build import build_sparse_indices as jax_sparse_indices
from mfar_tpu.models import EncoderConfig as JaxEncoderConfig
from mfar_tpu.models import SimpleVocabTokenizer as JaxTokenizer
from mfar_tpu.models.t5_encoder import T5Config as JaxT5Config
from mfar_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mfar_tpu.parallel.sharding import shard_params as jax_shard_params
from mfar_tpu.sparse.bm25 import BM25Index as JaxBM25
from mfar_tpu.train.data_pipeline import ContrastiveDataset as JaxDataset
from mfar_tpu.train.model import MFARModel as JaxMFARModel
from mfar_tpu.train.optim import make_optimizer as jax_make_optimizer
from mfar_tpu.train.train_step import init_state as jax_init_state
from mfar_tpu.train.train_step import make_train_step
from mfar_tpu.train.trainer import Trainer as JaxTrainer
from mfar_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from mfar_tpu_torch.models.convert import model_state_from_jax
from mfar_tpu_torch.models.encoder import EncoderConfig
from mfar_tpu_torch.models.t5_encoder import T5Config
from synth import make_amazon_corpus, write_dataset_dir
from torch_train_mesh_worker import build_model, fit_world, new_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_train_mesh_worker.py")
WORLDS = (2, 4)
B, VOCAB = 8, 64
WIDTHS = {"alpha_dense": 16, "beta_dense": 24}
DIMS = dict(vocab_size=VOCAB, hidden_size=32, num_heads=2, num_layers=2, intermediate_size=64,
            max_position_embeddings=64)
FIT_FIELDS = "title_dense,description_dense,title_sparse"
# name: (family, sparse field, batchnorm, reverse, in_batch, freeze_encoder)
CASES = {
    "dense": ("bert", False, False, True, True, False),
    "hybrid": ("bert", True, False, True, True, False),
    "batchnorm": ("bert", True, True, True, True, False),
    "no_reverse": ("bert", False, False, False, True, False),
    "simple": ("bert", False, False, True, False, False),
    "frozen": ("bert", False, False, True, True, True),
    "t5": ("t5", False, False, True, True, False),
}
TP_CASES = ("dense", "batchnorm", "t5")  # on (data 2 x model 2)


def _batch(seed, sparse):
    rng = np.random.default_rng(seed)

    def toks(n, width):
        mask = np.zeros((n, width), np.int32)
        for i in range(n):
            mask[i, : rng.integers(2, width + 1)] = 1
        return {"input_ids": (rng.integers(4, VOCAB, size=(n, width)) * mask).astype(np.int32),
                "attention_mask": mask}

    batch = {"query": toks(B, 16), "pos": {fk: toks(B, w) for fk, w in WIDTHS.items()},
             "neg": {fk: toks(B, w) for fk, w in WIDTHS.items()}}
    if sparse:
        batch["sparse_pos"] = rng.gamma(2.0, 2.0, size=(B, B, 1)).astype(np.float32)
        batch["sparse_neg"] = rng.gamma(2.0, 2.0, size=(B, B, 1)).astype(np.float32)
    return batch


def _jax_case(i, name):
    """One case's JAX model on one device, its initial weights and batch,
    and the port's inputs made from them; the reference comes later
    (:func:`_jax_reference`)."""
    family, sparse, bn, reverse, in_batch, freeze = CASES[name]
    if family == "t5":
        jcfg = JaxT5Config.tiny(vocab_size=VOCAB, projection_dim=24)
        pcfg = T5Config.tiny(vocab_size=VOCAB, projection_dim=24)
    else:
        jcfg = JaxEncoderConfig.tiny(**DIMS, hidden_dropout=0.0, attention_dropout=0.0)
        pcfg = EncoderConfig.tiny(**DIMS, hidden_dropout=0.0, attention_dropout=0.0)
    nf = 2 + sparse
    model = JaxMFARModel(encoder_config=jcfg, num_fields=nf, use_batchnorm=bn,
                         temperature=0.05, reverse=reverse, in_batch=in_batch)
    opt = jax_make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, freeze_encoder=freeze,
                             use_adafactor=family == "t5")
    jstate = jax_init_state(model, opt, seed=i)
    batch = _batch(i, sparse)
    stats = jax.tree.map(np.asarray, jstate.batch_stats) if bn else None
    case = dict(config=pcfg, num_fields=nf, batchnorm=bn, reverse=reverse, in_batch=in_batch,
                freeze=freeze, adafactor=family == "t5", batch=batch,
                state=model_state_from_jax(jax.tree.map(np.asarray, jstate.params), stats))
    return case, (model, opt, jstate, batch)


def _jax_reference(model, opt, jstate, batch, mesh=None):
    """The batch's loss, gradients and running stats (``value_and_grad`` of
    ``compute_loss``, train=True) and ``make_train_step``'s metrics, in one
    jitted function; with a ``mesh``, the parameters placed by JAX's
    sharding rules and the batch split over ``data``."""
    jb = jax.tree.map(jnp.asarray, batch)
    bn = bool(jstate.batch_stats)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        split = NamedSharding(mesh, P("data"))
        jb = jax.tree.map(lambda x: jax.device_put(x, split) if x.ndim and x.shape[0] % 2 == 0
                          else x, jb)
        jstate = jstate._replace(params=jax_shard_params(mesh, jstate.params))

    def loss_fn(params):
        variables, kw = {"params": params}, {}
        if bn:
            variables["batch_stats"], kw["mutable"] = jstate.batch_stats, ["batch_stats"]
        out = model.apply(variables, jb["query"], jb["pos"], jb["neg"], jb.get("sparse_pos"),
                          jb.get("sparse_neg"), train=True, method=model.compute_loss, **kw)
        return out if bn else (out, {})

    @jax.jit
    def run(state):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return loss, stats, grads, make_train_step(model, opt)(state, jb)[1]

    loss, stats, grads, metrics = jax.tree.map(np.asarray, run(jstate))
    bstats = jax.tree.map(np.asarray, jstate.batch_stats) if bn else None
    return dict(loss=float(loss), grad_norm=float(metrics["grad_norm"]),
                step_loss=float(metrics["loss"]), grads=model_state_from_jax(grads, bstats),
                stats=stats["batch_stats"]["bn"] if bn else None)


def _fit_world(data_dir):
    """``tests/test_trainer_mesh.py``'s world in the JAX package."""
    field_info = jax_resolve_fields(FIT_FIELDS, "amazon")
    corpus = JaxCorpus.from_pairs(list(jax_trec.read_corpus(os.path.join(data_dir, "corpus"))),
                                  "amazon")
    texts = [t for f in field_info.values()
             for _, t in jax_format_documents(corpus.pairs(), f.name, "amazon")]
    q_train = jax_trec.read_queries(os.path.join(data_dir, "train.queries"))
    q_val = jax_trec.read_queries(os.path.join(data_dir, "val.queries"))
    tok = JaxTokenizer.build(texts + list(q_train.values()) + list(q_val.values()),
                             max_length=64)
    model = JaxMFARModel(
        encoder_config=JaxEncoderConfig.tiny(vocab_size=tok.vocab_size, hidden_size=32,
                                             num_layers=2, num_heads=2, hidden_dropout=0.0,
                                             attention_dropout=0.0),
        num_fields=len(field_info), temperature=0.05)
    opt = jax_make_optimizer(encoder_lr=2e-3, weights_lr=1e-1)
    sampler = JaxSampler(JaxBM25.create(jax_format_documents(corpus.pairs(), "single", "amazon")),
                         n_retrieve=10, n_bottom=5, n_sample=1)
    sparse = jax_sparse_indices(corpus, field_info)

    def ds(queries, split):
        return JaxDataset(queries, corpus,
                          jax_trec.QRels.from_file(os.path.join(data_dir, f"{split}.qrels")),
                          sampler, field_info, tok, query_max_length=64, sparse_indices=sparse)

    def trainer(out_dir, mesh, batch=8):
        cfg = JaxTrainerConfig(out_dir=out_dir, max_epochs=2, patience=10, trec_val_freq=2,
                               train_batch_size=batch, dev_batch_size=8, index_batch_size=16,
                               query_max_length=64, recall_k=20, seed=7)
        return JaxTrainer(model=model, optimizer=opt, tokenizer=tok, field_info=field_info,
                          corpus=corpus, train_dataset=ds(q_train, "train"),
                          val_dataset=ds(q_val, "val"), dev_queries=q_val,
                          dev_qrels_path=os.path.join(data_dir, "val.qrels"), config=cfg,
                          sparse_indices=sparse, mesh=mesh)

    return model, opt, trainer, q_val


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both gloo worlds, started together, and the JAX side."""
    root = tmp_path_factory.mktemp("trainmesh")
    data_dir = str(root / "data")
    write_dataset_dir(data_dir, make_amazon_corpus(40), n_train=16, n_val=4)
    with ThreadPoolExecutor(4) as ex:  # XLA's compiles release the GIL
        made = list(ex.map(_jax_case, range(len(CASES)), CASES))
        cases = {name: c for name, (c, _) in zip(CASES, made)}
        model, opt, jax_trainer, q_val = _fit_world(data_dir)
        jstate = jax_init_state(model, opt, seed=0)
    spec = dict(cases=cases, tp_cases=TP_CASES, fit=dict(data_dir=data_dir, fields=FIT_FIELDS,
                                      state=model_state_from_jax(jax.tree.map(
                                          np.asarray, jstate.params))))
    torch.save(spec, str(root / "spec.pt"))
    procs = {}
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for w in WORLDS:
        out = root / f"w{w}"
        out.mkdir()
        procs[w] = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(w), str(root / f"init{w}"),
             str(root / "spec.pt"), str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(w)]

    # the JAX side while the ranks run: each case's reference, in threads
    # (their time is XLA's compiles, which release the GIL), fit on the
    # 8-device mesh, and the message of a batch that does not divide a
    # 4-device mesh
    def jax_fit_run():
        t = jax_trainer(str(root / "jax"), jax_make_mesh())
        fitted = t.fit(jax_init_state(model, opt, seed=0))
        return dict(mixer=np.asarray(fitted.params["mixer"]["weight"]), step=int(fitted.step),
                    dev=t.trec_eval(fitted, q_val, os.path.join(data_dir, "val.qrels"),
                                    "mesh-cmp"))

    tp_mesh = jax_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    with ThreadPoolExecutor(4) as ex:
        fit_run = ex.submit(jax_fit_run)
        refs = dict(zip(CASES, ex.map(lambda c: _jax_reference(*c[1]), made)))
        tp_refs = dict(zip(TP_CASES, ex.map(
            lambda name: _jax_reference(*dict(zip(CASES, made))[name][1], mesh=tp_mesh),
            TP_CASES)))
        jax_fit = fit_run.result()
    with pytest.raises(AssertionError) as err:
        jax_trainer(str(root / "jax6"), jax_make_mesh(devices=jax.devices()[:4]),
                    batch=6).fit(jax_init_state(model, opt, seed=0))
    jax_fit["batch_error"] = str(err.value)

    for w, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                log = p.communicate(timeout=150)[0]
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                pytest.fail(f"rank {r} of {w} timed out:\n{p.communicate()[0][-3000:]}")
            assert p.returncode == 0, f"rank {r} of {w} failed:\n{log[-4000:]}"
    results = {w: [torch.load(str(root / f"w{w}" / f"rank{r}.pt"), weights_only=False)
                   for r in range(w)] for w in WORLDS}
    return dict(results=results, spec=spec, refs=refs, tp_refs=tp_refs, jax_fit=jax_fit,
                root=root)


@pytest.fixture(scope="module")
def one_rank(worlds):
    """Each case on one rank of the port: the whole batch, no shard."""
    from mfar_tpu_torch.train.train_step import compute_gradients, train_step

    out = {}
    for name, case in worlds["spec"]["cases"].items():
        state = new_state(build_model(case), case)
        loss = compute_gradients(state, case["batch"])
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        state, metrics = train_step(new_state(build_model(case), case), case["batch"])
        out[name] = dict(loss=loss.item(), grads=grads, grad_norm=metrics["grad_norm"].item(),
                         after=state.model.state_dict(), optimizer=state.optimizer.state_dict())
    return out


def _close_grads(got, want, leaf_rel, top_rel):
    assert set(got) <= set(want)
    top = max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name]
        torch.testing.assert_close(g, w, rtol=0, atol=leaf_rel * w.abs().max().item()
                                   + top_rel * top, msg=name)


def test_every_rank_agrees_and_loads_no_jax(worlds):
    for w, ranks in worlds["results"].items():
        for r, res in enumerate(ranks):
            assert res["shape"] == {"replica": 1, "data": w, "model": 1}
            assert not [m for m in res["modules"] if m.split(".")[0] in ("jax", "mfar_tpu")]
            for name in CASES:
                got, first = res[f"step/{name}"], ranks[0][f"step/{name}"]
                assert got["rows"] == (r * B // w, B // w)
                assert got["step_loss"] == first["step_loss"]
                assert got["grad_norm"] == first["grad_norm"]
                for k, v in got["after"].items():
                    assert torch.equal(v, first["after"][k]), (w, r, name, k)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_one_rank_and_jax(worlds, one_rank, w, name):
    ranks = [res[f"step/{name}"] for res in worlds["results"][w]]
    one, ref = one_rank[name], worlds["refs"][name]
    for res in ranks:  # the global loss on every rank, from the gradients' pass and the step
        assert res["loss"] == res["step_loss"] == pytest.approx(one["loss"], rel=1e-6)
        assert res["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-5)
        # batchnorm's one-pass variance (measured: 6.8e-5 of a leaf's largest)
        _close_grads(res["grads"], one["grads"], 2e-4 if CASES[name][2] else 1e-5, 1e-7)
    got = ranks[0]
    assert got["step_loss"] == pytest.approx(ref["step_loss"], rel=5e-5)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=5e-4)
    want = {k: v for k, v in ref["grads"].items() if not k.startswith(("bn.mean", "bn.var"))}
    assert set(got["grads"]) == set(want)
    _close_grads(got["grads"], want, 5e-4, 1e-6)
    if ref["stats"] is not None:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(got["after"][f"bn.{stat}"].numpy(), ref["stats"][stat],
                                       rtol=2e-4)
    if CASES[name][-1]:  # freeze_encoder: the encoder did not move
        start = worlds["spec"]["cases"][name]["state"]
        assert all(torch.equal(v, start[k]) for k, v in got["after"].items()
                   if k.startswith("encoder."))


def test_fit_on_two_ranks_matches_the_jax_mesh(worlds):
    ranks, jfit = worlds["results"][2], worlds["jax_fit"]
    for res in ranks:
        assert res["fit/step"] == jfit["step"] == 4  # 16 queries, batch 8, 2 epochs
        np.testing.assert_allclose(res["fit/mixer"].numpy(), jfit["mixer"], rtol=1e-3,
                                   atol=1e-4)
        for k in ("ndcg_cut_10", "recall_10", "recip_rank"):
            assert abs(res["fit/dev"][k] - jfit["dev"][k]) < 1e-6, (k, res["fit/dev"][k])


def test_rank_zero_checkpoints_and_every_rank_restores(worlds):
    r0, r1 = worlds["results"][2]
    assert r1["fit/out_dir"] is None  # rank 1 wrote nothing
    assert {"checkpoints", "metrics.jsonl", "best.txt"} <= set(r0["fit/out_dir"])
    for res in (r0, r1):
        assert res["fit/latest"] == 1 and res["fit/restored_step"] == 4
        assert res["fit/restored_equal"]


def test_dropout_masks_differ_across_ranks_and_replay(worlds):
    r0, r1 = worlds["results"][2]
    rows = r0["dropout/rows"]
    torch.testing.assert_close(rows, r1["dropout/rows"], rtol=0, atol=0)
    assert not torch.allclose(rows[:2], rows[2:])  # the same two rows, each rank's masks
    for res in (r0, r1):
        a, b = res["dropout/replay"]
        assert a == b == r0["dropout/replay"][0]


def test_ragged_validation_and_a_batch_that_does_not_divide(worlds):
    """Batches of 6 over 4 ranks: 16 queries give 6, 6 (whole on every
    rank) and 4 (split); the mean equals one process's."""
    trainer, state, train_ds = fit_world(worlds["spec"], None, str(worlds["root"] / "one"))
    want = trainer(batch=6, val=train_ds).validate_proxy(state())
    for res in worlds["results"][4]:
        assert res["ragged/valid_loss"] == pytest.approx(want, rel=1e-6)
        assert res["ragged/fit_error"] == worlds["jax_fit"]["batch_error"]


def _shapes(tree):
    """The nested dict's tensors' shapes (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("name", TP_CASES)
def test_tensor_parallel_step_matches_one_rank_and_jax(worlds, one_rank, name):
    """(data 2 x model 2): the global loss, gradients and ``grad_norm`` on
    every rank against one rank's and JAX's mesh step; the weights and the
    optimizer state after the step, joined, equal on every rank and laid
    out as one rank's."""
    ranks = [res[f"tp/{name}"] for res in worlds["results"][4]]
    one, ref = one_rank[name], worlds["tp_refs"][name]
    for res in worlds["results"][4]:
        assert res["tp_shape"] == {"replica": 1, "data": 2, "model": 2}
    for r, res in enumerate(ranks):
        assert res["rows"] == (r // 2 * B // 2, B // 2) and res["model_index"] == r % 2
        assert res["loss"] == res["step_loss"] == pytest.approx(one["loss"], rel=1e-5)
        assert res["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-4)
        _close_grads(res["grads"], one["grads"], 2e-4 if CASES[name][2] else 1e-4, 1e-7)
        assert res["round_trip"], r
        assert res["collectives"] > 0
        for k, v in res["after"].items():
            assert torch.equal(v, ranks[0]["after"][k]), (r, k)
        assert _shapes(res["optimizer"]) == _shapes(one["optimizer"])
        assert _shapes(res["after"]) == _shapes(one["after"])
    got = ranks[0]
    assert got["step_loss"] == pytest.approx(ref["step_loss"], rel=5e-5)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=5e-4)
    want = {k: v for k, v in ref["grads"].items() if not k.startswith(("bn.mean", "bn.var"))}
    assert set(got["grads"]) == set(want)
    _close_grads(got["grads"], want, 5e-4, 1e-6)


@pytest.mark.parametrize("name", TP_CASES)
def test_tensor_parallel_ranks_hold_their_shards(worlds, name):
    """A rank holds half of each leaf that JAX's rules shard (the
    vocabulary, q/k/v, the MLP's or FFN's matrices) and every other leaf
    whole, bit-equal on all four ranks; model peers' shards join to the
    step's weights, data peers' shards are equal."""
    ranks = [res[f"tp/{name}"] for res in worlds["results"][4]]
    whole = ranks[0]["after"]
    sharded = set(ranks[0]["sharded"])
    t5 = CASES[name][0] == "t5"
    assert ("encoder.token_embed.weight" if t5 else
            "encoder.embeddings.word_embeddings.weight") in sharded
    assert {f"encoder.layers.0.attn_{x}.weight" for x in "qkvo"} <= sharded
    assert ("encoder.layers.1.ffn.wo.weight" if t5 else "encoder.layers.1.mlp_out.weight") \
        in sharded
    assert not any("ln" in k or "mixer" in k or "rel_bias" in k or k.startswith("bn.")
                   for k in sharded)
    for r, res in enumerate(ranks):
        assert res["sharded"] == ranks[0]["sharded"]
        for k, v in res["local"].items():
            if k not in sharded:
                assert torch.equal(v, whole[k]), (r, k)
                continue
            axis = 1 if k.endswith(("attn_o.weight", "mlp_out.weight", "wo.weight")) else 0
            assert v.shape[axis] * 2 == whole[k].shape[axis]
            assert torch.equal(v, whole[k].chunk(2, axis)[r % 2]), (r, k)


def test_tensor_parallel_fit_checkpoints_the_one_device_layout(worlds, tmp_path):
    """(data 1 x model 2): ``fit`` follows the JAX mesh's; rank 0's
    checkpoint holds one rank's keys and shapes (model and optimizer) and
    resumes on one rank; the data-parallel run's ``n_model`` 1 checkpoint
    restores into the sharded state."""
    from mfar_tpu_torch.train.checkpoint import CheckpointManager

    r0, r1 = worlds["results"][2]
    jfit = worlds["jax_fit"]
    root = worlds["root"] / "w2"
    for res in (r0, r1):
        assert res["tp_shape"] == {"replica": 1, "data": 1, "model": 2}
        assert res["tp_fit/sharded"] and res["tp_fit/step"] == jfit["step"] == 4
        np.testing.assert_allclose(res["tp_fit/state"]["model"]["mixer.weight"].numpy(),
                                   jfit["mixer"], rtol=1e-3, atol=1e-4)
        for k in ("ndcg_cut_10", "recall_10", "recip_rank"):
            assert abs(res["tp_fit/dev"][k] - jfit["dev"][k]) < 1e-6, (k, res["tp_fit/dev"][k])
        for k, v in res["tp_fit/state"]["model"].items():
            assert torch.equal(v, r0["tp_fit/state"]["model"][k]), k
    assert r1["tp_fit/out_dir"] is None
    tp_ckpt, dp_ckpt = CheckpointManager(str(root / "tp_run0")), CheckpointManager(str(root / "run0"))
    tp_payload, dp_payload = tp_ckpt.read(1), dp_ckpt.read(1)
    assert _shapes(tp_payload["model"]) == _shapes(dp_payload["model"])
    assert _shapes(tp_payload["optimizer"]) == _shapes(dp_payload["optimizer"])
    # resumed at n_model 1 on one rank
    trainer, state, train_ds = fit_world(worlds["spec"], None, str(tmp_path / "one"))
    one = tp_ckpt.restore(1, state())
    assert one.step == 4
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, r0["tp_fit/state"]["model"][k]), k
    from mfar_tpu_torch.train.data_pipeline import strip_meta
    from mfar_tpu_torch.train.train_step import train_step

    _, metrics = train_step(one, strip_meta(next(train_ds.epoch_batches(8, seed=3))))
    assert np.isfinite(metrics["loss"].item()) and one.step == 5
    # n_model 1 -> 2: every rank's joined state is the data-parallel checkpoint
    for res in (r0, r1):
        latest, step, payload = res["tp_fit/restored_dp"]
        assert latest == 1 and step == dp_payload["step"]
        for k, v in payload["model"].items():
            assert torch.equal(v, dp_payload["model"][k]), k
        assert _shapes(payload["optimizer"]) == _shapes(dp_payload["optimizer"])
