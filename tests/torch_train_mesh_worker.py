"""One rank of a gloo world for ``tests/test_torch_train_mesh.py``.

    python tests/torch_train_mesh_worker.py RANK WORLD INIT_FILE SPEC OUT_DIR

Every rank rebuilds the same inputs from ``SPEC`` (a ``torch.save`` of numpy
arrays, configs and state_dicts), joins the world through
``file://INIT_FILE`` and runs the port's data-parallel training on its rows:
one batch of each step case (the loss, the gradients summed over the ranks,
``grad_norm`` and the weights after one optimizer step), ``Trainer.fit``
over the spec's dataset directory with a checkpoint on rank 0 and
``restore_broadcast``, the dropout masks of each rank and their replay
after a restore, a validation pass whose last batch does not divide the
ranks, and ``fit`` refusing a batch that does not divide them.  Then, on a
second mesh over the same world, tensor parallelism: the spec's
``tp_cases`` on a ``(data 2 x model 2)`` mesh of W = 4 (the gathered
gradients, the step's loss and ``grad_norm``, the gathered weights and
optimizer state after it, the replicated leaves and the shards of every
rank, the round trip of the state through ``gather_state_dict`` and
``shard_state_dict``), and on W = 2 a ``(data 1 x model 2)`` ``fit`` whose
rank 0 checkpoints in the ``n_model`` 1 layout, then ``restore_broadcast`` of
the data-parallel run's checkpoint into the sharded state.  Each rank
writes what it computed to ``OUT_DIR/rank<R>.pt``.  Imports nothing of JAX.
"""

import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def build_model(case):
    from mfar_tpu_torch.train.model import MFARModel

    model = MFARModel(case["config"], num_fields=case["num_fields"],
                      use_batchnorm=case["batchnorm"], reverse=case["reverse"],
                      in_batch=case["in_batch"], temperature=0.05)
    model.load_state_dict(case["state"])
    return model


def new_state(model, case, seed=0):
    from mfar_tpu_torch.train.optim import make_optimizer
    from mfar_tpu_torch.train.train_step import TrainState

    opt = make_optimizer(encoder_lr=1e-3, weights_lr=1e-1, freeze_encoder=case["freeze"],
                         use_adafactor=case["adafactor"])
    return TrainState(model=model, optimizer=opt.build(model), step=0,
                      generator=torch.Generator().manual_seed(seed))


def run_steps(spec, mesh, out):
    """Each case's batch on this rank's rows: the summed gradients, then one
    train step from the same weights."""
    from mfar_tpu_torch.parallel.data_parallel import shard_batch
    from mfar_tpu_torch.train.train_step import compute_gradients, train_step

    for name, case in spec["cases"].items():
        local, shard = shard_batch(case["batch"], mesh)
        state = new_state(build_model(case), case)
        loss = compute_gradients(state, local, shard)
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        state = new_state(build_model(case), case)
        state, metrics = train_step(state, local, shard)
        out[f"step/{name}"] = dict(
            rows=(shard.offset, shard.rows), loss=loss.item(), grads=grads,
            step_loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
            after={k: v.clone() for k, v in state.model.state_dict().items()})


def _whole(model, tensors):
    """``{name: tensor}`` of ``model``'s parameters, the sharded ones joined
    over the model group."""
    from mfar_tpu_torch.parallel.tensor_parallel import _gather, shard_of

    params = dict(model.named_parameters())
    return {n: t if shard_of(params[n]) is None else
            _gather(t, shard_of(params[n]).mesh, shard_of(params[n]).axis)
            for n, t in tensors.items()}


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_trees(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def run_tp_steps(spec, mesh, out):
    """Each tensor-parallel case: this rank's rows and shards; the global
    gradients (joined), then one step from the same weights."""
    from mfar_tpu_torch.parallel import tensor_parallel as tp
    from mfar_tpu_torch.parallel.data_parallel import shard_batch
    from mfar_tpu_torch.train.checkpoint import apply_payload, state_payload
    from mfar_tpu_torch.train.train_step import compute_gradients, train_step

    for name in spec["tp_cases"]:
        case = spec["cases"][name]
        local, shard = shard_batch(case["batch"], mesh)
        state = new_state(tp.shard_module(build_model(case), mesh), case)
        loss = compute_gradients(state, local, shard)
        grads = _whole(state.model, {n: p.grad for n, p in state.model.named_parameters()})
        state = new_state(tp.shard_module(build_model(case), mesh), case)
        tp.collectives.clear()
        state, metrics = train_step(state, local, shard)
        n_collectives = sum(tp.collectives.values())
        payload = state_payload(state)
        local_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        local_opt = state.optimizer.state_dict()
        # the round trip: this rank's slices of the joined state are its own
        again = new_state(tp.shard_module(build_model(case), mesh), case)
        apply_payload(again, payload)
        out[f"tp/{name}"] = dict(
            rows=(shard.offset, shard.rows), model_index=mesh.index("model"),
            loss=loss.item(), grads=grads, step_loss=metrics["loss"].item(),
            grad_norm=metrics["grad_norm"].item(), after=payload["model"],
            optimizer=payload["optimizer"], local=local_sd, collectives=n_collectives,
            sharded=sorted(n for n, p in state.model.named_parameters() if tp.shard_of(p)),
            round_trip=_equal_trees(local_sd, again.model.state_dict())
            and _equal_trees(local_opt, again.optimizer.state_dict()))


def fit_world(spec, mesh, out_dir):
    """The port's counterpart of ``tests/test_trainer_mesh.py``'s world."""
    from mfar_tpu_torch.data import trec
    from mfar_tpu_torch.data.format import format_documents
    from mfar_tpu_torch.data.negative_sampler import IndexNegativeSampler
    from mfar_tpu_torch.data.schema import resolve_fields
    from mfar_tpu_torch.data.types import Corpus
    from mfar_tpu_torch.eval.index_build import build_sparse_indices
    from mfar_tpu_torch.models.encoder import EncoderConfig
    from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
    from mfar_tpu_torch.sparse.bm25 import BM25Index
    from mfar_tpu_torch.train.data_pipeline import ContrastiveDataset
    from mfar_tpu_torch.train.model import MFARModel
    from mfar_tpu_torch.train.optim import make_optimizer
    from mfar_tpu_torch.train.train_step import TrainState
    from mfar_tpu_torch.train.trainer import Trainer, TrainerConfig

    fit = spec["fit"]
    data = fit["data_dir"]
    field_info = resolve_fields(fit["fields"], "amazon")
    corpus = Corpus.from_pairs(list(trec.read_corpus(os.path.join(data, "corpus"))), "amazon")
    texts = [t for f in field_info.values()
             for _, t in format_documents(corpus.pairs(), f.name, "amazon")]
    q_train = trec.read_queries(os.path.join(data, "train.queries"))
    q_val = trec.read_queries(os.path.join(data, "val.queries"))
    tok = SimpleVocabTokenizer.build(texts + list(q_train.values()) + list(q_val.values()),
                                     max_length=64)
    sampler = IndexNegativeSampler(
        BM25Index.create(format_documents(corpus.pairs(), "single", "amazon")), 10, 5, 1)
    sparse = build_sparse_indices(corpus, field_info)

    def ds(queries, split):
        return ContrastiveDataset(queries, corpus,
                                  trec.QRels.from_file(os.path.join(data, f"{split}.qrels")),
                                  sampler, field_info, tok, query_max_length=64,
                                  sparse_indices=sparse)

    def trainer(batch=8, val=None):
        cfg = TrainerConfig(out_dir=out_dir, max_epochs=2, patience=10, trec_val_freq=2,
                            train_batch_size=batch, dev_batch_size=8, index_batch_size=16,
                            query_max_length=64, recall_k=20, seed=7)
        return Trainer(tok, field_info, corpus, ds(q_train, "train"),
                       val or ds(q_val, "val"), q_val, os.path.join(data, "val.qrels"), cfg,
                       sparse_indices=sparse, mesh=mesh)

    def state(dropout=0.0):
        cfg = EncoderConfig.tiny(vocab_size=tok.vocab_size, hidden_size=32, num_layers=2,
                                 num_heads=2, hidden_dropout=dropout,
                                 attention_dropout=dropout)
        model = MFARModel(cfg, num_fields=len(field_info), temperature=0.05)
        model.load_state_dict(fit["state"])
        return TrainState(model=model,
                          optimizer=make_optimizer(encoder_lr=2e-3, weights_lr=1e-1).build(model),
                          step=0, generator=torch.Generator().manual_seed(0))

    return trainer, state, ds(q_train, "train")


def run_fit(spec, mesh, out, out_dir):
    """``fit`` (2 epochs, a trec eval each 2), a trec eval after it, the
    checkpoints' round trip through ``restore_broadcast``, and the dropout
    masks: each rank's differ, a restored state replays them."""
    from mfar_tpu_torch.parallel.data_parallel import gather_rows, rank_generator, shard_batch
    from mfar_tpu_torch.train.data_pipeline import strip_meta
    from mfar_tpu_torch.train.train_step import train_step

    trainer, state, train_ds = fit_world(spec, mesh, out_dir)
    t = trainer()
    fitted = t.fit(state())
    data = spec["fit"]["data_dir"]
    out["fit/mixer"] = fitted.model.mixer.weight.detach().clone()
    out["fit/step"] = fitted.step
    out["fit/dev"] = t.trec_eval(fitted, t.dev_queries, os.path.join(data, "val.qrels"),
                                 "mesh-cmp")
    latest = t.ckpt_step_broadcast("latest")
    restored = t.restore_broadcast(latest, state())
    out["fit/latest"] = latest
    out["fit/restored_equal"] = all(
        torch.equal(a, b) for a, b in zip(fitted.model.state_dict().values(),
                                          restored.model.state_dict().values()))
    out["fit/restored_step"] = restored.step
    out["fit/out_dir"] = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else None

    # dropout: the same rows through each rank's generator, and a step
    # replayed from a restored state
    batch = strip_meta(next(train_ds.epoch_batches(8, seed=11)))
    local, shard = shard_batch(batch, mesh)
    drop = state(dropout=0.1)
    ids = torch.as_tensor(batch["query"]["input_ids"][:2]).long()
    mask = torch.as_tensor(batch["query"]["attention_mask"][:2]).long()
    gen = rank_generator(torch.Generator().manual_seed(3), shard)
    emb = drop.model.encoder.train()(ids, mask, generator=gen)
    out["dropout/rows"] = gather_rows(emb.detach(), shard)
    losses = []
    for _ in range(2):
        s = t.restore_broadcast(latest, state(dropout=0.1))
        losses.append(train_step(s, local, shard)[1]["loss"].item())
    out["dropout/replay"] = losses


def run_tp_fit(spec, mesh, out, out_dir, dp_dir):
    """``fit`` on a ``(data 1 x model 2)`` mesh: rank 0's checkpoints in the
    ``n_model`` 1 layout; then the data-parallel run's latest checkpoint
    (``dp_dir``, written at ``n_model`` 1) restored into sharded states."""
    from mfar_tpu_torch.parallel import tensor_parallel as tp
    from mfar_tpu_torch.train.checkpoint import CheckpointManager, state_payload

    trainer, state, _ = fit_world(spec, mesh, out_dir)
    t = trainer()
    fitted = t.fit(state())
    data = spec["fit"]["data_dir"]
    out["tp_fit/sharded"] = tp.is_sharded(fitted.model)
    out["tp_fit/step"] = fitted.step
    out["tp_fit/state"] = state_payload(fitted)
    out["tp_fit/dev"] = t.trec_eval(fitted, t.dev_queries, os.path.join(data, "val.qrels"),
                                    "tp-cmp")
    out["tp_fit/out_dir"] = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else None
    # an n_model 1 checkpoint into the sharded state, through rank 0
    t.ckpt = CheckpointManager(dp_dir) if t.ckpt is not None else None
    latest = t.ckpt_step_broadcast("latest")
    restored = t.restore_broadcast(latest, state())
    out["tp_fit/restored_dp"] = (latest, restored.step, state_payload(restored))


def run_ragged(spec, mesh, out, out_dir):
    """Validation whose batches of 6 over the ranks end ragged, and ``fit``
    refusing a batch of 6 that does not divide the ranks."""
    trainer, state, train_ds = fit_world(spec, mesh, out_dir)
    t = trainer(batch=6, val=train_ds)
    out["ragged/valid_loss"] = t.validate_proxy(state())
    try:
        t.fit(state())
        out["ragged/fit_error"] = None
    except ValueError as e:
        out["ragged/fit_error"] = str(e)


def main() -> None:
    rank, world, init_file, spec_path, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=100))
    from mfar_tpu_torch.parallel.mesh import make_mesh

    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh()
    out = {"shape": dict(mesh.shape)}
    run_steps(spec, mesh, out)
    if world == 2:
        run_fit(spec, mesh, out, os.path.join(out_dir, f"run{rank}"))
        tp_mesh = make_mesh(n_model=2)
        run_tp_fit(spec, tp_mesh, out, os.path.join(out_dir, f"tp_run{rank}"),
                   os.path.join(out_dir, "run0"))
    else:
        run_ragged(spec, mesh, out, os.path.join(out_dir, f"ragged{rank}"))
        tp_mesh = make_mesh(n_data=2, n_model=2)
        run_tp_steps(spec, tp_mesh, out)
    out["tp_shape"] = dict(tp_mesh.shape)
    out["modules"] = sorted(sys.modules)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
