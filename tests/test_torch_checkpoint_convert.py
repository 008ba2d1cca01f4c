"""``tools/jax_checkpoint_to_torch.py``: the JAX package's orbax checkpoints
in the port's layout.

- BERT: the JAX ``train --run-one-iteration`` with a ``synthetic`` model on
  ``tests/synth.py``'s dataset writes an orbax checkpoint at ``--n-model 1``
  and at ``--n-model 2`` (a ``(data 4 x model 2)`` mesh of the virtual
  devices); each converts into a directory with the same keys and shapes,
  and the port's ``retrieve --checkpoint-dir`` on it gives the JAX
  ``retrieve --checkpoint-dir``'s results on the orbax one (ties allowed,
  rtol 1e-4, atol 1e-3: ``eval/compare.py``);
- T5: a tiny T5 ``MFARModel`` state saved with JAX's ``CheckpointManager``
  converts to ``model_state_from_jax`` of the same params, and the port's
  ``retrieve`` serves it from a GTR directory (``save_gtr_dir``) of that
  shape.  The two retrieve commands are not compared there: both run a GTR
  directory in bf16, where the packages agree to 3e-2
  (``tests/test_torch_t5_registry.py``), not to 1e-4;
- a converted checkpoint holds no optimizer state and refuses to resume.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mfar_tpu.commands import retrieve as jax_retrieve_cmd
from mfar_tpu.commands import train as jax_train_cmd
from mfar_tpu.models.registry import prepare_model as jax_prepare_model
from mfar_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from mfar_tpu.train.model import MFARModel as JaxMFARModel
from mfar_tpu.train.optim import make_optimizer as jax_make_optimizer
from mfar_tpu.train.train_step import init_state as jax_init_state
from mfar_tpu_torch.commands import retrieve as retrieve_cmd
from mfar_tpu_torch.data import trec
from mfar_tpu_torch.eval.compare import rankings_agree
from mfar_tpu_torch.models.convert import model_state_from_jax
from mfar_tpu_torch.models.registry import save_gtr_dir
from mfar_tpu_torch.models.t5_encoder import T5Config, init_t5_encoder
from mfar_tpu_torch.train.checkpoint import CheckpointManager, apply_payload
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer
from mfar_tpu_torch.train.train_step import init_state
from synth import make_amazon_corpus, write_dataset_dir
from tools.jax_checkpoint_to_torch import main as convert_main

torch.set_num_threads(1)

FIELDS = "title_dense,description_dense"
WORDS = ["the", "red", "lamp", "glows", "blue", "book", "folds", "a"]


def _qres(path):
    out = {}
    for r in trec.QRes.from_file(path):
        out.setdefault(r.query_id, []).append((r.doc_id, float(r.sim)))
    return [out[q] for q in sorted(out)]


def _retrieve(data_dir, out, run_dir, model="synthetic", jax_cmd=False):
    args = ["--dataset-name", "amazon", "--data", data_dir, "--out", out,
            "--field-names", FIELDS, "--model-name", model, "--partition", "val",
            "--recall-k", "10", "--top-k", "5", "--checkpoint-dir", run_dir]
    if jax_cmd:
        jax_retrieve_cmd.main([*args, "--mesh", "off"])
    else:
        retrieve_cmd.main([*args, "--device", "cpu"])
    return _qres(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX train runs at --n-model 1 and 2, each converted."""
    root = tmp_path_factory.mktemp("convert")
    data = str(root / "data")
    write_dataset_dir(data, make_amazon_corpus(40), n_train=12, n_val=4)
    out = {"root": root, "data": data}
    for n_model in (1, 2):
        run = str(root / f"jax{n_model}")
        jax_train_cmd.main(["--dataset-name", "amazon", "--data", data, "--out", run,
                            "--lexical-index", str(root / "idx"), "--field-names", FIELDS,
                            "--model-name", "synthetic", "--weights-lr", "0.1",
                            "--train-batch-size", "4", "--max-epochs", "1",
                            "--run-one-iteration", "--recall-k", "10", "--dev-batch-size", "8",
                            "--n-model", str(n_model)])
        port = str(root / f"port{n_model}")
        convert_main(["--checkpoint-dir", run, "--out", port])
        out[n_model] = (run, port)
    return out


def test_tensor_parallel_checkpoints_convert_like_one_device_ones(runs):
    states = {}
    for n_model in (1, 2):
        run, port = runs[n_model]
        with open(os.path.join(run, "best.txt")) as f:
            step = os.path.basename(f.read().strip())
        with open(os.path.join(port, "best.txt")) as f:
            best = f.read().strip()
        assert best == os.path.join(port, "checkpoints", step)
        with open(os.path.join(best, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(run, "checkpoints", step, "meta.json")) as f:
            jax_meta = json.load(f)
        assert meta["field_info"] == jax_meta["field_info"]
        assert meta["metrics"] == jax_meta["metrics"]
        states[n_model] = torch.load(os.path.join(best, "state.pt"), weights_only=True)
    one, two = states[1]["model"], states[2]["model"]
    assert one.keys() == two.keys()
    assert {k: v.shape for k, v in one.items()} == {k: v.shape for k, v in two.items()}
    assert "optimizer" not in states[2]


@pytest.mark.parametrize("n_model", [1, 2])
def test_converted_checkpoint_serves_jax_results(runs, n_model):
    run, port = runs[n_model]
    root = runs["root"]
    want = _retrieve(runs["data"], str(root / f"jax{n_model}.qres"), run, jax_cmd=True)
    got = _retrieve(runs["data"], str(root / f"port{n_model}.qres"), port)
    assert len(got) == 4 and all(len(hits) == 5 for hits in got)
    assert rankings_agree(got, want, 1e-4, 1e-3) is None


def test_t5_checkpoint_converts_and_serves(tmp_path):
    """A JAX T5 MFARModel state (the encoder of a GTR directory, a trained
    mixer) through JAX's CheckpointManager, converted."""
    data = str(tmp_path / "data")
    write_dataset_dir(data, make_amazon_corpus(16), n_train=4, n_val=4)
    gtr = str(tmp_path / "gtr")
    cfg = T5Config.tiny(vocab_size=96, projection_dim=24)
    save_gtr_dir(gtr, cfg, init_t5_encoder(cfg, seed=2).state_dict(), WORDS)
    jcfg, jparams, _ = jax_prepare_model(gtr)
    model = JaxMFARModel(encoder_config=jcfg, num_fields=2)
    state = jax_init_state(model, jax_make_optimizer(encoder_lr=1e-4, weights_lr=1e-1), seed=0)
    mixer = np.random.default_rng(0).normal(size=state.params["mixer"]["weight"].shape)
    params = {**state.params, "encoder": jparams,
              "mixer": {"weight": jax.numpy.asarray(mixer, jax.numpy.float32)}}
    run = str(tmp_path / "jax")
    ckpt = JaxCheckpointManager(run)
    from mfar_tpu.data.schema import resolve_fields as jax_resolve_fields

    fields = jax_resolve_fields(FIELDS, "amazon")
    ckpt.save(0, state._replace(params=params), {"valid_loss": 1.0}, field_info=fields)
    ckpt.close()
    port = str(tmp_path / "port")
    convert_main(["--checkpoint-dir", run, "--out", port])
    got = torch.load(os.path.join(port, "checkpoints", "0", "state.pt"), weights_only=True)
    want = model_state_from_jax(jax.tree.map(np.asarray, params))
    assert got["model"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got["model"][k], v), k
    hits = _retrieve(data, str(tmp_path / "t5.qres"), port, model=gtr)
    assert len(hits) == 4 and all(len(h) == 5 and all(np.isfinite(s) for _, s in h)
                                  for h in hits)

    # served, not resumed: no optimizer state to restore
    restored = init_state(MFARModel(cfg, num_fields=2), make_optimizer(
        encoder_lr=1e-4, weights_lr=1e-1, use_adafactor=True), device="cpu")
    with pytest.raises(ValueError, match="no optimizer state"):
        apply_payload(restored, CheckpointManager(port).read(0))
