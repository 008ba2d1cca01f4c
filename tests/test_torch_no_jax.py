"""The PyTorch port imports nothing of JAX, nothing of ``mfar_tpu``, and
neither ``transformers`` nor ``sentence_transformers`` (it reads model
directories itself)."""

import os
import pkgutil
import re
import subprocess
import sys

import torch

import mfar_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transformers",
             "sentence_transformers")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(mfar_tpu_torch.__path__, "mfar_tpu_torch.")
    )


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    # "mfar_tpu_torch".startswith("mfar_tpu") is true: compare the top-level name
    return top in FORBIDDEN or top.startswith(FORBIDDEN) or top == "mfar_tpu"


def test_forbidden_matches_only_the_reference():
    assert _forbidden("mfar_tpu") and _forbidden("mfar_tpu.ops.scoring")
    assert _forbidden("jax._src") and _forbidden("flax.linen") and _forbidden("orbax.checkpoint")
    assert _forbidden("transformers.models.t5") and _forbidden("sentence_transformers")
    assert not _forbidden("mfar_tpu_torch") and not _forbidden("mfar_tpu_torch.ops")


def test_importing_the_port_loads_no_jax():
    mods = _port_modules() + ["chip_smoke", "flash_variants"]
    assert {"mfar_tpu_torch.eval.retrieval", "mfar_tpu_torch.commands.train",
            "mfar_tpu_torch.train.trainer", "mfar_tpu_torch.train.checkpoint",
            "mfar_tpu_torch.train.losses", "mfar_tpu_torch.train.optim",
            "mfar_tpu_torch.train.train_step", "mfar_tpu_torch.sparse.bm25",
            "mfar_tpu_torch.data.negative_sampler", "mfar_tpu_torch.utils.logging",
            "mfar_tpu_torch.utils.timing", "mfar_tpu_torch.native",
            "mfar_tpu_torch.data.synth", "mfar_tpu_torch.utils.jsonutil",
            "mfar_tpu_torch.train.sparse_cache", "mfar_tpu_torch.commands.mask_fields",
            "mfar_tpu_torch.commands.make_synth_data",
            "mfar_tpu_torch.commands.create_sparse_index",
            "mfar_tpu_torch.commands.precompute_sparse_scores",
            "mfar_tpu_torch.serve", "mfar_tpu_torch.commands.serve",
            "mfar_tpu_torch.ops.scoring", "mfar_tpu_torch.models.t5_encoder",
            "mfar_tpu_torch.models.t5_decoder", "mfar_tpu_torch.models.registry",
            "mfar_tpu_torch.models.convert", "mfar_tpu_torch.parallel.mesh",
            "mfar_tpu_torch.parallel.topk", "mfar_tpu_torch.parallel.multihost",
            "mfar_tpu_torch.parallel.data_parallel",
            "mfar_tpu_torch.parallel.tensor_parallel", "mfar_tpu_torch.commands.stark",
            "mfar_tpu_torch.commands.stark.stark_to_trec",
            "mfar_tpu_torch.commands.stark.download_queries", "mfar_tpu_torch.scripts",
            "mfar_tpu_torch.scripts.find_failures", "mfar_tpu_torch.scripts.compare_results",
            "mfar_tpu_torch.scripts.corpus_stats"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, check=True, timeout=300,
    ).stdout.split()
    bad = [m for m in out if _forbidden(m)]
    assert not bad, f"the port loaded {bad[:10]}"
    assert "torch" in out and "chip_smoke" in out and "flash_variants" in out


def test_sources_import_no_jax():
    import_re = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "flash_variants.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "mfar_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        bad = [m for m in import_re.findall(src) if _forbidden(m)]
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_the_package_imports_no_tool():
    """``tools/`` (the JAX checkpoint converter imports JAX and orbax) stays
    outside the package: no module of it imports ``tools``."""
    import_re = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "mfar_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert os.path.isfile(os.path.join(ROOT, "tools", "jax_checkpoint_to_torch.py"))
    for path in files:
        with open(path, encoding="utf-8") as f:
            mods = import_re.findall(f.read())
        assert not [m for m in mods if m.split(".")[0] == "tools"], path


SERVING_PATHS = """
import json, sys, urllib.request
import numpy as np, torch
from mfar_tpu_torch.data.schema import resolve_fields
from mfar_tpu_torch.eval.retrieval import RetrievalEngine
from mfar_tpu_torch.models.tokenizer import SimpleVocabTokenizer
from mfar_tpu_torch.ops import scoring
from mfar_tpu_torch.serve import RetrievalServer

rng = np.random.default_rng(0)
docs = rng.normal(size=(50, 16)).astype(np.float32)
q = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
dq, ds = scoring.quantize_rows_int8_np(docs)
scoring.dense_topk_chunked_int8(q, torch.from_numpy(dq), torch.from_numpy(ds), 50, 5)
scoring.dense_topk_host_streamed_int8(q, dq, ds, 5, chunk_size=16)
scoring.hybrid_topk_host_streamed(q, docs, 5, chunk_size=16,
                                  sparse_comb_host=np.zeros((2, 50), np.float32))
tok = SimpleVocabTokenizer.build(["red lamp", "blue chair"], max_length=8)
table = torch.from_numpy(rng.normal(size=(tok.vocab_size, 8)).astype(np.float32))
engine = RetrievalEngine(
    field_info=resolve_fields("title_dense,description_dense", "amazon"),
    doc_keys=[f"d{i}" for i in range(50)], encode_fn=lambda ids, m: table[ids].mean(1),
    tokenizer=tok, mixer_params={"weight": np.ones((1, 2), np.float32)},
    dense_matrix=rng.normal(size=(50, 2, 8)).astype(np.float32), quantize="int8",
    corpus_on_host=True, device="cpu")
srv = RetrievalServer(engine, port=0, max_batch=4, top_k=3)
try:
    srv.warmup()
    srv.start_background()
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/retrieve",
                                 data=json.dumps({"queries": ["red lamp"]}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert len(json.loads(r.read())["results"][0]) == 3
finally:
    srv.shutdown()
assert engine.last_serve_path == "host-stream-dense-int8", engine.last_serve_path
print("\\n".join(sorted(sys.modules)))
"""


def test_serving_paths_run_without_jax():
    """The daemon over an int8 host-streamed engine, and the int8 and
    streamed scans, run in a process that loads no JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", SERVING_PATHS], cwd=ROOT, env=env, capture_output=True,
        text=True, check=True, timeout=300,
    ).stdout.split()
    bad = [m for m in out if _forbidden(m)]
    assert not bad, f"the port loaded {bad[:10]}"
    assert "mfar_tpu_torch.serve" in out


T5_PATHS = """
import sys, tempfile
import torch
from mfar_tpu_torch.models import T5Config, build_encoder
from mfar_tpu_torch.models.registry import prepare_model, save_gtr_dir, save_t5_dir
from mfar_tpu_torch.models.t5_decoder import T5Seq2SeqConfig, init_t5_seq2seq
from mfar_tpu_torch.models.t5_encoder import init_t5_encoder
from mfar_tpu_torch.train.model import MFARModel
from mfar_tpu_torch.train.optim import make_optimizer

d = tempfile.mkdtemp()
cfg = T5Config.tiny(vocab_size=64, projection_dim=16)
save_gtr_dir(d + "/gtr", cfg, init_t5_encoder(cfg).state_dict(), ["red", "lamp"])
s2s = init_t5_seq2seq(T5Seq2SeqConfig(encoder=T5Config.tiny(vocab_size=64),
                                      decoder=T5Config.tiny(vocab_size=64)))
save_t5_dir(d + "/t5", s2s.cfg.encoder, s2s.encoder.state_dict(), ["red"],
            decoder_state=s2s.decoder.state_dict())
config, state, tok = prepare_model(d + "/gtr", dtype=torch.float32)
enc = build_encoder(config)
enc.load_state_dict(state)
toks = tok.encode_batch(["red lamp"])
enc(torch.from_numpy(toks["input_ids"]).long(), torch.from_numpy(toks["attention_mask"]))
prepare_model("t5:" + d + "/t5")
model = MFARModel(config, num_fields=2)
opt = make_optimizer(weights_lr=0.1, use_adafactor=True).build(model)
for p in model.parameters():
    p.grad = torch.ones_like(p)
opt.step()
print("\\n".join(sorted(sys.modules)))
"""


def test_t5_paths_run_without_jax_or_transformers():
    """A GTR and a seq2seq T5 directory written, loaded, encoded, and an
    Adafactor step, in a process that loads neither JAX nor transformers."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", T5_PATHS], cwd=ROOT, env=env, capture_output=True,
        text=True, check=True, timeout=300,
    ).stdout.split()
    bad = [m for m in out if _forbidden(m)]
    assert not bad, f"the port loaded {bad[:10]}"
    assert "mfar_tpu_torch.models.t5_encoder" in out and "tokenizers" in out


RANK_PATHS = """
import datetime, sys, time
import numpy as np, torch, torch.distributed as dist
rank, init = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
from mfar_tpu_torch.parallel import multihost, topk
from mfar_tpu_torch.parallel.mesh import make_mesh
from mfar_tpu_torch.serve import MultihostEngineProxy, follower_loop

mesh = make_mesh()
docs = torch.from_numpy(np.random.default_rng(0).normal(size=(10, 8)).astype(np.float32))
s, i = topk.distributed_dense_topk(mesh, docs[:2], docs[rank * 5 : rank * 5 + 5], 10, 3)
assert i.tolist() == torch.topk(docs[:2] @ docs.T, 3).indices.tolist(), i


class Engine:
    n_docs, device = 10, torch.device("cpu")

    def dispatch(self, queries, top_k=100, mode=None):
        return topk.distributed_dense_topk(mesh, docs[:len(queries)], docs[rank * 5 :][:5],
                                           10, top_k)

    def finish(self, handle):
        return handle[1].tolist()


if rank == 0:
    # heartbeats every second (the thread's tick) among 40 batches over ~2 s:
    # the shared lock keeps a no-op from landing inside a batch's collectives
    proxy = MultihostEngineProxy(Engine(), max_batch=2, heartbeat_s=0.0)
    want = torch.topk(docs[:2] @ docs.T, 2).indices.tolist()
    for _ in range(40):
        assert proxy.retrieve(["a", "b"], top_k=2) == want
        time.sleep(0.05)
    proxy.stop()
    assert not proxy._hb.is_alive()
else:
    follower_loop(Engine())
multihost.sync("done")
print("\\n".join(sorted(sys.modules)))
"""


def test_a_spawned_rank_loads_no_jax(tmp_path):
    """Two gloo ranks run the mesh, a distributed route, and the daemon's
    broadcast (rank 0's proxy, rank 1's follower loop, heartbeats between
    batches) without JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_PATHS, str(r), str(tmp_path / "init")],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        mods = out.split()
        bad = [m for m in mods if _forbidden(m)]
        assert not bad, f"a rank loaded {bad[:10]}"
        assert "mfar_tpu_torch.parallel.topk" in mods and "mfar_tpu_torch.serve" in mods
