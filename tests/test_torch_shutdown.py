"""The port shuts its process group down at exit, as JAX registers
``distributed.shutdown()`` (``jax/_src/api.py:3170-3177``):
``mfar_tpu_torch.parallel.multihost.maybe_initialize`` registers
``shutdown`` with ``atexit``, which stops the serving daemon's heartbeat
thread (``before_shutdown``) and then destroys the gloo control group and
the world.

Two-rank gloo runs of ``retrieve --mesh auto --multihost force --device
cpu`` (started as ``tests/test_torch_multihost.py`` starts its pairs, all at
once, once for the module) each exit 0 with no abort on stderr, and a hook
registered before the command's own (so run after it) sees no process group
left.  In one process, the registered hook leaves ``dist.is_initialized()``
False and runs the ``before_shutdown`` hooks while the group still exists.
"""

import os
import subprocess
import sys

import pytest
import torch

from mfar_tpu_torch.commands import create_sparse_index, make_synth_data

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 3

# runs the module with an atexit hook registered first, so that it runs
# after every hook the module registers, and reports the process group
LAUNCH = (
    "import atexit, runpy, sys, torch; torch.set_num_threads(1)\n"
    "import torch.distributed as dist\n"
    "atexit.register(lambda: print('initialized at exit:', dist.is_initialized(), flush=True))\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__')\n"
)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MFAR_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def retrieve_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shutdown")
    data, idx = str(tmp / "data"), str(tmp / "idx")
    make_synth_data.main(["--out", data, "--dataset-name", "amazon", "--n-docs", "61",
                          "--n-train", "8", "--n-val", "8", "--seed", "3"])
    create_sparse_index.main(["--data-path", data, "--dataset-name", "amazon",
                              "--output-path", idx])
    procs = {}
    for run in range(RUNS):
        for rank in range(2):
            argv = ["mfar_tpu_torch.commands.retrieve", "--dataset-name", "amazon", "--data",
                    data, "--field-names", "title_dense,title_sparse", "--model-name",
                    "synthetic", "--lexical-index", idx, "--top-k", "10", "--batch-size", "8",
                    "--out", str(tmp / f"run{run}_{rank}.qres"), "--mesh", "auto",
                    "--multihost", "force", "--device", "cpu"]
            env = _env(MFAR_COORDINATOR=f"file://{tmp / f'init{run}'}",
                       MFAR_NUM_PROCESSES="2", MFAR_PROCESS_ID=str(rank))
            procs[(run, rank)] = subprocess.Popen(
                [sys.executable, "-c", LAUNCH, *argv], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for key, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"run {key} timed out")
        out[key] = (p.returncode, stdout, stderr)
    return tmp, out


@pytest.mark.parametrize("run", range(RUNS))
def test_two_rank_retrieve_exits_without_a_live_group(retrieve_runs, run):
    tmp, out = retrieve_runs
    for rank in range(2):
        rc, stdout, stderr = out[(run, rank)]
        assert rc == 0, f"run {run} rank {rank} exited {rc}:\n{stderr[-3000:]}"
        assert "terminate called" not in stderr and "Aborted" not in stderr, stderr[-3000:]
        assert "[mesh-" in stdout or rank == 1, stdout[-2000:]  # rank 0 served on the mesh
        assert stdout.rstrip().endswith("initialized at exit: False"), stdout[-2000:]
    assert os.path.exists(tmp / f"run{run}_0.qres") and not os.path.exists(tmp / f"run{run}_1.qres")


IN_PROCESS = """
import atexit, os, sys
import torch.distributed as dist
from mfar_tpu_torch.parallel import multihost

registered = []
atexit.register = registered.append  # keep the hook from running at this exit
os.environ.update(MFAR_COORDINATOR="file://" + sys.argv[1], MFAR_NUM_PROCESSES="1",
                  MFAR_PROCESS_ID="0")
assert multihost.maybe_initialize("force", "cpu") is False  # a world of one
assert dist.is_initialized() and registered == [multihost.shutdown]
assert multihost.maybe_initialize("force", "cpu") is False and len(registered) == 1
seen = []
multihost.before_shutdown(lambda: seen.append(("first", dist.is_initialized())))
multihost.before_shutdown(lambda: seen.append(("second", dist.is_initialized())))
dropped = lambda: seen.append("dropped")
multihost.before_shutdown(dropped)
multihost.drop_shutdown_hook(dropped)
registered[0]()
assert not dist.is_initialized(), "the hook left the group"
assert seen == [("second", True), ("first", True)], seen
registered[0]()  # a second call is a no-op
print("ok")
"""


def test_shutdown_hook_destroys_the_group_in_process(tmp_path):
    proc = subprocess.run([sys.executable, "-c", IN_PROCESS, str(tmp_path / "init")],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"
