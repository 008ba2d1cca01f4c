"""The PyTorch port imports nothing of JAX and nothing of ``mfar_tpu``."""

import os
import pkgutil
import re
import subprocess
import sys

import torch

import mfar_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


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
    assert not _forbidden("mfar_tpu_torch") and not _forbidden("mfar_tpu_torch.ops")


def test_importing_the_port_loads_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    assert {"mfar_tpu_torch.eval.retrieval", "mfar_tpu_torch.commands.train",
            "mfar_tpu_torch.train.trainer", "mfar_tpu_torch.train.checkpoint",
            "mfar_tpu_torch.train.losses", "mfar_tpu_torch.train.optim",
            "mfar_tpu_torch.train.train_step", "mfar_tpu_torch.sparse.bm25",
            "mfar_tpu_torch.data.negative_sampler", "mfar_tpu_torch.utils.logging",
            "mfar_tpu_torch.utils.timing"} <= set(mods)
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
    assert "torch" in out and "chip_smoke" in out


def test_sources_import_no_jax():
    import_re = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "mfar_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        bad = [m for m in import_re.findall(src) if _forbidden(m)]
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
