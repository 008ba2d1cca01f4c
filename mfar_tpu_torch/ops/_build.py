"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``mfar_tpu_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``mfar_tpu_torch/build/`` under a name that carries a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so a
changed source rebuilds and an unchanged one loads at once.  The build runs at first use, never at import.  A
missing ``nvcc`` or a failed build raises with the compiler's output; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

# kernel name -> source file under csrc/
SOURCES = {
    "gather_scores": "gather_scores.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "flash_attention_simt": "flash_attention_simt.cu",
    "flash_attention_tf32": "flash_attention_tf32.cu",
    "flash_attention_tf32_bwd": "flash_attention_tf32_bwd.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the port's CUDA kernels build from source on the machine with the card"
    )


def library_path(name: str) -> str:
    """The library's path: its name and a hash of its source, the shared
    headers of ``csrc/`` (which a source may include) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Build the named kernel's library if it is missing.  Returns the
    compiler's output (empty for a library that was already built)."""
    target = library_path(name)
    if os.path.exists(target):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n(exit {proc.returncode})\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed (one load per process)."""
    build(name)
    return ctypes.CDLL(library_path(name))
