"""Time kernel K2b against edited copies of its source, in turns, on one card.

    python3 k2b_variants.py [PRESET ...]     (default: every preset)

Each variant is ``mfar_tpu_torch/csrc/flash_attention_bwd.cu`` with the
textual edits of its preset, built with the port's nvcc flags into
``mfar_tpu_torch/build/`` beside the committed library and bound in its place.
All are timed at chip_smoke's training shape [96, 12, 512, 64] bf16 with
chip_smoke's segment lengths: kernel dq (with di), kernel dkv and the whole
backward, as CUDA-event medians (``chip_smoke.time_cuda``), in the order
committed, variants, variants reversed, committed.  A preset whose name starts
with ``x_`` computes something else (an ablation: it shows what a part of the
kernels costs) and is not checked; every other variant is held against the
plain backward at chip_smoke's tolerance.  Prints the card's name and power
limit, a line per timing, and one JSON object last.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from mfar_tpu_torch.ops import _build
from mfar_tpu_torch.ops import flash_attention as fa

_ZERO_ACC = "namespace {\n\nstruct BwdParams"
PRESETS = {
    # exp2f's exact path instead of the special-function unit's ex2.approx
    "exp2f": [("exp2_approx(", "exp2f(")],
    # a ring of three stages instead of two
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # ablations: no exp2 at all; no products; no per-tile work (loads only)
    "x_noexp": [("exp2_approx(", "(")],
    "x_nomma": [(_ZERO_ACC, "namespace {\ntemplate <int M, class A, class B>\n"
                            "__device__ void gemm_none(float (&)[8][4], const A&, B) {}\n\n"
                            "struct BwdParams"),
                ("gemm_rs<0>(", "gemm_none<0>("), ("gemm_rs<1>(", "gemm_none<1>(")],
    "x_nocompute": [("if (m.tmin[t] <= hi && lo <= m.tmax[t]) tile(stage);", "")],
}


def build(name: str, edits) -> tuple:
    """The variant's (dq, dkv) entry points, typed as the committed ones."""
    src = open(os.path.join(_build.CSRC_DIR, "flash_attention_bwd.cu")).read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"preset {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    base = os.path.join(_build.BUILD_DIR, f"flash_attention_bwd-{name}")
    with open(base + ".cu", "w") as f:
        f.write(src)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", base + ".so",
           base + ".cu"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    lib = ctypes.CDLL(base + ".so")
    fns = (lib.mfar_flash_attention_bwd_dq, lib.mfar_flash_attention_bwd_dkv)
    for fn, ref in zip(fns, fa._bwd_kernels()):
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return fns


def main(argv) -> int:
    names = argv or list(PRESETS)
    if not torch.cuda.is_available():
        print("k2b_variants: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {"committed": fa._bwd_kernels()}
    libs.update((name, build(name, PRESETS[name])) for name in names)

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, s = 96, 12, 512
    lengths = np.random.default_rng(5).integers(2, s + 1, size=b)
    lengths[0], lengths[1] = s, 2
    q, k, v, seg, dout = chip_smoke.k2b_inputs(gen, b, h, s, lengths.tolist())
    scale = 0.125
    out, lse = fa.flash_attention_fwd(q, k, v, seg, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
    committed = fa._bwd_kernels
    times: dict = {}
    try:
        for name in ["committed", *names, *names[::-1], "committed"]:
            fa._bwd_kernels = lambda n=name: libs[n]
            got = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
            if not name.startswith("x_"):
                for g, w in zip(got, want):
                    atol = chip_smoke.K2B_ATOL_REL * w.float().abs().max().item()
                    chip_smoke.check(torch.allclose(g.float(), w.float(), rtol=chip_smoke.K2B_RTOL,
                                                    atol=atol), f"variant {name} disagrees")
            _, di = fa.flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, scale)
            t = dict(
                dq_ms=chip_smoke.time_cuda(
                    lambda: fa.flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, scale)),
                dkv_ms=chip_smoke.time_cuda(
                    lambda: fa.flash_attention_bwd_dkv(q, k, v, seg, lse, di, dout, scale)),
                bwd_ms=chip_smoke.time_cuda(
                    lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)),
            )
            times.setdefault(name, []).append(t)
            print(name, " ".join(f"{key} {x:.4f}" for key, x in t.items()), flush=True)
    finally:
        fa._bwd_kernels = committed
    print(json.dumps({"shape": [b, h, s, 64], "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
