"""Time kernel K2 or K2b against edited copies of its source, in turns, on one card.

    python3 flash_variants.py [--kernel k2|k2b|k2b_tf32] [--dims D ...] [--against DIR]
                              [PRESET ...]
        (default: K2b, every preset of the kernel)

Each variant is the kernel's source (``mfar_tpu_torch/csrc/flash_attention.cu``
for K2, ``flash_attention_bwd.cu`` for K2b, ``flash_attention_tf32_bwd.cu`` for
K2b's f32 pair, ``k2b_tf32``) with the textual edits of its
preset, built with the port's nvcc flags into ``mfar_tpu_torch/build/``
beside the committed library and bound in its place.  ``--against DIR``
adds the kernel's source in another checkout of the repo (its ``csrc``, as
it stands) as the variant ``against``, e.g. the parent commit unpacked with
``git archive``.  The kernel is timed as CUDA-event medians
(``chip_smoke.time_cuda``), in the order committed, variants, variants
reversed, committed:

- K2 at chip_smoke's index-build shape [256, 12, 512, 64] bf16 (``fwd_ms``)
  and, with the logsumexp, at its training shape [96, 12, 512, 64]
  (``fwd_lse_ms``), with chip_smoke's segment lengths;
- K2b at the training shape: kernel dq (with di), kernel dkv and the whole
  backward;
- K2b's f32 pair (3xTF32) at [96, 12, 512, D] f32 for each D of ``--dims``
  (default 96, 128, 192 and 256: its wide instances), chip_smoke's segment
  lengths: dq (with di), dkv, and dq then dkv (``pair``), each a median of
  7 runs of 3 calls, held to the plain backward at the f32 gate (2e-5 of
  the largest gradient).

Presets join with ``+`` (``stages4+exp2f``).  A preset whose name
starts with ``x_`` computes something else (an
ablation: it shows what a part of the kernel costs) and is not checked;
every other variant is held against the plain version at chip_smoke's
tolerances.  Prints the card's name and power limit, a line per timing, and
one JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from mfar_tpu_torch.ops import _build
from mfar_tpu_torch.ops import flash_attention as fa


def _no_mma(anchor: str, ss: bool = False):
    """Edits that replace every product by a no-op (the ablation x_nomma)."""
    none = ("template <int M, class A, class B>\n"
            "__device__ void gemm_none(float (&)[8][4], const A&, B) {}\n"
            "template <bool kAccumulate = false>\n"
            "__device__ void gemm_none_ss(float (&)[8][4], uint64_t, uint64_t) {}\n\n")
    edits = [(anchor, none + anchor), ("gemm_rs<1>(", "gemm_none<1>(")]
    edits.append(("gemm_ss_new", "gemm_none_ss") if ss else ("gemm_rs<0>(", "gemm_none<0>("))
    return edits


PRESETS = {
    "k2": {
        # exp2f's exact path instead of the special-function unit's ex2.approx
        "exp2f": [("exp2_approx(", "exp2f(")],
        # at D = 64, a ring of two or four stages instead of three
        "stages2": [("kStages = NS == 4 ? 2 : 3;", "kStages = NS == 4 ? 2 : NS == 1 ? 2 : 3;")],
        "stages4": [("kStages = NS == 4 ? 2 : 3;", "kStages = NS == 4 ? 2 : NS == 1 ? 4 : 3;")],
        # at D = 64, one block an SM (no register cap below 255)
        "blocks1": [("kMinBlocks = NS == 1 ? 2 : 1;", "kMinBlocks = 1;")],
        # at D = 64, three blocks an SM (80 registers a thread)
        "blocks3": [("kMinBlocks = NS == 1 ? 2 : 1;", "kMinBlocks = NS == 1 ? 3 : 1;")],
        # no softmax for a warp none of whose rows takes a one-segment tile
        "maskedwarp": [("  if (seg_lo == seg_hi) {  // the tile's keys are of one segment",
                        "  if (seg_lo == seg_hi && !__any_sync(0xffffffffu, seg_q0 == seg_lo || "
                        "seg_q1 == seg_lo)) {\n    alpha[0] = alpha[1] = 1.f;\n    zero(s);\n"
                        "    return;\n  }\n"
                        "  if (seg_lo == seg_hi) {  // the tile's keys are of one segment")],
        # ablations: no exp2 at all; no products; no per-tile work (loads only)
        "x_noexp": [("exp2_approx(", "(")],
        "x_nomma": _no_mma("struct FwdParams", ss=True),
        "x_nocompute": [("const bool take = more && m.meets(m.live[i], lo, hi);",
                         "const bool take = false;")],
    },
    "k2b": {
        "exp2f": [("exp2_approx(", "exp2f(")],
        "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        # ablations: no exp2 at all; no products; no per-tile work (loads only)
        "x_noexp": [("exp2_approx(", "(")],
        "x_nomma": _no_mma("struct BwdParams"),
        "x_nocompute": [("consume(m, m.tmin[kGroups * blk + wg], m.tmax[kGroups * blk + wg],",
                         "consume(m, INT_MAX, INT_MIN,")],
    },
}
PRESETS["k2b_tf32"] = {
    # ablations of the wide pair: no S / dP products; no row products (dQ,
    # dV, dK)
    "x_noheads": [("    wgmma_3xtf32(s0,", "    if (Dl < 0) wgmma_3xtf32(s0,"),
                  ("      wgmma_3xtf32(s1,", "      if (Dl < 0) wgmma_3xtf32(s1,")],
    "x_norows": [("    wgmma_3xtf32(d[k >> 3],", "    if (Dl < 0) wgmma_3xtf32(d[k >> 3],")],
}
SOURCES = {"k2": "flash_attention", "k2b": "flash_attention_bwd",
           "k2b_tf32": "flash_attention_tf32_bwd"}


def committed_fns(kernel: str) -> tuple:
    if kernel == "k2":
        return (fa._kernel(),)
    return fa._tf32_bwd_kernels() if kernel == "k2b_tf32" else fa._bwd_kernels()


def build(kernel: str, name: str, edits, csrc: str = _build.CSRC_DIR) -> tuple:
    """The variant's entry points, typed as the committed ones: K2's forward,
    or K2b's (dq, dkv)."""
    lib_name = SOURCES[kernel]
    with open(os.path.join(csrc, _build.SOURCES[lib_name])) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"preset {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    base = os.path.join(_build.BUILD_DIR, f"{lib_name}-{name}")
    with open(base + ".cu", "w") as f:
        f.write(src)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", base + ".so", base + ".cu"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    usage = [ln.split(":", 1)[-1].strip() for ln in proc.stdout.splitlines()
             if "spill" in ln or "Used" in ln]
    # the kernels whose wgmma ptxas serializes (its warning C7511)
    serial = [m[1] + " NS=" + m[2] for ln in proc.stdout.splitlines() if "C7511" in ln
              for m in [re.search(r"(\w+?_kernel)ILi(\d+)", ln)] if m]
    print(f"{name}: ptxas {'; '.join(usage)}; wgmma serialized in {serial}", flush=True)
    lib = ctypes.CDLL(base + ".so")
    if kernel == "k2":
        fns = (lib.mfar_flash_attention_fwd,)
    elif kernel == "k2b_tf32":
        fns = (lib.mfar_flash_attention_bwd_dq_tf32, lib.mfar_flash_attention_bwd_dkv_tf32)
    else:
        fns = (lib.mfar_flash_attention_bwd_dq, lib.mfar_flash_attention_bwd_dkv)
    for fn, ref in zip(fns, committed_fns(kernel)):
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    if "int S, int D," not in src:
        # a kernel from before its head-dim argument (D = 64 only): the same
        # calls without D (K2's tenth argument, K2b's thirteenth)
        at = 9 if kernel == "k2" else 12
        for raw in fns:
            raw.argtypes = raw.argtypes[:at] + raw.argtypes[at + 1:]
        fns = tuple((lambda raw: lambda *a: raw(*a[:at], *a[at + 1:]))(raw) for raw in fns)
    return fns


def use(kernel: str, fns: tuple) -> None:
    """Bind ``fns`` in place of the kernel's committed entry points."""
    if kernel == "k2":
        fa._kernel = lambda: fns[0]
    elif kernel == "k2b_tf32":
        fa._tf32_bwd_kernels = lambda: fns
    else:
        fa._bwd_kernels = lambda: fns


def lengths_of(seed: int, b: int, s: int):
    """chip_smoke's segment lengths: uniform over 2..S, a full row and a row
    of 2 tokens first."""
    lengths = np.random.default_rng(seed).integers(2, s + 1, size=b)
    lengths[0], lengths[1] = s, 2
    return lengths.tolist()


def k2_cases(gen):
    """K2's two timed calls with their checks: (label, call, check)."""
    scale = 0.125
    out = []
    for label, (b, h, s), with_lse in (("fwd_ms", (256, 12, 512), False),
                                      ("fwd_lse_ms", (96, 12, 512), True)):
        q, k, v, seg = chip_smoke.k2_inputs(gen, b, h, s, lengths_of(0 if b == 256 else 5, b, s))
        want = fa.flash_attention_plain(q, k, v, seg, scale)
        want_lse = chip_smoke.masked_logsumexp(q, k, seg, scale) if with_lse else None

        def call(q=q, k=k, v=v, seg=seg, with_lse=with_lse):
            if with_lse:
                return fa.flash_attention_fwd(q, k, v, seg, scale)
            return fa.flash_attention(q, k, v, seg, scale), None

        def check(name, call=call, want=want, want_lse=want_lse):
            got, lse = call()
            chip_smoke.check(torch.allclose(got.float(), want.float(), rtol=chip_smoke.K2_RTOL,
                                            atol=chip_smoke.K2_ATOL), f"variant {name} disagrees")
            if want_lse is not None:
                chip_smoke.check((lse - want_lse).abs().max().item() <= chip_smoke.K2B_LSE_ATOL,
                                 f"variant {name}: logsumexp disagrees")

        out.append((label, call, check))
    return out


def k2b_cases(gen):
    b, h, s = 96, 12, 512
    q, k, v, seg, dout = chip_smoke.k2b_inputs(gen, b, h, s, lengths_of(5, b, s))
    scale = 0.125
    out, lse = fa.flash_attention_fwd(q, k, v, seg, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
    _, di = fa.flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, scale)

    def check(name):
        got = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
        for g, w in zip(got, want):
            atol = chip_smoke.K2B_ATOL_REL * w.float().abs().max().item()
            chip_smoke.check(torch.allclose(g.float(), w.float(), rtol=chip_smoke.K2B_RTOL,
                                            atol=atol), f"variant {name} disagrees")

    return [
        ("dq_ms", lambda: fa.flash_attention_bwd_dq(q, k, v, seg, lse, out, dout, scale), check),
        ("dkv_ms", lambda: fa.flash_attention_bwd_dkv(q, k, v, seg, lse, di, dout, scale), None),
        ("bwd_ms", lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale), None),
    ]


def k2b_tf32_cases(gen, dims):
    """The f32 pair's timed calls at [96, 12, 512, D] for each D, the check
    (the whole backward at the f32 gate) on each D's first."""
    b, h, s = 96, 12, 512
    out = []
    for d in dims:
        q, k, v, seg, dout = chip_smoke.k2g_inputs(gen, b, h, s, d, torch.float32,
                                                   lengths_of(5, b, s))
        scale = 1.0 / d**0.5
        o, lse = fa.flash_attention_fwd(q, k, v, seg, scale)
        want = fa.flash_attention_bwd_plain(q, k, v, seg, o, lse, dout, scale)
        _, di = fa.flash_attention_tf32_bwd_dq(q, k, v, seg, lse, o, dout, scale)

        def check(name, q=q, k=k, v=v, seg=seg, o=o, lse=lse, dout=dout, scale=scale,
                  want=want, d=d):
            got = fa.flash_attention_bwd(q, k, v, seg, o, lse, dout, scale)
            for g, w in zip(got, want):
                err = (g - w).abs().max().item()
                chip_smoke.check(err <= chip_smoke.K2G_GRAD_REL * w.abs().max().item(),
                                 f"variant {name} disagrees at D={d}: max abs err {err}")

        def dq(q=q, k=k, v=v, seg=seg, o=o, lse=lse, dout=dout, scale=scale):
            return fa.flash_attention_tf32_bwd_dq(q, k, v, seg, lse, o, dout, scale)

        def dkv(q=q, k=k, v=v, seg=seg, di=di, lse=lse, dout=dout, scale=scale):
            return fa.flash_attention_tf32_bwd_dkv(q, k, v, seg, lse, di, dout, scale)

        out += [(f"d{d}_dq_ms", dq, check), (f"d{d}_dkv_ms", dkv, None),
                (f"d{d}_pair_ms", lambda dq=dq, dkv=dkv: (dq(), dkv()), None)]
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=sorted(PRESETS), default="k2b")
    p.add_argument("--against", metavar="DIR",
                   help="a checkout whose kernel source is timed as the variant 'against'")
    p.add_argument("--dims", type=int, nargs="+", default=[96, 128, 192, 256],
                   help="k2b_tf32's head dims")
    p.add_argument("presets", nargs="*", metavar="PRESET")
    args = p.parse_args(argv)
    presets = PRESETS[args.kernel]
    names = args.presets if args.presets or args.against else list(presets)
    unknown = [p for n in names for p in n.split("+") if p not in presets]
    if unknown:
        p.error(f"unknown {args.kernel} presets {unknown}; known: {sorted(presets)}")
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {"committed": committed_fns(args.kernel)}
    # "a+b" applies the edits of presets a and b
    libs.update((name, build(args.kernel, name, [e for p in name.split("+") for e in presets[p]]))
                for name in names)
    if args.against:
        names.append("against")
        libs["against"] = build(args.kernel, "against", [],
                                os.path.join(args.against, "mfar_tpu_torch", "csrc"))

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = (k2_cases(gen) if args.kernel == "k2" else
             k2b_tf32_cases(gen, args.dims) if args.kernel == "k2b_tf32" else k2b_cases(gen))
    slow = dict(reps=7, inner=3) if args.kernel == "k2b_tf32" else {}
    saved = fa._kernel, fa._bwd_kernels, fa._tf32_bwd_kernels
    times: dict = {}
    try:
        for name in ["committed", *names, *names[::-1], "committed"]:
            use(args.kernel, libs[name])
            if "x_" not in name:
                for _, _, check in cases:
                    if check is not None:
                        check(name)
            t = {label: chip_smoke.time_cuda(call, **slow) for label, call, _ in cases}
            times.setdefault(name, []).append(t)
            print(name, " ".join(f"{key} {x:.4f}" for key, x in t.items()), flush=True)
    finally:
        fa._kernel, fa._bwd_kernels, fa._tf32_bwd_kernels = saved
    print(json.dumps({"kernel": args.kernel, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
