"""K2b, the backward of kernel K2: the port's plain backward against
``jax.vjp`` of JAX's library Pallas ``flash_attention`` (whose VJP runs the
two Pallas kernels K2b replaces), run on the CPU in interpret mode; and the
autograd Function (K2 forward + K2b backward; the plain versions on CPU
tensors) against autograd through the plain forward.  The CUDA kernels run
only on a card: their tests are in ``tests/test_torch_card.py``.

Tolerances: f32 atol 2e-5 (the same f32 arithmetic; the Pallas kernels sum
blockwise).  bf16 rtol 2e-2 and atol 1e-2 of the largest gradient: the
gradients are rounded to bf16 (2**-8 relative), and the Pallas kernels
round P and dS to bf16 before their products, where the plain version stays
in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from mfar_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)

torch.set_num_threads(1)

SCALE = 0.125  # 1 / sqrt(64)


# segment layouts at [2, 2, 256, 64] (the card tests use the same inputs):
# several segments (ids 2/1/0 in runs), ids that return after another
# segment, tiles of alternating ids 0 and 2 against a tile of 1 (their
# [min, max] ranges meet, no id is shared), and a row all of one segment
SEG_LAYOUTS = {
    "runs": [[2] * 100 + [1] * 100 + [0] * 56, [1] * 70 + [0] * 58 + [1] * 128],
    "interleaved": [[0, 2] * 32 + [1] * 64 + [2] * 128, [0] * 64 + [3] * 64 + [0] * 64 + [3] * 64],
    "one_segment": [[7] * 256, [1] * 200 + [0] * 56],
}


def _inputs(b, h, s, rows, seed, d=64):
    """Normal q, k, v, dO [B, H, S, d] and int32 segment ids: each entry of
    ``rows`` is a valid length (1 for that many tokens, 0 for the pad) or a
    row of S ids."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(4))
    seg = np.zeros((b, s), np.int32)
    for i, r in enumerate(rows):
        if isinstance(r, int):
            seg[i, :r] = 1
        else:
            seg[i] = r
    return q, k, v, dout, seg


def _jax_grads(q, k, v, dout, seg, dtype, scale=SCALE):
    jseg = jnp.asarray(seg)

    def f(q, k, v):
        return jax_flash(q, k, v, segment_ids=SegmentIds(q=jseg, kv=jseg), sm_scale=scale)

    with pltpu.force_tpu_interpret_mode():
        args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
        _, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


# pad queries whose first key block is wholly valid (masked for them), a full
# row, and rows of 65 and 131 tokens; then the segment layouts; all at D = 64
# (sm_scale 0.125).  Then the head dims the wgmma kernels do not take (the
# card's CUDA-core route, whose plain version this is) at sm_scale 1 / sqrt(D):
# 16, 32 and 128 in both dtypes, and 256 in f32
@pytest.mark.parametrize("dtype,s,lengths,d", [
    pytest.param("f32", 256, [70, 200], 64, id="f32-256-lengths0"),
    pytest.param("bf16", 128, [128, 65], 64, id="bf16-128-lengths1"),
    pytest.param("bf16", 256, [131, 2], 64, id="bf16-256-lengths2"),
    pytest.param("f32", 256, SEG_LAYOUTS["runs"], 64, id="f32-256-lengths3"),
    pytest.param("bf16", 256, SEG_LAYOUTS["runs"], 64, id="bf16-256-lengths4"),
    pytest.param("bf16", 256, SEG_LAYOUTS["interleaved"], 64, id="bf16-256-lengths5"),
    pytest.param("bf16", 256, SEG_LAYOUTS["one_segment"], 64, id="bf16-256-lengths6"),
    *(pytest.param(dt, 256, SEG_LAYOUTS["runs"], d, id=f"{dt}-256-runs-D{d}")
      for d in (16, 32, 128) for dt in ("f32", "bf16")),
    pytest.param("f32", 256, [70, 200], 256, id="f32-256-D256"),
])
def test_plain_backward_matches_jax_vjp(dtype, s, lengths, d):
    q, k, v, dout, seg = _inputs(2, 2, s, lengths, seed=s + len(lengths), d=d)
    scale = 1.0 / np.sqrt(d)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = _jax_grads(q, k, v, dout, seg, jdt, scale)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, dout))
    tseg = torch.from_numpy(seg)
    out, lse = flash_attention_fwd(tq, tk, tv, tseg, scale)
    got = flash_attention_bwd_plain(tq, tk, tv, tseg, out, lse, tdo, scale)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == (2, 2, s, d)
        if dtype == "f32":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5)
        else:
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2,
                                       atol=1e-2 * np.abs(w).max())


def test_forward_logsumexp_and_dispatch():
    """The forward's logsumexp is the masked logits' logsumexp, and the CPU
    wrapper of the backward is the plain backward."""
    q, k, v, dout, seg = (torch.from_numpy(a) for a in _inputs(2, 2, 128, [128, 40], seed=3))
    out, lse = flash_attention_fwd(q, k, v, seg, SCALE)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, seg, SCALE))
    logits = torch.matmul(q, k.transpose(-1, -2)) * SCALE
    same = seg[:, None, :, None] == seg[:, None, None, :]
    want = torch.logsumexp(logits.masked_fill(~same, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)
    got = flash_attention_bwd(q, k, v, seg, out, lse, dout, SCALE)
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, SCALE)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_bwd(q, k, v, seg, out, lse[:, :1], dout, SCALE)


@pytest.mark.parametrize("needs,layout", [
    ("qkv", None), ("v", None), ("qkv", "runs"), ("qkv", "interleaved"), ("v", "one_segment"),
], ids=["qkv", "v", "qkv-runs", "qkv-interleaved", "v-one_segment"])
def test_function_grads_match_plain_autograd(needs, layout):
    """flash_attention under autograd (f32 on the CPU: the Function's plain
    forward and backward) against autograd through flash_attention_plain;
    segment ids get no gradient."""
    if layout is None:
        inputs = _inputs(2, 3, 256, [256, 77], seed=4)
    else:
        inputs = _inputs(2, 2, 256, SEG_LAYOUTS[layout], seed=256 + 2)
    q, k, v, dout, seg = (torch.from_numpy(a) for a in inputs)
    leaves = [t.clone().requires_grad_(name in needs) for name, t in zip("qkv", (q, k, v))]
    wrt = [t for t in leaves if t.requires_grad]
    out = flash_attention(*leaves, seg, SCALE)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, wrt, dout)
    want = torch.autograd.grad(flash_attention_plain(*leaves, seg, SCALE), wrt, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5)
    with torch.no_grad():
        assert flash_attention(*leaves, seg, SCALE).grad_fn is None
