"""Kernel K2 (the encoder's flash attention): the port's plain version against
JAX's own Pallas ``flash_attention``, run on the CPU in interpret mode, plus
the wrapper's checks.  The CUDA kernel runs only on a card: its tests are in
``tests/test_torch_card.py``.

JAX's encoder reaches the kernel only on a TPU (``encoder.py:147``), so the
library function is called directly, with the encoder's segment ids (1 for
valid tokens, 0 for pad).

Tolerance: f32 atol 1e-5 (the same f32 arithmetic; the Pallas kernel sums
blockwise with an online softmax).  bf16 rtol = atol = 1e-2: both round the
output to bf16 (one ulp is 7.8e-3 for outputs in [1, 2)), and the Pallas
kernel rounds the softmax weights to bf16 for the P.V product where the
plain version stays in f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa
from jax.experimental.pallas.ops.tpu.flash_attention import (
    DEFAULT_MASK_VALUE,
    BlockSizes,
    SegmentIds,
)
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from mfar_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
)

torch.set_num_threads(1)

B, H, D = 3, 2, 64
SCALE = 1.0 / np.sqrt(D)
TOL = {"f32": dict(rtol=0, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(s, lengths, seed=0, d=D):
    """q/k/v [B, H, S, d] and int32 segment ids: 1 for the first
    lengths[i] tokens of row i, 0 for the pad after them."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, s, d)).astype(np.float32) for _ in range(3))
    seg = np.zeros((B, s), np.int32)
    for i, n in enumerate(lengths):
        seg[i, :n] = 1
    return q, k, v, seg


# a fully valid row, a row of 2 valid tokens, ragged rows whose pad queries
# meet whole blocks of valid (for them masked) keys first
@pytest.mark.parametrize("s,lengths", [(128, [128, 2, 77]), (256, [2, 256, 131])])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_interpret(dtype, s, lengths):
    q, k, v, seg = _inputs(s, lengths, seed=s)
    jdt, tdt = DTYPES[dtype]
    jseg = jnp.asarray(seg)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                         segment_ids=SegmentIds(q=jseg, kv=jseg), sm_scale=SCALE)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = flash_attention.launches
    for fn in (flash_attention, flash_attention_plain):
        got = fn(tq, tk, tv, torch.from_numpy(seg), SCALE)
        assert got.shape == (B, H, s, D) and got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    assert flash_attention.launches == before  # CPU tensors: the plain version


# segment layouts at [2, 2, 256, 64] (tests/test_torch_flash_bwd.py and the
# card tests use the same): several segments (ids 2/1/0 in runs), ids that
# return after another segment, tiles of alternating ids 0 and 2 against a
# tile of 1 (their [min, max] ranges meet, no id is shared), a row all of
# one segment; the kernel's tile skipping rests on exactly these
SEG_LAYOUTS = {
    "runs": [[2] * 100 + [1] * 100 + [0] * 56, [1] * 70 + [0] * 58 + [1] * 128],
    "interleaved": [[0, 2] * 32 + [1] * 64 + [2] * 128, [0] * 64 + [3] * 64 + [0] * 64 + [3] * 64],
    "one_segment": [[7] * 256, [1] * 200 + [0] * 56],
}


# D = 64 (Contriever-base) on every layout; then the head dims JAX's kernel
# takes and the port's D = 64 wgmma kernels do not: 16 (EncoderConfig.tiny),
# 32 (the synthetic models, all-MiniLM-L6-v2's width), 128 and 256, in both
# dtypes (the card's CUDA-core route, whose plain version this is)
@pytest.mark.parametrize("dtype,layout,d", [
    pytest.param("f32", "runs", 64, id="f32-runs"),
    pytest.param("bf16", "runs", 64, id="bf16-runs"),
    pytest.param("bf16", "interleaved", 64, id="bf16-interleaved"),
    pytest.param("bf16", "one_segment", 64, id="bf16-one_segment"),
    *(pytest.param(dt, "runs", d, id=f"{dt}-runs-D{d}")
      for d in (16, 32, 128) for dt in ("f32", "bf16")),
    pytest.param("bf16", "interleaved", 32, id="bf16-interleaved-D32"),
    pytest.param("f32", "runs", 256, id="f32-runs-D256"),
])
def test_plain_forward_matches_pallas_on_segment_layouts(dtype, layout, d):
    """Output and row logsumexp of the forward that training runs against
    JAX's Pallas kernel with its residuals (l and m, lse = m + log l), in
    interpret mode, at sm_scale 1 / sqrt(D).  The logsumexp is f32 in both
    (atol 1e-5; for bf16 the logits are products of the same bf16 values
    summed in f32)."""
    rng = np.random.default_rng(256 + len(layout))
    q, k, v = (rng.normal(size=(2, 2, 256, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    seg = np.asarray(SEG_LAYOUTS[layout], np.int32)
    jdt, tdt = DTYPES[dtype]
    jseg = jnp.asarray(seg)
    with pltpu.force_tpu_interpret_mode():
        want, l, m = jax_fa._flash_attention(
            *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), None,
            SegmentIds(q=jseg, kv=jseg), True, False, scale,
            BlockSizes.get_default(2, 2, 256, 256, d), False)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(m) + np.log(np.asarray(l))  # [B, H, S] each
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out, lse = flash_attention_fwd(tq, tk, tv, torch.from_numpy(seg), scale)
    assert out.dtype == tdt and lse.shape == (2, 2, 256) and lse.dtype == torch.float32
    assert out.shape == (2, 2, 256, d)
    np.testing.assert_allclose(out.float().numpy(), want, **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    got = flash_attention(tq, tk, tv, torch.from_numpy(seg), scale)
    torch.testing.assert_close(got, out, rtol=0, atol=0)


def test_pad_rows_attend_only_pad_keys():
    """Under segment ids a pad query averages the pad keys' values only,
    and a valid query the valid ones."""
    q, k, v, seg = _inputs(128, [128, 2, 77])
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)), SCALE).numpy()
    for pos, keys in ((100, slice(77, 128)), (3, slice(0, 77))):
        logits = np.einsum("hd,hkd->hk", q[2, :, pos], k[2, :, keys]) * SCALE
        w = np.exp(logits - logits.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        want = np.einsum("hk,hkd->hd", w, v[2, :, keys])
        np.testing.assert_allclose(got[2, :, pos], want, rtol=0, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    assert MASK_VALUE == DEFAULT_MASK_VALUE
    q, k, v, seg = (torch.from_numpy(a) for a in _inputs(256, [256, 2, 77]))
    for s in (64, 192):  # below 128, not a multiple of 128
        with pytest.raises(ValueError, match="multiple of 128"):
            flash_attention(q[:, :, :s], k[:, :, :s], v[:, :, :s], seg[:, :s], SCALE)
    # D = 32 (a head dim the wgmma kernels do not take) runs: the CUDA-core
    # kernels take it on the card, the plain version here
    got = flash_attention(q[..., :32], k[..., :32], v[..., :32], seg, SCALE)
    torch.testing.assert_close(got, flash_attention_plain(q[..., :32], k[..., :32],
                                                          v[..., :32], seg, SCALE))
    wide = torch.zeros(*q.shape[:3], 257)  # past every kernel's 256
    with pytest.raises(ValueError, match="D=257"):
        flash_attention(wide, wide, wide, seg, SCALE)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(q, k[:, :1], v, seg, SCALE)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention(q, k, v, seg[:2], SCALE)
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, k, v, seg.long(), SCALE)
    with pytest.raises(TypeError, match="dtypes differ"):
        flash_attention(q, k.bfloat16(), v, seg, SCALE)
    # off the CPU the kernel runs or the call raises: no plain fallback
    meta = [t.to("meta") for t in (q, k, v, seg)]
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(*meta, SCALE)
