"""K2's and K2b's routes on the card and the arithmetic of their f32 kernels.

``forward_route`` and ``backward_route`` choose the forward's kernel and the
backward's pair from dtype, head dim and strides alone; they are held here
on CPU tensors laid out as each class of input is (the encoder's strided
views, a contiguous tensor, a view that starts off a 16-byte boundary, rows
padded to a stride that is not a multiple of 16 bytes), on both sides of
the backward's caps (bf16 D = 128, f32 D = 64).

The f32 kernel (``csrc/flash_attention_tf32.cu``) takes its products on the
tensor cores in 3xTF32: each f32 operand x split into hi = rna_tf32(x) and
lo = rna_tf32(x - hi), each product taken as hi*hi' + hi*lo' + lo*hi' with
f32 sums, for S = Q K^T and for O += P V over 64-key tiles of the online
softmax.  ``_flash_3xtf32`` below emulates that arithmetic in torch on the
CPU (rounding to 10 mantissa bits, to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` does) and is held against JAX's Pallas
``flash_attention`` in interpret mode in f32 within the f32 gates of the
card (output 2e-5, logsumexp 1e-5): the split keeps f32 accuracy.

The f32 backward (``csrc/flash_attention_tf32_bwd.cu``) takes all five of
its products (S, dP, dV, dK, dQ) in 3xTF32 with P and dS kept in f32;
``_bwd_3xtf32`` emulates that and is held against ``jax.vjp`` of the Pallas
``flash_attention`` in interpret mode within the card's f32 gate for
gradients (2e-5 of the largest), which one TF32 product a product misses.
It is held so too on zero-padded copies at TinyBERT-4L-312D's f32 D = 26
(padded to 28), the card's ``"tf32_pad"`` route for f32 rows TMA cannot
read.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, SegmentIds

from mfar_tpu_torch.ops.flash_attention import backward_route, flash_attention_fwd, forward_route

torch.set_num_threads(1)

B, H, S = 2, 2, 256
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
F32_ATOL, LSE_ATOL = 2e-5, 1e-5  # the card's gates for the f32 forward
GRAD_REL = 2e-5  # the card's gate for f32 gradients: of the largest entry


def _layout(dtype, d, layout):
    """Zeros [B, H, S, d] in one of the layouts the route reads."""
    if layout == "encoder":  # [B, S, H*d] projections viewed as [B, H, S, d]
        return torch.zeros(B, S, H * d, dtype=dtype).view(B, S, H, d).transpose(1, 2)
    if layout == "contiguous":
        return torch.zeros(B, H, S, d, dtype=dtype)
    if layout == "offset":  # one element into its buffer: off a 16-byte boundary
        return torch.zeros(B * S * H * d + 1, dtype=dtype)[1:].view(B, S, H, d).transpose(1, 2)
    if layout == "padded_rows":  # rows of H*d + 2 elements: not a multiple of 16 bytes
        buf = torch.zeros(B, S, H * d + 2, dtype=dtype)
        return buf[..., : H * d].view(B, S, H, d).transpose(1, 2)
    raise ValueError(layout)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,layout,want", [
    (BF16, 64, "encoder", "wgmma"),
    (BF16, 64, "contiguous", "wgmma"),
    (BF16, 32, "encoder", "wgmma_headdim"),
    (BF16, 16, "contiguous", "wgmma_headdim"),
    (BF16, 136, "encoder", "wgmma_headdim"),
    (BF16, 256, "encoder", "wgmma_headdim"),
    (BF16, 20, "encoder", "simt"),  # D not a multiple of 8
    (BF16, 26, "contiguous", "simt"),
    (BF16, 64, "offset", "simt"),
    (BF16, 64, "padded_rows", "simt"),
    (F32, 64, "encoder", "tf32"),
    (F32, 20, "encoder", "tf32"),  # a multiple of 4
    (F32, 16, "contiguous", "tf32"),
    (F32, 256, "encoder", "tf32"),
    (F32, 26, "encoder", "simt"),  # not a multiple of 4
    (F32, 64, "offset", "simt"),
    (F32, 64, "padded_rows", "simt"),
], ids=lambda x: str(x).replace("torch.", ""))
def test_forward_route(dtype, d, layout, want):
    t = _layout(dtype, d, layout)
    assert forward_route(t, t, t) == want
    if want != "simt":  # one operand TMA cannot read sends all three to the CUDA cores
        assert forward_route(t, t, _layout(dtype, d, "offset")) == "simt"


@pytest.mark.parametrize("dtype,d,layout,want", [
    (BF16, 64, "encoder", "wgmma"),
    (BF16, 64, "contiguous", "wgmma"),
    (BF16, 16, "contiguous", "wgmma_headdim"),
    (BF16, 32, "encoder", "wgmma_headdim"),
    (BF16, 40, "encoder", "wgmma_headdim"),
    (BF16, 128, "encoder", "wgmma_headdim"),  # the cap: two slabs of 64 columns
    (BF16, 136, "encoder", "simt"),  # past the cap
    (BF16, 256, "encoder", "simt"),
    # what TMA cannot read, bf16 up to D = 128: copied into zero-padded
    # buffers that TMA reads, for the wgmma pair
    (BF16, 20, "encoder", "wgmma_pad"),  # D not a multiple of 8
    (BF16, 26, "contiguous", "wgmma_pad"),
    (BF16, 64, "padded_rows", "wgmma_pad"),  # rows 260 bytes apart
    (BF16, 26, "encoder", "wgmma_pad"),  # TinyBERT-4L-312D's heads
    (BF16, 2, "encoder", "wgmma_pad"),
    (BF16, 126, "encoder", "wgmma_pad"),  # padded to 128: two slabs
    (BF16, 25, "encoder", "wgmma_pad"),  # odd D
    (BF16, 26, "offset", "wgmma_pad"),  # 2 bytes off a 4-byte boundary
    (BF16, 130, "encoder", "simt"),  # past the cap
    (BF16, 64, "offset", "wgmma_pad"),
    (BF16, 32, "offset", "wgmma_pad"),
    (F32, 16, "contiguous", "tf32"),
    (F32, 20, "encoder", "tf32"),  # a multiple of 4
    (F32, 64, "encoder", "tf32"),  # the cap: two slabs of 32 columns
    (F32, 68, "encoder", "simt"),  # past the cap
    (F32, 256, "encoder", "simt"),
    # what TMA cannot read, f32 up to D = 64: copied into zero-padded
    # buffers that TMA reads, for the 3xTF32 pair
    (F32, 26, "encoder", "tf32_pad"),  # not a multiple of 4: TinyBERT-4L-312D's heads
    (F32, 26, "contiguous", "tf32_pad"),
    (F32, 2, "encoder", "tf32_pad"),
    (F32, 62, "encoder", "tf32_pad"),  # padded to 64: two slabs
    (F32, 64, "offset", "tf32_pad"),
    (F32, 64, "padded_rows", "tf32_pad"),
    (F32, 66, "encoder", "simt"),  # past the cap
], ids=lambda x: str(x).replace("torch.", ""))
def test_backward_route(dtype, d, layout, want):
    t = _layout(dtype, d, layout)
    assert backward_route(t, t, t) == want
    if want not in ("simt", "wgmma_pad", "tf32_pad"):
        # one operand TMA cannot read sends all three to the padding copies
        for i in range(3):
            qkv = [t, t, t]
            qkv[i] = _layout(dtype, d, "padded_rows" if i == 1 else "offset")
            assert backward_route(*qkv) == ("wgmma_pad" if dtype == BF16 else "tf32_pad")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x: to 10
    mantissa bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel takes it: hi*hi' + hi*lo' + lo*hi' (each product
    of two tf32 values exact in f32), summed in f32; lo*lo' dropped."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _flash_3xtf32(q, k, v, seg, scale, tile=64):
    """The f32 kernel's arithmetic: the online softmax over 64-key tiles in
    log2 units (exactly 0 off a row's segment, a running max of -inf taken
    as 0), both products in 3xTF32.  Returns the output and the row
    logsumexp (natural log)."""
    scale_log2 = scale * LOG2E
    neg_inf = torch.tensor(float("-inf"))
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for t in range(0, q.shape[2], tile):
        s = _mm_3xtf32(q, k[:, :, t:t + tile].transpose(-1, -2))
        same = seg[:, None, :, None] == seg[:, None, None, t:t + tile]
        s = torch.where(same, s, neg_inf)
        mx = torch.maximum(m, s.amax(-1))
        ms = torch.where(mx == neg_inf, torch.zeros(()), mx * scale_log2)
        alpha = torch.exp2(m * scale_log2 - ms)
        p = torch.exp2(s * scale_log2 - ms[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _mm_3xtf32(p, v[:, :, t:t + tile])
        m = mx
    return o / l[..., None], (m * scale_log2 + torch.log2(l)) * LN2


SEG_LAYOUTS = {  # as tests/test_torch_flash.py's: several segments, returning ids, one id
    "runs": [[2] * 100 + [1] * 100 + [0] * 56, [1] * 70 + [0] * 58 + [1] * 128],
    "interleaved": [[0, 2] * 32 + [1] * 64 + [2] * 128, [0] * 64 + [3] * 64 + [0] * 64 + [3] * 64],
    "one_segment": [[7] * 256, [1] * 200 + [0] * 56],
}


@pytest.mark.parametrize("d,layout", [(16, "runs"), (32, "interleaved"), (64, "one_segment"),
                                      (128, "runs")])
def test_3xtf32_keeps_the_f32_gates_against_pallas(d, layout):
    rng = np.random.default_rng(1000 + d)
    q, k, v = (rng.normal(size=(B, H, S, d)).astype(np.float32) for _ in range(3))
    seg = np.asarray(SEG_LAYOUTS[layout], np.int32)
    scale = 1.0 / np.sqrt(d)
    jseg = jnp.asarray(seg)
    with pltpu.force_tpu_interpret_mode():
        want, l, m = jax_fa._flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), None, SegmentIds(q=jseg, kv=jseg), True,
            False, scale, BlockSizes.get_default(B, H, S, S, d), False)
    want = np.asarray(want)
    want_lse = np.asarray(m) + np.log(np.asarray(l))
    out, lse = _flash_3xtf32(*(torch.from_numpy(a) for a in (q, k, v, seg)), scale)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=LSE_ATOL)
    # the split is what keeps them: one TF32 product a product does not
    tq, tk, tv = (_tf32(torch.from_numpy(a)) for a in (q, k, v))
    one = torch.softmax(torch.where(
        torch.from_numpy(seg[:, None, :, None] == seg[:, None, None, :]),
        tq @ tk.transpose(-1, -2) * scale, torch.tensor(float("-inf"))), -1)
    assert np.abs((_tf32(one) @ tv).numpy() - want).max() > F32_ATOL


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand rounded to tf32 once: one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _bwd_3xtf32(q, k, v, seg, o, lse, dout, scale, mm=_mm_3xtf32):
    """The f32 backward kernels' arithmetic: di = sum_d o * dO in f32; S =
    Q K^T and dP = dO V^T; P = exp2(S * scale log2 e - lse log2 e) on
    same-segment pairs, exactly 0 elsewhere; dS = P (dP - di) * scale, both
    kept in f32; dQ = dS K, dK = dS^T Q, dV = P^T dO; every product through
    ``mm`` (3xTF32 in the kernels)."""
    di = (o * dout).sum(-1)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    s = mm(q, k.transpose(-1, -2))
    p = torch.where(same, torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None]),
                    torch.zeros(()))
    ds = p * (mm(dout, v.transpose(-1, -2)) - di[..., None]) * scale
    return mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), dout)


def _jax_grads(q, k, v, dout, seg, scale):
    """dq, dk, dv of the Pallas flash_attention by jax.vjp, in interpret
    mode, in f32."""
    jseg = jnp.asarray(seg)

    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, segment_ids=SegmentIds(q=jseg, kv=jseg),
                                      sm_scale=scale)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("d,layout", [(16, "runs"), (32, "interleaved"), (64, "one_segment"),
                                      (64, "runs")])
def test_3xtf32_backward_keeps_the_f32_gate_against_pallas(d, layout):
    rng = np.random.default_rng(2000 + d)
    q, k, v, dout = (rng.normal(size=(B, H, S, d)).astype(np.float32) for _ in range(4))
    seg = np.asarray(SEG_LAYOUTS[layout], np.int32)
    scale = 1.0 / np.sqrt(d)
    want = _jax_grads(q, k, v, dout, seg, scale)
    tq, tk, tv, tdo, tseg = (torch.from_numpy(a) for a in (q, k, v, dout, seg))
    o, lse = _flash_3xtf32(tq, tk, tv, tseg, scale)  # the f32 forward's output and lse
    got = _bwd_3xtf32(tq, tk, tv, tseg, o, lse, tdo, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_REL * np.abs(w).max())
    # the split is what keeps them: one TF32 product a product does not
    one = _bwd_3xtf32(tq, tk, tv, tseg, o, lse, tdo, scale, mm=_mm_1xtf32)
    assert max(np.abs(g.numpy() - w).max() / np.abs(w).max() for g, w in zip(one, want)) \
        > GRAD_REL


def test_3xtf32_backward_on_padded_copies_keeps_the_f32_gate_against_pallas():
    """The card's "tf32_pad" route at TinyBERT-4L-312D's D = 26, whose f32
    rows TMA cannot read: q, k, v, o and dO copied into zero-padded
    buffers at D = 28, the 3xTF32 pair's arithmetic on the copies (at the
    scale of D = 26), the gradients' first 26 columns against ``jax.vjp``
    of the Pallas kernel in interpret mode within the f32 gate; the padded
    columns' gradients are exactly 0."""
    d, width = 26, 28
    rng = np.random.default_rng(2026)
    q, k, v, dout = (rng.normal(size=(B, H, S, d)).astype(np.float32) for _ in range(4))
    seg = np.asarray(SEG_LAYOUTS["runs"], np.int32)
    scale = 1.0 / np.sqrt(d)
    want = _jax_grads(q, k, v, dout, seg, scale)
    tq, tk, tv, tdo, tseg = (torch.from_numpy(a) for a in (q, k, v, dout, seg))
    o, lse = flash_attention_fwd(tq, tk, tv, tseg, scale)  # the CUDA-core forward's, in f32
    padded = [torch.nn.functional.pad(t, (0, width - d)) for t in (tq, tk, tv, o, tdo)]
    pq, pk, pv, po, pdo = padded
    got = _bwd_3xtf32(pq, pk, pv, tseg, po, lse, pdo, scale)
    for g, w in zip(got, want):
        assert not g[..., d:].any()
        np.testing.assert_allclose(g[..., :d].numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())
