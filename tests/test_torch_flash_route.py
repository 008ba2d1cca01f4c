"""K2's and K2b's routes on the card and the arithmetic of their f32 kernels.

``forward_route`` and ``backward_route`` choose the forward's kernel and the
backward's pair from dtype, head dim and strides alone; they are held here
on CPU tensors laid out as each class of input is (the encoder's strided
views at 2, 8 and 1 heads, a contiguous tensor, a view that starts off a
16-byte boundary, rows padded to a stride that is not a multiple of 16
bytes, a D stride other than 1), at every head dim from 1 to 256: each
input takes a tensor-core route, on the copies that ``pad_heads``
zero-pads to D rounded up to 8 (bf16) or 4 (f32) where TMA cannot read
it.

The forward's rows routes (``"wgmma_rows"``, ``"tf32_rows"``) read the
encoder's ``[B, S, H*D]`` rows in place where no per-head tensor map can
(TinyBERT-4L-312D's D = 26): head h's boxes of 64 bf16 or 32 f32 columns
start at column h*D rounded down to a 16-byte boundary, hold the
neighbours' columns (zeros past H*D), and the head's Q and K columns are
moved to the start, Q's past D set to 0.  ``_box_attention`` below reads
what the kernels read and is held against JAX's Pallas
``flash_attention`` in interpret mode.

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
read, and past D = 64 in the wide pair's order: the streamed rows summed
in steps of 16 rows, every product in k steps of 8 as the tensor cores sum
them, past D = 128 S and dP summed over two halves of the head dim.  The
forward's
padding routes (``"wgmma_pad"``, ``"tf32_pad"``) are held so on copies of
a contiguous ``[B, H, S, 26]``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, SegmentIds

from mfar_tpu_torch.ops.flash_attention import (
    backward_route,
    flash_attention_fwd,
    forward_route,
    pad_heads,
)

torch.set_num_threads(1)

B, H, S = 2, 2, 256
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
F32_ATOL, LSE_ATOL = 2e-5, 1e-5  # the card's gates for the f32 forward
GRAD_REL = 2e-5  # the card's gate for f32 gradients: of the largest entry


def _layout(dtype, d, layout):
    """Zeros [B, H, S, d] in one of the layouts the route reads."""
    if layout.startswith("encoder"):  # [B, S, H*d] projections viewed as [B, H, S, d]
        h = int(layout[len("encoder_h"):]) if layout != "encoder" else H  # "encoder_h8": 8 heads
        return torch.zeros(B, S, h * d, dtype=dtype).view(B, S, h, d).transpose(1, 2)
    if layout == "contiguous":
        return torch.zeros(B, H, S, d, dtype=dtype)
    if layout == "offset":  # one element into its buffer: off a 16-byte boundary
        return torch.zeros(B * S * H * d + 1, dtype=dtype)[1:].view(B, S, H, d).transpose(1, 2)
    if layout == "padded_rows":  # rows of H*d + 2 elements: not a multiple of 16 bytes
        buf = torch.zeros(B, S, H * d + 2, dtype=dtype)
        return buf[..., : H * d].view(B, S, H, d).transpose(1, 2)
    if layout == "d_strided":  # [B, H, d, S] viewed as [B, H, S, d]: the D stride S
        return torch.zeros(B, H, d, S, dtype=dtype).transpose(-1, -2)
    raise ValueError(layout)


BF16, F32 = torch.bfloat16, torch.float32
PAD = {BF16: "wgmma_pad", F32: "tf32_pad"}  # each dtype's padding route
# the routes whose kernels read their operands through tensor maps, and
# the padding routes, which copy them into buffers those kernels read
TMA_ROUTES = {BF16: ("wgmma", "wgmma_headdim"), F32: ("tf32",)}
ROWS_ROUTES = {BF16: "wgmma_rows", F32: "tf32_rows"}


@pytest.mark.parametrize("dtype,d,layout,want", [
    (BF16, 64, "encoder", "wgmma"),
    (BF16, 64, "contiguous", "wgmma"),
    (BF16, 32, "encoder", "wgmma_headdim"),
    (BF16, 16, "contiguous", "wgmma_headdim"),
    (BF16, 136, "encoder", "wgmma_headdim"),
    (BF16, 256, "encoder", "wgmma_headdim"),
    # D not a multiple of 8: the heads' rows (H*D*2 bytes: 80 at two heads
    # of 20) read in place through row maps
    (BF16, 20, "encoder", "wgmma_rows"),
    (BF16, 2, "encoder_h8", "wgmma_rows"),
    (BF16, 20, "encoder_h8", "wgmma_rows"),
    (BF16, 25, "encoder_h8", "wgmma_rows"),  # odd D
    (BF16, 26, "encoder_h8", "wgmma_rows"),  # TinyBERT-4L-312D's heads
    (BF16, 126, "encoder_h8", "wgmma_rows"),  # three slabs: up to 7 columns into a box
    (BF16, 249, "encoder_h8", "wgmma_rows"),  # four slabs
    (BF16, 250, "encoder_h8", "wgmma_pad"),  # past four slabs
    (BF16, 26, "encoder_h1", "wgmma_pad"),  # rows of 52 bytes: no map reads them
    (BF16, 26, "contiguous", "wgmma_pad"),  # the heads not side by side
    (BF16, 26, "offset", "wgmma_pad"),
    (BF16, 64, "offset", "wgmma_pad"),
    (BF16, 64, "padded_rows", "wgmma_pad"),
    (F32, 64, "encoder", "tf32"),
    (F32, 20, "encoder", "tf32"),  # a multiple of 4
    (F32, 16, "contiguous", "tf32"),
    (F32, 256, "encoder", "tf32"),
    (F32, 26, "encoder", "tf32_rows"),  # not a multiple of 4: rows of 208 bytes
    (F32, 2, "encoder_h8", "tf32_rows"),
    (F32, 26, "encoder_h8", "tf32_rows"),
    (F32, 62, "encoder_h8", "tf32_rows"),  # up to three slabs
    (F32, 253, "encoder_h8", "tf32_rows"),  # eight slabs
    (F32, 254, "encoder_h8", "tf32_pad"),  # past eight slabs
    (F32, 26, "contiguous", "tf32_pad"),
    (F32, 26, "offset", "tf32_pad"),
    (F32, 64, "offset", "tf32_pad"),
    (F32, 64, "padded_rows", "tf32_pad"),
], ids=lambda x: str(x).replace("torch.", ""))
def test_forward_route(dtype, d, layout, want):
    t = _layout(dtype, d, layout)
    assert forward_route(t, t, t) == want
    if want != PAD[dtype]:  # one operand TMA cannot read sends all three to the copies
        assert forward_route(t, t, _layout(dtype, d, "offset")) == PAD[dtype]
    if want.endswith("_rows"):  # so does one whose heads are not side by side
        assert forward_route(_layout(dtype, d, "contiguous"), t, t) == PAD[dtype]


@pytest.mark.parametrize("dtype,d,layout,want", [
    (BF16, 64, "encoder", "wgmma"),
    (BF16, 64, "contiguous", "wgmma"),
    (BF16, 16, "contiguous", "wgmma_headdim"),
    (BF16, 32, "encoder", "wgmma_headdim"),
    (BF16, 40, "encoder", "wgmma_headdim"),
    (BF16, 128, "encoder", "wgmma_headdim"),  # two slabs of 64 columns, two warpgroups
    (BF16, 136, "encoder", "wgmma_headdim"),  # three slabs, one warpgroup, dkv split
    (BF16, 256, "encoder", "wgmma_headdim"),
    # what TMA cannot read: copied into zero-padded buffers that TMA reads,
    # for the wgmma pair
    (BF16, 20, "encoder", "wgmma_pad"),  # D not a multiple of 8
    (BF16, 26, "contiguous", "wgmma_pad"),
    (BF16, 64, "padded_rows", "wgmma_pad"),  # rows 260 bytes apart
    (BF16, 26, "encoder", "wgmma_pad"),  # TinyBERT-4L-312D's heads
    (BF16, 2, "encoder", "wgmma_pad"),
    (BF16, 126, "encoder", "wgmma_pad"),  # padded to 128: two slabs
    (BF16, 25, "encoder", "wgmma_pad"),  # odd D
    (BF16, 26, "offset", "wgmma_pad"),  # 2 bytes off a 4-byte boundary
    (BF16, 130, "encoder", "wgmma_pad"),  # padded to 136: three slabs
    (BF16, 64, "offset", "wgmma_pad"),
    (BF16, 32, "offset", "wgmma_pad"),
    (F32, 16, "contiguous", "tf32"),
    (F32, 20, "encoder", "tf32"),  # a multiple of 4
    (F32, 64, "encoder", "tf32"),  # two slabs of 32 columns, two warpgroups
    (F32, 68, "encoder", "tf32"),  # three slabs: one warpgroup, 32-row half tiles
    (F32, 256, "encoder", "tf32"),
    # what TMA cannot read: copied into zero-padded buffers that TMA reads,
    # for the 3xTF32 pair
    (F32, 26, "encoder", "tf32_pad"),  # not a multiple of 4: TinyBERT-4L-312D's heads
    (F32, 26, "contiguous", "tf32_pad"),
    (F32, 2, "encoder", "tf32_pad"),
    (F32, 62, "encoder", "tf32_pad"),  # padded to 64: two slabs
    (F32, 64, "offset", "tf32_pad"),
    (F32, 64, "padded_rows", "tf32_pad"),
    (F32, 66, "encoder", "tf32_pad"),  # padded to 68: three slabs
], ids=lambda x: str(x).replace("torch.", ""))
def test_backward_route(dtype, d, layout, want):
    t = _layout(dtype, d, layout)
    assert backward_route(t, t, t) == want
    if want != PAD[dtype]:
        # one operand TMA cannot read sends all three to the padding copies
        for i in range(3):
            qkv = [t, t, t]
            qkv[i] = _layout(dtype, d, "padded_rows" if i == 1 else "offset")
            assert backward_route(*qkv) == PAD[dtype]


@pytest.mark.parametrize("layout", ["encoder", "encoder_h8", "encoder_h1", "contiguous", "offset",
                                    "padded_rows", "d_strided"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_every_head_dim_takes_a_tensor_core_route(dtype, layout):
    """At every D from 1 to 256 both routes name a tensor-core kernel: one
    that reads the operands through tensor maps, the forward's rows routes,
    or a padding route whose copies (``pad_heads``) such a kernel reads;
    the backward's rule is the forward's without the rows routes."""
    for d in range(1, 257):
        t = _layout(dtype, d, layout)
        fwd, bwd = forward_route(t, t, t), backward_route(t, t, t)
        assert bwd in (*TMA_ROUTES[dtype], PAD[dtype]), (d, bwd)
        assert fwd == bwd or (bwd == PAD[dtype] and fwd == ROWS_ROUTES[dtype]), (d, fwd, bwd)
        if bwd == PAD[dtype]:
            width = -(-d // (8 if dtype == BF16 else 4)) * (8 if dtype == BF16 else 4)
            p = pad_heads(t, width)
            assert forward_route(p, p, p) in TMA_ROUTES[dtype], (d, forward_route(p, p, p))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x: to 10
    mantissa bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, step=None) -> torch.Tensor:
    """a @ b as the kernel takes it: hi*hi' + hi*lo' + lo*hi' (each product
    of two tf32 values exact in f32), summed in f32; lo*lo' dropped.  With
    ``step``, as the tensor cores sum it: k steps of ``step`` in order, each
    adding lo*hi', then hi*lo', then hi*hi' to the f32 sum."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    if step is None:
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k in range(0, a.shape[-1], step):
        ks = slice(k, k + step)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            out = out + x[..., ks] @ y[..., ks, :]
    return out


def _mm_3xtf32_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The backward kernels' products: k steps of 8 (mma.sync's and wgmma's
    TF32 k)."""
    return _mm_3xtf32(a, b, step=8)


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


def _walk_rows(d: int) -> int:
    """The streamed rows a step of the f32 backward kernels at head dim d:
    64-row tiles up to D = 64, the wide pair's 16-row steps past it."""
    return 64 if d <= 64 else 16


def _bwd_3xtf32(q, k, v, seg, o, lse, dout, scale, mm=_mm_3xtf32_steps, tile=64):
    """The f32 backward kernels' arithmetic: di = sum_d o * dO in f32; S =
    Q K^T and dP = dO V^T; P = exp2(S * scale log2 e - lse log2 e) on
    same-segment pairs, exactly 0 elsewhere; dS = P (dP - di) * scale, both
    kept in f32; dQ = dS K, dK = dS^T Q, dV = P^T dO, each summed in f32
    over the streamed rows ``tile`` at a time (``_walk_rows``); every
    product through ``mm`` (3xTF32 in k steps of 8 in the kernels, every
    operand split once with hi rounded to nearest, as ``_tf32``).  The wide
    pair takes the gradients transposed (dQ^T = K^T dS^T, ...: the same
    products and sums) and, past D = 128, S and dP as the sum of the two
    blocks of a cluster, the first over ceil(D / 2) columns rounded up to
    8, the second over the rest."""
    di = (o * dout).sum(-1)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    d = q.shape[-1]
    half = ((d + 1) // 2 + 7) // 8 * 8 if d > 128 else d

    def heads(a, b):  # a b^T over the head dim, in the cluster's two halves
        out = mm(a[..., :half], b[..., :half].transpose(-1, -2))
        if half < d:
            out = out + mm(a[..., half:], b[..., half:].transpose(-1, -2))
        return out

    s = heads(q, k)
    p = torch.where(same, torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None]),
                    torch.zeros(()))
    ds = p * (heads(dout, v) - di[..., None]) * scale
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for t in range(0, q.shape[2], tile):
        rows = slice(t, t + tile)
        dq += mm(ds[..., rows], k[:, :, rows])  # key tiles
        dk += mm(ds[:, :, rows].transpose(-1, -2), q[:, :, rows])  # query tiles
        dv += mm(p[:, :, rows].transpose(-1, -2), dout[:, :, rows])
    return dq, dk, dv


def _pallas_takes(d: int) -> bool:
    """Whether JAX's Pallas kernel takes head dim d: up to 128, past it only
    multiples of 128 (it raises NotImplementedError at D = 192)."""
    return d <= 128 or d % 128 == 0


def _jax_grads(q, k, v, dout, seg, scale):
    """dq, dk, dv of the Pallas flash_attention by jax.vjp, in interpret
    mode, in f32; at a head dim the Pallas kernel refuses, of the same
    module's plain attention (mha_reference_no_custom_vjp: the same mask
    value, differentiated by JAX; mha_reference's own VJP takes no
    sm_scale)."""
    jseg = jnp.asarray(seg)
    ids = SegmentIds(q=jseg, kv=jseg)

    def f(q, k, v):
        if not _pallas_takes(q.shape[-1]):
            return jax_fa.mha_reference_no_custom_vjp(q, k, v, segment_ids=ids, sm_scale=scale)
        return jax_fa.flash_attention(q, k, v, segment_ids=ids, sm_scale=scale)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("d,layout", [(16, "runs"), (32, "interleaved"), (64, "one_segment"),
                                      (64, "runs"), (80, "interleaved"), (96, "runs"),
                                      (128, "interleaved"), (192, "runs"), (256, "one_segment")])
def test_3xtf32_backward_keeps_the_f32_gate_against_pallas(d, layout):
    rng = np.random.default_rng(2000 + d)
    q, k, v, dout = (rng.normal(size=(B, H, S, d)).astype(np.float32) for _ in range(4))
    seg = np.asarray(SEG_LAYOUTS[layout], np.int32)
    scale = 1.0 / np.sqrt(d)
    if not _pallas_takes(d):  # the port's kernels take D = 192; JAX's Pallas kernel does not
        with pytest.raises(NotImplementedError, match="head_dim"), \
                pltpu.force_tpu_interpret_mode():
            jax_fa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), sm_scale=scale)
    want = _jax_grads(q, k, v, dout, seg, scale)
    tq, tk, tv, tdo, tseg = (torch.from_numpy(a) for a in (q, k, v, dout, seg))
    o, lse = _flash_3xtf32(tq, tk, tv, tseg, scale)  # the f32 forward's output and lse
    got = _bwd_3xtf32(tq, tk, tv, tseg, o, lse, tdo, scale, tile=_walk_rows(d))
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
    o, lse = flash_attention_fwd(tq, tk, tv, tseg, scale)  # the plain forward's, in f32
    padded = [torch.nn.functional.pad(t, (0, width - d)) for t in (tq, tk, tv, o, tdo)]
    pq, pk, pv, po, pdo = padded
    got = _bwd_3xtf32(pq, pk, pv, tseg, po, lse, pdo, scale)
    for g, w in zip(got, want):
        assert not g[..., d:].any()
        np.testing.assert_allclose(g[..., :d].numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())


def _box_attention(q, k, v, seg, scale, attend):
    """Attention as the rows routes read it, on [B, H, S, D] q, k, v viewed
    from [B, S, H*D] rows: head h's boxes start at column h*D rounded down
    to 8 (bf16) or 4 (f32) columns, TMA's 16-byte boundary, the head's
    columns ``off`` = h*D % 8 (or 4) into them; ceil((D + 7) / 64) slabs of
    64 columns (f32: ceil((D + 3) / 32) of 32), zeros past H*D.  Q's and K's
    columns moved ``off`` to the left (zeros in at the end), Q's past D set
    to 0; K's past D (the next head's) left live in bf16, set to 0 in f32;
    V where it landed.  ``attend`` over the boxes; O's columns
    off..off+D-1 and the logsumexp."""
    b, h, s, d = q.shape
    align, slab = (8, 64) if q.dtype == torch.bfloat16 else (4, 32)
    width = -(-(d + align - 1) // slab) * slab

    def rows(t):
        return torch.nn.functional.pad(t.transpose(1, 2).reshape(b, s, h * d), (0, width))

    outs, lses, live = [], [], False
    for i in range(h):
        off = i * d % align
        start = i * d - off
        bq, bk, bv = (rows(t)[:, None, :, start:start + width] for t in (q, k, v))
        bq, bk = (torch.nn.functional.pad(t[..., off:], (0, off)) for t in (bq, bk))
        live |= bool(bk[..., d:].any())
        bq[..., d:] = 0
        if q.dtype == torch.float32:
            bk[..., d:] = 0
        out, lse = attend(bq, bk, bv, seg, scale)
        outs.append(out[:, 0, :, off:off + d])
        lses.append(lse[:, 0])
    assert live  # the next head's columns of K, in the boxes
    return torch.stack(outs, 1), torch.stack(lses, 1)


@pytest.mark.parametrize("dtype,heads", [(BF16, 4), (F32, 2)], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["runs", "interleaved"])
def test_rows_boxes_keep_the_gates_against_pallas(dtype, heads, layout):
    """The rows routes' arithmetic at TinyBERT-4L-312D's D = 26: the boxes
    of ``_box_attention`` (bf16 through the plain forward in f32, as the
    wgmma kernel's S is exact; f32 through the 3xTF32 kernel's arithmetic)
    against JAX's Pallas ``flash_attention`` in interpret mode on the same
    heads: f32 output 2e-5 and logsumexp 1e-5; bf16 within K2's gates
    (rtol = atol = 1e-2, the logsumexp 1e-3)."""
    d = 26
    rng = np.random.default_rng(2600 + heads)
    qkv = [torch.from_numpy(rng.normal(size=(B, S, heads * d)).astype(np.float32)).to(dtype)
           .view(B, S, heads, d).transpose(1, 2) for _ in range(3)]
    assert forward_route(*qkv) == ("wgmma_rows" if dtype == BF16 else "tf32_rows")
    seg = np.asarray(SEG_LAYOUTS[layout], np.int32)
    scale = 1.0 / np.sqrt(d)
    jseg = jnp.asarray(seg)
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want, l, m = jax_fa._flash_attention(
            *(jnp.asarray(t.float().contiguous().numpy()).astype(jdtype) for t in qkv), None,
            SegmentIds(q=jseg, kv=jseg), True, False, scale,
            BlockSizes.get_default(B, heads, S, S, d), False)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(m) + np.log(np.asarray(l))
    if dtype == BF16:
        out, lse = _box_attention(*qkv, torch.from_numpy(seg), scale, flash_attention_fwd)
        np.testing.assert_allclose(out.float().numpy(), want, rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-3)
    else:
        out, lse = _box_attention(*qkv, torch.from_numpy(seg), scale, _flash_3xtf32)
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_padded_forward_keeps_the_gates_against_pallas(dtype):
    """The forward's padding routes at a contiguous ``[B, H, S, 26]``, whose
    52- and 104-byte rows no tensor map reads: q, k and v copied by
    ``pad_heads`` into zero-padded buffers at D = 32 (bf16) or 28 (f32), the
    route's kernel arithmetic on the copies at the scale of D = 26 (bf16
    through the plain forward in f32, as the wgmma kernel's S is exact; f32
    through the 3xTF32 kernel's), the output's first 26 columns and the
    logsumexp against JAX's Pallas ``flash_attention`` in interpret mode on
    the unpadded heads: f32 output 2e-5 and logsumexp 1e-5; bf16 within K2's
    gates (rtol = atol = 1e-2, the logsumexp 1e-3)."""
    d, width = 26, 32 if dtype == BF16 else 28
    rng = np.random.default_rng(2627)
    qkv = [torch.from_numpy(rng.normal(size=(B, H, S, d)).astype(np.float32)).to(dtype)
           for _ in range(3)]
    assert forward_route(*qkv) == PAD[dtype]
    padded = [pad_heads(t, width) for t in qkv]
    assert forward_route(*padded) in TMA_ROUTES[dtype]
    assert all(not t[..., d:].any() and torch.equal(t[..., :d], u) for t, u in zip(padded, qkv))
    seg = np.asarray(SEG_LAYOUTS["interleaved"], np.int32)
    scale = 1.0 / np.sqrt(d)
    jseg = jnp.asarray(seg)
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want, l, m = jax_fa._flash_attention(
            *(jnp.asarray(t.float().numpy()).astype(jdtype) for t in qkv), None,
            SegmentIds(q=jseg, kv=jseg), True, False, scale,
            BlockSizes.get_default(B, H, S, S, d), False)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(m) + np.log(np.asarray(l))
    attend = flash_attention_fwd if dtype == BF16 else _flash_3xtf32
    out, lse = attend(*padded, torch.from_numpy(seg), scale)
    out = out[..., :d].float().numpy()
    if dtype == BF16:
        np.testing.assert_allclose(out, want, rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(out, want, rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=LSE_ATOL)
