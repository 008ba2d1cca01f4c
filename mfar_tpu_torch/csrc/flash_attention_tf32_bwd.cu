// Kernel K2b in f32: the backward of K2's f32 forward (flash_attention_tf32.cu)
// on Hopper's tensor cores (sm_90a) in 3xTF32.  Two kernels, launched in
// this order:
//
//   dq:  di = sum_d O * dO (f32), written out,   dQ = dS K
//   dkv: dV = P^T dO,  dK = dS^T Q               (reads dq's di)
//
// with  P  = exp(Q K^T * sm_scale - lse)  on same-segment pairs, 0 elsewhere,
//       dS = P * (dO V^T - di) * sm_scale,
// lse the forward's row logsumexp (natural units).  q/k/v/o/dO are f32
// [B, H, S, D], D a multiple of 4 up to 256, read through their strides (D
// contiguous; the others multiples of 16 bytes), seg is int32 [B, S], lse
// and di contiguous f32 [B, H, S], S a multiple of 128; the gradients are
// f32 into [B, H, S, D] views with their own strides (multiples of 4
// elements, 16-byte aligned).  f32 that TMA cannot read reaches these
// kernels as zero-padded copies at D rounded up to 4 (the "tf32_pad" route
// of ops/flash_attention.py).
//
// Replaces the two Pallas kernels of the VJP of JAX's library
// flash_attention at f32 (jax/experimental/pallas/ops/tpu/flash_attention.py,
// jax 0.9.0): _flash_attention_bwd_dkv (pl.pallas_call at :1121) and
// _flash_attention_bwd_dq (:1456), reached when mfar_tpu/models/encoder.py:170
// is differentiated in an f32 model (EncoderConfig.tiny, the synthetic
// models, --precision 32); and the row dots di that JAX computes outside
// Pallas (:273-275).  As in the bf16 pair (flash_attention_bwd.cu) each
// block loops over the other axis itself and keeps its sums in registers:
// no block writes what another writes, no atomics, and the gradients are
// the same from run to run.
//
// f32 accuracy (tf32_common.cuh): every product (S or S^T, dP or dP^T, then
// dV += P^T dO, dK += dS^T Q, dQ += dS K) is on TF32 operands, three of
// them a product (hi*hi' + hi*lo' + lo*hi', f32 sums, in k steps of 8: lo
// hi', hi lo', hi hi'), hi rounded to nearest: mma.sync.m16n8k8 up to D =
// 64, wgmma past it.  P and dS stay in f32 and are split like any operand:
// the bf16 kernels round them to bf16, which would miss the f32 gates
// (gradients within 2e-5 of the largest).  exp2f, not ex2.approx alone.
//
// What bounds it: operations.  At the f32 train step's [96, 12, 512, 64]
// dq's three and dkv's four products over chip_smoke's same-segment pairs
// take 0.48 / 0.64 ms at 495 TFLOP/s / 3 against ~0.18 ms of bytes each
// (at D = 128, 0.96 / 1.28 ms against 0.54; at D = 256, 1.92 / 2.56).
// Up to D = 64 the tensor cores are not what limits it: each warp splits
// every streamed value it reads (five integer and float operations a
// value), eight warps the same tile, so it is bound by its instruction
// issue.
//
// Design (hopper_pipeline.cuh's ring and live-tile list; the loads issued
// by the consumers, as in the f32 forward), up to D = 64 (NS <= 2; the
// wide shape past it below):
//   block = two warpgroups of 64 rows (128 keys in dkv, 128 queries in dq;
//        S % 128 == 0), 16 rows a warp, one block an SM.  The grid is
//        (b, h)-major, so the blocks of one head run together and find its
//        streamed tiles in L2.
//   loads: TMA boxes of 64 rows by 32 f32 (128 bytes), swizzled by 128
//        bytes: NS = ceil(D / 32) slabs a tile, columns past D read as 0
//        (computed like the rest).  Each warpgroup's own slabs arrive once
//        (dkv: K, V; dq: Q, dO, O); 64-row tiles of the other side (dkv: Q,
//        dO with their lse, di and segment ids; dq: K, V with their segment
//        ids) stream through the mbarrier ring (3 stages at NS = 1, 2 at
//        NS = 2), each stage reloaded by the warpgroup last done with it.
//   own operands split once: after dq's di, each warp reads the A fragments
//        of its two own operands (K and V, or Q and dO) for every k step,
//        splits them and writes hi and lo back in fragment order over its
//        own 16-row bands of the warpgroup's 4 NS own slabs (the raw slabs
//        are its bands too, so only __syncwarp orders it).  Per streamed
//        tile a k step then costs two 16-byte loads of the A fragments and
//        no split (at NS = 2, 64 of the 480 splits a thread makes in a dq
//        tile).  Holding them in registers would take 128 at NS = 2.
//   products, per streamed tile and warp:
//        S = Q K^T and dP = dO V^T (dkv: S^T = K Q^T, dP^T = V dO^T) over
//        4 NS k steps of the head dim, 8 n-tiles of 8 rows: each k step
//        takes columns 4kl..+3 and 16+4kl..+3 of a slab (kcol), so a
//        thread's two entries of a row are one 8-byte load and a half-warp
//        reads 8 distinct 16-byte chunks.
//        dQ += dS K (dkv: dV += P^T dO, dK += dS^T Q) over 8 k steps of the
//        tile's rows: a thread's C entries of rows 2t4 and 2t4 + 1 of step
//        j serve as its A entries of k = t4 and t4 + 4 when B is read at
//        those rows (the forward's trick), so P and dS go from the
//        accumulator to the A registers with no shuffle; B's n index g
//        takes columns 16E + 2g and + 1 of two n-tiles in one 8-byte load,
//        and a thread's four columns of a row come out neighbours (one
//        16-byte store).
//   skipping: streamed tiles whose segment-id [min, max] misses the block's
//        rows are never loaded, and a warpgroup skips the products of a
//        loaded tile that misses its own 64 rows (exact for any int32 ids).
//
// Wide head dims (D 68-256; Tf32WideShape): the same work on wgmma, every
// operand split once.  Two instances: NS = 4 (D 68-128), one block a row
// tile; NS = 8 (D 132-256), a cluster of two blocks a row tile, each taking
// half the head dim's columns (ceil(D / 2) rounded up to 8 and the rest: 96
// each at D = 192), which is the NS = 4 block plus an exchange.
//   block = two warpgroups over one 64-row own tile (keys in dkv, queries in
//        dq), 256 threads, one block an SM.
//   own operands (dq: Q, dO; dkv: K, V): the block's up to 128 columns land
//        by TMA (64-row boxes; columns past D as 0) and are split once, in
//        place: hi over the slab TMA wrote, lo beside it (4 slabs x 2
//        operands x 2 = 128 KB), each group of 8 columns with its even
//        columns at k 0-3 and its odd ones at 4-7.
//   S^T, dP^T (dq) or S, dP (dkv): wgmma.m64n64k8, M = the streamed tile's
//        64 rows, N = the own 64 rows (B: the split own slabs, K-major), k
//        = the head dim up to D only.  A comes from global memory (L2, then
//        L1), no ring: a thread loads its rows' columns 2t4, 2t4 + 1 of a k
//        step (one 8-byte load) four k steps ahead and splits them at use;
//        each value is split once a product, by the one thread whose
//        fragment holds it.  Each k step is a commit group; the next one's
//        A is split while it runs.
//   P, dS: in f32 in registers, split once into a [64 own rows][64
//        streamed rows] operand tile (hi | lo, K-major: 32 KB), transposed
//        on the way (the own rows become its rows).
//   dQ, dV, dK: taken transposed, dQ^T += K^T dS^T, dV^T += dO^T P, dK^T +=
//        Q^T dS: wgmma.m64n64k8, M = 64 of the block's head-dim columns (one
//        or two tiles: up to D rounded up to 64, wgmma's M), N = the own 64
//        rows (B: the operand tile), k = the streamed rows; A = the streamed
//        tile's columns, loaded from global memory two k steps ahead and
//        split at use.  TF32 wgmma takes no transpose, and this way no
//        streamed operand needs a transposed copy in shared memory.  The
//        accumulators (32 registers a thread a 64-column tile) are stored
//        transposed, columns before D.
//   dkv: the two warpgroups share each live query tile: warpgroup 0 takes S,
//        P and dV^T, warpgroup 1 dP, dS and dK^T, P handed over in f32
//        through shared memory (16 KB; two named barriers, arrive / sync).
//        S is computed once for dV and dK at every D.
//   dq: the warpgroups take the live key tiles in turns, each summing dQ^T
//        over its own (S^T, dP^T, dS and the product), and add the two
//        sums in a fixed order at the end (sum_groups): the gradients are
//        the same from run to run.  Splitting dq's work as dkv's (P^T
//        handed over, each warpgroup 64 columns of dQ^T) ran 1.18-1.34x
//        slower: the two handoffs chain the warpgroups.
//   NS = 8: each block of the cluster sums S and dP over its columns; a
//        warpgroup then writes its partial sums into the other block's
//        exchange tile (st.shared::cluster, once that block has freed it),
//        arrives on that block's barrier and adds what the other block
//        wrote into its own (f32 addition commutes: both get the same
//        bits); each block then runs P, dS and the gradients' products for
//        its own columns.  Two barriers a warpgroup a block (full: 128
//        arrivals; free: one) pace the exchange.
//   Budget: shared memory 192 KB (dq) and 208 KB (dkv) of 227: the own
//        split slabs 128 KB, the two operand tiles 64 KB (a warpgroup's
//        exchange tile too), dkv's P 16 KB; registers 199-238 a thread of
//        255 (ptxas -v: dq 227 / 238, dkv 199 / 203 at NS = 4 / 8).  ptxas
//        serializes dq's wgmma for register resources (its note C7511).
//
// Masking: a cross-segment entry of P (and so of dS) is exactly 0; every
// row has at least its own key, so lse is finite and no NaN can arise.

#include <climits>

#include "hopper_pipeline.cuh"
#include "tf32_common.cuh"

namespace {

struct Tf32BwdParams {
  const int32_t* seg;
  const float* lse;  // [B, H, S]
  float* di;         // [B, H, S]: written by dq, read by dkv
  float* dq;
  float* dk;
  float* dv;
  const float* o;     // dq: the forward's output and dO, whose rows the wide
  const float* dout;  // kernel reads for di
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  const float* x[2];  // the wide kernels' streamed operands (dq: K, V; dkv: Q, dO)
  long long x_sb[2], x_sh[2], x_ss[2];
  long long g_sb, g_sh, g_ss;  // strides of the gradients (one layout for all)
  int H, S, D;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

// The block by NS slabs of 32 f32 columns, up to NS = 2 (the wide shape:
// Tf32WideShape below): two warpgroups, the own slabs a warpgroup the raw
// ones, then the split operands over them (4 NS slabs hold two operands' hi
// and lo), 64-row streamed tiles; stages of the ring 3 at NS = 1, 2 at NS =
// 2 (three would pass 227 KB).
template <int NS>
struct Tf32BwdShape {
  static_assert(NS <= 2, "past D = 64: Tf32WideShape");
  static constexpr int kG = 2;
  static constexpr int kThreads = 128 * kG;
  static constexpr int kStages = NS == 1 ? 3 : 2;
  static constexpr int kOwn = 4 * NS;
  static constexpr int kPer = 2 * NS;
};

template <int NS>
using Tf32Ring = Smem<Tf32BwdShape<NS>::kStages, Tf32BwdShape<NS>::kG, Tf32BwdShape<NS>::kPer>;

__device__ __forceinline__ const float* as_f32(const __nv_bfloat16* t) {
  return reinterpret_cast<const float*>(t);
}

constexpr int kSlabFloats = kTileElems / 2;  // a [64][32] f32 slab: one 8 KB tile

// Two neighbouring f32 (c even) of row r of a swizzled [64][32] slab.
__device__ __forceinline__ float2 ld2(const float* slab, int r, int c) {
  return *reinterpret_cast<const float2*>(slab + swz32(r, c));
}

// The column of its slab (kk / 4) that k index t4 of k step kk reads; k
// index t4 + 4 reads the next one.  Any order of the head dim's columns
// gives the same sums, and A and B take the same one.
__device__ __forceinline__ int kcol(int kk, int t4) {
  return 4 * (kk & 3) + 16 * (t4 >> 1) + 2 * (t4 & 1);
}

// The 1 KB block of a warp's split fragments of own operand o (0 or 1) at
// k step kk: each lane's hi[4] at lane * 4 floats, its lo[4] 128 floats on.
// Block o * 4 NS + kk lies in half (block % 2) of the warp's 16-row band of
// own slab block / 2.
template <int NS, class Ring>
__device__ __forceinline__ float* split_block(const Ring& m, int wg, int warp, int o, int kk) {
  const int blk = o * 4 * NS + kk;
  return reinterpret_cast<float*>(m.own_tile(blk >> 1, wg)) + warp * 512 + (blk & 1) * 256;
}

// Split a warp's A fragments of two own operands (the warpgroup's own slabs
// from `first[o]`: rows r0 and r0 + 8, every k step) once, into their
// blocks.  The warp reads only its own bands before any lane writes them.
template <int NS, class Ring>
__device__ __forceinline__ void split_own(const Ring& m, int wg, int warp, int lane,
                                          const int (&first)[2]) {
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16 + g;
  float x[2][4 * NS][4];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk) {
      const float* slab = as_f32(m.own_tile(first[o] + (kk >> 2), wg));
      const float2 u = ld2(slab, r0, kcol(kk, t4)), w = ld2(slab, r0 + 8, kcol(kk, t4));
      x[o][kk][0] = u.x;  // a0 (g, k t4)
      x[o][kk][1] = w.x;  // a1 (g + 8, k t4)
      x[o][kk][2] = u.y;  // a2 (g, k t4 + 4)
      x[o][kk][3] = w.y;  // a3 (g + 8, k t4 + 4)
    }
  }
  __syncwarp();
#pragma unroll
  for (int o = 0; o < 2; ++o) {
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(x[o][kk][i], hi[i], lo[i]);
      float* blk = split_block<NS>(m, wg, warp, o, kk);
      *reinterpret_cast<uint4*>(blk + lane * 4) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(blk + 128 + lane * 4) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  __syncwarp();
}

// d0[j] = A0 B0_j^T and d1[j] = A1 B1_j^T over the head dim, for the 8
// n-tiles j (rows 8j..8j+7) of a streamed tile: A0, A1 the warp's split own
// operands 0 and 1, B0 and B1 the stage's slabs from 0 and from NS (both
// K-major: rows n, columns k).
template <int NS, class Ring>
__device__ __forceinline__ void gemm_heads(float (&d0)[8][4], float (&d1)[8][4], const Ring& m,
                                           int wg, int warp, int lane, int stage) {
  const int g = lane >> 2, t4 = lane & 3;
  zero(d0);
  zero(d1);
#pragma unroll
  for (int kk = 0; kk < 4 * NS; ++kk) {
    const float* a[2] = {split_block<NS>(m, wg, warp, 0, kk), split_block<NS>(m, wg, warp, 1, kk)};
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const uint4 h = *reinterpret_cast<const uint4*>(a[o] + lane * 4);
      const uint4 l = *reinterpret_cast<const uint4*>(a[o] + 128 + lane * 4);
      a_hi[o][0] = h.x, a_hi[o][1] = h.y, a_hi[o][2] = h.z, a_hi[o][3] = h.w;
      a_lo[o][0] = l.x, a_lo[o][1] = l.y, a_lo[o][2] = l.z, a_lo[o][3] = l.w;
    }
    const float* b0 = as_f32(m.stream_tile(stage, kk >> 2));
    const float* b1 = as_f32(m.stream_tile(stage, NS + (kk >> 2)));
    const int c = kcol(kk, t4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 x0 = ld2(b0, 8 * j + g, c), x1 = ld2(b1, 8 * j + g, c);
      uint32_t b_hi[2], b_lo[2];
      split(x0.x, b_hi[0], b_lo[0]);
      split(x0.y, b_hi[1], b_lo[1]);
      mma_3xtf32(d0[j], a_hi[0], a_lo[0], b_hi, b_lo);
      split(x1.x, b_hi[0], b_lo[0]);
      split(x1.y, b_hi[1], b_lo[1]);
      mma_3xtf32(d1[j], a_hi[1], a_lo[1], b_hi, b_lo);
    }
  }
}

// d += A B over the 8 NJ rows of a streamed tile (64, or a half tile's
// 32): A (16 x 8 NJ, k = the tile's rows) the warp's C-layout values x (P,
// P^T, dS or dS^T), B the tile's NS slabs of an operand from b, `stride`
// floats apart (rows k, columns n: MN-major).  d[4c + 2E + h] is n-tile h
// of pair E of slab c: its n index g is column 32c + 16E + 2g + h.
template <int NS, int NJ = 8>
__device__ __forceinline__ void gemm_rows(float (&d)[4 * NS][4], const float (&x)[NJ][4],
                                          const float* b, int stride, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    // this thread's entries of rows 8j + 2t4 and + 1 as A's k = t4, t4 + 4
    uint32_t a_hi[4], a_lo[4];
    split(x[j][0], a_hi[0], a_lo[0]);
    split(x[j][2], a_hi[1], a_lo[1]);
    split(x[j][1], a_hi[2], a_lo[2]);
    split(x[j][3], a_hi[3], a_lo[3]);
    const int row = 8 * j + 2 * t4;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float* bt = b + c * stride;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 x0 = ld2(bt, row, 16 * e + 2 * g), x1 = ld2(bt, row + 1, 16 * e + 2 * g);
        uint32_t b_hi[2], b_lo[2];
        split(x0.x, b_hi[0], b_lo[0]);
        split(x1.x, b_hi[1], b_lo[1]);
        mma_3xtf32(d[4 * c + 2 * e], a_hi, a_lo, b_hi, b_lo);
        split(x0.y, b_hi[0], b_lo[0]);
        split(x1.y, b_hi[1], b_lo[1]);
        mma_3xtf32(d[4 * c + 2 * e + 1], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
}

// Store a warp's 16 x 32 NS accumulator (gemm_rows's columns) to its rows:
// row g at dst, row g + 8 at dst + 8 * ld; a thread's columns 32c + 16E +
// 4t4..+3 are neighbours, one 16-byte store, those before D.
template <int NS>
__device__ __forceinline__ void store_acc(float* dst, long long ld, const float (&d)[4 * NS][4],
                                          int t4, int D) {
#pragma unroll
  for (int c = 0; c < NS; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 32 * c + 16 * e + 4 * t4, n = 4 * c + 2 * e;
      if (col < D) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(d[n][0], d[n + 1][0], d[n][1], d[n + 1][1]);
        *reinterpret_cast<float4*>(dst + 8 * ld + col) =
            make_float4(d[n][2], d[n + 1][2], d[n][3], d[n + 1][3]);
      }
    }
  }
}

template <int NS>
__device__ __forceinline__ void zero_acc(float (&d)[4 * NS][4]) {
#pragma unroll
  for (int n = 0; n < 4 * NS; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
}

// P^T = exp2(S^T * sm_scale * log2 e - lse * log2 e) in place of S^T (rows
// = this thread's keys, of segments seg_k0 / seg_k1; 8 NJ columns = the
// tile's queries) on same-segment pairs, exactly 0 elsewhere.
template <int NJ>
__device__ __forceinline__ void p_transposed(float (&st)[NJ][4], const float* lse_t,
                                             const int32_t* seg_t, int seg_k0, int seg_k1,
                                             int t4, float scale_log2) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 8 * j + 2 * t4;  // the tile's queries c and c + 1
    const int sq0 = seg_t[c], sq1 = seg_t[c + 1];
    const float l0 = lse_t[c] * kLog2e, l1 = lse_t[c + 1] * kLog2e;
    st[j][0] = sq0 == seg_k0 ? exp2f(fmaf(st[j][0], scale_log2, -l0)) : 0.f;
    st[j][1] = sq1 == seg_k0 ? exp2f(fmaf(st[j][1], scale_log2, -l1)) : 0.f;
    st[j][2] = sq0 == seg_k1 ? exp2f(fmaf(st[j][2], scale_log2, -l0)) : 0.f;
    st[j][3] = sq1 == seg_k1 ? exp2f(fmaf(st[j][3], scale_log2, -l1)) : 0.f;
  }
}

// dS^T = P^T (dP^T - di) * sm_scale in place of dP^T (di_t: the tile's
// queries').
template <int NJ>
__device__ __forceinline__ void ds_transposed(float (&dpt)[NJ][4], const float (&st)[NJ][4],
                                              const float* di_t, int t4, float scale) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 8 * j + 2 * t4;
    const float d0 = di_t[c], d1 = di_t[c + 1];
    dpt[j][0] = st[j][0] * (dpt[j][0] - d0) * scale;
    dpt[j][1] = st[j][1] * (dpt[j][1] - d1) * scale;
    dpt[j][2] = st[j][2] * (dpt[j][2] - d0) * scale;
    dpt[j][3] = st[j][3] * (dpt[j][3] - d1) * scale;
  }
}

// dS = P (dP - di) * sm_scale in place of S (rows = this thread's two
// queries, with their segment ids, lse in log2 units and di; 8 NJ columns =
// the tile's keys), P exactly 0 across segments.
template <int NJ>
__device__ __forceinline__ void ds_rows(float (&s)[NJ][4], const float (&dp)[NJ][4],
                                        const int32_t* seg_t, int seg_q0, int seg_q1, float lse0,
                                        float lse1, float di0, float di1, int t4, float scale,
                                        float scale_log2) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 8 * j + 2 * t4;  // the tile's keys c and c + 1
    const int sk0 = seg_t[c], sk1 = seg_t[c + 1];
    const float p0 = sk0 == seg_q0 ? exp2f(fmaf(s[j][0], scale_log2, -lse0)) : 0.f;
    const float p1 = sk1 == seg_q0 ? exp2f(fmaf(s[j][1], scale_log2, -lse0)) : 0.f;
    const float p2 = sk0 == seg_q1 ? exp2f(fmaf(s[j][2], scale_log2, -lse1)) : 0.f;
    const float p3 = sk1 == seg_q1 ? exp2f(fmaf(s[j][3], scale_log2, -lse1)) : 0.f;
    s[j][0] = p0 * (dp[j][0] - di0) * scale;
    s[j][1] = p1 * (dp[j][1] - di0) * scale;
    s[j][2] = p2 * (dp[j][2] - di1) * scale;
    s[j][3] = p3 * (dp[j][3] - di1) * scale;
  }
}

template <int NS>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_tf32_bwd_dkv_kernel(const Tf32BwdParams p, const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const __grid_constant__ CUtensorMap) {
  using Sh = Tf32BwdShape<NS>;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // each warpgroup's K slabs, then its V slabs (then their splits); a
  // stage holds Q's slabs, then dO's
  const Tf32Ring<NS> m = carve<Sh::kStages, kGroups, Sh::kPer>(smem_raw, n_tiles, Sh::kOwn);
  const int blocks = p.S / kRows;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const float* lseg = p.lse + static_cast<long long>(bh) * p.S;
  const float* dig = p.di + static_cast<long long>(bh) * p.S;

  // a streamed tile t into a stage: Q, dO, and the queries' lse, di and
  // segment ids
  const uint32_t bytes = 2 * NS * kTileBytes + 3 * 256;
  auto load = [&](int t, int stage) {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.stream_tile(stage, c), &map_q, &m.full[stage], h, t * 64, b, 32 * c);
      tma_load_tile(m.stream_tile(stage, NS + c), &map_do, &m.full[stage], h, t * 64, b, 32 * c);
    }
    bulk_load(m.row_values(0, stage), lseg + t * 64, 256, &m.full[stage]);
    bulk_load(m.row_values(1, stage), dig + t * 64, 256, &m.full[stage]);
    bulk_load(m.row_values(2, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, 2 * NS * kGroups * kTileBytes, [&] {
    for (int w = 0; w < kGroups; ++w) {
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        tma_load_tile(m.own_tile(c, w), &map_k, m.own_full, h, blk * kRows + w * 64, b, 32 * c);
        tma_load_tile(m.own_tile(NS + c, w), &map_v, m.own_full, h, blk * kRows + w * 64, b,
                      32 * c);
      }
    }
  }, bytes, load, 0);
  if (tid == 0) start_loads(m, bytes, load);

  // two warpgroups of 64 keys (16 a warp), which also issue the loads
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int key0 = blk * kRows + wg * 64;  // the warpgroup's first key
  const int r0 = warp * 16 + g;            // this thread's keys: r0 and r0 + 8
  const int seg_k0 = segb[key0 + r0], seg_k1 = segb[key0 + r0 + 8];
  const int lo = m.tmin[kGroups * blk + wg], hi = m.tmax[kGroups * blk + wg];
  mbar_wait(m.own_full, 0);
  const int own_first[2] = {0, NS};  // K, V
  split_own<NS>(m, wg, warp, lane, own_first);

  float dk[4 * NS][4], dv[4 * NS][4];
  zero_acc<NS>(dk);
  zero_acc<NS>(dv);
  const int n_live = *m.n_live;
  for (int i = 0; i < n_live; ++i) {
    m.wait_full(i);
    const int stage = i % Sh::kStages;
    if (m.meets(m.live[i], lo, hi)) {
      float st[8][4], dpt[8][4];
      gemm_heads<NS>(st, dpt, m, wg, warp, lane, stage);  // S^T = K Q^T, dP^T = V dO^T
      p_transposed(st, m.row_values(0, stage),
                   reinterpret_cast<const int32_t*>(m.row_values(2, stage)), seg_k0, seg_k1, t4,
                   p.scale_log2);
      gemm_rows<NS>(dv, st, as_f32(m.stream_tile(stage, NS)), kSlabFloats, lane);  // dV += P^T dO
      ds_transposed(dpt, st, m.row_values(1, stage), t4, p.scale);
      gemm_rows<NS>(dk, dpt, as_f32(m.stream_tile(stage, 0)), kSlabFloats, lane);  // dK += dS^T Q
    }
    release_and_load(m, i, wg, bytes, load);
  }

  const long long out = b * p.g_sb + h * p.g_sh + (key0 + r0) * p.g_ss;
  store_acc<NS>(p.dk + out, p.g_ss, dk, t4, p.D);
  store_acc<NS>(p.dv + out, p.g_ss, dv, t4, p.D);
}

template <int NS>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_tf32_bwd_dq_kernel(const Tf32BwdParams p, const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_o) {
  using Sh = Tf32BwdShape<NS>;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // each warpgroup's Q slabs, its dO slabs, its O slabs (then the splits
  // of Q and dO); a stage holds K's slabs, then V's
  const Tf32Ring<NS> m = carve<Sh::kStages, kGroups, Sh::kPer>(smem_raw, n_tiles, Sh::kOwn);
  const int blocks = p.S / kRows;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;

  // a streamed tile t into a stage: K, V and the keys' segment ids
  const uint32_t bytes = 2 * NS * kTileBytes + 256;
  auto load = [&](int t, int stage) {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.stream_tile(stage, c), &map_k, &m.full[stage], h, t * 64, b, 32 * c);
      tma_load_tile(m.stream_tile(stage, NS + c), &map_v, &m.full[stage], h, t * 64, b, 32 * c);
    }
    bulk_load(m.row_values(0, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, 3 * NS * kGroups * kTileBytes, [&] {
    for (int w = 0; w < kGroups; ++w) {
      const int row = blk * kRows + w * 64;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        tma_load_tile(m.own_tile(c, w), &map_q, m.own_full, h, row, b, 32 * c);
        tma_load_tile(m.own_tile(NS + c, w), &map_do, m.own_full, h, row, b, 32 * c);
        tma_load_tile(m.own_tile(2 * NS + c, w), &map_o, m.own_full, h, row, b, 32 * c);
      }
    }
  }, bytes, load, 0);
  if (tid == 0) start_loads(m, bytes, load);

  // two warpgroups of 64 queries (16 a warp), which also issue the loads
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = blk * kRows + wg * 64;  // the warpgroup's first query
  const int r0 = warp * 16 + g;            // this thread's rows: r0 and r0 + 8
  float* di_s = m.row_values(1, 0);        // [kRows]: the block's di
  mbar_wait(m.own_full, 0);

  // di of the warpgroup's 64 rows from its O and dO slabs: two threads a
  // row (of the thread's own warp), 16 products a slab each, in f32
  {
    const int r = wtid >> 1, half = wtid & 1;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float* ot = as_f32(m.own_tile(2 * NS + c, wg));
      const float* dt = as_f32(m.own_tile(NS + c, wg));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = (half * 4 + j) * 4;
        const float4 a = *reinterpret_cast<const float4*>(ot + swz32(r, col));
        const float4 d = *reinterpret_cast<const float4*>(dt + swz32(r, col));
        sum += a.x * d.x + a.y * d.y + a.z * d.z + a.w * d.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      di_s[wg * 64 + r] = sum;
      p.di[static_cast<long long>(bh) * p.S + row0 + r] = sum;
    }
  }
  // the warp's di reads of O and dO end before its splits overwrite them
  __syncwarp();
  const int own_first[2] = {0, NS};  // Q, dO
  split_own<NS>(m, wg, warp, lane, own_first);

  const long long rows = static_cast<long long>(bh) * p.S + row0 + r0;
  const int seg_q0 = segb[row0 + r0], seg_q1 = segb[row0 + r0 + 8];
  const float lse0 = p.lse[rows] * kLog2e, lse1 = p.lse[rows + 8] * kLog2e;
  const float di0 = di_s[wg * 64 + r0], di1 = di_s[wg * 64 + r0 + 8];
  const int lo = m.tmin[kGroups * blk + wg], hi = m.tmax[kGroups * blk + wg];
  float dq[4 * NS][4];
  zero_acc<NS>(dq);
  const int n_live = *m.n_live;
  for (int i = 0; i < n_live; ++i) {
    m.wait_full(i);
    const int stage = i % Sh::kStages;
    if (m.meets(m.live[i], lo, hi)) {
      float s[8][4], dp[8][4];
      gemm_heads<NS>(s, dp, m, wg, warp, lane, stage);  // S = Q K^T, dP = dO V^T
      ds_rows(s, dp, reinterpret_cast<const int32_t*>(m.row_values(0, stage)), seg_q0, seg_q1,
              lse0, lse1, di0, di1, t4, p.scale, p.scale_log2);
      gemm_rows<NS>(dq, s, as_f32(m.stream_tile(stage, 0)), kSlabFloats, lane);  // dQ += dS K
    }
    release_and_load(m, i, wg, bytes, load);
  }

  store_acc<NS>(p.dq + b * p.g_sb + h * p.g_sh + (row0 + r0) * p.g_ss, p.g_ss, dq, t4, p.D);
}

// ---- the wide pair (D 68-256) ---------------------------------------------

// The wide blocks (see the note at the head): two warpgroups over 64 own
// rows, holding up to 4 slabs (128 columns) of the head dim split once:
// each slab's hi in place of the slab TMA landed, its lo beside (16 tiles
// of 8 KB); at NS = 8 a cluster of two such blocks (kCTAs), each with half
// the columns (wide_cols).  Then each warpgroup's operand tile ([64][128]:
// hi in columns 0-63, lo in 64-127; 4 tiles; at NS = 8 also where the
// other block's partial sums land) and, in dkv, P in f32 (2 tiles).  The
// streamed side is read from global memory (L2, then L1) as A fragments:
// no ring.
template <int NS>
struct Tf32WideShape {
  static constexpr int kCTAs = NS / 4;
  static constexpr int kOwnDq = 16 + 8;
  static constexpr int kOwnDkv = 16 + 8 + 2;
};

template <int NS>
struct WideSmem {
  Smem<1, 1, 0> m;
  // hl 0: hi, 1: lo of slab c of own operand o ([64][32], k-permuted)
  __device__ __forceinline__ float* own(int o, int c, int hl) const {
    return reinterpret_cast<float*>(m.own_tile(8 * hl + 4 * o + c, 0));
  }
  // warpgroup wg's operand tile (at NS = 8 also its exchange buffer)
  __device__ __forceinline__ float* btile(int wg) const {
    return reinterpret_cast<float*>(m.own_tile(16 + 4 * wg, 0));
  }
  // dkv: a tile's P in f32, from warpgroup 0 to 1 (32 floats a thread, 16 KB)
  __device__ __forceinline__ float* p_handoff() const {
    return reinterpret_cast<float*>(m.own_tile(24, 0));
  }
};

// Element (r, c) of an operand tile's 128 columns (slabs of 32), and the
// descriptor of its k step from column col (a multiple of 8).
__device__ __forceinline__ int bcol(int r, int c) { return (c >> 5) * kSlabFloats + swz32(r, c & 31); }
__device__ __forceinline__ uint64_t bdesc(const float* bt, int col) {
  return tile_desc(bt + (col >> 5) * kSlabFloats) + 2 * ((col & 31) >> 3);
}

template <int N>
__device__ __forceinline__ void pin_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
  }
}
__device__ __forceinline__ void pin_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Split the own operands' nsl slabs (64 rows) once, in place: each group of
// 8 columns of a row with its even columns at k 0-3 and its odd ones at k
// 4-7, the order in which a thread's A fragment holds a k step (columns 2t4
// and 2t4 + 1 of the group: one 8-byte load); hi over the raw slab, lo in
// its lo slab.  A thread a row's group at a time.
template <int NS>
__device__ __forceinline__ void split_own(const WideSmem<NS>& w, int n_ops, int nsl) {
  for (int it = threadIdx.x; it < n_ops * nsl * 256; it += 256) {
    const int o = it / (nsl * 256), c = (it >> 8) % nsl, r = (it >> 2) & 63, col = 8 * (it & 3);
    float* hi = w.own(o, c, 0);
    float* lo = w.own(o, c, 1);
    const float4 x0 = *reinterpret_cast<const float4*>(hi + swz32(r, col));
    const float4 x1 = *reinterpret_cast<const float4*>(hi + swz32(r, col + 4));
    const float v[8] = {x0.x, x0.z, x1.x, x1.z, x0.y, x0.w, x1.y, x1.w};
    uint32_t h[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) split(v[i], h[i], l[i]);
    *reinterpret_cast<uint4*>(hi + swz32(r, col)) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + swz32(r, col + 4)) = make_uint4(h[4], h[5], h[6], h[7]);
    *reinterpret_cast<uint4*>(lo + swz32(r, col)) = make_uint4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<uint4*>(lo + swz32(r, col + 4)) = make_uint4(l[4], l[5], l[6], l[7]);
  }
}

// Two neighbouring f32 of a streamed row (col even), 0 from Dl on.
__device__ __forceinline__ float2 ldg2(const float* row, int col, int Dl) {
  return col < Dl ? __ldg(reinterpret_cast<const float2*>(row + col)) : make_float2(0.f, 0.f);
}

// s0 = X0 Y0^T and, with two, s1 = X1 Y1^T over the block's columns before
// Dl: X0, X1 a streamed tile's 64 rows (from x0, x1: row 0 at the block's
// first column, rows ss0, ss1 apart) as A, this thread's rows r0 and r0 +
// 8 loaded from global memory kAhead k steps ahead and split at use, by
// the one thread whose fragment holds them; Y0, Y1 the own operands own0
// and 1 (B, N = the own 64 rows, split once).  Each k step is one commit group; the
// next one's A is split while it runs (wait<1>: A double-buffered).
template <int NS>
__device__ __forceinline__ void heads_wide(float (&s0)[8][4], float (&s1)[8][4],
                                           const WideSmem<NS>& w, const float* x0, long long ss0,
                                           const float* x1, long long ss1, bool two, int Dl,
                                           int warp, int lane, int own0 = 0) {
  constexpr int kAhead = 4;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16 + g;
  const float* row[2][2] = {{x0 + r0 * ss0, x0 + (r0 + 8) * ss0},
                            {x1 + r0 * ss1, x1 + (r0 + 8) * ss1}};
  float2 raw[kAhead][2][2];  // [slot][operand][row]
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      raw[k][o][0] = ldg2(row[o][0], 8 * k + 2 * t4, o == 0 || two ? Dl : 0);
      raw[k][o][1] = ldg2(row[o][1], 8 * k + 2 * t4, o == 0 || two ? Dl : 0);
    }
  }
  uint32_t ah[2][2][4], al[2][2][4];  // [buffer][operand]
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (8 * k >= Dl) break;
    const int slot = k % kAhead, buf = k & 1;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      split(raw[slot][o][0].x, ah[buf][o][0], al[buf][o][0]);  // a0 (g, k t4)
      split(raw[slot][o][1].x, ah[buf][o][1], al[buf][o][1]);  // a1 (g + 8, k t4)
      split(raw[slot][o][0].y, ah[buf][o][2], al[buf][o][2]);  // a2 (g, k t4 + 4)
      split(raw[slot][o][1].y, ah[buf][o][3], al[buf][o][3]);  // a3 (g + 8, k t4 + 4)
      if (k + kAhead < 16) {
        raw[slot][o][0] = ldg2(row[o][0], 8 * (k + kAhead) + 2 * t4, o == 0 || two ? Dl : 0);
        raw[slot][o][1] = ldg2(row[o][1], 8 * (k + kAhead) + 2 * t4, o == 0 || two ? Dl : 0);
      }
    }
    const int c = k >> 2, j = k & 3;
    wgmma_fence();
    wgmma_3xtf32(s0, ah[buf][0], al[buf][0], tile_desc(w.own(own0, c, 0)) + 2 * j,
                 tile_desc(w.own(own0, c, 1)) + 2 * j, k == 0);
    if (two) {
      wgmma_3xtf32(s1, ah[buf][1], al[buf][1], tile_desc(w.own(1, c, 0)) + 2 * j,
                      tile_desc(w.own(1, c, 1)) + 2 * j, k == 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int o = 0; o < 2; ++o) pin_frag(ah[buf ^ 1][o]), pin_frag(al[buf ^ 1][o]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int o = 0; o < 2; ++o) pin_frag(ah[b][o]), pin_frag(al[b][o]);
  }
  pin_acc(s0);
  pin_acc(s1);
}

// Barrier over both blocks of a cluster (release / acquire: each block's
// writes to its shared memory before it are seen by the other after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// The address of the same shared-memory place in the other block of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* local, int rank) {
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(smem_u32(local)),
               "r"(rank ^ 1));
  return peer;
}

// A warpgroup's handshake with the same warpgroup of the other block (NS =
// 8): in each block `full` (128 arrivals: the other block's partial sums
// have landed in this block's operand tile) and `free` (one arrival: the
// other block's operand tile may take the next ones).
struct Exchange {
  uint64_t* full;
  uint64_t* free;
  int rank, n;  // exchanges done
};

// Wait for phase `parity` of a barrier that the other block arrives on.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t peer_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(peer_bar)
               : "memory");
}

// At NS = 8: s0 and s1 summed over the cluster's two halves of the head dim.
// Each thread writes its entries into the other block's operand tile of its
// warpgroup (once that block has freed it) and arrives on that block's
// `full`; then waits for its own `full` and adds what the other block wrote
// (f32 addition commutes: both blocks get the same bits).  The caller frees
// this block's tile (exchange_free) once it is done with it.
template <int NS>
__device__ __forceinline__ void exchange_heads(float (&s0)[8][4], float (&s1)[8][4],
                                               const WideSmem<NS>& w, Exchange& x, int wg,
                                               bool two = true) {
  float* tile = w.btile(wg);
  const int tid = threadIdx.x & 127;
  if (x.n > 0) mbar_wait_cluster(x.free, (x.n - 1) & 1);
  const uint32_t peer = peer_addr(tile, x.rank);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(peer + 4 * ((4 * n + i) * 128 + tid)),
                   "f"(s0[n][i])
                   : "memory");
      if (two) {
        asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                         peer + 4 * ((32 + 4 * n + i) * 128 + tid)),
                     "f"(s1[n][i])
                     : "memory");
      }
    }
  }
  mbar_arrive_remote(peer_addr(x.full, x.rank));
  mbar_wait_cluster(x.full, x.n & 1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s0[n][i] += tile[(4 * n + i) * 128 + tid];
      if (two) s1[n][i] += tile[(32 + 4 * n + i) * 128 + tid];
    }
  }
  ++x.n;
  named_sync(1 + wg, 128);  // every thread has read the tile before any writes it again
}

// This block's operand tile of the warpgroup is free for the other block's
// next partial sums (after a barrier of the warpgroup: one arrival).
__device__ __forceinline__ void exchange_free(const Exchange& x) {
  if ((threadIdx.x & 127) == 0) mbar_arrive_remote(peer_addr(x.free, x.rank));
}

// P = exp2(S * sm_scale * log2 e - lse * log2 e) in place of S (rows =
// this thread's two queries, of segments seg_q0 / seg_q1, lse in log2
// units; columns = the own keys, segments seg_t), exactly 0 across
// segments: ds_rows without dS.
__device__ __forceinline__ void p_rows(float (&s)[8][4], const int32_t* seg_t, int seg_q0,
                                       int seg_q1, float lse0, float lse1, int t4,
                                       float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const int sk0 = seg_t[c], sk1 = seg_t[c + 1];
    s[j][0] = sk0 == seg_q0 ? exp2f(fmaf(s[j][0], scale_log2, -lse0)) : 0.f;
    s[j][1] = sk1 == seg_q0 ? exp2f(fmaf(s[j][1], scale_log2, -lse0)) : 0.f;
    s[j][2] = sk0 == seg_q1 ? exp2f(fmaf(s[j][2], scale_log2, -lse1)) : 0.f;
    s[j][3] = sk1 == seg_q1 ? exp2f(fmaf(s[j][3], scale_log2, -lse1)) : 0.f;
  }
}

// A tile's P, P^T, dS or dS^T (x: this thread's C entries, rows r0 and r0 +
// 8 of the streamed tile, columns the own 64) split once into the operand
// tile bt, transposed: row = own row, hi at column = streamed row, lo 64
// further.
__device__ __forceinline__ void store_split_t(float* bt, const float (&x)[8][4], int warp,
                                              int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + 8 * (i >> 1), c = 8 * n + 2 * t4 + (i & 1);
      uint32_t h, l;
      split(x[n][i], h, l);
      reinterpret_cast<uint32_t*>(bt)[bcol(c, r)] = h;
      reinterpret_cast<uint32_t*>(bt)[bcol(c, 64 + r)] = l;
    }
  }
}

// d[m] += X_m^T B over a streamed tile's 64 rows, for the 64-row tiles m of
// the block's columns before Dl (the transposed gradients: dQ^T = K^T dS^T,
// dV^T = dO^T P, dK^T = Q^T dS): X_m^T the tile's columns 64m..64m+63 (from
// x: row 0 at the block's first column, rows ss apart) as A, loaded from
// global memory two k steps ahead and split at use; B the operand tile bt
// (N = the own 64 rows).  Ends with every product done.
__device__ __forceinline__ void rows_wide(float (&d)[2][8][4], const float* x, long long ss,
                                          const float* bt, int Dl, int warp, int lane) {
  constexpr int kAhead = 2;
  const int g = lane >> 2, t4 = lane & 3, nk = 8 * ((Dl + 63) / 64);
  auto load = [&](int k, float (&r)[4]) {
    const int col = 64 * (k >> 3) + 16 * warp + g;  // this thread's rows of A: col, col + 8
    const float* p0 = x + (8 * (k & 7) + t4) * ss + col;
    const float* p4 = p0 + 4 * ss;
    r[0] = col < Dl ? __ldg(p0) : 0.f;          // a0 (col, k t4)
    r[1] = col + 8 < Dl ? __ldg(p0 + 8) : 0.f;  // a1 (col + 8, k t4)
    r[2] = col < Dl ? __ldg(p4) : 0.f;          // a2 (col, k t4 + 4)
    r[3] = col + 8 < Dl ? __ldg(p4 + 8) : 0.f;  // a3 (col + 8, k t4 + 4)
  };
  float raw[kAhead][4];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) load(k, raw[k]);
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= nk) break;
    const int slot = k % kAhead, buf = k & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(raw[slot][i], ah[buf][i], al[buf][i]);
    if (k + kAhead < nk) load(k + kAhead, raw[slot]);
    wgmma_fence();
    wgmma_3xtf32(d[k >> 3], ah[buf], al[buf], bdesc(bt, 8 * (k & 7)),
                    bdesc(bt, 64 + 8 * (k & 7)));
    wgmma_commit();
    wgmma_wait<1>();
    pin_frag(ah[buf ^ 1]);
    pin_frag(al[buf ^ 1]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < 2; ++b) pin_frag(ah[b]), pin_frag(al[b]);
}

// Store a transposed gradient (d[m]: rows = the block's head-dim columns
// from 0, columns = the own 64 rows) to the own rows from dst (row stride
// ld), columns before Dl.
__device__ __forceinline__ void store_transposed(float* dst, long long ld, float (&d)[2][8][4],
                                                 int Dl, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    pin_acc(d[m]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 64 * m + 16 * warp + g + 8 * (i >> 1), row = 8 * n + 2 * t4 + (i & 1);
        if (col < Dl) dst[row * ld + col] = d[m][n][i];
      }
    }
  }
}

// The block's place in its cluster (0 at NS = 4) and its head-dim columns:
// from col0, Dl of them (at most 128), nsl slabs.  A cluster's two blocks
// take halves as even as whole k steps allow (the first ceil(D / 2)
// rounded up to 8: at D = 192, 96 each), so neither waits on the other at
// an exchange.
struct WideCols {
  int rank, col0, Dl, nsl;
};
template <int NS>
__device__ __forceinline__ WideCols wide_cols(int D) {
  int rank = 0, col0 = 0, Dl = D;
  if constexpr (Tf32WideShape<NS>::kCTAs > 1) {
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    const int half = ((D + 1) / 2 + 7) / 8 * 8;
    col0 = rank * half;
    Dl = rank == 0 ? half : D - half;
  }
  return {rank, col0, Dl, (Dl + 31) / 32};
}

// A wide block's set-up, by all threads: thread 0 sets up the barriers
// (own_full, and each warpgroup's exchange barriers) and starts the own
// slabs' loads (`load_own`, `own_bytes` in all, on own_full); every thread
// helps find the live tiles.  Ends with the block synchronised.
template <typename LoadOwn>
__device__ __forceinline__ void wide_set_up(const Smem<1, 1, 0>& m, const int32_t* segb,
                                            int n_tiles, int blk, uint32_t own_bytes,
                                            LoadOwn load_own) {
  if (threadIdx.x == 0) {
    mbar_init(m.own_full, 1);
    for (int wg = 0; wg < 2; ++wg) {
      mbar_init(m.full + 3 + wg, 128);  // the exchange's full and free barriers (NS = 8)
      mbar_init(m.full + 5 + wg, 1);
    }
    mbar_fence_init();
    mbar_expect_tx(m.own_full, own_bytes);
    load_own();
  }
  find_live_tiles<1>(segb, n_tiles, blk, m.tmin, m.tmax, m.live, m.n_live);
}

// The two warpgroups' transposed gradients summed in warpgroup 0's
// registers (d0 + d1, in that order): warpgroup 1 writes its sums through
// its operand tile (64 floats a thread), warpgroup 0 adds them.
template <int NS>
__device__ __forceinline__ void sum_groups(float (&d)[2][8][4], const WideSmem<NS>& w, int wg) {
  float* buf = w.btile(1);
  const int wtid = threadIdx.x & 127;
  __syncthreads();  // both warpgroups' last products have ended
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    pin_acc(d[m]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (wg == 1) buf[((8 * m + n) * 4 + i) * 128 + wtid] = d[m][n][i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (wg == 0) d[m][n][i] += buf[((8 * m + n) * 4 + i) * 128 + wtid];
      }
    }
  }
}

// dS = P (dP - di) * sm_scale in place of dP (rows = this thread's two
// queries, with their di; P exactly 0 across segments): ds_rows's
// arithmetic on a P computed elsewhere.
__device__ __forceinline__ void ds_from_p(float (&dp)[8][4], const float (&p)[8][4], float di0,
                                          float di1, float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dp[n][0] = p[n][0] * (dp[n][0] - di0) * scale;
    dp[n][1] = p[n][1] * (dp[n][1] - di0) * scale;
    dp[n][2] = p[n][2] * (dp[n][2] - di1) * scale;
    dp[n][3] = p[n][3] * (dp[n][3] - di1) * scale;
  }
}

// One side of a barrier of `n` threads over two warpgroups: arrive without
// waiting (the producer's side).
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int NS>
__global__ void __launch_bounds__(256, 1)
    flash_tf32_bwd_dkv_wide_kernel(const Tf32BwdParams p,
                                   const __grid_constant__ CUtensorMap,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __grid_constant__ CUtensorMap,
                                   const __grid_constant__ CUtensorMap) {
  using Sh = Tf32WideShape<NS>;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // own: K, V; operand tiles P^T (warpgroup 0's) and dS^T (warpgroup 1's);
  // P in f32
  const WideSmem<NS> w{carve<1, 1, 0>(smem_raw, n_tiles, Sh::kOwnDkv)};
  const auto& m = w.m;
  const int unit = blockIdx.x / Sh::kCTAs;  // the cluster's key tile
  const int blk = unit % n_tiles, bh = unit / n_tiles;
  const int h = bh % p.H, b = bh / p.H;
  const WideCols cols = wide_cols<NS>(p.D);
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const float* lseg = p.lse + static_cast<long long>(bh) * p.S;
  const float* dig = p.di + static_cast<long long>(bh) * p.S;
  wide_set_up(m, segb, n_tiles, blk, 2 * cols.nsl * kTileBytes, [&] {
    for (int c = 0; c < cols.nsl; ++c) {
      tma_load_tile(w.own(0, c, 0), &map_k, m.own_full, h, blk * 64, b, cols.col0 + 32 * c);
      tma_load_tile(w.own(1, c, 0), &map_v, m.own_full, h, blk * 64, b, cols.col0 + 32 * c);
    }
  });

  // two warpgroups over the same 64 keys and every live query tile:
  // warpgroup 0 takes S = Q K^T, P and dV^T += dO^T P; warpgroup 1 dP = dO
  // V^T, dS (from warpgroup 0's P) and dK^T += Q^T dS.  A thread's rows of
  // a tile: queries r0 and r0 + 8 of it.
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31,
            t4 = lane & 3, wtid = tid & 127;
  const int key0 = blk * 64, r0 = warp * 16 + (lane >> 2);
  int32_t* kseg = reinterpret_cast<int32_t*>(m.row_values(0, 0));  // [64]: the own keys' ids
  if (tid < 64) kseg[tid] = segb[key0 + tid];
  const float* xq = p.x[0] + b * p.x_sb[0] + h * p.x_sh[0] + cols.col0;  // Q, row 0
  const float* xd = p.x[1] + b * p.x_sb[1] + h * p.x_sh[1] + cols.col0;  // dO, row 0
  // a warpgroup's streamed operand in its head product (Q, dO) and in its
  // rows product (dO, Q)
  const float* xh = wg == 0 ? xq : xd;
  const float* xr = wg == 0 ? xd : xq;
  const long long ssh = p.x_ss[wg], ssr = p.x_ss[wg ^ 1];
  float* handoff = w.p_handoff();
  mbar_wait(m.own_full, 0);
  split_own<NS>(w, 2, cols.nsl);
  fence_proxy_async();
  __syncthreads();
  float acc[2][8][4];  // warpgroup 0: dV^T; 1: dK^T
  zero(acc[0]);
  zero(acc[1]);
  Exchange x{m.full + 3 + wg, m.full + 5 + wg, cols.rank, 0};
  if constexpr (Sh::kCTAs > 1) cluster_sync();  // both blocks' barriers are set up
  constexpr int kReady = 3, kFree = 4;  // the P handoff's barriers (256 threads)
  const int n_live = *m.n_live;
  for (int i = 0; i < n_live; ++i) {
    const int q0 = m.live[i] * 64;
    float s[8][4], unused[8][4];
    heads_wide<NS>(s, unused, w, xh + q0 * ssh, ssh, xh, ssh, false, cols.Dl, warp, lane,
                   wg);  // S = Q K^T (warpgroup 0), dP = dO V^T (1)
    if constexpr (Sh::kCTAs > 1) exchange_heads<NS>(s, unused, w, x, wg, false);
    const int seg_q0 = segb[q0 + r0], seg_q1 = segb[q0 + r0 + 8];
    if (wg == 0) {
      p_rows(s, kseg, seg_q0, seg_q1, lseg[q0 + r0] * kLog2e, lseg[q0 + r0 + 8] * kLog2e, t4,
             p.scale_log2);  // P
      if (i > 0) named_sync(kFree, 256);  // warpgroup 1 has read the last tile's P
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) handoff[(4 * n + j) * 128 + wtid] = s[n][j];
      }
      named_arrive(kReady, 256);
    } else {
      float pt[8][4];
      named_sync(kReady, 256);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pt[n][j] = handoff[(4 * n + j) * 128 + wtid];
      }
      if (i + 1 < n_live) named_arrive(kFree, 256);
      ds_from_p(s, pt, dig[q0 + r0], dig[q0 + r0 + 8], p.scale);  // dS
    }
    store_split_t(w.btile(wg), s, warp, lane);  // P^T or dS^T
    fence_proxy_async();
    named_sync(1 + wg, 128);
    rows_wide(acc, xr + q0 * ssr, ssr, w.btile(wg), cols.Dl, warp,
                  lane);  // dV^T += dO^T P, or dK^T += Q^T dS
    named_sync(1 + wg, 128);  // the warpgroup's operand tile is free
    if constexpr (Sh::kCTAs > 1) exchange_free(x);
  }
  if constexpr (Sh::kCTAs > 1) cluster_sync();  // the other block's last arrivals have landed
  store_transposed((wg == 0 ? p.dv : p.dk) + b * p.g_sb + h * p.g_sh + key0 * p.g_ss + cols.col0,
                   p.g_ss, acc, cols.Dl, warp, lane);
}

template <int NS>
__global__ void __launch_bounds__(256, 1)
    flash_tf32_bwd_dq_wide_kernel(const Tf32BwdParams p, const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap,
                                  const __grid_constant__ CUtensorMap,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const __grid_constant__ CUtensorMap) {
  using Sh = Tf32WideShape<NS>;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // own: Q, dO; each warpgroup's operand tile: dS
  const WideSmem<NS> w{carve<1, 1, 0>(smem_raw, n_tiles, Sh::kOwnDq)};
  const auto& m = w.m;
  const int unit = blockIdx.x / Sh::kCTAs;  // the cluster's query tile
  const int blk = unit % n_tiles, bh = unit / n_tiles;
  const int h = bh % p.H, b = bh / p.H;
  const WideCols cols = wide_cols<NS>(p.D);
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  wide_set_up(m, segb, n_tiles, blk, 2 * cols.nsl * kTileBytes, [&] {
    for (int c = 0; c < cols.nsl; ++c) {
      tma_load_tile(w.own(0, c, 0), &map_q, m.own_full, h, blk * 64, b, cols.col0 + 32 * c);
      tma_load_tile(w.own(1, c, 0), &map_do, m.own_full, h, blk * 64, b, cols.col0 + 32 * c);
    }
  });

  // two warpgroups over the same 64 queries, taking the live key tiles in
  // turns; a thread's rows of a tile: keys r0 and r0 + 8 of it
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31,
            t4 = lane & 3;
  const int row0 = blk * 64, r0 = warp * 16 + (lane >> 2);
  // the own queries' ids, lse and di: [64] each
  int32_t* qseg = reinterpret_cast<int32_t*>(m.row_values(0, 0));
  float* qlse = m.row_values(1, 0);
  float* qdi = m.row_values(2, 0);
  if (tid < 64) {
    qseg[tid] = segb[row0 + tid];
    qlse[tid] = p.lse[static_cast<long long>(bh) * p.S + row0 + tid];
  }

  // di of the 64 rows from O's and dO's rows in global memory (the whole
  // head dim, in each block of a cluster): four threads a row, 4 columns a
  // load, taking turns, in f32
  {
    const int r = tid >> 2, part = tid & 3;
    const float* orow = p.o + b * p.o_sb + h * p.o_sh + (row0 + r) * p.o_ss;
    const float* drow = p.dout + b * p.do_sb + h * p.do_sh + (row0 + r) * p.do_ss;
    float sum = 0.f;
    for (int col = 4 * part; col < p.D; col += 16) {
      const float4 a = *reinterpret_cast<const float4*>(orow + col);
      const float4 d = *reinterpret_cast<const float4*>(drow + col);
      sum += a.x * d.x + a.y * d.y + a.z * d.z + a.w * d.w;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      qdi[r] = sum;
      if (cols.rank == 0) p.di[static_cast<long long>(bh) * p.S + row0 + r] = sum;
    }
  }

  const float* xk = p.x[0] + b * p.x_sb[0] + h * p.x_sh[0] + cols.col0;  // K, row 0
  const float* xv = p.x[1] + b * p.x_sb[1] + h * p.x_sh[1] + cols.col0;  // V, row 0
  mbar_wait(m.own_full, 0);
  split_own<NS>(w, 2, cols.nsl);
  fence_proxy_async();
  __syncthreads();
  float dq[2][8][4];  // dQ^T, over the warpgroup's tiles
  zero(dq[0]);
  zero(dq[1]);
  Exchange x{m.full + 3 + wg, m.full + 5 + wg, cols.rank, 0};
  if constexpr (Sh::kCTAs > 1) cluster_sync();  // both blocks' barriers are set up
  const int n_live = *m.n_live;
  for (int i = wg; i < n_live + (n_live & 1); i += 2) {
    const bool has = i < n_live;
    const int k0 = m.live[has ? i : 0] * 64;
    float st[8][4], dpt[8][4];
    if (has) {
      heads_wide<NS>(st, dpt, w, xk + k0 * p.x_ss[0], p.x_ss[0], xv + k0 * p.x_ss[1],
                     p.x_ss[1], true, cols.Dl, warp, lane);  // S^T = K Q^T, dP^T = V dO^T
    }
    if (!has) continue;
    if constexpr (Sh::kCTAs > 1) exchange_heads<NS>(st, dpt, w, x, wg);
    p_transposed(st, qlse, qseg, segb[k0 + r0], segb[k0 + r0 + 8], t4, p.scale_log2);
    ds_transposed(dpt, st, qdi, t4, p.scale);
    store_split_t(w.btile(wg), dpt, warp, lane);  // dS
    fence_proxy_async();
    named_sync(1 + wg, 128);
    rows_wide(dq, xk + k0 * p.x_ss[0], p.x_ss[0], w.btile(wg), cols.Dl, warp,
                  lane);  // dQ^T += K^T dS^T
    named_sync(1 + wg, 128);  // the warpgroup's operand tile is free
    if constexpr (Sh::kCTAs > 1) exchange_free(x);
  }
  if constexpr (Sh::kCTAs > 1) cluster_sync();  // the other block's last arrivals have landed
  sum_groups<NS>(dq, w, wg);
  if (wg == 0) {
    store_transposed(p.dq + b * p.g_sb + h * p.g_sh + row0 * p.g_ss + cols.col0, p.g_ss, dq,
                     cols.Dl, warp, lane);
  }
}

// Encode the f32 tensor maps of q, k, v, dO and o (dkv reads no o: its map
// is dO's again) over D columns, boxes of `rows[i]` rows (kT for what a wide
// kernel streams), and launch `kernel` on `blocks` blocks of `threads`
// with `smem` bytes of shared memory, in clusters of `cluster` blocks.
template <typename Kernel>
int launch(Kernel kernel, long long blocks, int threads, int smem, int cluster,
           const int (&rows)[5], const Tf32BwdParams& p, const void* const bases[5],
           const long long* strides, int B, cudaStream_t stream) {
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward on a thread of its own), which the
  // driver's encoder needs
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  CUtensorMap maps[5];
  for (int i = 0; i < 5; ++i) {
    err = encode_tile_map(&maps[i], bases[i], B, p.H, p.S, strides[3 * i], strides[3 * i + 1],
                          strides[3 * i + 2], p.D, true, rows[i]);
    if (err != 0) return err;
  }
  if (cluster == 1) {
    kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(p, maps[0], maps[1], maps[2],
                                                                    maps[3], maps[4]);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, p, maps[0], maps[1], maps[2], maps[3], maps[4]));
}

// box rows of the maps of q, k, v, dO and o by kernel
constexpr int kRows64[5] = {64, 64, 64, 64, 64};

template <int NS>
int launch_dq(const Tf32BwdParams& p, const void* const bases[5], const long long* strides, int B,
              cudaStream_t stream) {
  const long long tiles = static_cast<long long>(B) * p.H * (p.S / 64);
  if constexpr (NS > 2) {
    using Sh = Tf32WideShape<NS>;
    return launch(flash_tf32_bwd_dq_wide_kernel<NS>, tiles * Sh::kCTAs, 256,
                  smem_bytes<1, 1, 0>(p.S, Sh::kOwnDq), Sh::kCTAs, kRows64, p, bases, strides, B,
                  stream);
  } else {
    using Sh = Tf32BwdShape<NS>;
    return launch(flash_tf32_bwd_dq_kernel<NS>, tiles / Sh::kG, Sh::kThreads,
                  smem_bytes<Sh::kStages, Sh::kG, Sh::kPer>(p.S, Sh::kOwn), 1, kRows64, p, bases,
                  strides, B, stream);
  }
}

template <int NS>
int launch_dkv(const Tf32BwdParams& p, const void* const bases[5], const long long* strides,
               int B, cudaStream_t stream) {
  const long long tiles = static_cast<long long>(B) * p.H * (p.S / 64);
  if constexpr (NS > 2) {
    using Sh = Tf32WideShape<NS>;
    return launch(flash_tf32_bwd_dkv_wide_kernel<NS>, tiles * Sh::kCTAs, 256,
                  smem_bytes<1, 1, 0>(p.S, Sh::kOwnDkv), Sh::kCTAs, kRows64, p, bases, strides,
                  B, stream);
  } else {
    using Sh = Tf32BwdShape<NS>;
    return launch(flash_tf32_bwd_dkv_kernel<NS>, tiles / Sh::kG, Sh::kThreads,
                  smem_bytes<Sh::kStages, Sh::kG, Sh::kPer>(p.S, Sh::kOwn), 1, kRows64, p, bases,
                  strides, B, stream);
  }
}

// The wide kernels' streamed operands x0, x1 and their (b, h, s) strides.
void set_streamed(Tf32BwdParams& p, const void* x0, const long long* s0, const void* x1,
                  const long long* s1) {
  p.x[0] = static_cast<const float*>(x0), p.x[1] = static_cast<const float*>(x1);
  p.x_sb[0] = s0[0], p.x_sh[0] = s0[1], p.x_ss[0] = s0[2];
  p.x_sb[1] = s1[0], p.x_sh[1] = s1[1], p.x_ss[1] = s1[2];
}

int fill_params(Tf32BwdParams& p, const int32_t* seg, const float* lse, int H, int S, int D,
                const long long* g_strides, float sm_scale) {
  if (S <= 0 || S % kRows || D < 4 || D > 256 || D % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p = Tf32BwdParams{};
  p.seg = seg;
  p.lse = lse;
  p.g_sb = g_strides[0], p.g_sh = g_strides[1], p.g_ss = g_strides[2];
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return 0;
}

}  // namespace

// strides: (b, h, s) strides in elements of q, k, v, dout and of the
// gradient outputs (which share one layout), in that order (15 values), and
// for dq then those of o (18).  Each entry returns the first CUDA error of
// setting the kernel's shared memory size, encoding its tensor maps and
// launching it (0 = launched).  The caller has checked shapes, dtypes (f32,
// int32 seg, contiguous f32 lse and di), a contiguous D, strides that are
// multiples of 4 elements and 16-byte aligned pointers; D must be a
// multiple of 4 up to 256 and S a multiple of 128.
extern "C" int mfar_flash_attention_bwd_dq_tf32(const void* q, const void* k, const void* v,
                                                const void* o, const void* dout,
                                                const int32_t* seg, const float* lse, void* dq,
                                                float* di, int B, int H, int S, int D,
                                                const long long* strides, float sm_scale,
                                                cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  Tf32BwdParams p;
  int err = fill_params(p, seg, lse, H, S, D, strides + 12, sm_scale);
  if (err != 0) return err;
  p.dq = static_cast<float*>(dq);
  p.di = di;
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.o_sb = strides[15], p.o_sh = strides[16], p.o_ss = strides[17];
  p.do_sb = strides[9], p.do_sh = strides[10], p.do_ss = strides[11];
  set_streamed(p, k, strides + 3, v, strides + 6);
  const void* bases[5] = {q, k, v, dout, o};
  const long long st[15] = {strides[0], strides[1], strides[2], strides[3], strides[4],
                            strides[5], strides[6], strides[7], strides[8], strides[9],
                            strides[10], strides[11], strides[15], strides[16], strides[17]};
  switch ((D + 31) / 32) {
    case 1: return launch_dq<1>(p, bases, st, B, stream);
    case 2: return launch_dq<2>(p, bases, st, B, stream);
    case 3:
    case 4: return launch_dq<4>(p, bases, st, B, stream);
    default: return launch_dq<8>(p, bases, st, B, stream);
  }
}

extern "C" int mfar_flash_attention_bwd_dkv_tf32(const void* q, const void* k, const void* v,
                                                 const void* dout, const int32_t* seg,
                                                 const float* lse, const float* di, void* dk,
                                                 void* dv, int B, int H, int S, int D,
                                                 const long long* strides, float sm_scale,
                                                 cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  Tf32BwdParams p;
  int err = fill_params(p, seg, lse, H, S, D, strides + 12, sm_scale);
  if (err != 0) return err;
  p.di = const_cast<float*>(di);  // read only
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  set_streamed(p, q, strides, dout, strides + 9);
  const void* bases[5] = {q, k, v, dout, dout};
  const long long st[15] = {strides[0], strides[1], strides[2], strides[3], strides[4],
                            strides[5], strides[6], strides[7], strides[8], strides[9],
                            strides[10], strides[11], strides[9], strides[10], strides[11]};
  switch ((D + 31) / 32) {
    case 1: return launch_dkv<1>(p, bases, st, B, stream);
    case 2: return launch_dkv<2>(p, bases, st, B, stream);
    case 3:
    case 4: return launch_dkv<4>(p, bases, st, B, stream);
    default: return launch_dkv<8>(p, bases, st, B, stream);
  }
}
