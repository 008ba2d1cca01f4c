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
// dV += P^T dO, dK += dS^T Q, dQ += dS K) is mma.sync.m16n8k8 on TF32
// operands, three of them a product (hi*hi' + hi*lo' + lo*hi', f32 sums).
// P and dS stay in f32 and are split like any operand: the bf16 kernels
// round them to bf16, which would miss the f32 gates (gradients within 2e-5
// of the largest).  exp2f, not ex2.approx alone.
//
// What bounds it: operations.  At the f32 train step's [96, 12, 512, 64]
// dq's three and dkv's four products over chip_smoke's same-segment pairs
// take 0.48 / 0.64 ms at 495 TFLOP/s / 3 against ~0.18 ms of bytes each
// (at D = 128, 0.96 / 1.28 ms against 0.54).
// As in the forward, the tensor cores are not what limits it: each warp
// splits every streamed value it reads (five integer and float operations
// a value), eight warps the same tile, so it is bound by its instruction
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
// Wide head dims (D 68-256; Tf32BwdShape): the split-once own slabs (4 NS
// a warpgroup) and two warpgroups would pass 227 KB, so a block is one
// warpgroup of 64 rows holding its two own operands raw (2 NS slabs, each
// A fragment split at use, as the f32 forward splits Q) and streaming the
// other side in 32-row halves of a tile (tensor maps with 32-row boxes): a
// stage holds NS slabs' worth, two stages at NS = 4 and one at NS = 8 (16
// own slabs and one stage, 192 KB).  Two instances only, NS = 4 for D
// 68-128 and NS = 8 for D 132-256 (each instance of this shape adds
// seconds to the build): slabs wholly past D are TMA's zero fill, computed
// like the rest, and the stores stop at D.  Per half: the
// products over 4 n-tiles (S, dP) or 4 k steps (dQ, dV, dK) of 8 rows.  dq
// reads O's and dO's rows for di from global memory.  dkv's dK and dV (4 NS
// x 4 registers a thread each, 256 at NS = 8) would not both fit: its grid
// has two blocks a key tile, one summing dV (S^T, P^T, dV += P^T dO, no V
// read), the other dK (S^T, dP^T, dS^T, dK += dS^T Q), each writing its
// own gradient.
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
  long long g_sb, g_sh, g_ss;  // strides of the gradients (one layout for all)
  int H, S, D;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

// The block by NS slabs of 32 f32 columns.  Up to NS = 2: two warpgroups,
// the own slabs a warpgroup the raw ones, then the split operands over them
// (4 NS slabs hold two operands' hi and lo), 64-row streamed tiles; stages
// of the ring 3 at NS = 1, 2 at NS = 2 (three would pass 227 KB).  Wide
// (NS = 4 and 8, D 68-256): one warpgroup, the own slabs raw (2 NS, split
// at use), the streamed tiles in 32-row halves (a stage's kPer 8 KB tiles
// hold two operands' NS half slabs), two stages at NS = 4 and one at NS = 8
// (192 KB, where two would pass 227 KB), and dkv's grid split in
// two blocks a key tile, one summing dV, the other dK (both would take 8 NS
// x 4 registers a thread).
template <int NS>
struct Tf32BwdShape {
  static constexpr bool kWide = NS > 2;
  static constexpr int kG = kWide ? 1 : 2;
  static constexpr int kThreads = 128 * kG;
  static constexpr int kStages = NS == 1 ? 3 : NS <= 4 ? 2 : 1;
  static constexpr int kOwn = kWide ? 2 * NS : 4 * NS;
  static constexpr int kPer = kWide ? NS : 2 * NS;
};

template <int NS>
using Tf32Ring = Smem<Tf32BwdShape<NS>::kStages, Tf32BwdShape<NS>::kG, Tf32BwdShape<NS>::kPer>;

__device__ __forceinline__ const float* as_f32(const __nv_bfloat16* t) {
  return reinterpret_cast<const float*>(t);
}

constexpr int kSlabFloats = kTileElems / 2;  // a [64][32] f32 slab: one 8 KB tile

// Half slab j (32 rows of 32 f32, 4 KB) of a wide kernel's stage.
template <class Ring>
__device__ __forceinline__ __nv_bfloat16* half_slab(const Ring& m, int stage, int j) {
  return m.stream_tile(stage, 0) + j * (kTileElems / 2);
}

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

// d[j] = A B_j^T over the head dim for the NJ n-tiles j (rows 8j..8j+7) of
// a streamed tile, where a wide kernel holds its own operands raw: A the
// warp's 16 rows of the own operand whose NS slabs start at a, split at use
// (the raw fragments gemm_heads reads pre-split), B the tile's NS slabs of
// the other from b, `stride` floats apart; both K-major.
template <int NS, int NJ>
__device__ __forceinline__ void gemm_head(float (&d)[NJ][4], const float* a, const float* b,
                                          int stride, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < NJ; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  // a slab's four k steps unrolled at a time (a whole unroll lengthens
  // this file's build)
#pragma unroll 4
  for (int kk = 0; kk < 4 * NS; ++kk) {
    const float* at = a + (kk >> 2) * kSlabFloats;
    const float* bt = b + (kk >> 2) * stride;
    const int c = kcol(kk, t4);
    const float2 u = ld2(at, r0, c), w = ld2(at, r0 + 8, c);
    uint32_t a_hi[4], a_lo[4];
    split(u.x, a_hi[0], a_lo[0]);  // a0 (g, k t4)
    split(w.x, a_hi[1], a_lo[1]);  // a1 (g + 8, k t4)
    split(u.y, a_hi[2], a_lo[2]);  // a2 (g, k t4 + 4)
    split(w.y, a_hi[3], a_lo[3]);  // a3 (g + 8, k t4 + 4)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 x = ld2(bt, 8 * j + g, c);
      uint32_t b_hi[2], b_lo[2];
      split(x.x, b_hi[0], b_lo[0]);
      split(x.y, b_hi[1], b_lo[1]);
      mma_3xtf32(d[j], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// A wide kernel's walk over its streamed tiles (one warpgroup a block, which
// issues the loads): position i of the live list's halves is tile live[i /
// 2], rows 32 (i % 2) on, in stage i % kStages; `load(t, half, stage)`
// starts a position's loads (`bytes` in all).  set_up has loaded position
// 0; thread 0 loads the next ones into the free stages, then each further
// position into the stage the warpgroup has just left.  `body(stage)` runs
// the products of each position.  (A listed tile meets the warpgroup's
// rows: they are the block's.)
template <int kStages, int kPer, typename Load, typename Body>
__device__ __forceinline__ void walk_halves(const Smem<kStages, 1, kPer>& m, uint32_t bytes,
                                            Load load, Body body) {
  const int n = 2 * *m.n_live;
  if (threadIdx.x == 0) {
    for (int i = 1; i < min(kStages, n); ++i) {
      mbar_expect_tx(&m.full[i], bytes);
      load(m.live[i / 2], i % 2, i);
    }
  }
  for (int i = 0; i < n; ++i) {
    m.wait_full(i);
    body(i % kStages);
    named_sync(1, 128);
    const int next = i + kStages;
    if (threadIdx.x == 0 && next < n) {
      mbar_expect_tx(&m.full[i % kStages], bytes);
      load(m.live[next / 2], next % 2, i % kStages);
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(128, 1)
    flash_tf32_bwd_dkv_wide_kernel(const Tf32BwdParams p,
                                   const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __grid_constant__ CUtensorMap map_do,
                                   const __grid_constant__ CUtensorMap) {
  using Sh = Tf32BwdShape<NS>;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // the warpgroup's K slabs, then its V slabs; a stage holds Q's half
  // slabs, then dO's
  const Tf32Ring<NS> m = carve<Sh::kStages, 1, Sh::kPer>(smem_raw, n_tiles, Sh::kOwn);
  const int blk = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const float* lseg = p.lse + static_cast<long long>(bh) * p.S;
  const float* dig = p.di + static_cast<long long>(bh) * p.S;
  const bool sums_dv = blockIdx.y == 0;  // else dK; a dV block reads no V

  // half `half` of query tile t into a stage: Q's and dO's 32 rows, and the
  // queries' lse, di and segment ids
  const uint32_t bytes = NS * kTileBytes + 3 * 128;
  auto load = [&](int t, int half, int stage) {
    const int row = t * 64 + 32 * half;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(half_slab(m, stage, c), &map_q, &m.full[stage], h, row, b, 32 * c);
      tma_load_tile(half_slab(m, stage, NS + c), &map_do, &m.full[stage], h, row, b, 32 * c);
    }
    bulk_load(m.row_values(0, stage), lseg + row, 128, &m.full[stage]);
    bulk_load(m.row_values(1, stage), dig + row, 128, &m.full[stage]);
    bulk_load(m.row_values(2, stage), segb + row, 128, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, (sums_dv ? 1 : 2) * NS * kTileBytes, [&] {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.own_tile(c, 0), &map_k, m.own_full, h, blk * 64, b, 32 * c);
      if (!sums_dv) tma_load_tile(m.own_tile(NS + c, 0), &map_v, m.own_full, h, blk * 64, b, 32 * c);
    }
  }, bytes, [&](int t, int stage) { load(t, 0, stage); }, 0);

  // one warpgroup of 64 keys (16 a warp)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int key0 = blk * 64, r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  const int seg_k0 = segb[key0 + r0], seg_k1 = segb[key0 + r0 + 8];
  const float* k_own = as_f32(m.own_tile(0, 0));
  const float* v_own = as_f32(m.own_tile(NS, 0));
  mbar_wait(m.own_full, 0);
  float acc[4 * NS][4];  // dV or dK
  zero_acc<NS>(acc);
  if (sums_dv) {
    walk_halves(m, bytes, load, [&](int stage) {
      const float* qt = as_f32(half_slab(m, stage, 0));
      float st[4][4];
      gemm_head<NS, 4>(st, k_own, qt, kSlabFloats / 2, warp, lane);  // S^T = K Q^T
      p_transposed(st, m.row_values(0, stage),
                   reinterpret_cast<const int32_t*>(m.row_values(2, stage)), seg_k0, seg_k1, t4,
                   p.scale_log2);
      gemm_rows<NS, 4>(acc, st, as_f32(half_slab(m, stage, NS)), kSlabFloats / 2,
                       lane);  // dV += P^T dO
    });
  } else {
    walk_halves(m, bytes, load, [&](int stage) {
      const float* qt = as_f32(half_slab(m, stage, 0));
      const float* dot = as_f32(half_slab(m, stage, NS));
      float st[4][4], dpt[4][4];
      gemm_head<NS, 4>(st, k_own, qt, kSlabFloats / 2, warp, lane);    // S^T = K Q^T
      gemm_head<NS, 4>(dpt, v_own, dot, kSlabFloats / 2, warp, lane);  // dP^T = V dO^T
      p_transposed(st, m.row_values(0, stage),
                   reinterpret_cast<const int32_t*>(m.row_values(2, stage)), seg_k0, seg_k1, t4,
                   p.scale_log2);
      ds_transposed(dpt, st, m.row_values(1, stage), t4, p.scale);
      gemm_rows<NS, 4>(acc, dpt, qt, kSlabFloats / 2, lane);  // dK += dS^T Q
    });
  }
  store_acc<NS>((sums_dv ? p.dv : p.dk) + b * p.g_sb + h * p.g_sh + (key0 + r0) * p.g_ss,
                p.g_ss, acc, t4, p.D);
}

template <int NS>
__global__ void __launch_bounds__(128, 1)
    flash_tf32_bwd_dq_wide_kernel(const Tf32BwdParams p, const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const __grid_constant__ CUtensorMap) {
  using Sh = Tf32BwdShape<NS>;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // the warpgroup's Q slabs, then its dO slabs; a stage holds K's half
  // slabs, then V's
  const Tf32Ring<NS> m = carve<Sh::kStages, 1, Sh::kPer>(smem_raw, n_tiles, Sh::kOwn);
  const int blk = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;

  // half `half` of key tile t into a stage: K's and V's 32 rows and the
  // keys' segment ids
  const uint32_t bytes = NS * kTileBytes + 128;
  auto load = [&](int t, int half, int stage) {
    const int row = t * 64 + 32 * half;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(half_slab(m, stage, c), &map_k, &m.full[stage], h, row, b, 32 * c);
      tma_load_tile(half_slab(m, stage, NS + c), &map_v, &m.full[stage], h, row, b, 32 * c);
    }
    bulk_load(m.row_values(0, stage), segb + row, 128, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, 2 * NS * kTileBytes, [&] {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.own_tile(c, 0), &map_q, m.own_full, h, blk * 64, b, 32 * c);
      tma_load_tile(m.own_tile(NS + c, 0), &map_do, m.own_full, h, blk * 64, b, 32 * c);
    }
  }, bytes, [&](int t, int stage) { load(t, 0, stage); }, 0);

  // one warpgroup of 64 queries (16 a warp)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = blk * 64, r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float* di_s = m.row_values(1, 0);              // [64]: the block's di

  // di of the 64 rows from O's and dO's rows in global memory: two threads
  // a row, 4 columns a load, the halves taking turns, in f32
  {
    const int r = tid >> 1, half = tid & 1;
    const float* orow = p.o + b * p.o_sb + h * p.o_sh + (row0 + r) * p.o_ss;
    const float* drow = p.dout + b * p.do_sb + h * p.do_sh + (row0 + r) * p.do_ss;
    float sum = 0.f;
    for (int col = 4 * half; col < p.D; col += 8) {
      const float4 a = *reinterpret_cast<const float4*>(orow + col);
      const float4 d = *reinterpret_cast<const float4*>(drow + col);
      sum += a.x * d.x + a.y * d.y + a.z * d.z + a.w * d.w;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      di_s[r] = sum;
      p.di[static_cast<long long>(bh) * p.S + row0 + r] = sum;
    }
  }
  named_sync(1, 128);

  const long long rows = static_cast<long long>(bh) * p.S + row0 + r0;
  const int seg_q0 = segb[row0 + r0], seg_q1 = segb[row0 + r0 + 8];
  const float lse0 = p.lse[rows] * kLog2e, lse1 = p.lse[rows + 8] * kLog2e;
  const float di0 = di_s[r0], di1 = di_s[r0 + 8];
  const float* q_own = as_f32(m.own_tile(0, 0));
  const float* do_own = as_f32(m.own_tile(NS, 0));
  mbar_wait(m.own_full, 0);
  float dq[4 * NS][4];
  zero_acc<NS>(dq);
  walk_halves(m, bytes, load, [&](int stage) {
    const float* kt = as_f32(half_slab(m, stage, 0));
    float s[4][4], dp[4][4];
    gemm_head<NS, 4>(s, q_own, kt, kSlabFloats / 2, warp, lane);  // S = Q K^T
    gemm_head<NS, 4>(dp, do_own, as_f32(half_slab(m, stage, NS)), kSlabFloats / 2, warp,
                     lane);  // dP = dO V^T
    ds_rows(s, dp, reinterpret_cast<const int32_t*>(m.row_values(0, stage)), seg_q0, seg_q1,
            lse0, lse1, di0, di1, t4, p.scale, p.scale_log2);
    gemm_rows<NS, 4>(dq, s, kt, kSlabFloats / 2, lane);  // dQ += dS K
  });

  store_acc<NS>(p.dq + b * p.g_sb + h * p.g_sh + (row0 + r0) * p.g_ss, p.g_ss, dq, t4, p.D);
}

// Encode the f32 tensor maps of q, k, v, dO and o (dkv reads no o: its map
// is dO's again) over D columns, boxes of `rows[i]` rows (32 for what a
// wide kernel streams), and launch `kernel` with `parts` blocks a row tile.
template <int NS, typename Kernel>
int launch(Kernel kernel, int parts, const int (&rows)[5], const Tf32BwdParams& p,
           const void* const bases[5], const long long* strides, int B, cudaStream_t stream) {
  using Sh = Tf32BwdShape<NS>;
  const long long blocks = static_cast<long long>(B) * p.H * (p.S / (64 * Sh::kG));
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward on a thread of its own), which the
  // driver's encoder needs
  const int smem = smem_bytes<Sh::kStages, Sh::kG, Sh::kPer>(p.S, Sh::kOwn);
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  CUtensorMap maps[5];
  for (int i = 0; i < 5; ++i) {
    err = encode_tile_map(&maps[i], bases[i], B, p.H, p.S, strides[3 * i], strides[3 * i + 1],
                          strides[3 * i + 2], p.D, true, rows[i]);
    if (err != 0) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), parts), Sh::kThreads, smem, stream>>>(
      p, maps[0], maps[1], maps[2], maps[3], maps[4]);
  return static_cast<int>(cudaGetLastError());
}

// box rows of the maps of q, k, v, dO and o by kernel
constexpr int kRows64[5] = {64, 64, 64, 64, 64};
constexpr int kDqWideRows[5] = {64, 32, 32, 64, 64};
constexpr int kDkvWideRows[5] = {32, 64, 64, 32, 32};

template <int NS>
int launch_dq(const Tf32BwdParams& p, const void* const bases[5], const long long* strides, int B,
              cudaStream_t stream) {
  if constexpr (Tf32BwdShape<NS>::kWide) {
    return launch<NS>(flash_tf32_bwd_dq_wide_kernel<NS>, 1, kDqWideRows, p, bases, strides, B,
                      stream);
  } else {
    return launch<NS>(flash_tf32_bwd_dq_kernel<NS>, 1, kRows64, p, bases, strides, B, stream);
  }
}

template <int NS>
int launch_dkv(const Tf32BwdParams& p, const void* const bases[5], const long long* strides,
               int B, cudaStream_t stream) {
  if constexpr (Tf32BwdShape<NS>::kWide) {
    return launch<NS>(flash_tf32_bwd_dkv_wide_kernel<NS>, 2, kDkvWideRows, p, bases, strides, B,
                      stream);
  } else {
    return launch<NS>(flash_tf32_bwd_dkv_kernel<NS>, 1, kRows64, p, bases, strides, B, stream);
  }
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
