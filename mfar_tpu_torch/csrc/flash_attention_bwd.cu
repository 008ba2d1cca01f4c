// Kernel K2b: the backward of kernel K2 (flash_attention.cu), written for
// Hopper (sm_90a), for bf16 at every head dim up to 256 whose rows TMA can
// read (D a multiple of 8).  Two kernels, launched in this order:
//
//   dq:  di = sum_d O * dO (f32), written out,   dQ = dS K
//   dkv: dV = P^T dO,  dK = dS^T Q               (reads dq's di)
//
// with  P  = exp(Q K^T * sm_scale - lse)  on same-segment pairs, 0 elsewhere,
//       dS = P * (dO V^T - di) * sm_scale,
// lse the forward's row logsumexp (natural units, written by K2 under
// training).  q/k/v/o/dO are bf16 [B, H, S, D] read through their strides
// (D contiguous; the others multiples of 16 bytes), seg int32 [B, S], lse and
// di contiguous f32 [B, H, S]; the gradients are bf16 (q's dtype, as JAX
// writes them) into [B, H, S, D] views with their own strides, so the
// encoder's head split costs no copy.  bf16 that TMA cannot read (e.g.
// TinyBERT-4L-312D's 52-byte rows at D = 26) reaches these kernels as
// zero-padded copies at D rounded up to 8 (the "wgmma_pad" route of
// ops/flash_attention.py).  f32 takes flash_attention_tf32_bwd.cu.
//
// Replaces the two Pallas kernels of the VJP of JAX's library
// flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py,
// jax 0.9.0): _flash_attention_bwd_dkv (pl.pallas_call at :1121, body
// _flash_attention_dkv_kernel :796) and _flash_attention_bwd_dq (:1456,
// body :1146), reached when mfar_tpu/models/encoder.py:170 is
// differentiated; and the row dots di that JAX computes outside Pallas
// (:273-275).  The TPU kernels walk a sequential grid and carry dK/dV (or
// dQ) in scratch memory from one grid step to the next; here each block
// loops over the other axis itself and keeps its sums in registers, so no
// block writes what another writes: no atomics, and the gradients are the
// same from run to run.  The ds output of the TPU's dq kernel (the gradient
// of an attention bias) is not computed: the encoder passes no bias.
//
// Design:
//   block = kG consumer warpgroups of 64 rows each (keys in dkv, queries in
//           dq) and a producer warpgroup whose one thread issues every load;
//           it keeps 24 registers a thread and the consumers take the rest
//           (setmaxnreg).  One block an SM; the grid is (b, h)-major, so the
//           blocks of one head run together and find its K/V (or Q/dO) in
//           L2.  kG = 2 (128 rows, S % 128 == 0) up to D = 128, 1 past it
//           (BwdShape).
//   loads: TMA (4-D tensor maps over the [B, S, H, D] buffers, encoded on
//        the host each call, 128-byte swizzle) into the layout wgmma's
//        descriptors read; the row values (lse, di, segment ids) by bulk
//        copy.  The block's own tiles land on one mbarrier; the streamed
//        tiles go through a ring of two stages (full / empty mbarriers).
//        The block structure, the ring, the live-tile list and the tensor
//        maps are hopper_pipeline.cuh's, shared with K2.
//   head dims: both kernels are templated on NS = ceil(D / 64) slabs of 64
//        columns (1 to 4), each slab one 64 x 64 tile (as K2's forward).
//        The tensor maps span D columns with a 64-wide box, so the columns
//        of the last slab past D arrive as zeros: S and dP (summed over the
//        slabs) are exact, the gradients' columns past D are 0, and the
//        stores stop at D (a slab's 64 columns would run into the next
//        head's).  D < 64 runs D = 64's products.  NS = 1 is the D = 64
//        kernel as it was; past it the warpgroup's own tiles are read as
//        shared-memory operands of wgmma (SS) where NS = 1 holds them as A
//        registers: dK, dV and their operands' fragments would pass the
//        consumers' registers.
//   wide head dims (NS = 3, 4: D 136-256): what a block holds grows with
//        D, so the block shrinks.  One consumer warpgroup (64 rows), which
//        takes up to 256 registers a thread.  dq holds Q and dO (2 NS
//        tiles; the ring 4 NS: 192 KB at NS = 4) and reads O's rows for di
//        from global memory, where kG = 2 holds O's tiles too.  dkv would
//        hold dK and dV (2 x 32 NS registers) beside S^T and dP^T, past the
//        registers at NS >= 3: its grid has two blocks a key tile, one
//        summing dV (from P^T alone), the other dK, each computing S^T
//        itself; each writes its own gradient, so the rule above holds.
//   dkv: each consumer's K and V tiles stay put (bf16 A registers at NS =
//        1); 64-query tiles of Q and dO with their lse, di and segment ids
//        stream.  Per tile: S^T = K Q^T and dP^T = V dO^T (B the Q / dO
//        tile, K-major), P^T and dS^T packed to bf16 A registers, dV += P^T
//        dO and dK += dS^T Q (B the dO / Q tile, MN-major), one accumulator
//        a slab.
//   dq:  each consumer's Q and dO tiles (and, at kG = 2, O's) stay put; it
//        first computes di for its rows and writes it out for dkv.  64-key
//        tiles of K and V with their segment ids stream.  Per tile: S = Q
//        K^T, dP = dO V^T, dS as bf16 A registers, dQ += dS K (K MN-major).
//   Every product is wgmma.m64n64k16 (bf16 in, f32 accumulate; see
//   hopper_common.cuh for the layouts and descriptors).  P and dS are
//   rounded to bf16 for the products they feed, as the TPU kernels do;
//   exp2 is the special-function unit's ex2.approx.
//
// Masking: JAX adds its finite mask value and relies on exp underflowing;
// here a cross-segment entry of P (and so of dS) is set to exactly 0, so no
// masked logit is ever scaled (which would overflow in log2 units, as in
// K2) and no NaN can arise.  Every row has at least its own key, so lse is
// finite.  Skipping: a block takes the min and max segment id of every
// 64-row tile of its batch row and walks only the streamed tiles whose
// [min, max] meets that of its own rows (a warpgroup skips the products of
// a walked tile that misses its own 64 rows); every P entry of a skipped
// pair of tiles is 0, so the skip is exact.  Pads attend pads, so pad x pad
// tiles stay live, and a block's own tiles always are; they come first, so
// their loads start before the list is known.
//
// What bounds it (at the training shape [96, 12, 512, 64] bf16, the
// train step's lengths): q/k/v/o/dO are 75.5 MB each.  dq reads q, k, v,
// o, dO, lse and writes dQ and di: ~460 MB, 0.137 ms at 3.35 TB/s; dkv
// reads q, k, v, dO, lse, di and writes dK, dV: ~460 MB, 0.137 ms.  Their
// three and four products over the same-segment pairs take less at 989
// TFLOP/s, so bytes bound both.  What holds them back is not the bytes:
// with no per-tile work at all (flash_variants.py --kernel k2b
// x_nocompute) the kernels still take ~0.19-0.20 ms, the latency of each
// block's own tiles and first streamed tiles with one block an SM, and the
// products add to that time instead of hiding under it (see PERF.md).  At
// D = 32 (all-MiniLM-L6-v2's heads) the bytes halve while the products and
// the latency do not, so the pair takes D = 64's time.  At D = 256 bytes
// still bound both on paper (6 x 302 MB at [96, 12, 512, 256] against 3 or
// 4 products), but one warpgroup a block streams each K/V (or Q/dO) tile
// twice as often from L2 and the split dkv computes S^T twice.

#include <climits>

#include "hopper_pipeline.cuh"

namespace {

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const int32_t* seg;
  const float* lse;  // [B, H, S]
  float* di;         // [B, H, S]: written by dq, read by dkv
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
  long long g_sb, g_sh, g_ss;  // strides of the gradients (one layout for all)
  long long o_sb, o_sh, o_ss;
  int H, S, D;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

constexpr int kStages = 2;  // of the ring of streamed tiles

// The block by NS slabs of 64 columns (see the design above): kG consumer
// warpgroups and their registers a thread; dq's own tiles (Q, dO, and O
// where kG = 2) and dkv's (K, V); kSplit: a dkv block sums dV or dK.
template <int NS>
struct BwdShape {
  static constexpr int kG = NS <= 2 ? 2 : 1;
  static constexpr int kThreads = 128 * kG + 128;
  static constexpr int kRegs = kG == 2 ? kConsumerRegs : 256;
  static constexpr bool kOwnO = kG == 2;
  static constexpr int kOwnDq = kOwnO ? 3 * NS : 2 * NS, kOwnDkv = 2 * NS;
  static constexpr bool kSplit = NS > 2;
};

// each consumer's own tiles (NS slabs an operand) and a stage's streamed
// tiles (two operands of NS slabs)
template <int NS>
using Ring = Smem<kStages, BwdShape<NS>::kG, 2 * NS>;

// d = A B^T over the head dim (d's old value dropped at NS > 1; at NS = 1
// the caller zeroes d), A the warpgroup's own 64 rows and B a streamed
// tile, both K-major: at one slab A from registers (af, loaded once), past
// it from the own tile's NS slabs in shared memory (a), where NS x 32
// registers of fragments would not fit beside the accumulators.
template <int NS>
__device__ __forceinline__ void gemm_own_smem(float (&d)[8][4], const uint64_t (&a)[NS],
                                              const uint64_t (&b)[NS]) {
  gemm_ss_new(d, a[0], b[0]);
#pragma unroll
  for (int c = 1; c < NS; ++c) gemm_ss_new<true>(d, a[c], b[c]);
}
template <int NS>
__device__ __forceinline__ void gemm_own(float (&d)[8][4], const uint32_t (&af)[4][4],
                                         const uint64_t (&a)[NS], const uint64_t (&b)[NS]) {
  if constexpr (NS == 1) {
    gemm_rs<0>(d, af, b[0]);
  } else {
    gemm_own_smem<NS>(d, a, b);
  }
}

// P^T = exp2(S^T * sm_scale * log2 e - lse * log2 e) in place of S^T (rows
// = this thread's keys, of segments seg_k0 / seg_k1; columns = the tile's
// queries) on same-segment pairs, exactly 0 elsewhere.
__device__ __forceinline__ void p_transposed(float (&st)[8][4], const float* lse_t,
                                             const int32_t* seg_t, int seg_k0, int seg_k1,
                                             int t4, float scale_log2) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;  // the tile's queries c and c + 1
    const int sq0 = seg_t[c], sq1 = seg_t[c + 1];
    const float l0 = lse_t[c] * kLog2e, l1 = lse_t[c + 1] * kLog2e;
    st[n][0] = sq0 == seg_k0 ? exp2_approx(st[n][0] * scale_log2 - l0) : 0.f;
    st[n][1] = sq1 == seg_k0 ? exp2_approx(st[n][1] * scale_log2 - l1) : 0.f;
    st[n][2] = sq0 == seg_k1 ? exp2_approx(st[n][2] * scale_log2 - l0) : 0.f;
    st[n][3] = sq1 == seg_k1 ? exp2_approx(st[n][3] * scale_log2 - l1) : 0.f;
  }
}

// A 64-row accumulator packed to bf16 A registers, its columns as the next
// product's k (hopper_common.cuh).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n >> 1][(n & 1) * 2] = pack_bf16(x[n][0], x[n][1]);
    a[n >> 1][(n & 1) * 2 + 1] = pack_bf16(x[n][2], x[n][3]);
  }
}

// dS^T = P^T (dP^T - di) * sm_scale as bf16 A registers (columns = the
// tile's queries, whose di are di_t).
__device__ __forceinline__ void pack_ds_transposed(uint32_t (&dsf)[4][4], const float (&st)[8][4],
                                                   const float (&dpt)[8][4], const float* di_t,
                                                   int t4, float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;
    const float d0 = di_t[c], d1 = di_t[c + 1];
    dsf[n >> 1][(n & 1) * 2] =
        pack_bf16(st[n][0] * (dpt[n][0] - d0) * scale, st[n][1] * (dpt[n][1] - d1) * scale);
    dsf[n >> 1][(n & 1) * 2 + 1] =
        pack_bf16(st[n][2] * (dpt[n][2] - d0) * scale, st[n][3] * (dpt[n][3] - d1) * scale);
  }
}

// One streamed tile of 64 queries against the warpgroup's 64 keys: dV +=
// P^T dO, dK += dS^T Q, one accumulator a slab.  K and V are kf, vf (A
// registers) at one slab, their own tiles (k_own, v_own) past it; qd, dod
// are the tile's Q and dO slabs.  seg_k0/1 are the segment ids of this
// thread's two keys (rows g and g + 8 of its warp's 16).
template <int NS>
__device__ __forceinline__ void dkv_tile(float (&dk)[NS][8][4], float (&dv)[NS][8][4],
                                         const uint32_t (&kf)[4][4], const uint32_t (&vf)[4][4],
                                         const uint64_t (&k_own)[NS], const uint64_t (&v_own)[NS],
                                         const uint64_t (&qd)[NS], const uint64_t (&dod)[NS],
                                         const float* lse_t, const float* di_t,
                                         const int32_t* seg_t, int seg_k0, int seg_k1, int t4,
                                         float scale, float scale_log2) {
  float st[8][4], dpt[8][4];
  if constexpr (NS == 1) {
    zero(st);
    zero(dpt);
  }
  wgmma_fence();
  gemm_own<NS>(st, kf, k_own, qd);  // S^T = K Q^T
  wgmma_commit();
  gemm_own<NS>(dpt, vf, v_own, dod);  // dP^T = V dO^T
  wgmma_commit();
  wgmma_wait<1>();
  pin(st);

  // P^T on same-segment pairs, exactly 0 elsewhere; bf16 A registers (rows
  // = keys) for P^T dO
  p_transposed(st, lse_t, seg_t, seg_k0, seg_k1, t4, scale_log2);
  uint32_t pf[4][4];
  pack_a(pf, st);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NS; ++c) gemm_rs<1>(dv[c], pf, dod[c]);  // dV += P^T dO
  wgmma_commit();
  // past one slab dV's product ends here, so P^T's registers are free for
  // dS^T's (dK, dV, S^T and dP^T alone take 64 NS + 64 registers)
  wgmma_wait<NS == 1 ? 1 : 0>();
  pin(dpt);
  if constexpr (NS > 1) pin(pf);

  uint32_t dsf[4][4];
  pack_ds_transposed(dsf, st, dpt, di_t, t4, scale);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NS; ++c) gemm_rs<1>(dk[c], dsf, qd[c]);  // dK += dS^T Q
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (NS == 1) pin(pf);
  pin(dsf);
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    pin(dv[c]);
    pin(dk[c]);
  }
}

// dkv_tile's two halves on a split grid (BwdShape::kSplit), NS > 1: a
// block's warpgroup sums dV (dv_tile: S^T, P^T, dV += P^T dO) or dK
// (dk_tile: S^T, dP^T, dS^T, dK += dS^T Q) over the same streamed tiles,
// with dkv_tile's arithmetic.
template <int NS>
__device__ __forceinline__ void dv_tile(float (&dv)[NS][8][4], const uint64_t (&k_own)[NS],
                                        const uint64_t (&qd)[NS], const uint64_t (&dod)[NS],
                                        const float* lse_t, const int32_t* seg_t, int seg_k0,
                                        int seg_k1, int t4, float scale_log2) {
  float st[8][4];
  wgmma_fence();
  gemm_own_smem<NS>(st, k_own, qd);  // S^T = K Q^T
  wgmma_commit();
  wgmma_wait<0>();
  pin(st);
  p_transposed(st, lse_t, seg_t, seg_k0, seg_k1, t4, scale_log2);
  uint32_t pf[4][4];
  pack_a(pf, st);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NS; ++c) gemm_rs<1>(dv[c], pf, dod[c]);  // dV += P^T dO
  wgmma_commit();
  wgmma_wait<0>();
  pin(pf);
#pragma unroll
  for (int c = 0; c < NS; ++c) pin(dv[c]);
}

template <int NS>
__device__ __forceinline__ void dk_tile(float (&dk)[NS][8][4], const uint64_t (&k_own)[NS],
                                        const uint64_t (&v_own)[NS], const uint64_t (&qd)[NS],
                                        const uint64_t (&dod)[NS], const float* lse_t,
                                        const float* di_t, const int32_t* seg_t, int seg_k0,
                                        int seg_k1, int t4, float scale, float scale_log2) {
  float st[8][4], dpt[8][4];
  wgmma_fence();
  gemm_own_smem<NS>(st, k_own, qd);  // S^T = K Q^T
  wgmma_commit();
  gemm_own_smem<NS>(dpt, v_own, dod);  // dP^T = V dO^T
  wgmma_commit();
  wgmma_wait<1>();
  pin(st);
  p_transposed(st, lse_t, seg_t, seg_k0, seg_k1, t4, scale_log2);
  wgmma_wait<0>();
  pin(dpt);
  uint32_t dsf[4][4];
  pack_ds_transposed(dsf, st, dpt, di_t, t4, scale);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NS; ++c) gemm_rs<1>(dk[c], dsf, qd[c]);  // dK += dS^T Q
  wgmma_commit();
  wgmma_wait<0>();
  pin(dsf);
#pragma unroll
  for (int c = 0; c < NS; ++c) pin(dk[c]);
}

// One streamed tile of 64 keys against the warpgroup's 64 queries: dQ +=
// dS K, one accumulator a slab.  Q and dO are qf, df (A registers) at one
// slab, their own tiles (q_own, do_own) past it; kd, vd are the tile's K
// and V slabs.  seg_q0/1, lse0/1 (log2 units) and di0/1 belong to this
// thread's two query rows.
template <int NS>
__device__ __forceinline__ void dq_tile(float (&dq)[NS][8][4], const uint32_t (&qf)[4][4],
                                        const uint32_t (&df)[4][4], const uint64_t (&q_own)[NS],
                                        const uint64_t (&do_own)[NS], const uint64_t (&kd)[NS],
                                        const uint64_t (&vd)[NS], const int32_t* seg_t,
                                        int seg_q0, int seg_q1, float lse0, float lse1, float di0,
                                        float di1, int t4, float scale, float scale_log2) {
  float s[8][4], dpm[8][4];
  if constexpr (NS == 1) {
    zero(s);
    zero(dpm);
  }
  wgmma_fence();
  gemm_own<NS>(s, qf, q_own, kd);  // S = Q K^T
  wgmma_commit();
  gemm_own<NS>(dpm, df, do_own, vd);  // dP = dO V^T
  wgmma_commit();
  wgmma_wait<1>();
  pin(s);

  // P, exactly 0 across segments (in place of S)
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;  // the tile's keys c and c + 1
    const int sk0 = seg_t[c], sk1 = seg_t[c + 1];
    s[n][0] = sk0 == seg_q0 ? exp2_approx(s[n][0] * scale_log2 - lse0) : 0.f;
    s[n][1] = sk1 == seg_q0 ? exp2_approx(s[n][1] * scale_log2 - lse0) : 0.f;
    s[n][2] = sk0 == seg_q1 ? exp2_approx(s[n][2] * scale_log2 - lse1) : 0.f;
    s[n][3] = sk1 == seg_q1 ? exp2_approx(s[n][3] * scale_log2 - lse1) : 0.f;
  }
  wgmma_wait<0>();
  pin(dpm);

  // dS = P (dP - di) * sm_scale as bf16 A registers (rows = queries)
  uint32_t dsf[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dsf[n >> 1][(n & 1) * 2] =
        pack_bf16(s[n][0] * (dpm[n][0] - di0) * scale, s[n][1] * (dpm[n][1] - di0) * scale);
    dsf[n >> 1][(n & 1) * 2 + 1] =
        pack_bf16(s[n][2] * (dpm[n][2] - di1) * scale, s[n][3] * (dpm[n][3] - di1) * scale);
  }
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NS; ++c) gemm_rs<1>(dq[c], dsf, kd[c]);  // dQ += dS K
  wgmma_commit();
  wgmma_wait<0>();
  pin(dsf);
#pragma unroll
  for (int c = 0; c < NS; ++c) pin(dq[c]);
}

template <int NS>
__global__ void __launch_bounds__(BwdShape<NS>::kThreads, 1)
    flash_attention_bwd_dkv_kernel(const BwdParams p, const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __grid_constant__ CUtensorMap map_do,
                                   const __grid_constant__ CUtensorMap) {
  using Sh = BwdShape<NS>;
  constexpr int kG = Sh::kG;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // each consumer's K slabs, then its V slabs; a stage holds Q's slabs, then dO's
  const Ring<NS> m = carve<kStages, kG, 2 * NS>(smem_raw, n_tiles, Sh::kOwnDkv);
  const int blocks = p.S / (64 * kG);
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const float* lseg = p.lse + static_cast<long long>(bh) * p.S;
  const float* dig = p.di + static_cast<long long>(bh) * p.S;
  // on a split grid the block sums dV (blockIdx.y 0: no V read) or dK (1)
  const bool sums_dv = !Sh::kSplit || blockIdx.y == 0;
  const bool reads_v = !Sh::kSplit || blockIdx.y == 1;

  // a streamed tile t into a stage: Q, dO, and the queries' lse, di and
  // segment ids
  const uint32_t bytes = 2 * NS * kTileBytes + 3 * 256;
  auto load = [&](int t, int stage) {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.stream_tile(stage, c), &map_q, &m.full[stage], h, t * 64, b, 64 * c);
      tma_load_tile(m.stream_tile(stage, NS + c), &map_do, &m.full[stage], h, t * 64, b, 64 * c);
    }
    bulk_load(m.row_values(0, stage), lseg + t * 64, 256, &m.full[stage]);
    bulk_load(m.row_values(1, stage), dig + t * 64, 256, &m.full[stage]);
    bulk_load(m.row_values(2, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, (reads_v ? 2 : 1) * NS * kG * kTileBytes, [&] {
    for (int w = 0; w < kG; ++w) {
      const int row = (blk * kG + w) * 64;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        tma_load_tile(m.own_tile(c, w), &map_k, m.own_full, h, row, b, 64 * c);
        if (reads_v) tma_load_tile(m.own_tile(NS + c, w), &map_v, m.own_full, h, row, b, 64 * c);
      }
    }
  }, bytes, load);
  if (wg == kG) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (wtid == 0) produce(m, bytes, load);
  } else {  // the consumer warpgroups: 64 keys each
    setmaxnreg_inc<Sh::kRegs>();
    const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int key0 = (blk * kG + wg) * 64;  // the warpgroup's first key
    // this thread's two keys: g and g + 8 of its warp's 16
    const int seg_k0 = segb[key0 + warp * 16 + g], seg_k1 = segb[key0 + warp * 16 + g + 8];
    const int lo = m.tmin[kG * blk + wg], hi = m.tmax[kG * blk + wg];
    uint64_t k_own[NS], v_own[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      k_own[c] = tile_desc(m.own_tile(c, wg));
      v_own[c] = tile_desc(m.own_tile(NS + c, wg));
    }
    const long long out = b * p.g_sb + h * p.g_sh + key0 * p.g_ss;
    mbar_wait(m.own_full, 0);
    if constexpr (Sh::kSplit) {
      float acc[NS][8][4];  // dV or dK
#pragma unroll
      for (int c = 0; c < NS; ++c) zero(acc[c]);
      if (sums_dv) {
        consume(m, lo, hi, [&](int stage) {
          uint64_t qd[NS], dod[NS];
#pragma unroll
          for (int c = 0; c < NS; ++c) {
            qd[c] = tile_desc(m.stream_tile(stage, c));
            dod[c] = tile_desc(m.stream_tile(stage, NS + c));
          }
          dv_tile<NS>(acc, k_own, qd, dod, m.row_values(0, stage),
                      reinterpret_cast<const int32_t*>(m.row_values(2, stage)), seg_k0, seg_k1,
                      t4, p.scale_log2);
        });
      } else {
        consume(m, lo, hi, [&](int stage) {
          uint64_t qd[NS], dod[NS];
#pragma unroll
          for (int c = 0; c < NS; ++c) {
            qd[c] = tile_desc(m.stream_tile(stage, c));
            dod[c] = tile_desc(m.stream_tile(stage, NS + c));
          }
          dk_tile<NS>(acc, k_own, v_own, qd, dod, m.row_values(0, stage), m.row_values(1, stage),
                      reinterpret_cast<const int32_t*>(m.row_values(2, stage)), seg_k0, seg_k1,
                      t4, p.scale, p.scale_log2);
        });
      }
      // each warp read only its own warpgroup's K tiles: stage the
      // gradient's slabs there, and store the columns before D
      __nv_bfloat16* dst = (sums_dv ? p.dv : p.dk) + out;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        store_rows(dst + 64 * c, p.g_ss, m.own_tile(c, wg), acc[c], 1.f, 1.f, warp, lane,
                   min(kHeadDim, p.D - 64 * c));
      }
    } else {
      float dk[NS][8][4], dv[NS][8][4];
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        zero(dk[c]);
        zero(dv[c]);
      }
      uint32_t kf[4][4], vf[4][4];  // at one slab K and V as A registers, one per 16-wide slice
      if constexpr (NS == 1) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          load_a_fragment(kf[kc], m.own_tile(0, wg), warp, lane, kc);
          load_a_fragment(vf[kc], m.own_tile(1, wg), warp, lane, kc);
        }
      }
      consume(m, lo, hi, [&](int stage) {
        uint64_t qd[NS], dod[NS];
#pragma unroll
        for (int c = 0; c < NS; ++c) {
          qd[c] = tile_desc(m.stream_tile(stage, c));
          dod[c] = tile_desc(m.stream_tile(stage, NS + c));
        }
        dkv_tile<NS>(dk, dv, kf, vf, k_own, v_own, qd, dod, m.row_values(0, stage),
                     m.row_values(1, stage),
                     reinterpret_cast<const int32_t*>(m.row_values(2, stage)), seg_k0, seg_k1, t4,
                     p.scale, p.scale_log2);
      });

      // each warp read only its own warpgroup's K and V tiles: stage dK and
      // dV's slabs there, and store the columns before D
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int cols = min(kHeadDim, p.D - 64 * c);
        store_rows(p.dk + out + 64 * c, p.g_ss, m.own_tile(c, wg), dk[c], 1.f, 1.f, warp, lane,
                   cols);
        store_rows(p.dv + out + 64 * c, p.g_ss, m.own_tile(NS + c, wg), dv[c], 1.f, 1.f, warp,
                   lane, cols);
      }
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(BwdShape<NS>::kThreads, 1)
    flash_attention_bwd_dq_kernel(const BwdParams p, const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const __grid_constant__ CUtensorMap map_o) {
  using Sh = BwdShape<NS>;
  constexpr int kG = Sh::kG;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // each consumer's Q slabs, its dO slabs (and its O slabs); a stage holds
  // K's slabs, then V's
  const Ring<NS> m = carve<kStages, kG, 2 * NS>(smem_raw, n_tiles, Sh::kOwnDq);
  const int blocks = p.S / (64 * kG);
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;

  // a streamed tile t into a stage: K, V and the keys' segment ids
  const uint32_t bytes = 2 * NS * kTileBytes + 256;
  auto load = [&](int t, int stage) {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.stream_tile(stage, c), &map_k, &m.full[stage], h, t * 64, b, 64 * c);
      tma_load_tile(m.stream_tile(stage, NS + c), &map_v, &m.full[stage], h, t * 64, b, 64 * c);
    }
    bulk_load(m.row_values(0, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, Sh::kOwnDq * kG * kTileBytes, [&] {
    for (int w = 0; w < kG; ++w) {
      const int row = (blk * kG + w) * 64;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        tma_load_tile(m.own_tile(c, w), &map_q, m.own_full, h, row, b, 64 * c);
        tma_load_tile(m.own_tile(NS + c, w), &map_do, m.own_full, h, row, b, 64 * c);
        if constexpr (Sh::kOwnO) {
          tma_load_tile(m.own_tile(2 * NS + c, w), &map_o, m.own_full, h, row, b, 64 * c);
        }
      }
    }
  }, bytes, load);
  if (wg == kG) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (wtid == 0) produce(m, bytes, load);
  } else {  // the consumer warpgroups: 64 queries each
    setmaxnreg_inc<Sh::kRegs>();
    const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = (blk * kG + wg) * 64;  // the warpgroup's first query
    float* di_s = m.row_values(1, 0);  // [64 kG]: the block's di
    mbar_wait(m.own_full, 0);

    // di of the warpgroup's 64 rows: two threads a row, in f32 (columns
    // past D read as 0), from its O and dO tiles or, without O's tiles,
    // from O's and dO's rows in global memory (16 bytes a load)
    {
      const int r = wtid >> 1, half = wtid & 1;
      float sum = 0.f;
      auto add = [&](const uint4& ov, const uint4& dv) {
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(o2[e]), c2 = __bfloat1622float2(d2[e]);
          sum += a.x * c2.x + a.y * c2.y;
        }
      };
      if constexpr (Sh::kOwnO) {  // 32 products a slab each
#pragma unroll
        for (int c = 0; c < NS; ++c) {
          const __nv_bfloat16* ot_own = m.own_tile(2 * NS + c, wg);
          const __nv_bfloat16* dot_own = m.own_tile(NS + c, wg);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = half * 4 + j;
            add(*reinterpret_cast<const uint4*>(ot_own + swz(r, ch * 8)),
                *reinterpret_cast<const uint4*>(dot_own + swz(r, ch * 8)));
          }
        }
      } else {  // 8 columns a load, the row's halves taking turns
        const __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + (row0 + r) * p.o_ss;
        const __nv_bfloat16* drow = p.dout + b * p.do_sb + h * p.do_sh + (row0 + r) * p.do_ss;
        for (int col = 8 * half; col < p.D; col += 16) {
          add(*reinterpret_cast<const uint4*>(orow + col),
              *reinterpret_cast<const uint4*>(drow + col));
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        di_s[wg * 64 + r] = sum;
        p.di[static_cast<long long>(bh) * p.S + row0 + r] = sum;
      }
    }
    named_sync(1 + wg, 128);

    // this thread's two query rows: g and g + 8 of its warp's 16
    const int r0 = warp * 16 + g;
    const long long rows = static_cast<long long>(bh) * p.S + row0 + r0;
    const int seg_q0 = segb[row0 + r0], seg_q1 = segb[row0 + r0 + 8];
    const float lse0 = p.lse[rows] * kLog2e, lse1 = p.lse[rows + 8] * kLog2e;
    const float di0 = di_s[wg * 64 + r0], di1 = di_s[wg * 64 + r0 + 8];
    uint64_t q_own[NS], do_own[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      q_own[c] = tile_desc(m.own_tile(c, wg));
      do_own[c] = tile_desc(m.own_tile(NS + c, wg));
    }
    uint32_t qf[4][4], df[4][4];  // at one slab Q and dO as A registers, one per 16-wide slice
    if constexpr (NS == 1) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        load_a_fragment(qf[kc], m.own_tile(0, wg), warp, lane, kc);
        load_a_fragment(df[kc], m.own_tile(1, wg), warp, lane, kc);
      }
    }
    float dq[NS][8][4];
#pragma unroll
    for (int c = 0; c < NS; ++c) zero(dq[c]);
    consume(m, m.tmin[kG * blk + wg], m.tmax[kG * blk + wg], [&](int stage) {
      uint64_t kd[NS], vd[NS];
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        kd[c] = tile_desc(m.stream_tile(stage, c));
        vd[c] = tile_desc(m.stream_tile(stage, NS + c));
      }
      dq_tile<NS>(dq, qf, df, q_own, do_own, kd, vd,
                  reinterpret_cast<const int32_t*>(m.row_values(0, stage)), seg_q0, seg_q1, lse0,
                  lse1, di0, di1, t4, p.scale, p.scale_log2);
    });

    // each warp read only its own warpgroup's Q tile: stage dQ's slabs
    // there, and store the columns before D
    __nv_bfloat16* dst = p.dq + b * p.g_sb + h * p.g_sh + row0 * p.g_ss;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      store_rows(dst + 64 * c, p.g_ss, m.own_tile(c, wg), dq[c], 1.f, 1.f, warp, lane,
                 min(kHeadDim, p.D - 64 * c));
    }
  }
}

int fill_params(BwdParams& p, const void* q, const void* k, const void* v, const void* dout,
                const int32_t* seg, const float* lse, int H, int S, int D,
                const long long* strides, float sm_scale) {
  if (S <= 0 || S % kRows || D < 8 || D > 4 * kHeadDim || D % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p = BwdParams{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.seg = seg;
  p.lse = lse;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.do_sb = strides[9], p.do_sh = strides[10], p.do_ss = strides[11];
  p.g_sb = strides[12], p.g_sh = strides[13], p.g_ss = strides[14];
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return 0;
}

// Encode the tensor maps of q, k, v, dO and o (dkv reads no o: its map is
// dO's again) over D columns and launch `kernel` at NS slabs of the head
// dim, with `n_own` own tiles a warpgroup and `parts` blocks a row tile.
template <int NS, typename Kernel>
int launch(Kernel kernel, int n_own, int parts, const BwdParams& p, int B, cudaStream_t stream) {
  using Sh = BwdShape<NS>;
  const long long blocks = static_cast<long long>(B) * p.H * (p.S / (64 * Sh::kG));
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward on a thread of its own), which the
  // driver's encoder needs
  const int smem = smem_bytes<kStages, Sh::kG, 2 * NS>(p.S, n_own);
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  struct View {
    const void* base;
    long long sb, sh, ss;
  };
  const View o = p.o ? View{p.o, p.o_sb, p.o_sh, p.o_ss} : View{p.dout, p.do_sb, p.do_sh, p.do_ss};
  const View ts[5] = {{p.q, p.q_sb, p.q_sh, p.q_ss}, {p.k, p.k_sb, p.k_sh, p.k_ss},
                      {p.v, p.v_sb, p.v_sh, p.v_ss}, {p.dout, p.do_sb, p.do_sh, p.do_ss}, o};
  CUtensorMap maps[5];
  for (int i = 0; i < 5; ++i) {
    err = encode_tile_map(&maps[i], ts[i].base, B, p.H, p.S, ts[i].sb, ts[i].sh, ts[i].ss, p.D);
    if (err != 0) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), parts), Sh::kThreads, smem, stream>>>(
      p, maps[0], maps[1], maps[2], maps[3], maps[4]);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  return launch<NS>(flash_attention_bwd_dq_kernel<NS>, BwdShape<NS>::kOwnDq, 1, p, B, stream);
}

template <int NS>
int launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
  return launch<NS>(flash_attention_bwd_dkv_kernel<NS>, BwdShape<NS>::kOwnDkv,
                    BwdShape<NS>::kSplit ? 2 : 1, p, B, stream);
}

}  // namespace

// strides: (b, h, s) strides in elements of q, k, v, dout and of the
// gradient outputs (which share one layout), in that order (15 values), and
// for dq then those of o (18).  Each entry returns the first CUDA error of
// setting the kernel's shared memory size, encoding its tensor maps and
// launching it (0 = launched).  The caller has checked shapes, dtypes
// (bf16, int32 seg, contiguous f32 lse and di), a contiguous D, strides
// that are multiples of 8 elements and 16-byte aligned pointers; D must be
// a multiple of 8 up to 256 and S a multiple of 128.
extern "C" int mfar_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const int32_t* seg,
                                           const float* lse, void* dq, float* di, int B, int H,
                                           int S, int D, const long long* strides,
                                           float sm_scale, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  BwdParams p;
  int err = fill_params(p, q, k, v, dout, seg, lse, H, S, D, strides, sm_scale);
  if (err != 0) return err;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.o_sb = strides[15], p.o_sh = strides[16], p.o_ss = strides[17];
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.di = di;
  switch ((D + kHeadDim - 1) / kHeadDim) {
    case 1: return launch_dq<1>(p, B, stream);
    case 2: return launch_dq<2>(p, B, stream);
    case 3: return launch_dq<3>(p, B, stream);
    default: return launch_dq<4>(p, B, stream);
  }
}

extern "C" int mfar_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const int32_t* seg,
                                            const float* lse, const float* di, void* dk,
                                            void* dv, int B, int H, int S, int D,
                                            const long long* strides, float sm_scale,
                                            cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  BwdParams p;
  int err = fill_params(p, q, k, v, dout, seg, lse, H, S, D, strides, sm_scale);
  if (err != 0) return err;
  p.di = const_cast<float*>(di);  // read only
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  switch ((D + kHeadDim - 1) / kHeadDim) {
    case 1: return launch_dkv<1>(p, B, stream);
    case 2: return launch_dkv<2>(p, B, stream);
    case 3: return launch_dkv<3>(p, B, stream);
    default: return launch_dkv<4>(p, B, stream);
  }
}
