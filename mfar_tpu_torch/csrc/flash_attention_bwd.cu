// Kernel K2b: the backward of kernel K2 (flash_attention.cu), written for
// Hopper (sm_90a).  Two kernels, launched in this order:
//
//   dq:  di = sum_d O * dO (f32), written out,   dQ = dS K
//   dkv: dV = P^T dO,  dK = dS^T Q               (reads dq's di)
//
// with  P  = exp(Q K^T * sm_scale - lse)  on same-segment pairs, 0 elsewhere,
//       dS = P * (dO V^T - di) * sm_scale,
// lse the forward's row logsumexp (natural units, written by K2 under
// training).  q/k/v/o/dO are bf16 [B, H, S, 64] read through their strides
// (D contiguous), seg int32 [B, S], lse and di contiguous f32 [B, H, S]; the
// gradients are bf16 (q's dtype, as JAX writes them) into [B, H, S, 64]
// views with their own strides, so the encoder's head split costs no copy.
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
//   block = 3 warpgroups: two consumers, 64 rows each (128 keys in dkv, 128
//           queries in dq; S % 128 == 0), and a producer whose one thread
//           issues every load; it keeps 24 registers a thread and the
//           consumers take 240 (setmaxnreg).  One block an SM; the grid is
//           (b, h)-major, so the blocks of one head run together and find
//           its K/V (or Q/dO) in L2.
//   loads: TMA (4-D tensor maps over the [B, S, H, D] buffers, encoded on
//        the host each call, 128-byte swizzle) into the layout wgmma's
//        descriptors read; the row values (lse, di, segment ids) by bulk
//        copy.  The block's own tiles land on one mbarrier; the streamed
//        tiles go through a ring of two stages (full / empty mbarriers).
//        The block structure, the ring, the live-tile list and the tensor
//        maps are hopper_pipeline.cuh's, shared with K2.
//   dkv: each consumer's K and V tiles stay put, also as bf16 A registers;
//        64-query tiles of Q and dO with their lse, di and segment ids
//        stream.  Per tile: S^T = K Q^T and dP^T = V dO^T (B the Q / dO
//        tile, K-major), P^T and dS^T packed to bf16 A registers, dV += P^T
//        dO and dK += dS^T Q (B the dO / Q tile, MN-major).
//   dq:  each consumer's Q, dO and O tiles stay put; it first computes di
//        for its rows from the O and dO tiles and writes it out for dkv.
//        64-key tiles of K and V with their segment ids stream.  Per tile:
//        S = Q K^T, dP = dO V^T, dS as bf16 A registers, dQ += dS K (K
//        MN-major).
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
// [min, max] meets that of its own 128 rows (a warpgroup skips the
// products of a walked tile that misses its own 64 rows); every P entry of
// a skipped pair of tiles is 0, so the skip is exact.  Pads attend pads, so
// pad x pad tiles stay live, and a block's own tiles always are; they come
// first, so their loads start before the list is known.
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
// products add to that time instead of hiding under it (see PERF.md).

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
  int H, S;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

constexpr int kStages = 2;  // of the ring of streamed tiles
using Ring = Smem<kStages>;

// One streamed tile of 64 queries against the warpgroup's 64 keys (K and V
// as A registers kf, vf): dV += P^T dO, dK += dS^T Q.  seg_k0/1 are
// the segment ids of this thread's two keys (rows g and g + 8 of its
// warp's 16).
__device__ __forceinline__ void dkv_tile(float (&dk)[8][4], float (&dv)[8][4],
                                         const uint32_t (&kf)[4][4], const uint32_t (&vf)[4][4],
                                         const __nv_bfloat16* qt,
                                         const __nv_bfloat16* dot, const float* lse_t,
                                         const float* di_t, const int32_t* seg_t, int seg_k0,
                                         int seg_k1, int t4, float scale, float scale_log2) {
  const uint64_t qd = tile_desc(qt), dod = tile_desc(dot);
  float st[8][4], dpt[8][4];
  zero(st);
  zero(dpt);
  wgmma_fence();
  gemm_rs<0>(st, kf, qd);  // S^T = K Q^T
  wgmma_commit();
  gemm_rs<0>(dpt, vf, dod);  // dP^T = V dO^T
  wgmma_commit();
  wgmma_wait<1>();
  pin(st);

  // P^T = exp2(S^T * sm_scale * log2 e - lse * log2 e) on same-segment
  // pairs, exactly 0 elsewhere; bf16 A registers (rows = keys) for P^T dO
  uint32_t pf[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;  // the tile's queries c and c + 1
    const int sq0 = seg_t[c], sq1 = seg_t[c + 1];
    const float l0 = lse_t[c] * kLog2e, l1 = lse_t[c + 1] * kLog2e;
    st[n][0] = sq0 == seg_k0 ? exp2_approx(st[n][0] * scale_log2 - l0) : 0.f;
    st[n][1] = sq1 == seg_k0 ? exp2_approx(st[n][1] * scale_log2 - l1) : 0.f;
    st[n][2] = sq0 == seg_k1 ? exp2_approx(st[n][2] * scale_log2 - l0) : 0.f;
    st[n][3] = sq1 == seg_k1 ? exp2_approx(st[n][3] * scale_log2 - l1) : 0.f;
    pf[n >> 1][(n & 1) * 2] = pack_bf16(st[n][0], st[n][1]);
    pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(st[n][2], st[n][3]);
  }
  wgmma_fence();
  gemm_rs<1>(dv, pf, dod);  // dV += P^T dO
  wgmma_commit();
  wgmma_wait<1>();
  pin(dpt);

  // dS^T = P^T (dP^T - di) * sm_scale as bf16 A registers
  uint32_t dsf[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t4;
    const float d0 = di_t[c], d1 = di_t[c + 1];
    dsf[n >> 1][(n & 1) * 2] =
        pack_bf16(st[n][0] * (dpt[n][0] - d0) * scale, st[n][1] * (dpt[n][1] - d1) * scale);
    dsf[n >> 1][(n & 1) * 2 + 1] =
        pack_bf16(st[n][2] * (dpt[n][2] - d0) * scale, st[n][3] * (dpt[n][3] - d1) * scale);
  }
  wgmma_fence();
  gemm_rs<1>(dk, dsf, qd);  // dK += dS^T Q
  wgmma_commit();
  wgmma_wait<0>();
  pin(pf);
  pin(dsf);
  pin(dv);
  pin(dk);
}

// One streamed tile of 64 keys against the warpgroup's 64 queries (Q and dO
// as A registers qf, df): dQ += dS K.  seg_q0/1, lse0/1 (log2
// units) and di0/1 belong to this thread's two query rows.
__device__ __forceinline__ void dq_tile(float (&dq)[8][4], const uint32_t (&qf)[4][4],
                                        const uint32_t (&df)[4][4],
                                        const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                                        const int32_t* seg_t, int seg_q0, int seg_q1, float lse0,
                                        float lse1, float di0, float di1, int t4, float scale,
                                        float scale_log2) {
  const uint64_t kd = tile_desc(kt), vd = tile_desc(vt);
  float s[8][4], dpm[8][4];
  zero(s);
  zero(dpm);
  wgmma_fence();
  gemm_rs<0>(s, qf, kd);  // S = Q K^T
  wgmma_commit();
  gemm_rs<0>(dpm, df, vd);  // dP = dO V^T
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
  gemm_rs<1>(dq, dsf, kd);  // dQ += dS K
  wgmma_commit();
  wgmma_wait<0>();
  pin(dsf);
  pin(dq);
}

__global__ void __launch_bounds__(kBlockThreads + 128, 1)
    flash_attention_bwd_dkv_kernel(const BwdParams p, const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __grid_constant__ CUtensorMap map_do,
                                   const __grid_constant__ CUtensorMap) {
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  const Ring m = carve<kStages>(smem_raw, n_tiles, 2);
  const int blocks = p.S / kRows;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const float* lseg = p.lse + static_cast<long long>(bh) * p.S;
  const float* dig = p.di + static_cast<long long>(bh) * p.S;

  // a streamed tile t into a stage: Q, dO, and the queries' lse, di and
  // segment ids
  const uint32_t bytes = 2 * kTileBytes + 3 * 256;
  auto load = [&](int t, int stage) {
    tma_load_tile(m.stream_tile(stage, 0), &map_q, &m.full[stage], h, t * 64, b);
    tma_load_tile(m.stream_tile(stage, 1), &map_do, &m.full[stage], h, t * 64, b);
    bulk_load(m.row_values(0, stage), lseg + t * 64, 256, &m.full[stage]);
    bulk_load(m.row_values(1, stage), dig + t * 64, 256, &m.full[stage]);
    bulk_load(m.row_values(2, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, 2 * kGroups * kTileBytes, [&] {
    for (int w = 0; w < kGroups; ++w) {
      tma_load_tile(m.own_tile(0, w), &map_k, m.own_full, h, blk * kRows + w * 64, b);
      tma_load_tile(m.own_tile(1, w), &map_v, m.own_full, h, blk * kRows + w * 64, b);
    }
  }, bytes, load);
  if (wg == kGroups) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (wtid == 0) produce(m, bytes, load);
  } else {  // the consumer warpgroups: 64 keys each
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int key0 = blk * kRows + wg * 64;  // the warpgroup's first key
    // this thread's two keys: g and g + 8 of its warp's 16
    const int seg_k0 = segb[key0 + warp * 16 + g], seg_k1 = segb[key0 + warp * 16 + g + 8];
    __nv_bfloat16* kt_own = m.own_tile(0, wg);
    __nv_bfloat16* vt_own = m.own_tile(1, wg);
    float dk[8][4], dv[8][4];
    zero(dk);
    zero(dv);
    mbar_wait(m.own_full, 0);
    uint32_t kf[4][4], vf[4][4];  // K and V as A registers, one per 16-wide slice of D
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      load_a_fragment(kf[kc], kt_own, warp, lane, kc);
      load_a_fragment(vf[kc], vt_own, warp, lane, kc);
    }
    consume(m, m.tmin[kGroups * blk + wg], m.tmax[kGroups * blk + wg], [&](int stage) {
      dkv_tile(dk, dv, kf, vf, m.stream_tile(stage, 0), m.stream_tile(stage, 1),
               m.row_values(0, stage), m.row_values(1, stage),
               reinterpret_cast<const int32_t*>(m.row_values(2, stage)), seg_k0, seg_k1, t4,
               p.scale, p.scale_log2);
    });

    // each warp read only its own warpgroup's K and V tiles: stage dK and dV there
    const long long out = b * p.g_sb + h * p.g_sh + key0 * p.g_ss;
    store_rows(p.dk + out, p.g_ss, kt_own, dk, 1.f, 1.f, warp, lane);
    store_rows(p.dv + out, p.g_ss, vt_own, dv, 1.f, 1.f, warp, lane);
  }
}

__global__ void __launch_bounds__(kBlockThreads + 128, 1)
    flash_attention_bwd_dq_kernel(const BwdParams p, const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const __grid_constant__ CUtensorMap map_o) {
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  const Ring m = carve<kStages>(smem_raw, n_tiles, 3);
  const int blocks = p.S / kRows;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;

  // a streamed tile t into a stage: K, V and the keys' segment ids
  const uint32_t bytes = 2 * kTileBytes + 256;
  auto load = [&](int t, int stage) {
    tma_load_tile(m.stream_tile(stage, 0), &map_k, &m.full[stage], h, t * 64, b);
    tma_load_tile(m.stream_tile(stage, 1), &map_v, &m.full[stage], h, t * 64, b);
    bulk_load(m.row_values(0, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, 3 * kGroups * kTileBytes, [&] {
    for (int w = 0; w < kGroups; ++w) {
      tma_load_tile(m.own_tile(0, w), &map_q, m.own_full, h, blk * kRows + w * 64, b);
      tma_load_tile(m.own_tile(1, w), &map_do, m.own_full, h, blk * kRows + w * 64, b);
      tma_load_tile(m.own_tile(2, w), &map_o, m.own_full, h, blk * kRows + w * 64, b);
    }
  }, bytes, load);
  if (wg == kGroups) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (wtid == 0) produce(m, bytes, load);
  } else {  // the consumer warpgroups: 64 queries each
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = blk * kRows + wg * 64;  // the warpgroup's first query
    __nv_bfloat16* qt_own = m.own_tile(0, wg);
    const __nv_bfloat16* dot_own = m.own_tile(1, wg);
    const __nv_bfloat16* ot_own = m.own_tile(2, wg);
    float* di_s = m.row_values(1, 0);  // [kRows]: the block's di
    mbar_wait(m.own_full, 0);

    // di of the warpgroup's 64 rows from its O and dO tiles: two threads a
    // row, 32 products each, in f32
    {
      const int r = wtid >> 1, half = wtid & 1;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = half * 4 + j;
        const uint4 ov = *reinterpret_cast<const uint4*>(ot_own + swz(r, ch * 8));
        const uint4 dv = *reinterpret_cast<const uint4*>(dot_own + swz(r, ch * 8));
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(o2[e]), c = __bfloat1622float2(d2[e]);
          sum += a.x * c.x + a.y * c.y;
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
    uint32_t qf[4][4], df[4][4];  // Q and dO as A registers, one per 16-wide slice of D
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      load_a_fragment(qf[kc], qt_own, warp, lane, kc);
      load_a_fragment(df[kc], dot_own, warp, lane, kc);
    }
    float dq[8][4];
    zero(dq);
    consume(m, m.tmin[kGroups * blk + wg], m.tmax[kGroups * blk + wg], [&](int stage) {
      dq_tile(dq, qf, df, m.stream_tile(stage, 0), m.stream_tile(stage, 1),
              reinterpret_cast<const int32_t*>(m.row_values(0, stage)), seg_q0, seg_q1, lse0,
              lse1, di0, di1, t4, p.scale, p.scale_log2);
    });

    // each warp read only its own warpgroup's Q tile: stage dQ there
    store_rows(p.dq + b * p.g_sb + h * p.g_sh + row0 * p.g_ss, p.g_ss, qt_own, dq, 1.f, 1.f,
               warp, lane);
  }
}

int fill_params(BwdParams& p, const void* q, const void* k, const void* v, const void* dout,
                const int32_t* seg, const float* lse, int B, int H, int S,
                const long long* strides, float sm_scale, long long* blocks) {
  if (S <= 0 || S % kRows) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<long long>(B) * H * (S / kRows);
  if (*blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
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
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return 0;
}

// Encode the tensor maps of q, k, v, dO and o (dkv reads no o: its map is
// dO's again) and launch `kernel` with `n_own` own tiles a warpgroup.
template <typename Kernel>
int launch(Kernel kernel, int n_own, const BwdParams& p, int B, long long blocks,
           cudaStream_t stream) {
  // a runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward on a thread of its own), which the
  // driver's encoder needs
  const int smem = smem_bytes<kStages>(p.S, n_own);
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
    err = encode_tile_map(&maps[i], ts[i].base, B, p.H, p.S, ts[i].sb, ts[i].sh, ts[i].ss);
    if (err != 0) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads + 128, smem, stream>>>(
      p, maps[0], maps[1], maps[2], maps[3], maps[4]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: (b, h, s) strides in elements of q, k, v, dout and of the
// gradient outputs (which share one layout), in that order (15 values), and
// for dq then those of o (18).  Each entry returns the first CUDA error of
// setting the kernel's shared memory size and launching it (0 = launched).
// The caller has checked shapes, dtypes (bf16, int32 seg, contiguous f32
// lse and di), D == 64, S % 128 == 0, a contiguous D, strides that are
// multiples of 8 elements and 16-byte aligned pointers.
extern "C" int mfar_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const int32_t* seg,
                                           const float* lse, void* dq, float* di, int B, int H,
                                           int S, const long long* strides, float sm_scale,
                                           cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  BwdParams p;
  long long blocks = 0;
  int err = fill_params(p, q, k, v, dout, seg, lse, B, H, S, strides, sm_scale, &blocks);
  if (err != 0) return err;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.o_sb = strides[15], p.o_sh = strides[16], p.o_ss = strides[17];
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.di = di;
  return launch(flash_attention_bwd_dq_kernel, 3, p, B, blocks, stream);
}

extern "C" int mfar_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const int32_t* seg,
                                            const float* lse, const float* di, void* dk,
                                            void* dv, int B, int H, int S,
                                            const long long* strides, float sm_scale,
                                            cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  BwdParams p;
  long long blocks = 0;
  int err = fill_params(p, q, k, v, dout, seg, lse, B, H, S, strides, sm_scale, &blocks);
  if (err != 0) return err;
  p.di = const_cast<float*>(di);  // read only
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  return launch(flash_attention_bwd_dkv_kernel, 2, p, B, blocks, stream);
}
